"""Checkpoint / resume of the port (`training/checkpoint.py`) on the CPU,
mirroring tests/test_checkpoint.py and the EMA cases of tests/test_ema.py:
bit-exact round trip; train 3 + save + restore + train 2 equals train 5
bit for bit; restore_or_init on a fresh directory; cadence and
retention; async save durable after wait(); params-only and EMA-only
restores; the structure-mismatch error when ema_decay is toggled; a save
cut off mid-write is never listed as a step."""

import json
import os

import numpy as np
import pytest
import torch

from cloud_server_tpu_torch.config import ModelConfig, TrainConfig
from cloud_server_tpu_torch.training import (
    Checkpointer, abstract_train_state, init_train_state, make_train_step,
    restore_or_init)
from cloud_server_tpu_torch.training import checkpoint as ckpt_mod
from cloud_server_tpu_torch.training.checkpoint import (restore_ema_params,
                                                        restore_params)
from cloud_server_tpu_torch.training.optim import ema_params, flatten

TINY = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=32, dtype="float32",
    param_dtype="float32", remat="none")
TCFG = TrainConfig(batch_size=8, seq_len=16, warmup_steps=2, total_steps=50,
                   learning_rate=1e-2)


def _batch(seed):
    tok = np.random.default_rng(seed).integers(0, TINY.vocab_size, (8, 16))
    return {"tokens": torch.from_numpy(tok)}


def _leaves(state):
    out = dict(flatten(state.params))
    out.update({f"mu/{k}": t for k, t in flatten(ckpt_mod._split_opt(
        state.opt_state)[0].mu)})
    out.update({f"nu/{k}": t for k, t in flatten(ckpt_mod._split_opt(
        state.opt_state)[0].nu)})
    ema = ema_params(state.opt_state)
    if ema is not None:
        out.update({f"ema/{k}": t for k, t in flatten(ema)})
    return out


def _assert_states_equal(a, b):
    assert int(a.step) == int(b.step)
    assert ckpt_mod._split_opt(a.opt_state)[0].count == \
        ckpt_mod._split_opt(b.opt_state)[0].count
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k].detach(), lb[k].detach()), k


def _init(tcfg=TCFG):
    return init_train_state(TINY, tcfg, 0, "cpu")


def test_save_restore_roundtrip(tmp_path):
    state = _init()
    with Checkpointer(tmp_path, async_save=False) as ckpt:
        assert ckpt.save(state)
        assert not ckpt.save(state, force=True)  # the step is on disk
        got = ckpt.restore(abstract_train_state(TINY, TCFG), device="cpu")
    _assert_states_equal(state, got)
    assert all(p.requires_grad for _, p in flatten(got.params))


def test_resume_is_bit_exact(tmp_path):
    """train 3 + save + restore + train 2 == train 5 uninterrupted."""
    step = make_train_step(TINY, TCFG)

    def run(state, n, seed0):
        for i in range(n):
            state, _ = step(state, _batch(seed0 + i))
        return state

    ref = run(_init(), 5, 100)
    state = run(_init(), 3, 100)
    with Checkpointer(tmp_path, async_save=False) as ckpt:
        ckpt.save(state)
        del state
        resumed, was_resumed = restore_or_init(ckpt, TINY, TCFG, 0, "cpu")
    assert was_resumed and resumed.step == 3
    _assert_states_equal(ref, run(resumed, 2, 103))


def test_restore_or_init_fresh(tmp_path):
    with Checkpointer(tmp_path, async_save=False) as ckpt:
        state, resumed = restore_or_init(ckpt, TINY, TCFG, 0, "cpu")
    assert not resumed and state.step == 0
    _assert_states_equal(state, _init())


def test_retention_and_cadence(tmp_path):
    state = _init()
    with Checkpointer(tmp_path, max_to_keep=2, save_interval_steps=2,
                      async_save=False) as ckpt:
        saved = [ckpt.save(state._replace(step=s)) for s in range(6)]
        # cadence 2 -> saved {0, 2, 4}; retention 2 -> kept {2, 4}
        assert saved == [True, False, True, False, True, False]
        assert ckpt.all_steps() == [2, 4]
        assert ckpt.latest_step() == 4


def test_async_save_is_durable_after_wait(tmp_path):
    state = _init()
    with Checkpointer(tmp_path, async_save=True) as ckpt:
        assert ckpt.save(state)
        ckpt.wait()
        assert ckpt.latest_step() == 0
        got = ckpt.restore(abstract_train_state(TINY, TCFG), device="cpu")
    _assert_states_equal(state, got)


def test_async_save_snapshots_before_the_next_update(tmp_path):
    """The next optimizer step updates the parameters in place while the
    writer runs: the checkpoint still holds the saved step's values."""
    step = make_train_step(TINY, TCFG)
    state, _ = step(_init(), _batch(1))
    want = {k: t.detach().clone() for k, t in flatten(state.params)}
    with Checkpointer(tmp_path, async_save=True) as ckpt:
        ckpt.save(state)
        state, _ = step(state, _batch(2))
    got = restore_params(tmp_path, TINY, device="cpu")
    for k, t in flatten(got):
        assert torch.equal(t, want[k]), k


def test_restore_params_reads_no_moments(tmp_path):
    state = _init()
    with Checkpointer(tmp_path, async_save=False) as ckpt:
        ckpt.save(state)
    os.remove(tmp_path / "0" / "opt.pt")  # the moments are never read
    params = restore_params(tmp_path, TINY, device="cpu")
    for (ka, a), (kb, b) in zip(flatten(state.params), flatten(params)):
        assert ka == kb and torch.equal(a.detach(), b)
    with pytest.raises(FileNotFoundError):
        restore_params(tmp_path / "empty", TINY, device="cpu")


def test_ema_item_roundtrip_and_toggle_error(tmp_path):
    tcfg = TrainConfig(batch_size=8, seq_len=16, warmup_steps=1,
                       total_steps=10, learning_rate=1e-2, ema_decay=0.9)
    step = make_train_step(TINY, tcfg)
    state = _init(tcfg)
    for i in range(2):
        state, _ = step(state, _batch(i))
    with Checkpointer(tmp_path, async_save=False) as ckpt:
        ckpt.save(state)
        got = ckpt.restore(abstract_train_state(TINY, tcfg), device="cpu")
        _assert_states_equal(state, got)
        with pytest.raises(ValueError, match="ema_decay was toggled"):
            ckpt.restore(abstract_train_state(TINY, TCFG), device="cpu")
    ema = restore_ema_params(tmp_path, TINY, device="cpu")
    for (ka, a), (kb, b) in zip(flatten(ema_params(state.opt_state)),
                                flatten(ema)):
        assert ka == kb and b.dtype == torch.float32 and torch.equal(a, b)
    # a run without EMA has no such item; restoring it with EMA on fails
    plain = tmp_path / "plain"
    with Checkpointer(plain, async_save=False) as ckpt:
        ckpt.save(_init())
        with pytest.raises(ValueError, match="ema_decay was toggled"):
            ckpt.restore(abstract_train_state(TINY, tcfg), device="cpu")
    with pytest.raises(FileNotFoundError, match="no 'ema' item"):
        restore_ema_params(plain, TINY, device="cpu")


def test_cut_off_save_is_not_a_step(tmp_path, monkeypatch):
    """A save that dies after writing some of its files leaves no step:
    the last complete step stays the latest, and a later save of the
    same step succeeds."""
    state = _init()
    with Checkpointer(tmp_path, async_save=False) as ckpt:
        ckpt.save(state)
        calls = []

        def dying(path, obj):
            calls.append(path)
            if len(calls) == 2:
                raise OSError("disk full")
            real(path, obj)

        real = ckpt_mod._write_file
        monkeypatch.setattr(ckpt_mod, "_write_file", dying)
        with pytest.raises(OSError, match="disk full"):
            ckpt.save(state._replace(step=7))
        assert ckpt.all_steps() == [0]
        assert any(".tmp-" in n for n in os.listdir(tmp_path))
        monkeypatch.setattr(ckpt_mod, "_write_file", real)
        assert ckpt.save(state._replace(step=7))
        assert ckpt.all_steps() == [0, 7]


def test_async_writer_error_surfaces_at_wait(tmp_path, monkeypatch):
    def failing(path, obj):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "_write_file", failing)
    ckpt = Checkpointer(tmp_path, async_save=True)
    assert ckpt.save(_init())
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    assert ckpt.all_steps() == []
    ckpt.close()


def test_meta_records_the_write_time(tmp_path):
    """meta.json carries write_s, the seconds the item files took to write
    and sync, for every save; a restore reads past it."""
    state = _init()
    with Checkpointer(tmp_path, async_save=True) as ckpt:
        ckpt.save(state)
        ckpt.wait()
        with open(tmp_path / "0" / "meta.json") as f:
            meta = json.load(f)
        got = ckpt.restore(abstract_train_state(TINY, TCFG), device="cpu")
    assert isinstance(meta["write_s"], float) and meta["write_s"] >= 0.0
    _assert_states_equal(state, got)
