"""The port's training path against the reference's, float32 on the CPU,
from the same numpy weights and batches:

  * `next_token_loss` and its gradients, leaf by leaf, for
    attention_impl "xla" and "flash" (the reference's flash in interpret
    mode), the dense and the vocab-chunked CE, with and without z-loss,
    with and without remat — loss within 1e-5 relative, every gradient
    leaf within 1e-4 of its largest reference entry;
  * the learning-rate schedules against optax's at every step (1e-6
    relative: float32 there, float64 here);
  * `fused_adamw` over 3 updates on identical gradients (the first large
    enough that clipping engages), parameters and moments within 1e-6;
  * one `make_train_step` step: loss and grad_norm within 1e-5
    relative, parameters after the update within 1e-6, with
    microbatch_steps 1 and 2;
  * the losses of a 4-step `train_loop` on SyntheticLMDataset within
    1e-4 relative of the reference loop's; the same with periodic
    evaluation and checkpointing on (eval records within 1e-4, eval_ppl
    = exp(eval_loss));
  * resume: 4 steps, then a resumed run to 8, equals 8 straight steps bit
    for bit; a KeyboardInterrupt from a hook saves, a NaN-guard abort
    does not;
  * remat "dots" and "attn" (selective checkpointing): loss and
    gradients equal "full"'s and the reference's under the same policy;
    per layer the backward reruns the flash forward once under "full"
    and never under "attn"/"dots", and "dots" reruns no projection;
  * the FaultInjector drills of tests/test_failure.py on one device.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_server_tpu.config import MeshConfig, ModelConfig, TrainConfig
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu.parallel.mesh import make_mesh
from cloud_server_tpu.training import init_train_state as ref_init_state
from cloud_server_tpu.training import make_train_step as ref_make_step
from cloud_server_tpu.training import optim as ref_optim
from cloud_server_tpu_torch import config as tconfig
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.training import optim, train_step
from cloud_server_tpu_torch.training.loop import LoopConfig, train_loop
from cloud_server_tpu_torch.utils.logging import read_jsonl

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

TINY = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=32, dtype="float32",
    param_dtype="float32", remat="none")


def _t(cfg):
    """The reference's config as the port's config class."""
    for name in ("ModelConfig", "TrainConfig", "MeshConfig"):
        if type(cfg).__name__ == name:
            return getattr(tconfig, name)(**dataclasses.asdict(cfg))
    raise TypeError(type(cfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(np_params, cfg):
    params = transformer.params_from_numpy(np_params, _t(cfg), device="cpu",
                                           keep_param_dtype=True)
    return optim.map_tree(lambda p: p.requires_grad_(True), params)


def _tokens(b, s, vocab, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _assert_tree_close(got: dict, want, tol, what=""):
    flat_want = dict(optim.flatten(_np_tree(want)))
    flat_got = dict(optim.flatten(got))
    assert sorted(flat_got) == sorted(flat_want)
    for path, w in flat_want.items():
        g = flat_got[path]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(
            g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{what}{path}")


LOSS_CASES = {
    "xla": dict(attention_impl="xla"),
    "xla_zloss": dict(attention_impl="xla", z=1e-3),
    "xla_chunked": dict(attention_impl="xla", vocab_chunk=24),
    "flash_fused": dict(attention_impl="flash"),
    "flash_blocked_remat": dict(attention_impl="flash", flash_block_q=8,
                                flash_block_kv=8, remat="full"),
    "flash_chunked_zloss": dict(attention_impl="flash", vocab_chunk=16,
                                z=1e-3),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_next_token_loss_and_grads_match_reference(name):
    opts = dict(LOSS_CASES[name])
    z = opts.pop("z", 0.0)
    cfg = dataclasses.replace(TINY, **opts)
    ref_cfg = dataclasses.replace(cfg, remat="none")
    ref_params = ref_tf.init_params(ref_cfg, jax.random.key(1))
    tokens = _tokens(2, 16, cfg.vocab_size)
    (want_loss, want_m), want_g = jax.value_and_grad(
        ref_tf.next_token_loss, has_aux=True)(
        ref_params, {"tokens": jnp.asarray(tokens)}, ref_cfg, z)
    params = _port_params(_np_tree(ref_params), cfg)
    loss, metrics = transformer.next_token_loss(
        params, {"tokens": torch.from_numpy(tokens)}, _t(cfg), z)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for key in want_m:
        np.testing.assert_allclose(float(metrics[key]), float(want_m[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    _assert_tree_close(optim.map_tree(lambda p: p.grad, params), want_g,
                       1e-4, "grad ")


SCHEDULES = ["warmup_cosine", "constant", "wsd"]


def _tcfg(schedule, **kw):
    base = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                lr_schedule=schedule, weight_decay=0.1, grad_clip_norm=0.5)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_optax(schedule, warmup):
    cfg = _tcfg(schedule, warmup_steps=warmup, total_steps=20)
    want = ref_optim.make_schedule(cfg)
    got = optim.make_schedule(_t(cfg))
    for count in range(cfg.total_steps + 5):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_fused_adamw_matches_reference(schedule):
    cfg = _tcfg(schedule)
    r = np.random.default_rng(3)
    np_params = {"layers": {"w": r.standard_normal((3, 4)).astype(
        np.float32), "attn_norm": np.ones((3,), np.float32)},
        "final_norm": {"scale": np.ones((4,), np.float32)}}
    ref_opt = ref_optim.fused_adamw(cfg)
    ref_params = jax.tree.map(jnp.asarray, np_params)
    ref_state = ref_opt.init(ref_params)
    opt = optim.fused_adamw(_t(cfg))
    params = optim.map_tree(lambda x: torch.from_numpy(x.copy()), np_params)
    state = opt.init(params)
    for i in range(3):
        scale = 100.0 if i == 0 else 0.1
        np_grads = jax.tree.map(
            lambda p: (scale * r.standard_normal(p.shape)).astype(
                np.float32), np_params)
        upd, ref_state = ref_opt.update(
            jax.tree.map(jnp.asarray, np_grads), ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, upd)
        state, gnorm = opt.step_(
            optim.map_tree(lambda g: torch.from_numpy(g.copy()), np_grads),
            state, params)
        np.testing.assert_allclose(float(gnorm), float(
            optax.global_norm(jax.tree.map(jnp.asarray, np_grads))),
            rtol=1e-6)
        _assert_tree_close(params, ref_params, 1e-6, f"step {i} param ")
        _assert_tree_close(state.mu, ref_state.mu, 1e-6, f"step {i} mu ")
        _assert_tree_close(state.nu, ref_state.nu, 1e-6, f"step {i} nu ")
    assert state.count == int(ref_state.count) == 3


def test_ema_of_params_matches_reference():
    cfg = _tcfg("constant", ema_decay=0.9)
    r = np.random.default_rng(4)
    np_params = {"layers": {"w": r.standard_normal((2, 3)).astype(
        np.float32)}, "final_norm": {"scale": np.ones((3,), np.float32)}}
    ref_opt = ref_optim.make_optimizer(cfg)
    ref_params = jax.tree.map(jnp.asarray, np_params)
    ref_state = ref_opt.init(ref_params)
    opt = optim.make_optimizer(_t(cfg))
    params = optim.map_tree(lambda x: torch.from_numpy(x.copy()), np_params)
    state = opt.init(params)
    for _ in range(3):
        np_grads = jax.tree.map(lambda p: r.standard_normal(p.shape).astype(
            np.float32), np_params)
        upd, ref_state = ref_opt.update(
            jax.tree.map(jnp.asarray, np_grads), ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, upd)
        state, _ = opt.step_(optim.map_tree(
            lambda g: torch.from_numpy(g.copy()), np_grads), state, params)
    _assert_tree_close(optim.ema_params(state),
                       ref_optim.ema_params(ref_state), 1e-6, "ema ")
    assert optim.ema_params(opt.adamw.init(params)) is None


@pytest.mark.parametrize("microbatch_steps", [1, 2])
def test_train_step_matches_reference(microbatch_steps):
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                       batch_size=4, seq_len=16,
                       microbatch_steps=microbatch_steps)
    mesh = make_mesh(MeshConfig())
    ref_state = ref_init_state(TINY, tcfg, mesh, jax.random.key(0))
    np_params = _np_tree(ref_state.params)
    ref_step, _ = ref_make_step(TINY, tcfg, mesh)
    tokens = _tokens(4, 16, TINY.vocab_size)
    ref_state, ref_m = ref_step(ref_state, {"tokens": jnp.asarray(tokens)})

    state = train_step.train_state_from_params(
        _port_params(np_params, TINY), _t(tcfg))
    step = train_step.make_train_step(_t(TINY), _t(tcfg))
    state, metrics = step(state, {"tokens": torch.from_numpy(tokens).long()})
    assert state.step == 1
    for key in ("loss", "grad_norm", "accuracy"):
        np.testing.assert_allclose(float(metrics[key]), float(ref_m[key]),
                                   rtol=1e-5, err_msg=key)
    _assert_tree_close(state.params, ref_state.params, 1e-6, "param ")


def test_train_loop_tracks_reference(tmp_path):
    from cloud_server_tpu.data.dataset import SyntheticLMDataset as RefDS
    from cloud_server_tpu.training.loop import LoopConfig as RefLoop
    from cloud_server_tpu.training.loop import train_loop as ref_loop
    from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
    from cloud_server_tpu_torch.training import loop as tloop

    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=4,
                       batch_size=4, seq_len=16)
    ref_loop(TINY, tcfg, RefDS(32, 16, TINY.vocab_size, seed=0),
             loop_cfg=RefLoop(log_interval=1, logdir=str(tmp_path / "ref")))
    want = [r["loss"] for r in read_jsonl(tmp_path / "ref" / "train.jsonl")]

    # the reference loop draws its weights from jax.random.key(seed); the
    # port's loop starts from the same numbers
    mesh = make_mesh(MeshConfig())
    np_params = _np_tree(ref_init_state(TINY, tcfg, mesh,
                                        jax.random.key(tcfg.seed)).params)

    def same_init(model_cfg, train_cfg, seed, device, loss_fn_module=None,
                  mesh=None, rules=None):
        assert mesh is None and rules is None
        return train_step.train_state_from_params(
            _port_params(np_params, TINY), train_cfg)

    orig = tloop.init_train_state
    tloop.init_train_state = same_init
    try:
        train_loop(_t(TINY), _t(tcfg),
                   SyntheticLMDataset(32, 16, TINY.vocab_size, seed=0),
                   loop_cfg=LoopConfig(log_interval=1,
                                       logdir=str(tmp_path / "port")),
                   device="cpu")
    finally:
        tloop.init_train_state = orig
    got = [r["loss"] for r in read_jsonl(tmp_path / "port" / "train.jsonl")]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _same_init(np_params, monkeypatch):
    """Start the port's loop from the reference's initial weights (the
    reference loop draws them from jax.random.key(seed))."""
    from cloud_server_tpu_torch.training import checkpoint as tckpt
    from cloud_server_tpu_torch.training import loop as tloop

    def same_init(model_cfg, train_cfg, seed, device, loss_fn_module=None,
                  mesh=None, rules=None):
        assert mesh is None and rules is None
        return train_step.train_state_from_params(
            _port_params(np_params, TINY), train_cfg)

    monkeypatch.setattr(tloop, "init_train_state", same_init)
    monkeypatch.setattr(tckpt, "init_train_state", same_init)


def test_train_loop_with_eval_and_checkpoint_tracks_reference(
        tmp_path, monkeypatch):
    from cloud_server_tpu.data.dataset import SyntheticLMDataset as RefDS
    from cloud_server_tpu.training.loop import LoopConfig as RefLoop
    from cloud_server_tpu.training.loop import train_loop as ref_loop
    from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
    from cloud_server_tpu_torch.training.checkpoint import all_steps

    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=4,
                       batch_size=4, seq_len=16)
    knobs = dict(log_interval=1, checkpoint_interval=2, eval_interval=2,
                 eval_batches=2)
    ref_loop(TINY, tcfg, RefDS(32, 16, TINY.vocab_size, seed=0),
             eval_dataset=RefDS(16, 16, TINY.vocab_size, seed=5),
             loop_cfg=RefLoop(logdir=str(tmp_path / "ref"),
                              checkpoint_dir=str(tmp_path / "ref_ck"),
                              **knobs))
    want = read_jsonl(tmp_path / "ref" / "train.jsonl")

    mesh = make_mesh(MeshConfig())
    _same_init(_np_tree(ref_init_state(TINY, tcfg, mesh,
                                       jax.random.key(tcfg.seed)).params),
               monkeypatch)
    train_loop(_t(TINY), _t(tcfg),
               SyntheticLMDataset(32, 16, TINY.vocab_size, seed=0),
               eval_dataset=SyntheticLMDataset(16, 16, TINY.vocab_size,
                                               seed=5),
               loop_cfg=LoopConfig(logdir=str(tmp_path / "port"),
                                   checkpoint_dir=str(tmp_path / "ck"),
                                   **knobs),
               device="cpu")
    got = read_jsonl(tmp_path / "port" / "train.jsonl")
    for key in ("loss", "eval_loss", "eval_accuracy"):
        w = [(r["step"], r[key]) for r in want if key in r]
        g = [(r["step"], r[key]) for r in got if key in r]
        assert [s for s, _ in g] == [s for s, _ in w], key
        np.testing.assert_allclose([x for _, x in g], [x for _, x in w],
                                   rtol=1e-4, atol=1e-7, err_msg=key)
    evals = [r for r in got if "eval_loss" in r]
    assert [r["step"] for r in evals] == [2, 4]
    for r in evals:
        assert r["eval_ppl"] == pytest.approx(np.exp(r["eval_loss"]))
        assert r["eval_tokens"] == 2 * 4 * 15
    assert all_steps(tmp_path / "ck") == [2, 4]


def test_resume_matches_straight_run(tmp_path):
    """4 steps with checkpoints, then a second run that resumes to 8,
    ends bit for bit where 8 uninterrupted steps end (the data loader
    fast-forwards across an epoch boundary: 4 batches per epoch)."""
    from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
    cfg = _t(TINY)
    tcfg = _t(TrainConfig(learning_rate=1e-2, warmup_steps=2,
                          total_steps=8, batch_size=4, seq_len=16))
    ds = SyntheticLMDataset(16, 16, TINY.vocab_size, seed=0)
    straight = train_loop(cfg, tcfg, ds, device="cpu", loop_cfg=LoopConfig(
        log_interval=1, logdir=str(tmp_path / "a")))
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_interval=2,
              log_interval=1)
    first = train_loop(cfg, tcfg, ds, device="cpu", max_steps=4,
                       loop_cfg=LoopConfig(logdir=str(tmp_path / "b"), **ck))
    assert first.step == 4
    resumed = train_loop(cfg, tcfg, ds, device="cpu",
                         loop_cfg=LoopConfig(logdir=str(tmp_path / "c"),
                                             **ck))
    assert resumed.step == straight.step == 8
    for (k, a), (_, b) in zip(optim.flatten(straight.params),
                              optim.flatten(resumed.params)):
        assert torch.equal(a.detach(), b.detach()), k
    want = [r["loss"] for r in read_jsonl(tmp_path / "a" / "train.jsonl")]
    got = [r["loss"] for r in read_jsonl(tmp_path / "c" / "train.jsonl")]
    assert got == want[4:]


@pytest.mark.parametrize("abort", ["interrupt", "nan_guard"])
def test_only_a_keyboard_interrupt_saves(tmp_path, abort):
    """A KeyboardInterrupt (preemption) raised by a hook saves the state
    of that step; a NaN-guard abort saves nothing (it would checkpoint
    diverged parameters)."""
    from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
    from cloud_server_tpu_torch.training.checkpoint import all_steps
    from cloud_server_tpu_torch.utils.failure import (NaNGuard,
                                                      TrainingDiverged)

    def hook(step, state, metrics):
        if step == 2:
            if abort == "interrupt":
                raise KeyboardInterrupt("preempted")
            metrics["loss"] = torch.tensor(float("nan"))

    hooks = [hook] + ([NaNGuard(check_interval=1)]
                      if abort == "nan_guard" else [])
    with pytest.raises(KeyboardInterrupt if abort == "interrupt"
                       else TrainingDiverged):
        train_loop(_t(TINY), _t(TrainConfig(total_steps=6, batch_size=4,
                                            seq_len=16)),
                   SyntheticLMDataset(16, 16, TINY.vocab_size, seed=0),
                   hooks=hooks, device="cpu",
                   loop_cfg=LoopConfig(checkpoint_dir=str(tmp_path / "ck"),
                                       checkpoint_interval=100))
    assert all_steps(tmp_path / "ck") == ([2] if abort == "interrupt"
                                          else [])


@pytest.mark.parametrize("what", ["remat_dots", "segments", "mesh"])
def test_unported_options_raise(what, tmp_path):
    """The options the port once refused now run: a mesh with pipeline
    parallelism (pp 2, two ranks over gloo, the pipelined loss in 2
    microbatches) trains as one device does (losses, moments,
    parameters; dp, fsdp, sp and tp meshes: tests/
    test_torch_parallel_train.py); remat "dots" gives remat "none"'s
    loss and gradients; one document a row gives the unpacked loss, and
    two documents a row mask the target that crosses their boundary."""
    cfg = _t(TINY)
    tokens = torch.from_numpy(_tokens(2, 8, TINY.vocab_size).astype(
        np.int64))
    batch = {"tokens": tokens}
    if what == "mesh":
        import torch_train_ranks as ranks
        from cloud_server_tpu_torch.parallel import spawn_ranks
        tcfg = tconfig.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                                   total_steps=6, batch_size=2, seq_len=8)
        np_params = optim.map_tree(
            lambda t: t.numpy(), transformer.init_params(cfg, 0,
                                                         device="cpu"))
        want = ranks.train(cfg, tcfg, np_params, tokens.numpy(), 2)
        got = spawn_ranks(ranks.run_cases, 2, "gloo", [(
            "pp2", "train_case", dict(
                cfg=cfg, tcfg=tcfg, np_params=np_params,
                tokens=tokens.numpy(), axes={"pp": 2}, steps=2,
                pipeline_m=2))], deadline_s=240.0)
        for rank, res in enumerate(got):
            ranks.assert_run_close(res["pp2"], want, f"rank {rank}", tcfg)
            assert res["pp2"]["shapes"]["layers/wq"][0] == 1
        return
    params = transformer.init_params(cfg, 0, device="cpu")
    if what == "remat_dots":
        got = []
        for remat in ("none", "dots"):
            tree = optim.map_tree(
                lambda p: p.detach().clone().requires_grad_(True), params)
            loss, _ = transformer.next_token_loss(
                tree, batch, dataclasses.replace(cfg, remat=remat))
            loss.backward()
            got.append((loss.detach(), tree))
        (l0, t0), (l1, t1) = got
        assert torch.equal(l0, l1)
        for (k, a), (_, b) in zip(optim.flatten(t0), optim.flatten(t1)):
            torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6,
                                       msg=k)
        return
    with torch.no_grad():
        plain, _ = transformer.next_token_loss(params, batch, cfg)
        one, _ = transformer.next_token_loss(
            params, {**batch, "segment_ids": torch.ones((2, 8))}, cfg)
        seg = torch.tensor([[1] * 4 + [2] * 4] * 2)
        two, _ = transformer.next_token_loss(
            params, {**batch, "segment_ids": seg}, cfg)
        halves = [transformer.next_token_loss(
            params, {"tokens": tokens[:, i:i + 4]}, cfg)[0]
            for i in (0, 4)]
    torch.testing.assert_close(one, plain, rtol=1e-6, atol=0)
    torch.testing.assert_close(two, sum(halves) / 2, rtol=1e-5, atol=0)


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("remat", ["dots", "attn"])
def test_selective_remat_grads_match_full_and_reference(remat, impl):
    """remat "dots" and "attn" (selective checkpointing; with "xla"
    attention "attn" saves nothing, as "full") give the loss and the
    gradients of remat "full" (1e-6 of each leaf's largest entry) and of
    the reference under the same policy (its flash in interpret mode;
    loss 1e-5 relative, gradients 1e-4)."""
    cfg = dataclasses.replace(TINY, attention_impl=impl, remat=remat)
    ref_params = ref_tf.init_params(cfg, jax.random.key(3))
    tokens = _tokens(2, 16, cfg.vocab_size, seed=9)
    (want_loss, _), want_g = jax.value_and_grad(
        ref_tf.next_token_loss, has_aux=True)(
        ref_params, {"tokens": jnp.asarray(tokens)}, cfg)
    out = {}
    for policy in (remat, "full"):
        params = _port_params(_np_tree(ref_params), cfg)
        loss, _ = transformer.next_token_loss(
            params, {"tokens": torch.from_numpy(tokens)},
            _t(dataclasses.replace(cfg, remat=policy)))
        loss.backward()
        out[policy] = (float(loss.detach()), params)
    np.testing.assert_allclose(out[remat][0], float(want_loss), rtol=1e-5)
    assert out[remat][0] == out["full"][0]
    _assert_tree_close(optim.map_tree(lambda p: p.grad, out[remat][1]),
                       want_g, 1e-4, "grad ")
    _assert_tree_close(optim.map_tree(lambda p: p.grad, out[remat][1]),
                       optim.map_tree(lambda p: p.grad.numpy(),
                                      out["full"][1]), 1e-6, "vs full ")


class _CountMM(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the matmuls without batch dims that run under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat,fwd_in_backward,mm_in_backward", [
    ("none", 0, 2 * 7), ("full", 1, 2 * 7 + 6), ("attn", 0, 2 * 7 + 6),
    ("dots", 0, 2 * 7)])
def test_remat_policy_reruns_what_it_does_not_save(remat, fwd_in_backward,
                                                   mm_in_backward):
    """Per layer, the backward runs the flash forward (the plain version
    here, counted by `plain_calls`) once under "full" and never under
    "attn", "dots" or "none"; "dots" saves the block's 7 projections
    (wq, wk, wv, wo, gate, up, down), so its backward runs only their
    2 x 7 gradient matmuls, where "full" and "attn" first recompute 6 of
    them (the recompute stops once it has rebuilt what the backward
    reads, and no gradient reads w_down's output)."""
    from cloud_server_tpu_torch.ops import flash_attention as fl
    cfg = dataclasses.replace(TINY, attention_impl="flash", remat=remat)
    params = _port_params(_np_tree(ref_tf.init_params(cfg,
                                                      jax.random.key(3))),
                          cfg)
    fl.reset_counters()
    loss, _ = transformer.next_token_loss(
        params, {"tokens": torch.from_numpy(_tokens(2, 16, 64))}, _t(cfg))
    assert fl.plain_calls == cfg.num_layers
    with _CountMM() as mm:
        loss.backward()
    assert fl.plain_calls - cfg.num_layers == \
        fwd_in_backward * cfg.num_layers
    # the unembed's product runs outside the blocks: its gradient's two
    # matmuls come on top
    assert mm.n == mm_in_backward * cfg.num_layers + 2


# -- FaultInjector (tests/test_failure.py's drills, on one device) ----------

def _drill(tmp_path, hooks, **loop_kw):
    from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
    return train_loop(_t(TINY), _t(TrainConfig(total_steps=6, batch_size=4,
                                               seq_len=16)),
                      SyntheticLMDataset(16, 16, TINY.vocab_size, seed=0),
                      hooks=hooks, device="cpu",
                      loop_cfg=LoopConfig(log_interval=100, **loop_kw))


def test_fault_injector_preempt_saves_and_resumes(tmp_path):
    """An injected preemption takes the emergency-save path (the state of
    that step is saved) without any signal, and a second run resumes
    from it to the end."""
    from cloud_server_tpu_torch.training.checkpoint import all_steps
    from cloud_server_tpu_torch.utils.failure import FaultInjector
    ck = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_interval=100)
    inj = FaultInjector({3: "preempt"})
    with pytest.raises(KeyboardInterrupt, match="injected"):
        _drill(tmp_path, [inj], **ck)
    assert inj.fired == [(3, "preempt")]
    assert all_steps(tmp_path / "ck") == [3]
    assert _drill(tmp_path, [], **ck).step == 6


def test_fault_injector_nan_drives_guard(tmp_path):
    """An injected NaN loss trips a downstream NaNGuard exactly as a real
    divergence would (hook order: injector before guard)."""
    from cloud_server_tpu_torch.utils.failure import (FaultInjector,
                                                      NaNGuard,
                                                      TrainingDiverged)
    inj = FaultInjector({4: "nan_loss"})
    with pytest.raises(TrainingDiverged):
        _drill(tmp_path, [inj, NaNGuard(check_interval=1, patience=0)])
    assert inj.fired == [(4, "nan_loss")]


def test_fault_injector_crash_does_not_save(tmp_path):
    """A generic crash does NOT checkpoint (corrupt-state protection)."""
    from cloud_server_tpu_torch.training.checkpoint import all_steps
    from cloud_server_tpu_torch.utils.failure import FaultInjector
    with pytest.raises(RuntimeError, match="injected crash"):
        _drill(tmp_path, [FaultInjector({2: "crash"})],
               checkpoint_dir=str(tmp_path / "ck"), checkpoint_interval=100)
    assert all_steps(tmp_path / "ck") == []


def test_fault_injector_validates_kinds():
    from cloud_server_tpu_torch.utils.failure import FaultInjector
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultInjector({1: "meteor"})
