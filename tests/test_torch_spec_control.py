"""The port's copy of the adaptive speculation controller
(mirroring tests/test_spec_control.py): the control law step by step,
held equal to the reference's controller on the same observation
sequence, the constructor's forms, and the server's records of
speculation (flight records, metrics, /stats summary) against the
reference server's on the same weights."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference import spec_control as ref_sc
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.spec_control import (
    SpecControlConfig, SpecController, resolve_controller)
from cloud_server_tpu_torch.models.transformer import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401


def _ctl(**kw):
    has_draft = kw.pop("has_draft_model", False)
    return SpecController(kw.pop("max_drafts", 3),
                          SpecControlConfig(**kw),
                          has_draft_model=has_draft)


def test_starts_at_initial_and_climbs_on_acceptance():
    c = _ctl(initial=1, high=0.5, low=0.2, ewma=0.5, cooldown=2)
    c.on_admit(0)
    assert c.draft_len(0) == 1
    for _ in range(8):
        c.observe(0, drafted=c.draft_len(0), accepted=c.draft_len(0))
    assert c.draft_len(0) == 3
    assert c.length_changes >= 2


def test_decays_to_zero_on_rejection_and_cooldown_gates_changes():
    c = _ctl(low=0.3, high=0.7, ewma=0.5, cooldown=3)
    c.on_admit(0)
    assert c.draft_len(0) == 3
    changes = []
    for _ in range(24):
        before = c.draft_len(0)
        c.observe(0, drafted=before, accepted=0)
        if c.draft_len(0) != before:
            changes.append(before)
    assert c.draft_len(0) == 0
    assert changes == [3, 2, 1]


def test_ngram_probe_recovers_from_zero():
    c = _ctl(low=0.3, high=0.6, ewma=1.0, cooldown=1, probe_period=4)
    c.on_admit(0)
    for _ in range(8):
        c.observe(0, c.draft_len(0), 0)
    assert c.draft_len(0) == 0
    for _ in range(4):
        c.observe(0, 0, 0)
    assert c.draft_len(0) == 1


def test_draft_model_plain_dispatch_is_sticky_off():
    c = _ctl(low=0.3, high=0.6, ewma=1.0, cooldown=1, probe_period=3,
             has_draft_model=True)
    c.on_admit(0)
    for _ in range(3):
        c.observe(0, c.draft_len(0), 0)
    assert c.draft_len(0) == 0
    c.on_plain_dispatch([0], rounds=8)
    for _ in range(16):
        c.observe(0, 0, 0)
    assert c.draft_len(0) == 0
    c.on_admit(0)
    assert c.draft_len(0) == 3


def test_release_forgets_slot_state():
    c = _ctl(ewma=1.0, cooldown=1)
    c.on_admit(0)
    c.observe(0, 3, 0)
    c.on_release(0)
    c.observe(0, 3, 0)
    c.on_admit(0)
    assert c.draft_len(0) == 3


@pytest.mark.parametrize("has_draft", [False, True])
def test_controller_trajectory_equals_the_reference(has_draft):
    """The same random observation stream (admits, releases, plain
    dispatches, partial acceptance) through both controllers: the same
    lengths, rates and change counts after every event."""
    kw = dict(low=0.3, high=0.6, ewma=0.4, cooldown=2, probe_period=5)
    mine = SpecController(4, SpecControlConfig(**kw),
                          has_draft_model=has_draft)
    ref = ref_sc.SpecController(4, ref_sc.SpecControlConfig(**kw),
                                has_draft_model=has_draft)
    rng = np.random.default_rng(0)
    for c in (mine, ref):
        for s in range(3):
            c.on_admit(s)
    for _ in range(300):
        s = int(rng.integers(0, 3))
        ev = rng.random()
        d = mine.draft_len(s)
        assert d == ref.draft_len(s)
        acc = int(min(d, rng.integers(0, 5)))
        for c in (mine, ref):
            if ev < 0.02:
                c.on_release(s)
                c.on_admit(s)
            elif ev < 0.05:
                c.on_plain_dispatch([s], 2)
            else:
                c.observe(s, d, acc)
        assert mine.draft_lengths() == ref.draft_lengths()
    assert mine.accept_rate() == pytest.approx(ref.accept_rate())
    assert mine.length_changes == ref.length_changes


def test_resolve_controller_forms():
    assert resolve_controller(False, "", 3, has_draft_model=False) is None
    assert resolve_controller(None, "off", 3,
                              has_draft_model=False) is None
    assert resolve_controller(None, "", 0, has_draft_model=False) is None
    c = resolve_controller(None, "", 3, has_draft_model=True)
    assert isinstance(c, SpecController) and c.has_draft_model
    c = resolve_controller({"low": 0.1, "high": 0.9, "initial": 2}, "",
                           4, has_draft_model=False)
    assert c.config.initial == 2 and c.max_drafts == 4
    with pytest.raises(ValueError, match="unknown spec_control"):
        resolve_controller({"lo": 0.1}, "", 3, has_draft_model=False)
    with pytest.raises(ValueError, match="low"):
        SpecControlConfig(low=0.9, high=0.5)
    ready = SpecController(5)
    with pytest.raises(ValueError, match="max_drafts"):
        resolve_controller(ready, "", 3, has_draft_model=False)
    assert resolve_controller(ready, "", 5,
                              has_draft_model=False) is ready


CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
SRV_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 48])


def test_flight_recorder_and_metrics_record_speculation():
    """The reference's records of speculation on the port's server: the
    same drafted and accepted totals as the reference server's on the
    same weights (one program per iteration either way)."""
    ref_p = ref_tf.init_params(CFG, jax.random.key(0))
    port_p = params_from_numpy(jax.tree.map(np.asarray, ref_p),
                               TModelConfig(**dataclasses.asdict(CFG)),
                               device="cpu")
    rep = [3, 4, 5, 6] * 5
    srv = PagedInferenceServer(port_p, TModelConfig(**dataclasses.asdict(
        CFG)), TInferConfig(**dataclasses.asdict(GREEDY)), device="cpu",
        scheduler="mixed", overlap=False, spec_drafts=3, **SRV_KW)
    ref = RefServer(ref_p, CFG, GREEDY, scheduler="mixed", overlap=False,
                    spec_drafts=3, **SRV_KW)
    assert srv.generate([rep, [7, 8, 9]], max_new_tokens=10) == \
        ref.generate([rep, [7, 8, 9]], max_new_tokens=10)
    recs = [r for r in srv.flight_window() if r.get("spec_rows")]
    assert recs, "no speculative iteration recorded"
    r = recs[-1]
    assert r["spec_window"] >= 2
    assert "spec_tokens_drafted" in r and "spec_tokens_accepted" in r
    assert "spec_draft_lens" in r  # adaptive on by default
    snap = srv.metrics_snapshot()
    drafted = snap["cloud_server_spec_tokens_drafted_total"]["value"]
    accepted = snap["cloud_server_spec_tokens_accepted_total"]["value"]
    assert drafted > 0 and 0 <= accepted <= drafted
    assert 0.0 <= snap["cloud_server_spec_accept_rate"]["value"] <= 1.0
    stats = srv.speculation_stats()
    assert stats == ref.speculation_stats()
    assert stats["tokens_drafted"] == drafted
    assert (srv.decode_rounds, srv.decode_tokens_committed) == (
        ref.decode_rounds, ref.decode_tokens_committed)
