"""The port's schedulers against the reference's, and its pipelined
(overlap) scheduler: the same inputs through the reference's
PagedInferenceServer and the port's give the same tokens (greedy,
per-request seeded, and server-global seeded: the port splits its
threefry key where the reference splits its own and stages the
reference's bucketed rows), logprobs within 1e-4, the same preemptions
and the same flight records (every key, and every field that is not a
clock), under the mixed scheduler with the overlap on and off and under
the alternating scheduler, on the staggered workload and under
preemption. Then the pipeline's own discipline, mirroring
tests/test_overlap.py: one launch and one sync per steady step, cancels
and deadline expiries deferred past the in-flight dispatch, the overlap
fields of the flight records."""

import dataclasses
import os
import sys
import time

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.inference.sampling import (
    SamplingParams as RefSamplingParams)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import graphs
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.sampling import SamplingParams
from cloud_server_tpu_torch.models.transformer import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
SRV_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])
LONG = [(i * 7) % 60 + 1 for i in range(30)]
PROMPTS = [[5, 9, 3], [17, 2, 40, 8, 21], LONG, list(range(1, 14))]
PREEMPT_PROMPTS = [LONG[:20], LONG[5:25], list(range(1, 18)), LONG[:9]]

SCHEDULERS = {"overlap": dict(scheduler="mixed", overlap=True),
              "sequential": dict(scheduler="mixed", overlap=False),
              "alternating": dict(scheduler="alternating")}
# the flight-record fields read off a clock; every other field is host
# policy and must equal the reference's
CLOCK_FIELDS = {"t_start", "phases_ms", "duration_ms", "host_ms",
                "device_wait_ms", "host_gap_frac", "overlap_ms",
                "overlap_launch_lead_ms", "t_launch", "ts"}


def _port_cfgs(cfg=CFG, icfg=GREEDY):
    return (TModelConfig(**dataclasses.asdict(cfg)),
            TInferConfig(**dataclasses.asdict(icfg)))


@pytest.fixture(scope="module")
def weights():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    port = params_from_numpy(jax.tree.map(np.asarray, ref),
                             _port_cfgs()[0], device="cpu")
    return ref, port


def _port_server(params, icfg=GREEDY, **kw):
    cfg, ticfg = _port_cfgs(CFG, icfg)
    return PagedInferenceServer(params, cfg, ticfg, device="cpu", **kw)


def _staggered(srv, prompts, max_new, sampling=None):
    sp = sampling or [None] * len(prompts)
    reqs = [srv.submit(p, max_new_tokens=max_new, sampling=s)
            for p, s in zip(prompts[:2], sp[:2])]
    for _ in range(3):
        srv.step()
    reqs += [srv.submit(p, max_new_tokens=max_new, sampling=s)
             for p, s in zip(prompts[2:], sp[2:])]
    srv.run_until_idle()
    return [r.result() for r in reqs], [list(r.logprobs) for r in reqs]


def _policy(records):
    return [{k: v for k, v in r.items() if k not in CLOCK_FIELDS}
            for r in records]


# ---------------------------------------------------------------------------
# the port against the reference, every scheduler and draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workload", ["staggered", "preempt"])
@pytest.mark.parametrize("draw", ["greedy", "seeded_rows", "server_global"])
@pytest.mark.parametrize("sched", ["overlap"])
def test_schedulers_match_reference(weights, sched, draw, workload):
    """The overlap scheduler's case of `check_schedulers_match_reference`;
    test_torch_overlap_{sequential,alternating}.py hold the other two
    schedulers' cases (a file each, so that `--dist loadfile` spreads
    them over workers)."""
    check_schedulers_match_reference(weights, sched, draw, workload)


def check_schedulers_match_reference(weights, sched, draw, workload):
    """The port's server and the reference's on the same inputs under
    scheduler `sched`: the same tokens, logprobs within 1e-4, the same
    preemptions and flight records."""
    ref_params, params = weights
    icfg = GREEDY
    if draw == "server_global":
        icfg = dataclasses.replace(GREEDY, temperature=0.9, top_k=20)
    elif draw == "seeded_rows":
        icfg = dataclasses.replace(GREEDY, temperature=1.0)
    kw = dict(SRV_KW, seed=3, **SCHEDULERS[sched])
    prompts, max_new = PROMPTS, 10
    if workload == "preempt":
        kw["num_pages"] = 12
        prompts, max_new = PREEMPT_PROMPTS, 16
    sp = ([dict(seed=7 + i, temperature=0.9, top_p=0.9) for i in range(4)]
          if draw == "seeded_rows" else [None] * 4)
    ref = RefServer(ref_params, CFG, icfg, **kw)
    want, want_lps = _staggered(
        ref, prompts, max_new,
        [None if s is None else RefSamplingParams(**s) for s in sp])
    srv = _port_server(params, icfg, **kw)
    got, got_lps = _staggered(
        srv, prompts, max_new,
        [None if s is None else SamplingParams(**s) for s in sp])
    assert all(len(t) == max_new for t in want)
    assert got == want
    for a, b in zip(got_lps, want_lps):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert srv.preemptions == ref.preemptions
    if workload == "preempt":
        assert srv.preemptions > 0
    assert _policy(srv.flight_window()) == _policy(ref.flight_window())
    assert [sorted(r) for r in srv.flight_window()] == \
        [sorted(r) for r in ref.flight_window()]
    if draw == "server_global":
        # the draws really sampled: not the greedy stream
        greedy, _ = _staggered(_port_server(params, GREEDY, **kw), prompts,
                               max_new)
        assert got != greedy


# ---------------------------------------------------------------------------
# pipeline discipline
# ---------------------------------------------------------------------------


def test_overlap_dispatch_and_sync_count(weights):
    """Steady pipelined steps make exactly one program launch and one
    sync; the fill step completes its own iteration and primes the next
    (two launches, one sync)."""
    srv = _port_server(weights[1], overlap=True, **SRV_KW)

    def counts():
        return graphs.launches, graphs.syncs

    warm = srv.submit([5, 9, 3, 1], max_new_tokens=24)
    l0, s0 = counts()
    srv.step()  # fill: the sequential iteration + the pipeline prime
    assert counts() == (l0 + 2, s0 + 1)
    assert srv._inflight is not None
    long = srv.submit(LONG, max_new_tokens=4)
    steps = 0
    while srv._jobs or srv.num_pending:
        before = counts()
        srv.step()
        steps += 1
        assert counts() == (before[0] + 1, before[1] + 1)
        assert steps < 50
    assert steps >= 2
    srv.run_until_idle()
    assert warm.done and long.done


def test_overlap_off_is_sequential(weights):
    """overlap=False: nothing is left in flight across steps and the
    records carry no overlap fields."""
    srv = _port_server(weights[1], overlap=False, **SRV_KW)
    assert not srv._overlap_enabled
    srv.submit(LONG, max_new_tokens=6)
    while srv.num_pending or srv.num_active or srv._jobs:
        srv.step()
        assert srv._inflight is None
    assert srv.flight_window()
    for rec in srv.flight_window():
        assert "overlap" not in rec
        assert "launch" not in rec.get("phases_ms", {})
        assert "t_launch" not in rec


def test_overlap_requires_mixed_scheduler(weights):
    """The alternating scheduler keeps its sequential per-chunk loop
    whatever the knob says."""
    srv = _port_server(weights[1], scheduler="alternating", overlap=True,
                       **SRV_KW)
    assert srv.overlap and not srv._overlap_enabled
    srv.submit(PROMPTS[0], max_new_tokens=4)
    srv.run_until_idle()
    assert srv._inflight is None


def test_overlap_cancel_inflight_defers_release(weights):
    """A cancel landing while the victim's rows are in flight is marked
    by the sweep and released right after the commit; the allocator's
    accounting balances afterwards."""
    srv = _port_server(weights[1], overlap=True, **SRV_KW)
    victim = srv.submit([5, 9, 3], max_new_tokens=30)
    other = srv.submit([7, 2, 4], max_new_tokens=6)
    srv.step()          # fill + prime: a decode dispatch is in flight
    assert srv._inflight is not None
    victim.cancel()
    srv.step()          # sweep marks; commit; deferred release applies
    assert victim.done and victim.finish_reason == "cancelled"
    srv.run_until_idle()
    assert other.done and len(other.tokens) == 6
    s = srv.allocator.stats()
    assert s.pages_free + s.pages_cached == s.pages_total


def test_overlap_deadline_expires_active_under_pipeline(weights):
    srv = _port_server(weights[1], overlap=True, decode_chunk=1, **SRV_KW)
    doomed = srv.submit([5, 9, 3], max_new_tokens=50, deadline_s=0.2)
    srv.step()
    deadline = time.perf_counter() + 30
    while not doomed.done and time.perf_counter() < deadline:
        srv.step()
        time.sleep(0.02)
    assert doomed.done and doomed.finish_reason == "deadline"
    s = srv.allocator.stats()
    assert s.pages_free + s.pages_cached == s.pages_total


def test_fail_all_drops_the_inflight_dispatch(weights):
    """A failure with a dispatch in flight fails every request and drops
    the in-flight program; the server then serves again."""
    srv = _port_server(weights[1], overlap=True, **SRV_KW)
    req = srv.submit([5, 9, 3], max_new_tokens=8)
    srv.step()
    assert srv._inflight is not None
    srv._fail_all(RuntimeError("boom"))
    assert req.done and req.finish_reason.startswith("error")
    assert srv._inflight is None and not srv._reaped
    again = srv.submit([5, 9, 3], max_new_tokens=4)
    srv.run_until_idle()
    assert len(again.result()) == 4


def test_overlap_flight_fields_and_stats_block(weights):
    srv = _port_server(weights[1], overlap=True, **SRV_KW)
    assert srv.overlap_stats() == {"enabled": True, "active": True,
                                   "inflight_depth": 0}
    first = [srv.submit([5 + i, 9, 3], max_new_tokens=8)
             for i in range(2)]
    srv.step()
    assert srv.overlap_stats()["inflight_depth"] == 1
    srv.submit(LONG, max_new_tokens=4)
    srv.run_until_idle()
    assert all(r.done for r in first)
    recs = srv.flight_window()
    ov = [r for r in recs if r.get("overlap")]
    assert ov, "no overlapped iterations recorded"
    for r in ov:
        assert r["inflight_depth"] == 1
        assert r["overlap_launch_lead_ms"] >= 0.0
        assert r["overlap_ms"] >= 0.0
        ph = r["phases_ms"]
        serial = sum(ph.get(p, 0.0)
                     for p in ("commit", "launch", "epilogue"))
        assert r["host_ms"] == pytest.approx(serial, rel=1e-9, abs=1e-9)
    assert any("t_launch" in r for r in recs)
    snap = srv.metrics_snapshot()
    assert snap['cloud_server_iter_phase_ms{phase="overlap"}'][
        "count"] >= len(ov)
    assert srv.iteration_profile_stats()["overlap_ms_total"] > 0.0


def test_idle_iterations_stay_bounded(weights):
    """An idle started server parks on the bounded condition wait: the
    idle counter grows slowly, and a submit still wakes it at once."""
    srv = _port_server(weights[1], **SRV_KW).start()
    try:
        time.sleep(0.2)
        base = srv.idle_iterations
        time.sleep(0.6)
        assert srv.idle_iterations - base < 60
        t0 = time.perf_counter()
        srv.submit([5, 9, 3], max_new_tokens=2).result(timeout=60)
        assert time.perf_counter() - t0 < 30
    finally:
        srv.stop()
