"""The port's iteration profile and flight recorder against the
reference's (mirroring tests/test_iteration_profile.py): the phase clock
and the derived fields equal the reference module's on the same inputs,
flight records partition each iteration (host_ms + device_wait_ms (+
overlap_ms) == duration_ms), a profiled pipelined step stays one launch
and one sync with a constant count of clock reads, idle iterations are
visible, the scheduler timeline exports well-formed Chrome trace JSON,
and the HTTP frontend's /stats and /debug/scheduler_trace answer."""

import dataclasses
import json
import os
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference import iteration_profile as ref_ip
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import graphs
from cloud_server_tpu_torch.inference import iteration_profile as ip
from cloud_server_tpu_torch.inference.http_server import HttpFrontend
from cloud_server_tpu_torch.inference.iteration_profile import (
    PHASES, IterationProfiler, derive_gap_fields, resolve_profiler,
    scheduler_chrome_trace)
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.models.transformer import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
PAGED_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
                prompt_buckets=[16, 48])


@pytest.fixture(scope="module")
def params():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    return params_from_numpy(jax.tree.map(np.asarray, ref),
                             TModelConfig(**dataclasses.asdict(CFG)),
                             device="cpu")


def _server(params, **kw):
    return PagedInferenceServer(
        params, TModelConfig(**dataclasses.asdict(CFG)),
        TInferConfig(**dataclasses.asdict(GREEDY)), device="cpu",
        **{**PAGED_KW, **kw})


def _churn(srv, n_first=2, long_len=40):
    """Warm decodes, then a long prompt whose chunked admission spans
    several iterations."""
    first = [srv.submit([5 + i, 9, 3], max_new_tokens=8)
             for i in range(n_first)]
    srv.step()
    long = srv.submit([(k * 7) % 60 + 1 for k in range(long_len)],
                      max_new_tokens=4)
    srv.run_until_idle()
    return first + [long]


# ---------------------------------------------------------------------------
# the phase clock (no server, injected clock), against the reference's
# ---------------------------------------------------------------------------


def test_profiler_marks_match_reference(monkeypatch):
    """The same clock ticks through the port's and the reference's
    profiler give the same accumulated phases."""
    marks = ["sweep", "build", "device", "build", "device", "commit"]
    ticks = [10.0, 10.5, 11.0, 14.0, 14.25, 15.25, 15.5]
    got = {}
    for mod in (ip, ref_ip):
        it = iter(ticks)
        monkeypatch.setattr(mod, "perf_counter", lambda: next(it))
        p = mod.IterationProfiler()
        assert p.begin() == 10.0
        last = [p.mark(m) for m in marks][-1]
        got[mod] = p.phases_ms()
        assert sum(got[mod].values()) == pytest.approx((last - p.t0) * 1e3)
    assert got[ip] == got[ref_ip]
    assert list(got[ip]) == ["sweep", "build", "device", "commit"]


@pytest.mark.parametrize("overlapped", [False, True])
def test_derive_gap_fields_match_reference(overlapped):
    phases = {"sweep": 1.0, "admission": 2.0, "build": 0.5, "device": 7.0,
              "commit": 0.25, "launch": 0.125, "epilogue": 0.0625}
    dur = sum(phases.values())
    assert derive_gap_fields(phases, dur, overlapped) == \
        ref_ip.derive_gap_fields(phases, dur, overlapped)
    assert derive_gap_fields({}, 0.0)["host_gap_frac"] == 0.0


def test_resolve_profiler_forms():
    assert resolve_profiler(False) is None
    assert resolve_profiler("off") is None
    assert resolve_profiler(None, cfg_enabled=False) is None
    assert isinstance(resolve_profiler(None, cfg_enabled=True),
                      IterationProfiler)
    assert isinstance(resolve_profiler(True, cfg_enabled=False),
                      IterationProfiler)
    ready = IterationProfiler()
    assert resolve_profiler(ready) is ready
    with pytest.raises(ValueError):
        resolve_profiler(3)


# ---------------------------------------------------------------------------
# flight records on live servers
# ---------------------------------------------------------------------------


def test_flight_records_carry_phase_split(params):
    srv = _server(params)
    reqs = _churn(srv)
    assert all(r.done for r in reqs)
    window = srv.flight_window()
    assert window
    for rec in window:
        phases = rec["phases_ms"]
        assert set(phases) <= set(PHASES)
        assert all(v >= 0.0 for v in phases.values())
        assert (rec["host_ms"] + rec["device_wait_ms"]
                + rec.get("overlap_ms", 0.0)) == pytest.approx(
            rec["duration_ms"], rel=1e-9, abs=1e-6)
        assert 0.0 <= rec["host_gap_frac"] <= 1.0
        assert rec["t_start"] > 0.0
        assert "device" in phases and "epilogue" in phases
    ov = [rec for rec in window if rec.get("overlap")]
    assert ov, "default mixed churn produced no overlapped iterations"
    for rec in ov:
        assert rec["inflight_depth"] == 1
        assert rec["overlap_launch_lead_ms"] >= 0.0
    snap = srv.metrics_snapshot()
    dev = snap['cloud_server_iter_phase_ms{phase="device"}']
    assert dev["type"] == "histogram"
    assert dev["count"] == srv.flight.iterations
    summary = srv.iteration_profile_stats()
    assert set(summary["phases"]) <= set(PHASES) | {"overlap"}
    assert 0.0 <= summary["host_gap_frac"] <= 1.0


def test_alternating_scheduler_phase_split(params):
    srv = _server(params, scheduler="alternating")
    reqs = _churn(srv)
    assert all(r.done for r in reqs)
    assert srv.flight_window()
    for rec in srv.flight_window():
        assert rec["scheduler"] == "alternating"
        assert rec["host_ms"] + rec["device_wait_ms"] == pytest.approx(
            rec["duration_ms"], rel=1e-9, abs=1e-6)


def test_profiler_disabled_keeps_old_shape(params):
    srv = _server(params, iteration_profile=False)
    reqs = _churn(srv)
    assert all(r.done for r in reqs)
    assert srv.flight_window()
    for rec in srv.flight_window():
        assert "phases_ms" not in rec and "host_gap_frac" not in rec
        assert rec["duration_ms"] >= 0.0
    assert not [k for k in srv.metrics_snapshot() if "iter_phase" in k]
    assert srv.iteration_profile_stats() is None


def test_flight_recorder_size(params):
    srv = _server(params, flight_recorder_size=3)
    _churn(srv)
    assert srv.flight.iterations > 3
    assert len(srv.flight_window()) == 3
    assert srv.flight_window()[-1]["iteration"] == srv.flight.iterations


def test_profiled_step_dispatch_sync_and_clock_counts(params, monkeypatch):
    """A profiled pipelined step is one launch and one sync, with a
    constant count of profiler clock reads (begin + one mark per
    boundary, at most 9)."""
    srv = _server(params, iteration_profile=True)
    warm = srv.submit([5, 9, 3, 1], max_new_tokens=24)
    srv.step()
    assert srv.num_active == 1
    clock = {"n": 0}
    orig_clock = ip.perf_counter

    def clock_wrap():
        clock["n"] += 1
        return orig_clock()

    monkeypatch.setattr(ip, "perf_counter", clock_wrap)
    long = srv.submit([(k * 7) % 60 + 1 for k in range(40)],
                      max_new_tokens=4)
    steps, per_step = 0, set()
    while srv._jobs or srv.num_pending:
        before = (graphs.launches, graphs.syncs, clock["n"])
        srv.step()
        steps += 1
        assert graphs.launches - before[0] == 1
        assert graphs.syncs - before[1] == 1
        per_step.add(clock["n"] - before[2])
        assert steps < 50
    assert steps >= 2
    assert len(per_step) == 1 and per_step.pop() <= 9
    monkeypatch.setattr(ip, "perf_counter", orig_clock)
    srv.run_until_idle()
    assert warm.done and long.done


def test_idle_vs_busy_visibility(params):
    srv = _server(params)
    for _ in range(3):
        srv.step()
    snap = srv.metrics_snapshot()
    assert snap["cloud_server_idle_iterations_total"]["value"] == 3
    assert snap["cloud_server_last_busy_ts"]["value"] == 0.0
    srv.submit([5, 9, 3], max_new_tokens=3)
    srv.run_until_idle()
    snap = srv.metrics_snapshot()
    assert snap["cloud_server_last_busy_ts"]["value"] > 0.0
    assert snap["cloud_server_last_busy_ts"]["value"] == \
        srv.flight_window()[-1]["ts"]
    busy_before = srv.flight.iterations
    srv.step()  # idle again: the counter moves, the gauge freezes
    snap2 = srv.metrics_snapshot()
    assert snap2["cloud_server_idle_iterations_total"]["value"] == 4
    assert snap2["cloud_server_last_busy_ts"]["value"] == \
        snap["cloud_server_last_busy_ts"]["value"]
    assert srv.flight.iterations == busy_before


# ---------------------------------------------------------------------------
# the scheduler timeline export
# ---------------------------------------------------------------------------


def test_scheduler_chrome_trace_wellformed(params):
    srv = _server(params)
    reqs = _churn(srv)
    assert all(r.done for r in reqs)
    window = srv.flight_window()
    trace = scheduler_chrome_trace(window)
    assert json.loads(json.dumps(trace)) == trace
    events = trace["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    assert [e for e in events if e["ph"] == "M"]
    inflight_tid = len(PHASES) + 1
    iters = [e for e in xs if e["tid"] == 0]
    phases = [e for e in xs if 0 < e["tid"] < inflight_tid]
    inflight = [e for e in xs if e["tid"] == inflight_tid]
    assert [e["args"]["iteration"] for e in iters] == \
        [rec["iteration"] for rec in window]
    by_iter = {e["args"]["iteration"]: e for e in iters}
    for e in phases:
        assert e["name"] in PHASES
        it = by_iter[e["args"]["iteration"]]
        assert e["ts"] >= it["ts"] - 1.0
        assert e["ts"] + e["dur"] <= it["ts"] + it["dur"] + 1.0
    assert len(phases) == sum(
        len([v for v in rec["phases_ms"].values() if v > 0])
        for rec in window)
    # a pipelined dispatch renders launched in the previous iteration's
    # window and running into the iteration that commits it
    assert inflight, "overlapped run rendered no inflight slices"
    for e in inflight:
        it = by_iter[e["args"]["iteration"]]
        assert e["ts"] < it["ts"]
        assert e["ts"] + e["dur"] > it["ts"]
        assert e["ts"] + e["dur"] <= it["ts"] + it["dur"] + 1.0
        prev = by_iter.get(e["args"]["launched_in_iteration"])
        if prev is not None:
            assert prev["ts"] <= e["ts"] <= prev["ts"] + prev["dur"] + 1.0


def test_scheduler_trace_skips_unprofiled_records(params):
    srv = _server(params, iteration_profile=False)
    srv.submit([5, 9, 3], max_new_tokens=3)
    srv.run_until_idle()
    assert srv.flight_window()
    assert scheduler_chrome_trace(srv.flight_window())["traceEvents"] == []


# ---------------------------------------------------------------------------
# /stats and /debug/scheduler_trace over HTTP
# ---------------------------------------------------------------------------


def _get(front, path: str):
    host, port = front.address
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=30) as resp:
        return resp.status, json.loads(resp.read())


def test_http_stats_and_scheduler_trace(params):
    srv = _server(params).start()
    front = HttpFrontend(srv).start()
    try:
        req = srv.submit([5, 9, 3], max_new_tokens=4)
        req.result(timeout=60)
        status, stats = _get(front, "/stats?n=8")
        assert status == 200
        prof = stats["iteration_profile"]
        assert 0.0 <= prof["host_gap_frac"] <= 1.0
        assert "p99_ms" in prof["phases"]["device"]
        assert stats["flight_recorder"]
        for rec in stats["flight_recorder"]:
            assert "phases_ms" in rec
        assert stats["overlap"]["enabled"] is True
        status, trace = _get(front, "/debug/scheduler_trace?n=8")
        assert status == 200
        assert any(e["ph"] == "X" and e["name"] in PHASES
                   for e in trace["traceEvents"])
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(
                "http://%s:%d/debug/scheduler_trace?n=x" % front.address,
                timeout=30)
        assert err.value.code == 400
        status, empty = _get(front, "/debug/scheduler_trace?n=0")
        assert status == 200 and empty["traceEvents"] == []
    finally:
        front.stop()
        srv.stop()
