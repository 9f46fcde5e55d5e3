"""The port's copies of the serving-metrics registry, the iteration
profile's read side and the trace-context helpers against the
reference's modules: the same observations give the same snapshots,
percentiles, Prometheus text, merges and exports."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

from cloud_server_tpu.inference import iteration_profile as ref_ip
from cloud_server_tpu.inference import request_trace as ref_rt
from cloud_server_tpu.inference.server import Request as RefRequest
from cloud_server_tpu.utils import serving_metrics as ref_sm
from cloud_server_tpu_torch.inference import iteration_profile as ip
from cloud_server_tpu_torch.inference import request_trace as rt
from cloud_server_tpu_torch.inference.server import Request
from cloud_server_tpu_torch.utils import serving_metrics as sm
from cloud_server_tpu_torch.utils.logging import JsonLogger

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401


def _observations(seed):
    r = np.random.default_rng(seed)
    # latencies across every bucket, the edges themselves and overflow
    return [float(x) for x in np.concatenate([
        r.exponential(0.05, 40), r.uniform(0, 200, 10),
        np.asarray(ref_sm.LATENCY_BUCKETS), [0.0, 500.0]])]


def _fill(mod, seed):
    reg = mod.MetricsRegistry()
    h = reg.histogram("ttft_seconds", "Time to first token")
    for x in _observations(seed):
        h.observe(x)
    reg.histogram("custom_ms", "custom ladder", buckets=(1.0, 5.0, 25.0),
                  labels={"phase": "device"}).observe(3.0)
    reg.counter("requests_total", "Requests").inc(3)
    reg.counter("requests_total", "Requests").inc()
    reg.counter("faults_total", "Faults", labels={"site": 'a"b\\c'}).inc(2)
    reg.gauge("active_slots", "Active").set(5)
    reg.add_collector(lambda: reg.gauge("collected", "From a collector")
                      .set(seed))
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_snapshot_and_prometheus_text(seed):
    want = _fill(ref_sm, seed).snapshot()
    got = _fill(sm, seed).snapshot()
    assert got == want
    assert sm.render_prometheus(got) == ref_sm.render_prometheus(want)


@pytest.mark.parametrize("q", [0.0, 0.01, 0.5, 0.95, 0.99, 1.0])
def test_histogram_percentiles_and_summary(q):
    want = _fill(ref_sm, 2).snapshot()["cloud_server_ttft_seconds"]
    got = _fill(sm, 2).snapshot()["cloud_server_ttft_seconds"]
    assert sm.histogram_percentile(got, q) == \
        ref_sm.histogram_percentile(want, q)
    assert sm.histogram_summary(got) == ref_sm.histogram_summary(want)
    empty = sm.MetricsRegistry().histogram("e").snapshot()
    assert sm.histogram_summary(empty) == ref_sm.histogram_summary(empty)


def test_merge_snapshots_and_its_errors():
    snaps = [_fill(sm, s).snapshot() for s in range(3)]
    assert sm.merge_snapshots(snaps) == ref_sm.merge_snapshots(
        [_fill(ref_sm, s).snapshot() for s in range(3)])
    bad = dict(snaps[0])
    bad["cloud_server_active_slots"] = dict(bad["cloud_server_active_slots"],
                                            type="counter")
    with pytest.raises(ValueError, match="conflicting types"):
        sm.merge_snapshots([snaps[0], bad])
    reg = sm.MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="sorted"):
        reg.histogram("y", buckets=(2.0, 1.0))


def _lifecycle(mod, req_cls):
    """One request's lifecycle through ServingMetrics: submit, admit,
    three emitted tokens, a preempt-requeue, a second admit, finish."""
    m = mod.ServingMetrics()
    req = req_cls(prompt=[1, 2], max_new_tokens=4, submit_time=10.0)
    m.observe_submit(req)
    m.observe_admit(req, 10.5)
    for t in (11.0, 11.25, 11.75):
        req.emit_times.append(t)
        m.observe_emit(req)
    m.observe_requeue(req, 12.0)
    m.observe_admit(req, 12.5)  # queue wait counts the first admission
    req.finish_reason = "length"
    m.observe_finish(req, 13.0)
    return m.registry.snapshot(), req.events, req.admit_time


def test_serving_metrics_lifecycle_matches_reference():
    want = _lifecycle(ref_sm, RefRequest)
    got = _lifecycle(sm, Request)
    assert got == want
    snap = got[0]
    assert snap["cloud_server_ttft_seconds"]["count"] == 1
    assert snap["cloud_server_itl_seconds"]["count"] == 2
    assert snap["cloud_server_queue_wait_seconds"]["count"] == 1


@pytest.mark.parametrize("reason,counter", [
    ("cancelled", "requests_cancelled_total"),
    ("deadline", "deadline_expired_total"),
    ("error: boom", "requests_failed_total"),
    ("eos", "requests_finished_total")])
def test_finish_reasons_count_where_the_reference_counts(reason, counter):
    m = sm.ServingMetrics()
    req = Request(prompt=[1], max_new_tokens=2, submit_time=1.0)
    req.finish_reason = reason
    assert m.observe_finish(req, 3.0) == 3.0
    snap = m.registry.snapshot()
    assert snap[f"cloud_server_{counter}"]["value"] == 1
    assert snap["cloud_server_e2e_seconds"]["sum"] == 2.0
    assert req.events == [(f"finish:{reason}", 3.0)]


def test_flight_recorder_ring():
    for mod in (sm, ref_sm):
        with pytest.raises(ValueError):
            mod.FlightRecorder(0)
    fr, ref = sm.FlightRecorder(3), ref_sm.FlightRecorder(3)
    for i in range(5):
        fr.record(n_live=i)
        ref.record(n_live=i)
    assert len(fr) == 3 and fr.iterations == 5
    assert fr.window() == ref.window() and fr.window(2) == ref.window(2)


def _records():
    """Flight records as the reference's profiler writes them, one of them
    an overlapped iteration committing a launched-ahead dispatch."""
    return [
        {"iteration": 1, "t_start": 1.0, "duration_ms": 4.0, "n_live": 2,
         "phases_ms": {"sweep": 0.5, "admission": 0.5, "build": 1.0,
                       "device": 1.5, "commit": 0.5}, "t_launch": 1.003},
        {"iteration": 2, "t_start": 1.004, "duration_ms": 3.0,
         "overlap": True, "inflight_depth": 1,
         "phases_ms": {"sweep": 0.2, "device": 2.0, "epilogue": 0.8}},
        {"iteration": 3, "duration_ms": 1.0},  # profiling off: skipped
    ]


def test_iteration_profile_read_side_matches_reference():
    reg = ref_sm.MetricsRegistry()
    for phase, vals in (("device", [1.0, 3.0]), ("commit", [0.2]),
                        ("overlap", [0.7])):
        h = reg.histogram(ref_ip.PHASE_FAMILY, "phase ms",
                          buckets=(0.5, 1.0, 5.0), labels={"phase": phase})
        for v in vals:
            h.observe(v)
    snap = reg.snapshot()
    assert ip.profile_summary(snap) == ref_ip.profile_summary(snap)
    assert ip.profile_summary({}) is None
    assert ip.scheduler_chrome_trace(_records()) == \
        ref_ip.scheduler_chrome_trace(_records())


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0AF7651916CD43DD8448EB211C80319C-B7AD6B7169203331-00",
    "ff-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-00000000000000000000000000000000-b7ad6b7169203331-01",
    "00-xyz-b7ad6b7169203331-01", "garbage", "", None, 7])
def test_traceparent_parse_matches_reference(header):
    assert rt.parse_traceparent(header) == ref_rt.parse_traceparent(header)
    assert rt.TRACEPARENT_HEADER == ref_rt.TRACEPARENT_HEADER


def test_format_traceparent_and_chrome_trace_match_reference():
    for sampled in (True, False):
        assert rt.format_traceparent("a" * 32, "b" * 16, sampled) == \
            ref_rt.format_traceparent("a" * 32, "b" * 16, sampled)
    tree = {"request_id": "0123abcd4567", "trace_id": "c" * 32,
            "root": {"name": "request", "start": 1.0, "end": 2.5,
                     "tags": {"replica": 1},
                     "children": [{"name": "queue", "start": 1.0,
                                   "end": 1.2, "tags": {}, "children": []},
                                  {"name": "decode", "start": 1.2,
                                   "end": None, "tags": {"slot": 0},
                                   "children": []}]}}
    anomalies = [{"rule": "ttft_shift", "start": 1.1, "end": None,
                  "details": {"z": 3.0}}]
    assert rt.chrome_trace([tree], anomalies=anomalies) == \
        ref_rt.chrome_trace([tree], anomalies=anomalies)


def test_json_logger_lines(tmp_path, capsys):
    path = tmp_path / "log.jsonl"
    with JsonLogger(path) as log:
        log.log({"event": "access", "status": 200})
        log.log({"event": "access", "status": 501})
    recs = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["status"] for r in recs] == [200, 501]
    assert all(isinstance(r["time"], float) for r in recs)
    JsonLogger().log({"event": "x"})  # no path: stderr
    assert json.loads(capsys.readouterr().err)["event"] == "x"


def test_request_lifecycle_fields_match_reference():
    """The Request fields the metrics read exist with the reference's
    defaults."""
    mine = {f.name: f for f in dataclasses.fields(Request)}
    theirs = {f.name: f for f in dataclasses.fields(RefRequest)}
    for name in ("admit_time", "events", "emit_times", "submit_time"):
        assert name in mine and name in theirs
    req = Request(prompt=[1], max_new_tokens=1)
    req.record_event("submit", 4.0)
    assert req.events == [("submit", 4.0)] and req.admit_time is None
