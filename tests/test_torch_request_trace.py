"""Request tracing in the port (inference/request_trace.py, a copy of
the reference's) against the reference, on the module and on the paged
server: traceparent parsing and formatting, deterministic head
sampling, the phase derivation, ring eviction and tail retention
driven through the same calls; then the span trees both servers build
for the same requests under the mixed scheduler (with and without the
overlap pipeline) and the alternating one — the same requests, span
names, nesting, tags and flight-recorder iteration ids, times ignored —
preemption and tail retention included, and the Chrome-trace export.
Mirrors tests/test_request_trace.py and the tail cases of
tests/test_anomaly.py."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference import request_trace as ref_rt
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import request_trace as rt
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
SRV_KW = dict(max_slots=3, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32], num_pages=12, decode_chunk=2)
SCHEDULES = {"mixed": dict(scheduler="mixed", overlap=True),
             "mixed_sequential": dict(scheduler="mixed", overlap=False),
             "alternating": dict(scheduler="alternating", overlap=False)}
PROMPTS = [[(i * 9 + k) % 60 + 1 for k in range(6 + 3 * (i % 3))]
           for i in range(6)]
CTX = ("0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331", True)


@pytest.fixture(scope="module")
def weights():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    tcfg = TModelConfig(**dataclasses.asdict(CFG))
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), tcfg,
                                  device="cpu")


# ---------------------------------------------------------------------------
# the module, call for call
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("header", [
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01",
    "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00",
    "00-" + "0" * 32 + "-b7ad6b7169203331-01", "ff-" + "a" * 32
    + "-" + "b" * 16 + "-01", "garbage", "", None, 17])
def test_traceparent_parse_like_the_reference(header):
    assert rt.parse_traceparent(header) == ref_rt.parse_traceparent(header)
    got = rt.parse_traceparent(header)
    if got is not None:
        assert rt.format_traceparent(*got) == ref_rt.format_traceparent(
            *got)


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.5, 1.0])
def test_head_sampling_like_the_reference(rate):
    ids = [f"{i * 0x1F3A5C7:08x}" + "0" * 24 for i in range(0, 4000, 7)]
    got = rt.TraceRecorder(sample_rate=rate)
    want = ref_rt.TraceRecorder(sample_rate=rate)
    assert ([got.should_sample(t) for t in ids]
            == [want.should_sample(t) for t in ids])


class _Req:
    """A request as the recorder sees it (the fields it reads)."""

    def __init__(self, rid, events, finish, tokens=(), tenant=None):
        self.request_id = rid
        self.trace = self.tail_trace = None
        self.submit_time = events[0][1]
        self.tenant = tenant
        self.finish_reason = finish
        self.tokens = list(tokens)
        self.emit_times = [t for n, t in events if n == "emit"]
        self._events = [(n, t) for n, t in events if n != "emit"]

    def timeline(self):
        return list(self._events)


def _drive_recorder(mod, **kw):
    """One call sequence through a TraceRecorder: a sampled, an
    unsampled and a joined request, a failure, a deadline and a
    preempted one, spans, lookups and the ring exports."""
    rec = mod.TraceRecorder(**kw)
    runs = [
        ("a", [("submit", 1.0), ("admit", 1.5), ("first_token", 2.0),
               ("emit", 2.0), ("emit", 2.5), ("finish:length", 2.5)],
         "length", None),
        ("b", [("submit", 1.1), ("finish:deadline", 1.9)], "deadline",
         None),
        ("c", [("submit", 1.2), ("admit", 1.3), ("preempt_requeue", 1.6),
               ("admit", 1.8), ("first_token", 2.2), ("emit", 2.2),
               ("finish:error: boom", 2.4)], "error: boom", CTX),
        ("d", [("submit", 1.4), ("admit", 1.45), ("preempt_requeue", 1.5),
               ("admit", 1.55), ("preempt_requeue", 1.6), ("admit", 1.7),
               ("first_token", 1.8), ("emit", 1.8),
               ("finish:length", 1.9)], "length", None),
    ]
    out = []
    for i, (rid, events, finish, ctx) in enumerate(runs):
        r = _Req(f"{rid}{i:011d}", events, finish, tokens=[1, 2])
        tr = rec.begin(r, ctx)
        if tr is not None:
            tr.annotate(tenant="t")
            tr.add_span("decode_segment", 2.0, 2.1, iteration=3, slot=0,
                        rounds=2)
        rec.finish(r, slo_violated=(rid == "d"), in_anomaly=False)
        out.append((r.trace is not None, r.tail_trace is not None))
    trees = rec.trees()
    for t in trees:
        t.pop("trace_id")
        t.pop("root_span_id")
    out.append(trees)
    out.append([rec.lookup(f"{rid}{i:011d}") is not None
                for i, (rid, *_) in enumerate(runs)])
    if rec.tail_capacity:
        tails = rec.tail_trees()
        for t in tails:
            t.pop("trace_id")
            t.pop("root_span_id")
        out.append(tails)
        out.append(rec.tail_stats())
    out.append(rec.evicted_total)
    return out


@pytest.mark.parametrize("kw", [
    dict(sample_rate=1.0), dict(sample_rate=1.0, capacity=2),
    dict(sample_rate=0.0, tail_capacity=2),
    dict(sample_rate=0.0, tail_capacity=4, tail_preempt_min=3)],
    ids=["all", "ring2", "tail_only", "tail_preempt3"])
def test_recorder_like_the_reference(kw):
    assert _drive_recorder(rt, **kw) == _drive_recorder(ref_rt, **kw)


def test_chrome_trace_like_the_reference():
    trees = _drive_recorder(rt, sample_rate=1.0)[4]
    marks = [{"rule": "deadline_spike", "start": 1.0, "end": None,
              "details": {"count": 2}}]
    assert rt.chrome_trace(trees, marks) == ref_rt.chrome_trace(trees,
                                                                marks)


@pytest.mark.parametrize("spec", [None, 0.0, 0.5, "0.5", False])
def test_resolve_recorder_like_the_reference(spec):
    for args in ((spec,), (spec, 0.3), (spec, 0.0, 16, 4)):
        got = rt.resolve_recorder(*args)
        want = ref_rt.resolve_recorder(*args)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.sample_rate, got.tail_capacity) == (
                want.sample_rate, want.tail_capacity)


# ---------------------------------------------------------------------------
# span trees on the servers
# ---------------------------------------------------------------------------


def _shape(span) -> tuple:
    """A span without its times: name, tags, children."""
    return (span["name"], sorted(span.get("tags", {}).items()),
            [_shape(c) for c in span.get("children", ())])


def _trees(srv, reqs, tail=False):
    fn = srv.tail_trace_trees if tail else srv.trace_trees
    by_id = {t["request_id"]: t for t in fn()}
    return [None if r.request_id not in by_id
            else _shape(by_id[r.request_id]["root"]) for r in reqs]


def _servers(weights, sched, icfg=GREEDY, **kw):
    ref = RefServer(weights[0], CFG, icfg, **SCHEDULES[sched],
                    **{**SRV_KW, **kw})
    port = PagedInferenceServer(
        weights[1], TModelConfig(**dataclasses.asdict(CFG)),
        TInferConfig(**dataclasses.asdict(icfg)), device="cpu",
        **SCHEDULES[sched], **{**SRV_KW, **kw})
    return ref, port


@pytest.mark.parametrize("sched", SCHEDULES)
def test_span_trees_like_the_reference(weights, sched):
    """Six requests, one joining a caller's trace, over a pool that
    preempts: one tree per request with the reference's phases
    (queue/prefill/decode/preempt_gap/emit), iteration spans
    (prefill_chunk/decode_segment with their slots, widths, rounds and
    flight iteration ids) and tags; lookups and the Chrome export."""
    out = []
    for srv in _servers(weights, sched, tracing=1.0):
        reqs = [srv.submit(p, max_new_tokens=30,
                           trace_ctx=CTX if i == 2 else None)
                for i, p in enumerate(PROMPTS)]
        srv.run_until_idle()
        trees = _trees(srv, reqs)
        assert all(srv.lookup_trace(r.request_id) is not None
                   for r in reqs)
        assert srv.lookup_trace("nonexistent") is None
        assert reqs[2].trace.trace_id == CTX[0]
        events = rt.chrome_trace(srv.trace_trees())["traceEvents"]
        out.append({"trees": trees, "preemptions": srv.preemptions,
                    "n_events": len(events),
                    "iterations": srv.flight.iterations})
    want, got = out
    assert got == want
    assert got["preemptions"] > 0
    names = {c[0] for t in got["trees"] for ph in t[2] for c in ph[2]}
    assert {"prefill_chunk", "decode_segment"} <= names


@pytest.mark.parametrize("sched", SCHEDULES)
def test_tail_retention_like_the_reference(weights, sched):
    """No head sampling, a tail ring: the deadline-expired and the
    preempted requests' trees are retained, with the same reasons."""
    icfg = dataclasses.replace(GREEDY, trace_tail_capacity=8)
    out = []
    for srv in _servers(weights, sched, icfg=icfg):
        reqs = [srv.submit(p, max_new_tokens=30) for p in PROMPTS]
        late = srv.submit(PROMPTS[0], max_new_tokens=4, deadline_s=1e-6)
        srv.run_until_idle()
        out.append({"tails": _trees(srv, reqs + [late], tail=True),
                    "stats": srv.tail_trace_stats(),
                    "head": srv.trace_trees()})
    want, got = out
    assert got == want
    assert got["head"] == []
    assert got["stats"]["retained_total"]["deadline"] == 1
