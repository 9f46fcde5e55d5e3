"""The port's paged server with the host policy layer against the
reference's, on the same weights, under the mixed scheduler (with and
without the overlap pipeline) and the alternating one: multi-tenant QoS
(deficit round-robin admission, priority preemption, per-tenant pending
bounds), brownout shedding at a forced level, a seeded fault plan,
deadline and preemption anomalies, SLO counts, the wedge and dispatch
faults, and the programs a configured server captures. Mirrors the
paged-server scenarios of tests/test_qos.py, test_slo.py,
test_faults.py and test_anomaly.py; clocks are frozen where the
policies read one, so every compared number is exact."""

import dataclasses
import os
import sys
import threading
import time

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference import faults as ref_faults
from cloud_server_tpu.inference import qos as ref_qos
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import faults, graphs, qos
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
# a pool of 12 pages for 3 slots of up to 8: long requests preempt
SRV_KW = dict(max_slots=3, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32], num_pages=12, decode_chunk=2)
SCHEDULES = {"mixed": dict(scheduler="mixed", overlap=True),
             "mixed_sequential": dict(scheduler="mixed", overlap=False),
             "alternating": dict(scheduler="alternating", overlap=False)}
QOS = {"quantum": 4,
       "tenants": {"chat": {"weight": 4.0, "priority": "interactive"},
                   "batch": {"weight": 2.0, "priority": "batch"},
                   "bulk": {"weight": 1.0, "priority": "best_effort",
                            "max_pending": 2}}}
TENANTS = ["chat", "batch", "bulk"]
PROMPTS = [[(i * 9 + k) % 60 + 1 for k in range(6 + 3 * (i % 3))]
           for i in range(9)]
# generous targets: every observation is good, so the counts compare
SLO = {"windows_s": [60, 3600],
       "classes": {"interactive": {"objective": 0.99, "ttft_s": 30.0,
                                   "itl_s": 30.0, "queue_wait_s": 30.0,
                                   "e2e_s": 60.0},
                   "batch": {"objective": 0.95, "ttft_s": 30.0,
                             "e2e_s": 120.0},
                   "default": {"objective": 0.99, "e2e_s": 60.0}}}
# only the rules a run's counts decide (the rest read wall-clock EWMAs)
ANOMALY = {"warmup": 0, "check_every": 1, "hold_s": 3600.0,
           "disable": ["slo_burn", "latency_shift", "cache_collapse",
                       "breaker_flap", "host_gap", "wedged"],
           "rules": {"deadline_spike": {"count": 2, "window_s": 3600.0},
                     "preempt_spike": {"count": 1, "window_s": 3600.0}}}


class _Clock:
    """A frozen clock: the registries' buckets and virtual time read
    it, so both servers' policy decisions see the same instants."""

    def __call__(self) -> float:
        return 0.0


def _tcfg():
    return TModelConfig(**dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def weights():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), _tcfg(),
                                  device="cpu")


def _servers(weights, sched, icfg=GREEDY, policy=None, **kw):
    """(reference, port) servers on the same weights. `policy(mod)`
    builds the policy objects from a module set (the reference's or the
    port's: qos, faults), so each server gets its own instances."""
    ref_pol = policy(ref_qos, ref_faults) if policy else {}
    port_pol = policy(qos, faults) if policy else {}
    ref = RefServer(weights[0], CFG, icfg, **SCHEDULES[sched],
                    **{**SRV_KW, **kw}, **ref_pol)
    port = PagedInferenceServer(
        weights[1], _tcfg(), TInferConfig(**dataclasses.asdict(icfg)),
        device="cpu", **SCHEDULES[sched], **{**SRV_KW, **kw}, **port_pol)
    return ref, port


def _qos_policy(q, f):
    return {"qos": q.TenantRegistry(QOS, clock=_Clock())}


def _submit_all(srv, prompts, tenants, max_new, **kw):
    """Submit in order; a refused submit is recorded by its error type
    and (for a tenant refusal) its tenant."""
    reqs, refused = [], []
    for i, (p, t) in enumerate(zip(prompts, tenants)):
        try:
            reqs.append(srv.submit(p, max_new_tokens=max_new, tenant=t,
                                   **kw))
        except Exception as exc:  # noqa: BLE001 — compared by type
            refused.append((i, type(exc).__name__,
                            getattr(exc, "tenant", None)))
    return reqs, refused


def _admission_order(reqs):
    return sorted(range(len(reqs)), key=lambda i: reqs[i].admit_time)


def _outcome(srv, reqs, refused):
    return {"tokens": [r.tokens for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "tenants": [r.tenant for r in reqs],
            "order": _admission_order(reqs),
            "refused": refused,
            "preemptions": srv.preemptions,
            "preempt_tenants": [t for rec in srv.flight_window()
                                for t in rec.get("preempt_tenants", ())],
            "qos": srv.qos.stats()}


@pytest.mark.parametrize("sched", SCHEDULES)
def test_tenants_preemption_and_queue_full(weights, sched):
    """Three tenants (weights 4:2:1, `bulk` bounded to 2 pending) over a
    pool small enough to preempt: the same greedy tokens, admission
    order, per-tenant counters, TenantQueueFullError refusals and
    preemption victims (by tenant) as the reference."""
    tenants = TENANTS * 3
    out = []
    for srv in _servers(weights, sched, policy=_qos_policy):
        reqs, refused = _submit_all(srv, PROMPTS, tenants, 40)
        srv.run_until_idle()
        out.append(_outcome(srv, reqs, refused))
    want, got = out
    assert got == want
    assert [r[1] for r in got["refused"]] == ["TenantQueueFullError"]
    assert got["refused"][0][2] == "bulk"
    assert got["preemptions"] > 0
    assert got["order"] != list(range(len(got["order"])))  # DRR, not FIFO


@pytest.mark.parametrize("sched", SCHEDULES)
def test_brownout_sheds_at_forced_level(weights, sched):
    """Thresholds every busy iteration crosses force the detector's
    level: the same classes are shed, with the same counts and the same
    seeded Retry-After hints; the admitted requests' tokens agree."""
    brown = {"pending_age_s": 1e-9, "budget_utilization": 1e-9,
             "host_gap_frac": 10.0, "alpha": 1.0, "hold_s": 3600.0,
             "retry_after_s": 0.5, "jitter_frac": 0.5, "seed": 3}

    def policy(q, f):
        return {"qos": q.TenantRegistry(QOS, clock=_Clock()),
                "brownout": f.OverloadDetector(brown, clock=_Clock())}

    out = []
    for srv in _servers(weights, sched, policy=policy):
        # one more than the slots: the queue head ages
        first, _ = _submit_all(srv, PROMPTS[:4], ["chat"] * 4, 6)
        srv.step()  # a busy iteration grades the detector
        level = srv.brownout_stats()["level"]
        hints, refused = [], []
        for i, t in enumerate(TENANTS * 2):
            try:
                first.append(srv.submit(PROMPTS[i], max_new_tokens=6,
                                        tenant=t))
            except Exception as exc:  # noqa: BLE001 — compared by type
                refused.append((i, type(exc).__name__, exc.tenant,
                                exc.priority_class))
                hints.append(exc.retry_after_s)
        srv.run_until_idle()
        st = srv.brownout_stats()
        out.append({"level": level, "refused": refused, "hints": hints,
                    "shed_total": st["shed_total"],
                    "tokens": [r.tokens for r in first],
                    "levels": [rec.get("brownout_level")
                               for rec in srv.flight_window()]})
    want, got = out
    assert got == want
    assert got["level"] >= 1 and got["refused"]
    assert {r[3] for r in got["refused"]} <= {"best_effort", "batch"}


@pytest.mark.parametrize("sched", SCHEDULES)
def test_seeded_fault_plan_rejects_and_defers_the_same(weights, sched):
    """A seeded plan (a submit rejection, two transient page famines,
    two short stalls): the same submits refused, the same requests
    served with the same tokens, and the same per-site counts."""
    plan = {"seed": 7, "faults": [
        {"site": "submit_reject", "after": 2, "count": 1},
        {"site": "alloc_famine", "after": 1, "count": 2},
        {"site": "iteration_stall", "after": 3, "count": 2,
         "stall_ms": 5}]}
    out = []
    for srv in _servers(weights, sched, faults=plan):
        reqs, refused = _submit_all(srv, PROMPTS[:6], [None] * 6, 8)
        srv.run_until_idle()
        out.append({"refused": refused,
                    "tokens": [r.tokens for r in reqs],
                    "finish": [r.finish_reason for r in reqs],
                    "faults": srv.fault_stats()})
    want, got = out
    assert got == want
    assert got["refused"] == [(2, "InjectedFault", None)]
    assert got["faults"]["fired"]["alloc_famine"] == 2


@pytest.mark.parametrize("sched", SCHEDULES)
def test_dispatch_fault_fails_every_request_alike(weights, sched):
    """A dispatch fault at the fourth dispatch site: the scheduler
    thread fails, every request (live and queued) ends with the same
    error reason as the reference's, and no waiter hangs."""
    plan = {"faults": [{"site": "dispatch", "after": 3, "count": 1}]}
    out = []
    for srv in _servers(weights, sched, faults=plan):
        reqs, _ = _submit_all(srv, PROMPTS[:5], [None] * 5, 16)
        srv.start()
        try:
            for r in reqs:
                assert r._done.wait(30), "a waiter hung"
        finally:
            srv.stop()
        out.append([r.finish_reason for r in reqs])
    want, got = out
    assert got == want
    assert all(f.startswith("error: InjectedFault") for f in got)


@pytest.mark.parametrize("sched", SCHEDULES)
def test_slo_counts_and_class_deadlines(weights, sched):
    """SLO classes come from the tenants' priority classes; with
    generous targets every lifetime and window count equals the
    reference's. A class default deadline (QoS `deadline_s`) expires
    the `bulk` requests alike."""
    q = dict(QOS, deadline_s={"best_effort": 1e-6})

    def policy(qm, f):
        return {"qos": qm.TenantRegistry(q, clock=_Clock())}

    out = []
    for srv in _servers(weights, sched, policy=policy, slo=SLO):
        reqs, _ = _submit_all(srv, PROMPTS[:6], TENANTS * 2, 6)
        srv.run_until_idle()
        rep = srv.slo_report()
        out.append({"finish": [r.finish_reason for r in reqs],
                    "classes": [r.slo_class for r in reqs],
                    "counts": {
                        c: {m: (v["lifetime"]["good"],
                                v["lifetime"]["total"],
                                {w: x["total"]
                                 for w, x in v["windows"].items()})
                            for m, v in cls["metrics"].items()}
                        for c, cls in rep["classes"].items()}})
    want, got = out
    assert got == want
    assert got["finish"][2] == got["finish"][5] == "deadline"
    assert got["counts"]["interactive"]["ttft"][1] == 2


def test_wedge_lets_stop_return(weights):
    """A wedged scheduler keeps its step lock: _fail_all's bounded
    acquire times out, the teardown goes ahead (counted once) and every
    waiter is released; stop() then returns, on both servers."""
    plan = {"faults": [{"site": "wedge", "count": 1}]}
    out = []
    for srv in _servers(weights, "mixed_sequential", faults=plan):
        srv.start()
        req = srv.submit(PROMPTS[0], max_new_tokens=8)
        time.sleep(0.3)  # the scheduler is wedged inside step()
        assert req.tokens == [] and not req.done
        srv._teardown_lock_timeout_s = 0.05
        srv._fail_all(RuntimeError("wedged"))
        assert req.done and req.finish_reason.startswith("error")
        t = threading.Thread(target=srv.stop)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive(), "stop() hung"
        snap = srv.metrics_snapshot()
        out.append((srv.unserialized_teardowns,
                    snap["cloud_server_unserialized_teardown_total"]
                    ["value"], srv._thread))
    assert out[0] == out[1] == (1, 1, None)


def test_dispatch_fault_under_overlap_fails_everyone(weights):
    """The pipelined scheduler with a dispatch in flight: a fault armed
    mid-decode fails every request within 10 s, hangs no one, and
    stop() returns with no unserialized teardown."""
    fp = faults.FaultPlan()
    srv = PagedInferenceServer(
        weights[1], _tcfg(), TInferConfig(**dataclasses.asdict(GREEDY)),
        device="cpu", **SCHEDULES["mixed"], **SRV_KW, faults=fp)
    reqs = [srv.submit(p, max_new_tokens=40) for p in PROMPTS[:5]]
    srv.start()
    try:
        deadline = time.time() + 30
        while srv._inflight is None and time.time() < deadline:
            time.sleep(0.001)
        fp.arm("dispatch", count=1)
        t0 = time.perf_counter()
        for r in reqs:
            assert r._done.wait(10), "a waiter hung"
        assert time.perf_counter() - t0 < 10
    finally:
        srv.stop()
    assert all(r.finish_reason.startswith("error: InjectedFault")
               for r in reqs)
    assert srv.unserialized_teardowns == 0
    assert srv._inflight is None and srv._thread is None


@pytest.mark.parametrize("driver", ["step", "thread"])
@pytest.mark.parametrize("wait", ["raises", "times_out"])
def test_fail_all_survives_a_failed_wait(weights, monkeypatch, tmp_path,
                                        wait, driver):
    """A dispatch fault with a dispatch in flight, while the wait on that
    dispatch fails (a sticky device error raises again at every query)
    or times out: every request still fails with the fault, the
    teardown is counted as unserialized, and stop() returns. Driven by
    hand, the failing step also closes a profiler window: the window
    closes without that wait, so the step's own error surfaces."""
    def failed_wait(self, timeout=None):
        if wait == "raises":
            raise RuntimeError("sticky device error")
        return False

    monkeypatch.setattr(graphs.Program, "settle", failed_wait)
    fp = faults.FaultPlan()
    srv = PagedInferenceServer(
        weights[1], _tcfg(), TInferConfig(**dataclasses.asdict(GREEDY)),
        device="cpu", **SCHEDULES["mixed"], **SRV_KW, faults=fp)
    reqs = [srv.submit(p, max_new_tokens=40) for p in PROMPTS[:5]]
    if driver == "step":
        while srv._inflight is None:
            srv.step()
        srv.request_trace(1, tmp_path)
        fp.arm("dispatch", count=1)
        with pytest.raises(faults.InjectedFault) as err:
            srv.step()
        assert not srv.tracer.active
        srv._fail_all(err.value)
    else:
        srv.start()
        deadline = time.time() + 30
        while srv._inflight is None and time.time() < deadline:
            time.sleep(0.001)
        fp.arm("dispatch", count=1)
        for r in reqs:
            assert r._done.wait(10), "a waiter hung"
    t = threading.Thread(target=srv.stop)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "stop() hung"
    assert all(r.finish_reason.startswith("error: InjectedFault")
               for r in reqs)
    assert srv.unserialized_teardowns == 1
    assert srv._inflight is None and srv._thread is None


def _all_policies(q, f):
    return {"qos": q.TenantRegistry(
                {"tenants": {"chat": {"priority": "interactive"}}},
                clock=_Clock()),
            "faults": f.FaultPlan({"faults": [
                {"site": "dispatch", "after": 10 ** 9}]}),
            "brownout": f.OverloadDetector({}, clock=_Clock())}


@pytest.mark.parametrize("sched", SCHEDULES)
def test_policy_layer_adds_no_program(weights, sched):
    """A server with every policy configured (QoS, SLO, tracing at 100%
    with a tail ring, an armed but quiet fault plan, brownout, the
    watchdog) captures the same program keys, launches and waits as
    many programs, and gives the same tokens as an unconfigured one."""
    icfg = dataclasses.replace(GREEDY, trace_tail_capacity=8,
                               bundle_on_anomaly=True)
    tcfg = TInferConfig(**dataclasses.asdict(icfg))
    runs = []
    for pol in ({}, dict(_all_policies(qos, faults), slo=SLO,
                         tracing=1.0, anomaly={"warmup": 4})):
        srv = PagedInferenceServer(
            weights[1], _tcfg(), tcfg, device="cpu", **SCHEDULES[sched],
            **SRV_KW, **pol)
        l0, s0 = graphs.launches, graphs.syncs
        reqs = [srv.submit(p, max_new_tokens=10, tenant="chat")
                for p in PROMPTS[:4]]
        srv.run_until_idle()
        runs.append((sorted(map(repr, srv._programs.keys())),
                     graphs.launches - l0, graphs.syncs - s0,
                     [r.tokens for r in reqs]))
    assert runs[0] == runs[1]
