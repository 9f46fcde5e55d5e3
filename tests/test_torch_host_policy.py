"""The host policy modules the port copies (inference/qos.py, slo.py,
faults.py, anomaly.py, migration.py) against the reference's: each
class driven through the same seeded call sequence, with the same
injected clock, gives the same outputs and the same stats, exactly.
Then the port's own profiler layer (utils/tracing.py on torch.profiler
and the server's `_StepTracer`): a window writes its trace into
`logdir`, a second one is refused while one is open, failures are
swallowed with a note, and the profiler server is refused. Mirrors the
module-level cases of tests/test_qos.py, test_slo.py, test_faults.py,
test_anomaly.py and test_migration.py."""

import json
import os
import random
import sys
import threading

import pytest
import torch

from cloud_server_tpu.inference import anomaly as ref_anomaly
from cloud_server_tpu.inference import faults as ref_faults
from cloud_server_tpu.inference import migration as ref_migration
from cloud_server_tpu.inference import qos as ref_qos
from cloud_server_tpu.inference import slo as ref_slo
from cloud_server_tpu_torch.inference import (anomaly, faults, migration,
                                              qos, slo)
from cloud_server_tpu_torch.inference.server import _StepTracer
from cloud_server_tpu_torch.utils import tracing

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401


class _Clock:
    """A clock the test advances."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _outcome(fn):
    """A call's result, or its exception's type and message."""
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — compared across modules
        return ("raised", type(exc).__name__, str(exc))


# ---------------------------------------------------------------------------
# QoS
# ---------------------------------------------------------------------------

QOS_CFG = {"quantum": 8, "deadline_s": {"batch": 30.0},
           "default": {"weight": 0.5, "priority": "best_effort"},
           "tenants": {
               "chat": {"weight": 4.0, "priority": "interactive",
                        "api_keys": ["k-chat"], "prompt_tokens_per_s": 50.0,
                        "prompt_burst": 60.0},
               "batch": {"weight": 2.0, "priority": "batch",
                         "max_pending": 3,
                         "generated_tokens_per_s": 20.0,
                         "generated_burst": 40.0},
               "bulk": {"weight": 1.0, "priority": "best_effort"}}}


class _Pending:
    def __init__(self, tenant, prompt, tokens=()):
        self.tenant, self.prompt, self.tokens = tenant, prompt, list(tokens)


def _drive_qos(mod, seed):
    """A seeded run of submits, DRR admissions, prefill funding,
    generated and speculation charges, preemption ranks and requeues on
    a TenantRegistry: every return value and the final stats."""
    clk = _Clock()
    reg = mod.TenantRegistry(QOS_CFG, clock=clk)
    rng = random.Random(seed)
    names = ["chat", "batch", "bulk", None, "spoofed"]
    pending, log = [], []
    for step in range(60):
        clk.t += rng.random() * 0.2
        op = rng.randrange(7)
        if op <= 1:
            t = reg.resolve(rng.choice(names))
            n = rng.randrange(1, 40)
            res = _outcome(lambda: reg.gate_submit(t, n))
            log.append(("submit", t, n, res))
            if res[0] == "ok":
                pending.append(_Pending(t, [1] * n))
        elif op == 2 and pending:
            idx = reg.next_admission_index(pending)
            req = pending.pop(idx)
            reg.charge_admission(req.tenant, len(req.prompt))
            reg.on_pending_removed(req.tenant)
            log.append(("admit", idx, req.tenant))
        elif op == 3:
            tenants = [rng.choice(names[:3]) for _ in range(4)]
            order = reg.order_jobs(tenants)
            for i in order[:2]:
                reg.charge_prefill(tenants[i], rng.randrange(1, 16))
            log.append(("order", tenants, order))
        elif op == 4:
            t = rng.choice(names[:3])
            for _ in range(rng.randrange(1, 6)):
                reg.charge_generated(t)
            reg.charge_speculation(t, 4, rng.randrange(0, 5))
            log.append(("gen", t))
        elif op == 5:
            ranks = {t: reg.victim_rank(t) for t in names[:3]}
            log.append(("rank", ranks))
            reg.on_requeue(rng.choice(names[:3]))
        else:
            log.append(("meta", reg.priority_class(rng.choice(names)),
                        reg.default_deadline(rng.choice(names)),
                        reg.tenant_for_api_key("k-chat"),
                        reg.tenant_for_api_key("nope"),
                        reg.header_trusted("chat"),
                        reg.header_trusted("bulk"),
                        sorted(reg.fair_shares().items())))
    return log, reg.stats(), reg.tenants()


@pytest.mark.parametrize("seed", range(4))
def test_tenant_registry_like_the_reference(seed):
    assert _drive_qos(qos, seed) == _drive_qos(ref_qos, seed)


def test_token_bucket_like_the_reference():
    def drive(mod):
        clk = _Clock(0.0)
        b = mod.TokenBucket(rate=10.0, burst=20.0, clock=clk)
        out = [b.level(), b.try_consume(20.0), b.try_consume(1.0),
               b.retry_after(5.0)]
        clk.t += 0.5
        out += [b.level(), b.try_consume(5.0)]
        b.charge(30.0)
        out += [b.level(), b.retry_after(0.0)]
        clk.t += 100.0
        out.append(b.level())
        return out

    assert drive(qos) == drive(ref_qos)


@pytest.mark.parametrize("cfg", [
    {"tenants": {"a": {"priority": "urgent"}}},
    {"tenants": {"a": {"weight": 0}}},
    {"tenants": {"a": {"prompt_burst": 5}}},
    {"quantum": 0}, {"bogus": 1}, {"deadline_s": {"later": 3}},
    {"tenants": {"a": {"api_keys": ["k"]}, "b": {"api_keys": ["k"]}}}],
    ids=["priority", "weight", "burst", "quantum", "key", "deadline",
         "api_key"])
def test_qos_config_refusals_like_the_reference(cfg):
    got = _outcome(lambda: qos.resolve_registry(json.dumps(cfg)))
    want = _outcome(lambda: ref_qos.resolve_registry(json.dumps(cfg)))
    assert got[0] == want[0] == "raised"
    assert got[1:] == want[1:]


# ---------------------------------------------------------------------------
# SLO
# ---------------------------------------------------------------------------

SLO_CFG = {"windows_s": [10, 60], "bucket_s": 1.0,
           "classes": {"interactive": {"objective": 0.99, "ttft_s": 0.5,
                                       "itl_s": 0.1, "queue_wait_s": 0.25,
                                       "e2e_s": 30.0},
                       "batch": {"objective": 0.95, "ttft_s": 5.0,
                                 "e2e_s": 120.0},
                       "default": {"objective": 0.99, "e2e_s": 60.0}}}


def _drive_slo(mod, seed):
    clk = _Clock(0.0)
    tr = mod.SLOTracker(SLO_CFG, clock=clk)
    rng = random.Random(seed)
    log = []
    for _ in range(200):
        clk.t += rng.random() * 0.7
        cls = rng.choice(["interactive", "batch", "best_effort", None])
        metric = rng.choice(["ttft", "itl", "queue_wait", "e2e"])
        v = rng.random() * 2.0
        tr.observe(cls, metric, v, clk.t)
        if rng.random() < 0.1:
            log.append((tr.exceeds_target(cls, metric, v),
                        tr.burn_rates(clk.t), tr.report(clk.t)))
    return log, tr.report(), tr.report(clk.t + 30.0)


@pytest.mark.parametrize("seed", range(3))
def test_slo_tracker_like_the_reference(seed):
    assert _drive_slo(slo, seed) == _drive_slo(ref_slo, seed)


def test_slo_merge_reports_like_the_reference():
    reps = [_drive_slo(slo, s)[1] for s in range(3)]
    assert slo.merge_reports(reps) == ref_slo.merge_reports(reps)
    assert slo.merge_reports([]) == ref_slo.merge_reports([])


# ---------------------------------------------------------------------------
# faults and brownout
# ---------------------------------------------------------------------------

PLAN = {"seed": 11, "faults": [
    {"site": "dispatch", "after": 3, "count": 2},
    {"site": "submit_reject", "count": 0, "p": 0.3},
    {"site": "alloc_famine", "after": 1, "count": 3, "p": 0.5},
    {"site": "iteration_stall", "count": 2, "stall_ms": 0.5}]}


def _drive_plan(mod):
    plan = mod.FaultPlan(json.loads(json.dumps(PLAN)))
    log = []
    for i in range(40):
        site = mod.SITES[i % 5]
        if site in ("submit_reject", "dispatch"):
            log.append(_outcome(lambda: plan.check(site)))
        elif site == "iteration_stall":
            plan.maybe_stall()
        elif site == "wedge":
            stop = threading.Event()
            stop.set()
            plan.maybe_wedge(stop)
        else:
            log.append(plan.fire(site) is not None)
        if i == 20:
            plan.arm("wedge", after=0, count=1)
    return log, plan.stats()


def test_fault_plan_like_the_reference():
    assert faults.SITES == ref_faults.SITES
    assert _drive_plan(faults) == _drive_plan(ref_faults)


@pytest.mark.parametrize("spec", [
    {"faults": [{"site": "nope"}]}, {"faults": [{"site": "dispatch",
                                                 "p": 2.0}]},
    {"what": 1}, {"faults": [3]}],
    ids=["site", "p", "key", "entry"])
def test_fault_plan_refusals_like_the_reference(spec):
    got = _outcome(lambda: faults.resolve_fault_plan(json.dumps(spec)))
    want = _outcome(lambda: ref_faults.resolve_fault_plan(json.dumps(spec)))
    assert got == want and got[0] == "raised"


def _drive_brownout(mod, seed):
    clk = _Clock(0.0)
    det = mod.OverloadDetector({"alpha": 0.5, "hold_s": 1.0, "seed": seed,
                                "retry_after_s": 0.5}, clock=clk)
    rng = random.Random(seed)
    log = []
    for _ in range(120):
        clk.t += rng.random() * 0.3
        lvl = det.observe(pending_age_s=rng.random() * 4.0,
                          budget_utilization=rng.random(),
                          host_gap_frac=rng.random())
        shed = {c: det.shed(c) for c in ("interactive", "batch",
                                         "best_effort", None)}
        log.append((lvl, det.level(), shed,
                    det.retry_hint() if any(shed.values()) else None))
    clk.t += 5.0  # no busy iteration for longer than hold_s
    log.append(det.level())
    return log, det.stats()


@pytest.mark.parametrize("seed", range(3))
def test_overload_detector_like_the_reference(seed):
    assert _drive_brownout(faults, seed) == _drive_brownout(ref_faults,
                                                            seed)


# ---------------------------------------------------------------------------
# the anomaly watchdog
# ---------------------------------------------------------------------------

ANOMALY_CFG = {"warmup": 4, "check_every": 2, "hold_s": 1.5,
               "event_capacity": 6,
               "rules": {"deadline_spike": {"count": 2, "window_s": 5.0},
                         "preempt_spike": {"count": 3, "window_s": 4.0},
                         "breaker_flap": {"flaps": 2, "window_s": 6.0},
                         "wedged": {"stall_s": 2.0}}}


def _drive_watchdog(mod, seed, slo_mod):
    clk = _Clock(0.0)
    wd = mod.AnomalyWatchdog(ANOMALY_CFG, clock=clk)
    tracker = slo_mod.SLOTracker(SLO_CFG, clock=clk)
    wd.bind_slo(tracker)
    rng = random.Random(seed)
    log = []
    for i in range(300):
        clk.t += rng.random() * 0.2
        if rng.random() < 0.7:
            hits = rng.randrange(0, 8)
            fired = wd.observe_iteration(
                now=clk.t, host_gap_frac=rng.random() ** (3 if i < 150
                                                          else 0.3),
                pending=rng.randrange(0, 4),
                preempt_delta=int(rng.random() < 0.15),
                cache_lookup_delta=8, cache_hit_delta=hits if i < 200
                else 0, overload_level=rng.randrange(0, 3))
        else:
            ttft = rng.random() * (0.1 if i < 100 else 2.0)
            tracker.observe("interactive", "ttft", ttft, clk.t)
            fired = wd.observe_request(
                now=clk.t, ttft_s=ttft, itl_s=rng.random() * 0.05,
                finish_reason=rng.choice(["length", "deadline", "eos"]))
        log.append((fired, wd.active_count(clk.t)))
        if i % 50 == 0:
            log.append(wd.stats(events=3))
    clk.t += 10.0  # pending work, no iteration: `wedged` grades lazily
    log.append((wd.active(), wd.events(2), wd.events(0)))
    return log, wd.stats()


@pytest.mark.parametrize("seed", range(3))
def test_anomaly_watchdog_like_the_reference(seed):
    assert anomaly.RULES == ref_anomaly.RULES
    assert (_drive_watchdog(anomaly, seed, slo)
            == _drive_watchdog(ref_anomaly, seed, ref_slo))


def test_merge_anomaly_stats_like_the_reference():
    stats = [_drive_watchdog(anomaly, s, slo)[1] for s in range(2)]
    assert anomaly.merge_anomaly_stats(stats) == \
        ref_anomaly.merge_anomaly_stats(stats)


@pytest.mark.parametrize("cfg", [
    {"hold_s": -1}, {"alpha_fast": 0.0}, {"rules": {"nope": {}}},
    {"disable": ["nope"]}, {"rules": {"deadline_spike": {"bogus": 1}}},
    {"what": 1}], ids=["hold", "alpha", "rule", "disable", "knob", "key"])
def test_anomaly_config_refusals_like_the_reference(cfg):
    got = _outcome(lambda: anomaly.resolve_anomaly(json.dumps(cfg)))
    want = _outcome(lambda: ref_anomaly.resolve_anomaly(json.dumps(cfg)))
    assert got == want and got[0] == "raised"


# ---------------------------------------------------------------------------
# the migration ledger
# ---------------------------------------------------------------------------


def _drive_ledger(mod):
    led = mod.MigrationLedger()
    rng = random.Random(5)
    log = []
    for _ in range(50):
        op = rng.randrange(7)
        if op == 0:
            led.record_export_start()
        elif op == 1:
            led.record_export_done(rng.randrange(0, 30), rng.randrange(0, 5))
        elif op == 2:
            led.record_export_failed()
        elif op == 3:
            led.record_import_start()
        elif op == 4:
            led.record_import_done()
        elif op == 5:
            led.record_import_failed()
        else:
            log.append(led.drain_flight_deltas())
        log.append(led.stats())
    return log


def test_migration_ledger_like_the_reference():
    assert _drive_ledger(migration) == _drive_ledger(ref_migration)
    # a server that never migrates reports the reference's zero block
    assert (migration.MigrationLedger().stats()
            == ref_migration.MigrationLedger().stats())


# ---------------------------------------------------------------------------
# the profiler window (utils/tracing.py, _StepTracer)
# ---------------------------------------------------------------------------


def test_capture_trace_writes_into_logdir(tmp_path):
    with tracing.capture_trace(tmp_path):
        with tracing.annotate("policy-test-region"):
            torch.ones(8, 8).sum()
    (path,) = sorted(tmp_path.rglob("*.pt.trace.json"))
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "policy-test-region" in names


def test_step_profiler_traces_its_window(tmp_path):
    prof = tracing.StepProfiler(tmp_path, start_step=2, num_steps=2)
    seen = []
    for step in range(6):
        prof.step(step)
        seen.append(prof._prof is not None)
        torch.ones(4).sum()
    prof.close()
    assert seen == [False, False, True, True, False, False]
    assert len(sorted(tmp_path.rglob("*.pt.trace.json"))) == 1


def test_profiler_server_is_refused():
    with pytest.raises(NotImplementedError, match="profiler server"):
        tracing.start_profiler_server(9012)


def test_step_tracer_window_and_refusals(tmp_path):
    """Armed from any thread, opened at an iteration's start, closed
    after N ends (the settle callback first); a second request while one
    is armed or open is a ValueError; a bad count is refused."""
    tr = _StepTracer()
    with pytest.raises(ValueError, match="positive"):
        tr.request(0, tmp_path)
    tr.request(2, tmp_path)
    with pytest.raises(ValueError, match="already in progress"):
        tr.request(1, tmp_path)
    settled = []
    for _ in range(3):
        tr.step_start()
        torch.ones(4).sum()
        tr.step_end(settle=lambda: settled.append(True))
    assert not tr.active and settled == [True]
    assert len(sorted(tmp_path.rglob("*.pt.trace.json"))) == 1
    tr.request(1, tmp_path / "again")  # free again
    assert tr.active


def test_step_tracer_swallows_profiler_failures(monkeypatch, capsys):
    """A profiler that fails to start leaves the scheduler running, with
    a note on stderr (the reference's rule)."""
    def broken(logdir):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(tracing, "capture_trace", broken)
    tr = _StepTracer()
    tr.request(1, "unused")
    tr.step_start()
    tr.step_end()
    assert not tr.active
    assert "trace capture failed to start" in capsys.readouterr().err
