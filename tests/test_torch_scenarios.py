"""The port's scenario harness against the reference's (mirroring
tests/test_scenarios.py case for case): seeded event streams byte-equal
to the reference's, the replay driver's timing contract, the
discrete-event simulator's reports and the SLO-burn autoscaler's
decisions equal to the reference's on the same inputs, scripted routers
and clock; then live: a replay against a port server (its flight records
calibrate the simulator), against the port's HTTP frontend over the
wire, a scale-down drain racing a flood on a router of port servers, and
the replay-driven iteration still one program launch and one sync.

The reference's calibration test gates on sim-vs-live attainment, a
timing reading that fails under load; here the live run's records feed
both simulators, whose reports must agree, and the calibration itself
is read on the card (chip_smoke.py's elastic phase)."""

import dataclasses
import random
import threading
import time

import jax
import numpy as np
import pytest

from cloud_server_tpu import scenarios as ref_sc
from cloud_server_tpu.scenarios.simulator import _SimReq as RefSimReq
from cloud_server_tpu.utils.serving_metrics import (
    MetricsRegistry as RefRegistry)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch import scenarios as sc
from cloud_server_tpu_torch.config import InferConfig, ModelConfig
from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
from cloud_server_tpu_torch.inference import graphs
from cloud_server_tpu_torch.inference.http_server import HttpFrontend
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.router import ReplicatedRouter
from cloud_server_tpu_torch.models.transformer import params_from_numpy
from cloud_server_tpu_torch.scenarios.simulator import _SimReq
from cloud_server_tpu_torch.utils.serving_metrics import MetricsRegistry

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
PAGED_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
                prompt_buckets=[16, 48])
# both packages side by side: (scenarios module, registry class)
PKGS = [(ref_sc, RefRegistry), (sc, MetricsRegistry)]
PKG_IDS = ["ref", "port"]


@pytest.fixture(scope="module")
def params():
    from cloud_server_tpu.config import ModelConfig as RefModelConfig
    ref = ref_transformer.init_params(
        RefModelConfig(**dataclasses.asdict(CFG)), jax.random.key(0))
    return params_from_numpy(jax.tree.map(np.asarray, ref), CFG,
                             device="cpu")


def _server(params, **kw):
    return PagedInferenceServer(params, CFG, GREEDY, device="cpu",
                                **{**PAGED_KW, **kw})


def _mini(mod, seed=0, duration=1.0, rate=20.0, turns=1.0, prefix=0,
          think=0.0, arrivals=None, tenants=None):
    return mod.Scenario(
        arrivals=arrivals or mod.PoissonArrivals(rate), duration_s=duration,
        prompt_len=mod.LengthMixture([(1.0, ("uniform", 4, 12))]),
        output_len=mod.LengthMixture.point(4),
        tenants=mod.TenantMix(tenants or {"inter": 1.0, "bulk": 1.0}),
        session=mod.SessionShape(turns_mean=turns, think_s_mean=think,
                                 prefix_len=prefix),
        vocab=60, seed=seed)


# ---------------------------------------------------------------------------
# workload generation
# ---------------------------------------------------------------------------

STREAMS = {
    "poisson": dict(seed=7, turns=2.5, prefix=6, think=0.1),
    "poisson_seed8": dict(seed=8, turns=2.5, prefix=6, think=0.1),
    "single_turn": dict(seed=3, rate=40.0),
    "tenant_mix": dict(seed=11, turns=1.5, prefix=4, think=0.05,
                       tenants={"a": 1.0, "b": 3.0, "c": 0.5}),
    "mmpp": dict(seed=5, duration=3.0, turns=2.0, prefix=3, think=0.2,
                 arrivals="mmpp"),
    "trace": dict(seed=2, duration=2.0, arrivals="trace"),
}


def _arrivals(mod, kind):
    if kind == "mmpp":
        return mod.MMPPArrivals([(1.0, 1.0), (30.0, 1.0), (2.0, 1.0)])
    if kind == "trace":
        return mod.TraceArrivals([0.05, 0.2, 0.01])
    return None


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_bytes_equal_reference(name):
    """The determinism contract, across packages: the same config and
    seed give the reference's bytes (and each package repeats itself)."""
    kw = dict(STREAMS[name])
    kind = kw.pop("arrivals", None)
    a = _mini(sc, arrivals=_arrivals(sc, kind), **kw).generate()
    b = _mini(ref_sc, arrivals=_arrivals(ref_sc, kind), **kw).generate()
    assert a and sc.stream_bytes(a) == ref_sc.stream_bytes(b)
    again = _mini(sc, arrivals=_arrivals(sc, kind), **kw).generate()
    assert sc.stream_bytes(a) == sc.stream_bytes(again)


def test_diurnal_burst_equals_reference():
    """The elastic phase's traffic: the same events as the reference's
    `diurnal_burst`, with its low/high/low rate phases."""
    kw = dict(seed=0, duration_s=30, phase_s=10, low_rps=0.3,
              high_rps=6.0)
    a = sc.diurnal_burst(tenants=sc.TenantMix({"inter": 3, "bulk": 1}),
                         **kw).generate()
    b = ref_sc.diurnal_burst(
        tenants=ref_sc.TenantMix({"inter": 3, "bulk": 1}),
        **kw).generate()
    assert sc.stream_bytes(a) == ref_sc.stream_bytes(b)
    burst = sum(1 for e in a if e.turn == 0 and 10 <= e.time_s < 20)
    assert burst > 3 * sum(1 for e in a if e.turn == 0
                           and not 10 <= e.time_s < 20)


def test_multi_turn_sessions_share_tenant_prefix():
    s = _mini(sc, seed=3, duration=2.0, turns=3.0, prefix=6, think=0.2)
    events = s.generate()
    assert any(e.turn > 0 for e in events)
    by_tenant = {}
    for e in events:
        assert e.prefix_len == 6
        assert e.prompt[:6] == s.tenant_prefix(e.tenant)
        by_tenant.setdefault(e.tenant, set()).add(e.prompt[:6])
    assert all(len(v) == 1 for v in by_tenant.values())
    assert len(set(frozenset(v) for v in by_tenant.values())) == 2
    assert all(e.think_s > 0 for e in events if e.turn > 0)
    assert all(e.think_s == 0 for e in events if e.turn == 0)
    ref = _mini(ref_sc, seed=3, duration=2.0, turns=3.0, prefix=6,
                think=0.2)
    assert [s.tenant_prefix(t) for t in ("inter", "bulk")] == \
        [ref.tenant_prefix(t) for t in ("inter", "bulk")]


def test_arrival_processes():
    """The reference's bounds, and the reference's times for the same
    generator state."""
    for mod_a, mod_b in ((sc, ref_sc),):
        for make in (lambda m: m.PoissonArrivals(50.0),
                     lambda m: m.MMPPArrivals([(1.0, 1.0), (50.0, 1.0),
                                               (1.0, 1.0)]),
                     lambda m: m.TraceArrivals([0.5, 0.25])):
            ta = make(mod_a).times(random.Random(0), 3.0)
            tb = make(mod_b).times(random.Random(0), 3.0)
            assert ta == tb
    times = sc.PoissonArrivals(50.0).times(random.Random(0), 1.0)
    assert times == sorted(times) and all(0 <= t < 1.0 for t in times)
    times = sc.MMPPArrivals([(1.0, 1.0), (50.0, 1.0), (1.0, 1.0)]).times(
        random.Random(0), 3.0)
    burst = sum(1 for t in times if 1.0 <= t < 2.0)
    assert burst > 5 * max(1, len(times) - burst)
    tr = sc.TraceArrivals([0.5, 0.25]).times(random.Random(0), 2.0)
    assert tr == pytest.approx([0.5, 0.75, 1.25, 1.5])
    with pytest.raises(ValueError):
        sc.TraceArrivals([0.0, 0.0])


def test_length_mixture_bounds():
    spec = [(0.5, ("lognormal", 3.0, 0.8, 40)), (0.3, ("uniform", 2, 9)),
            (0.2, ("point", 7))]
    ra, rb = random.Random(0), random.Random(0)
    samples = [sc.LengthMixture(spec).sample(ra) for _ in range(500)]
    assert samples == [ref_sc.LengthMixture(spec).sample(rb)
                       for _ in range(500)]
    assert all(1 <= s <= 40 for s in samples)
    assert sc.LengthMixture.point(0).sample(ra) == 1
    sa = sc.TenantMix({"a": 1.0, "b": 3.0})
    sb = sc.TenantMix({"b": 3.0, "a": 1.0})
    ra, rb = random.Random(1), random.Random(1)
    assert ([sa.sample(ra) for _ in range(50)]
            == [sb.sample(rb) for _ in range(50)])


# ---------------------------------------------------------------------------
# replay driver (virtual time, stub target), both packages
# ---------------------------------------------------------------------------


class _StubHandle:
    def __init__(self):
        self.done = False
        self.finish_reason = ""


class _StubTarget:
    def __init__(self, reject_after=None):
        self.submitted = []
        self.reject_after = reject_after

    def submit(self, prompt, **kw):
        if (self.reject_after is not None
                and len(self.submitted) >= self.reject_after):
            raise RuntimeError("backpressure")
        h = _StubHandle()
        self.submitted.append((prompt, kw, h))
        return h


@pytest.mark.parametrize("mod,_", PKGS, ids=PKG_IDS)
def test_replay_timing_contract(mod, _):
    """Turn 0 fires at its nominal time; turn k fires think_s after turn
    k-1 ACTUALLY completed."""
    events = [
        mod.Event(time_s=1.0, session=0, turn=0, tenant="a",
                  prompt=(1, 2), max_new_tokens=4),
        mod.Event(time_s=1.1, session=0, turn=1, tenant="a",
                  prompt=(3,), max_new_tokens=4, think_s=0.5),
    ]
    tgt = _StubTarget()
    drv = mod.ReplayDriver(tgt, events, submit_kw={"deadline_s": 9.0})
    assert drv.tick(0.99) == 0 and not tgt.submitted
    assert drv.tick(1.0) == 1
    assert drv.tick(5.0) == 0
    tgt.submitted[0][2].done = True
    assert drv.tick(5.0) == 0
    assert drv.tick(5.49) == 0
    assert drv.tick(5.5) == 1
    assert drv.exhausted and not drv.done
    tgt.submitted[1][2].done = True
    assert drv.done
    _, kw, _ = tgt.submitted[0]
    assert kw == {"deadline_s": 9.0, "max_new_tokens": 4, "tenant": "a"}
    assert drv.result() == {"fired": 2, "completed": 2, "failed": 0,
                            "failures": [], "rejected": 0,
                            "outstanding": 0}


def test_replay_counts_rejections_and_metrics():
    """Both drivers on one stream and one refusing target give the same
    counts, result and metric families."""
    snaps = []
    for mod, _ in PKGS:
        events = _mini(mod, seed=1).generate()
        tgt = _StubTarget(reject_after=3)
        drv = mod.ReplayDriver(tgt, events)
        drv.tick(1e9)
        assert len(drv.rejected) == len(events) - 3
        assert drv.result()["rejected"] == len(events) - 3
        snaps.append((drv.result(), drv.metrics_snapshot()))
    (res_ref, ref), (res, snap) = snaps
    assert res == res_ref
    assert snap["cloud_server_scenario_events_fired_total"]["value"] == 3
    for fam in ("cloud_server_scenario_events_fired_total",
                "cloud_server_scenario_events_rejected_total",
                "cloud_server_scenario_sessions_total"):
        assert snap[fam]["value"] == ref[fam]["value"]
    assert "cloud_server_scenario_replay_lag_ms" in snap
    assert set(snap) == set(ref)


# ---------------------------------------------------------------------------
# discrete-event simulator
# ---------------------------------------------------------------------------

RECORDS = [
    [{"tokens_scheduled": 10, "duration_ms": 3.0},
     {"tokens_scheduled": 30, "duration_ms": 5.0},
     {"tokens_scheduled": 50, "duration_ms": 7.0}],
    [],
    [{"tokens_scheduled": 8, "duration_ms": 4.0},
     {"tokens_scheduled": 8, "duration_ms": 6.0}],
    [{"tokens_scheduled": 0, "duration_ms": 1.0},
     {"tokens_scheduled": 40, "duration_ms": 1.0},
     {"tokens_scheduled": 4, "duration_ms": 9.0}],
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_cost_model_fit(i):
    got = sc.CostModel.fit(RECORDS[i])
    want = ref_sc.CostModel.fit(RECORDS[i])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if i == 0:
        assert got.per_token_ms == pytest.approx(0.1)
        assert got.fixed_ms == pytest.approx(2.0)
        assert got.iteration_ms(100) == pytest.approx(12.0)


def _drr_case(mod, simreq):
    """The reference test's replica cases: weighted admission, the
    radix prefix skip, page-pool preemption; returns what they read."""
    def ev(sid, tenant, pfx=0, plen=8, out=2):
        return mod.Event(time_s=0.0, session=sid, turn=0, tenant=tenant,
                         prompt=tuple(range(1, plen + 1)),
                         max_new_tokens=out, prefix_len=pfx)
    r = mod.SimReplica(max_slots=1, budget=64, chunk=16, page_size=8,
                       class_weights={"interactive": 4.0, "batch": 1.0})
    b = simreq(ev(0, "bulk"), "batch", 0.0)
    i = simreq(ev(1, "inter"), "interactive", 0.0)
    r.submit(b, 0.0)
    r.submit(i, 0.0)
    r.step(mod.CostModel())
    r2 = mod.SimReplica(max_slots=4, budget=64, chunk=64, page_size=8)
    s1 = simreq(ev(0, "inter", pfx=6, plen=8), "default", 0.0)
    s2 = simreq(ev(1, "inter", pfx=6, plen=8), "default", 0.0)
    r2.submit(s1, 0.0)
    r2.submit(s2, 0.0)
    r2._admit(0.0)
    r3 = mod.SimReplica(max_slots=4, budget=64, chunk=64, page_size=8,
                        pages=1)
    a1 = simreq(ev(0, None), "default", 0.0)
    a2 = simreq(ev(1, None), "default", 0.0)
    r3.submit(a1, 0.0)
    r3.submit(a2, 0.0)
    r3.step(mod.CostModel())
    return (r.active[0] is i, s1.prefill_left, s2.prefill_left,
            r3.preemptions, a2.preempted, r.t, r3.t)


def test_sim_replica_drr_prefix_and_preemption():
    got = _drr_case(sc, _SimReq)
    assert got == _drr_case(ref_sc, RefSimReq)
    assert got[:3] == (True, 8, 2)
    assert got[3] >= 1 and got[4] >= 1


SLO = {"windows_s": [2, 10],
       "classes": {"default": {"objective": 0.9, "ttft_s": 1.0,
                               "e2e_s": 5.0},
                   "interactive": {"objective": 0.9, "ttft_s": 0.5,
                                   "queue_wait_s": 0.4, "e2e_s": 2.0},
                   "batch": {"objective": 0.5, "ttft_s": 0.5,
                             "queue_wait_s": 0.4, "e2e_s": 2.0}}}


def _fleet_report(mod, events, cost, n=2, tenant_class=None, **rkw):
    sim = mod.FleetSim(
        [mod.SimReplica(**{**dict(max_slots=4, budget=64, chunk=16,
                                  page_size=8), **rkw})
         for _ in range(n)],
        cost=mod.CostModel(**cost), slo=SLO, tenant_class=tenant_class)
    return sim.run(events)


@pytest.mark.parametrize("pages", [None, 6], ids=["pool", "tight_pool"])
def test_fleet_sim_serves_every_event(pages):
    """The simulated fleet serves every event, and its whole report
    (latencies, iterations, preemptions, SLO attainment and burn) equals
    the reference's on the same events."""
    cost = dict(fixed_ms=2.0, per_token_ms=0.1)
    tc = {"inter": "interactive", "bulk": "batch"}
    got = _fleet_report(sc, _mini(sc, seed=2, duration=2.0, rate=30.0,
                                  turns=2.0, prefix=4,
                                  think=0.05).generate(),
                        cost, tenant_class=tc, pages=pages)
    want = _fleet_report(ref_sc, _mini(ref_sc, seed=2, duration=2.0,
                                       rate=30.0, turns=2.0, prefix=4,
                                       think=0.05).generate(),
                         cost, tenant_class=tc, pages=pages)
    assert got == want
    n = len(_mini(sc, seed=2, duration=2.0, rate=30.0, turns=2.0,
                  prefix=4, think=0.05).generate())
    assert got["finished"] == n
    assert got["iterations"] > 0 and got["sim_duration_s"] > 0
    total = sum(c["metrics"]["e2e"]["lifetime"]["total"]
                for c in got["slo"]["classes"].values())
    assert total == n


def test_sim_calibrated_from_live_port_server(params):
    """A live replay against a port server fires every event and loses
    none; the cost model fitted from its flight records, and both
    simulators run on it, give equal reports (the calibration gap itself
    is read on the card)."""
    qos = {"quantum": 16,
           "tenants": {"inter": {"weight": 4.0, "priority": "interactive"},
                       "bulk": {"weight": 1.0, "priority": "batch"}}}
    slo = {k: SLO[k] for k in ("windows_s",)}
    slo["classes"] = {k: SLO["classes"][k]
                      for k in ("interactive", "batch")}
    srv = _server(params, qos=qos, slo=slo)
    events = _mini(sc, seed=5, duration=0.8, rate=40.0).generate()
    assert len(events) >= 10
    drv = sc.ReplayDriver(srv, events)
    res = drv.run(step=srv.step, timeout_s=300.0)
    srv.run_until_idle()
    assert res["fired"] == len(events)
    assert res["failed"] == 0 and res["rejected"] == 0
    assert res["completed"] == len(events)
    live = srv.slo_report()
    records = srv.flight_window()
    cost = sc.CostModel.fit(records)
    assert dataclasses.asdict(cost) == dataclasses.asdict(
        ref_sc.CostModel.fit(records))
    assert cost.fixed_ms > 0
    srv.stop()
    reports = []
    for mod in (sc, ref_sc):
        sim = mod.FleetSim(
            [mod.SimReplica(max_slots=PAGED_KW["max_slots"],
                            budget=PAGED_KW["prefill_chunk"]
                            + PAGED_KW["max_slots"],
                            chunk=PAGED_KW["prefill_chunk"],
                            page_size=PAGED_KW["page_size"],
                            class_weights={"interactive": 4.0,
                                           "batch": 1.0})],
            cost=mod.CostModel(**dataclasses.asdict(cost)), slo=slo,
            tenant_class={"inter": "interactive", "bulk": "batch"})
        reports.append(sim.run(_mini(mod, seed=5, duration=0.8,
                                     rate=40.0).generate()))
    assert reports[0] == reports[1]
    assert reports[0]["finished"] == len(events)
    for cls in ("interactive", "batch"):
        lv = live["classes"][cls]["metrics"]["e2e"]["lifetime"]
        sv = reports[0]["slo"]["classes"][cls]["metrics"]["e2e"]["lifetime"]
        assert lv["total"] == sv["total"]


# ---------------------------------------------------------------------------
# autoscaler policy (scripted routers, virtual clock), both packages
# ---------------------------------------------------------------------------


class _FakeReplica:
    def __init__(self):
        self.num_active = 0
        self.num_pending = 0
        self.stopped = False

    def stop(self):
        self.stopped = True


class _FakeRouter:
    """The surface SLOBurnAutoscaler reads and actuates, nothing more."""

    def __init__(self, registry_cls, n=1, disagg=False):
        self._registry = registry_cls()
        self.replicas = [_FakeReplica() for _ in range(n)]
        self.roles = ["colocated"] * n
        self._disagg = disagg
        self.num_pending = 0
        self.report = None
        self.removed = []

    def attached_indices(self):
        return list(range(len(self.replicas)))

    def slo_report(self):
        return self.report

    def add_replica(self, replica, *, role="colocated"):
        self.replicas.append(replica)
        self.roles.append(role)
        return len(self.replicas) - 1

    def remove_replica(self, i, *, migrate=True, timeout=None):
        r = self.replicas.pop(i)
        self.roles.pop(i)
        self.removed.append(r)
        return r


def _burn_report(fast, slow, cls="interactive", metric="ttft",
                 windows=(5.0, 60.0)):
    return {"windows_s": list(windows),
            "classes": {cls: {"objective": 0.9, "metrics": {metric: {
                "windows": {f"{windows[0]:g}": {"burn_rate": fast},
                            f"{windows[-1]:g}": {"burn_rate": slow}},
                "lifetime": {}}}}}}


def _asc(mod, router, spares=2, **cfg_kw):
    pool = [_FakeReplica() for _ in range(spares)]
    cfg = mod.AutoscalerConfig(**{**dict(
        min_replicas=1, max_replicas=3, hold_s=10.0, poll_s=1.0,
        pending_high=8.0, pending_low=1.0), **cfg_kw})
    return mod.SLOBurnAutoscaler(
        router, spawn=lambda role: pool.pop() if pool else None,
        config=cfg), pool


def _script_multiwindow(mod, reg):
    r = _FakeRouter(reg)
    asc, _ = _asc(mod, r)
    out = []
    r.report = _burn_report(fast=5.0, slow=0.2)
    out.append(asc.step(now=100.0))
    r.report = _burn_report(fast=5.0, slow=2.0)
    for now in (101.0, 101.5, 105.0, 112.0, 130.0):
        out.append(asc.step(now=now))
    return out, asc, r


def _script_pending(mod, reg):
    r = _FakeRouter(reg)
    asc, _ = _asc(mod, r)
    r.num_pending = 20
    return [asc.step(now=10.0)], asc, r


def _script_down(mod, reg):
    r = _FakeRouter(reg, n=3)
    asc, _ = _asc(mod, r, spares=0)
    r.report = _burn_report(fast=0.0, slow=0.0)
    out = [asc.step(now=t) for t in (50.0, 51.0, 70.0, 90.0)]
    assert all(x.stopped for x in r.removed)
    return out, asc, r


def _script_blocked(mod, reg):
    r = _FakeRouter(reg)
    asc, pool = _asc(mod, r, spares=0)
    r.report = _burn_report(fast=5.0, slow=5.0)
    out = [asc.step(now=10.0)]
    pool.append(_FakeReplica())
    out.append(asc.step(now=10.5))
    r2 = _FakeRouter(reg, n=2)
    asc2, _ = _asc(mod, r2, spares=0)
    r2.remove_replica = lambda i, migrate=True, timeout=None: None
    r2.report = _burn_report(fast=0.0, slow=0.0)
    out.append(asc2.step(now=10.0))
    return out + [e.to_json() for e in asc2.events], asc, r


def _script_roles(mod, reg):
    r = _FakeRouter(reg, disagg=True)
    asc, _ = _asc(mod, r)
    r.report = _burn_report(fast=5.0, slow=5.0, metric="ttft")
    asc.step(now=10.0)
    r.report = _burn_report(fast=5.0, slow=5.0, metric="itl")
    asc.step(now=30.0)
    rc = _FakeRouter(reg, disagg=False)
    ascc, _ = _asc(mod, rc)
    rc.report = _burn_report(fast=5.0, slow=5.0, metric="ttft")
    ascc.step(now=10.0)
    return list(r.roles) + list(rc.roles), asc, r


SCRIPTS = {"multiwindow_up_and_cooldown": _script_multiwindow,
           "pending_backstop_needs_no_slo": _script_pending,
           "scale_down_idle_and_min_clamp": _script_down,
           "blocked_paths": _script_blocked,
           "role_awareness": _script_roles}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_autoscaler_decisions_equal_reference(name):
    """Each reference policy case, scripted on a fake router and a
    virtual clock: the port's autoscaler takes the reference's actions,
    in the same order, with the same events (reasons included) and
    stats."""
    runs = [SCRIPTS[name](mod, reg) for mod, reg in PKGS]
    (want, ref_asc, ref_r), (got, asc, r) = runs
    assert got == want
    assert [e.to_json() for e in asc.events] == \
        [e.to_json() for e in ref_asc.events]
    assert asc.stats() == ref_asc.stats()
    assert r.roles == ref_r.roles
    expect = {"multiwindow_up_and_cooldown":
              ["hold", "up", "hold", "hold", "up", "hold"],
              "pending_backstop_needs_no_slo": ["up"],
              "scale_down_idle_and_min_clamp":
              ["down", "hold", "down", "hold"]}
    if name in expect:
        assert got == expect[name]
    if name == "pending_backstop_needs_no_slo":
        assert asc.events[-1].reason.startswith("pending/replica")


def test_autoscaler_metric_families_registered_eagerly():
    names = []
    for mod, reg in PKGS:
        r = _FakeRouter(reg)
        mod.SLOBurnAutoscaler(r, spawn=lambda role: None)
        assert r.autoscaler is not None
        names.append({n.split("{")[0] for n in r._registry.snapshot()})
    assert names[1] == names[0]
    for fam in ("cloud_server_autoscaler_scale_up_total",
                "cloud_server_autoscaler_scale_down_total",
                "cloud_server_autoscaler_scale_blocked_total",
                "cloud_server_autoscaler_replicas",
                "cloud_server_autoscaler_burn_fast",
                "cloud_server_autoscaler_burn_slow",
                "cloud_server_autoscaler_pending_per_replica"):
        assert fam in names[1], fam


# ---------------------------------------------------------------------------
# live: a fleet of port servers, HTTP, and the dispatch discipline
# ---------------------------------------------------------------------------


def test_scale_down_drain_race_loses_nothing(params):
    """Scale-down mid-flood: the victim still holds in-flight work when
    the autoscaler removes it; drain(migrate=True) moves every request
    and the client sees zero losses."""
    router = ReplicatedRouter([_server(params), _server(params)])
    released = []
    asc = sc.SLOBurnAutoscaler(
        router, spawn=lambda role: None, release=released.append,
        config=sc.AutoscalerConfig(min_replicas=1, max_replicas=2,
                                   hold_s=0.0, pending_low=100.0,
                                   drain_timeout_s=60.0))
    reqs = [router.submit([5, 9, 3], max_new_tokens=6) for _ in range(8)]
    router.step()
    assert all(r.num_active + r.num_pending > 0 for r in router.replicas)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            router.step()
            time.sleep(0.002)

    stepper = threading.Thread(target=pump, daemon=True)
    stepper.start()
    try:
        assert asc.step(now=1.0) == "down"
        assert len(router.attached_indices()) == 1
        deadline = time.monotonic() + 120.0
        while (not all(r.done for r in reqs)
               and time.monotonic() < deadline):
            time.sleep(0.01)
    finally:
        stop.set()
        stepper.join(timeout=30)
    assert all(r.done for r in reqs)
    assert all(len(r.tokens) == 6 for r in reqs), (
        [(len(r.tokens), r.finish_reason) for r in reqs])
    assert not any(str(r.finish_reason).startswith("error") for r in reqs)
    assert released and released[0].num_active == 0
    assert asc.stats()["scale_down_total"] == 1
    released[0].stop()
    router.stop()


def test_replay_over_http_target(params):
    """The same stream through the port's HTTP frontend over the wire
    (`HttpTarget`, X-Tenant headers): every event fired and completed,
    with the in-process server's tokens."""
    events = _mini(sc, seed=4, duration=0.5, rate=20.0,
                   turns=2.0, think=0.01).generate()
    srv = _server(params).start()
    front = HttpFrontend(srv, tokenizer=ByteTokenizer()).start()
    try:
        host, port = front.address
        drv = sc.ReplayDriver(sc.HttpTarget(f"http://{host}:{port}",
                                            timeout_s=120.0), events)
        res = drv.run(speed=1.0, timeout_s=240.0)
    finally:
        front.stop()
        srv.stop()
    assert res["fired"] == len(events) and res["completed"] == len(events)
    assert res["failed"] == 0 and res["rejected"] == 0
    assert all(h.finish_reason == "length" for _, h in drv.handles)


def test_replay_driven_step_dispatch_and_sync_count(params):
    """The harness drives the unconfigured serving path unchanged:
    firing replayed events between steps keeps each iteration under
    admission churn at one program launch and one sync (the port's
    counters, overlap off, as the reference's guard counts)."""
    srv = _server(params, scheduler="mixed", overlap=False)
    warm = srv.submit([5, 9, 3, 1], max_new_tokens=40)
    srv.step()
    assert srv.num_active == 1
    events = [sc.Event(time_s=0.1 * k, session=k, turn=0, tenant=None,
                       prompt=tuple([(k * 7 + j) % 60 + 1
                                     for j in range(20)]),
                       max_new_tokens=3)
              for k in range(6)]
    drv = sc.ReplayDriver(srv, events)
    now = 0.0
    steps = churn_steps = 0
    while (not drv.done or srv._jobs or srv.num_pending
           or srv.num_active):
        drv.tick(now)
        churn = bool(srv._jobs or srv.num_pending)
        before = (graphs.launches, graphs.syncs)
        srv.step()
        if churn:
            churn_steps += 1
            assert graphs.launches - before[0] == 1, \
                "a replay-driven iteration stays one program launch"
            assert graphs.syncs - before[1] == 1, \
                "a replay-driven iteration stays one sync"
        now += 0.1
        steps += 1
        assert steps < 300
    assert churn_steps >= 2
    assert warm.done
    assert drv.result()["completed"] == len(events)
    assert drv.result()["failed"] == 0
