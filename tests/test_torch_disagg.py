"""The port's disaggregated prefill/decode serving (mirroring
tests/test_disagg.py case for case): role validation and the colocated
default, the role planner and role-aware placement (each stub case run
through the reference's router and the port's alike), then the handoff
end to end on port servers: the reference's tokens, one gap-free span
tree per request, the handoff prefetch's pages, decode where the
request prefilled when no decode replica can import, QoS-class
handoffs and prompt tokens billed once."""

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
from cloud_server_tpu.inference.qos import (
    TenantQueueFullError as RefTenantQueueFullError)
from cloud_server_tpu.inference.qos import (
    TenantRegistry as RefTenantRegistry)
from cloud_server_tpu.inference.router import (
    ReplicatedRouter as RefRouter)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference.http_server import HttpFrontend
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.qos import (TenantQueueFullError,
                                                  TenantRegistry)
from cloud_server_tpu_torch.inference.router import (ROLE_COLOCATED,
                                                     ROLE_DECODE,
                                                     ROLE_PREFILL,
                                                     ReplicatedRouter)
from cloud_server_tpu_torch.models.transformer import params_from_numpy
from tests.test_torch_migration import _assert_gap_free

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
TCFG = TModelConfig(**dataclasses.asdict(CFG))
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
SRV_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])
LONG = [(i * 7) % 60 + 1 for i in range(30)]
MID = [3, 1, 4, 1, 5, 9, 2, 6]
ROUTERS = [RefRouter, ReplicatedRouter]
ROUTER_IDS = ["ref", "port"]


@pytest.fixture(scope="module")
def weights():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), TCFG,
                                  device="cpu")


def _port(weights, **kw):
    return PagedInferenceServer(
        weights[1], TCFG, TInferConfig(**dataclasses.asdict(GREEDY)),
        device="cpu", **{**SRV_KW, **kw})


def _ref(weights, **kw):
    return RefServer(weights[0], CFG, GREEDY, **{**SRV_KW, **kw})


def _drive(router, reqs, deadline_s=90.0):
    deadline = time.time() + deadline_s
    while not all(r.done for r in reqs) and time.time() < deadline:
        router.step()
        time.sleep(0.001)
    assert all(r.done for r in reqs), \
        [(r.request_id, len(r.tokens), r.finish_reason) for r in reqs]


def _counter(router, name):
    entry = router.metrics_snapshot().get(f"cloud_server_{name}")
    return 0.0 if entry is None else entry["value"]


class _Stub:
    """Minimal replica for placement tests: load knobs, no device."""

    def __init__(self, active=0, pending=0, prefill_tokens=None):
        self.num_active = active
        self.num_pending = pending
        if prefill_tokens is not None:
            self.pending_prefill_tokens = prefill_tokens
        self.got = []

    def submit(self, prompt, **kw):
        self.got.append(prompt)
        return prompt

    def stop(self, *a, **kw):
        pass


# ---------------------------------------------------------------------------
# role plumbing: validation, colocated default, planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router_cls", ROUTERS, ids=ROUTER_IDS)
def test_role_validation(router_cls):
    with pytest.raises(ValueError, match="entries for"):
        router_cls([_Stub(), _Stub()], roles=["prefill"])
    with pytest.raises(ValueError, match="unknown replica role"):
        router_cls([_Stub(), _Stub()], roles=["prefill", "chonk"])
    with pytest.raises(ValueError, match="prefill.*decode"):
        router_cls([_Stub(), _Stub()], roles=["prefill", "prefill"])
    r = router_cls([_Stub(), _Stub(), _Stub()],
                   roles=[ROLE_PREFILL, ROLE_COLOCATED, ROLE_DECODE])
    assert r._disagg
    assert r.replica_roles() == ["prefill", "colocated", "decode"]
    r.stop()


@pytest.mark.parametrize("router_cls", ROUTERS, ids=ROUTER_IDS)
def test_colocated_default_has_no_disagg_machinery(router_cls):
    r = router_cls([_Stub(), _Stub()])
    assert r.replica_roles() == [ROLE_COLOCATED, ROLE_COLOCATED]
    assert not r._disagg
    assert r._handoff_thread is None and r._handoff_q is None
    assert r._plan_roles(None) == (None, False)
    assert r._plan_roles("anyone") == (None, False)
    assert [st["role"] for st in r.breaker_states()] == \
        ["colocated", "colocated"]
    assert _counter(r, "router_handoffs_total") == 0
    assert _counter(r, "router_handoff_success_total") == 0


@pytest.mark.parametrize("router_cls", ROUTERS, ids=ROUTER_IDS)
def test_plan_roles_by_qos_class(router_cls):
    class _Q:
        def resolve(self, t):
            return t or "default"

        def priority_class(self, t):
            return {"bg": "batch", "scraper": "best_effort"}.get(
                t, "interactive")

    stub0 = _Stub()
    stub0.qos = _Q()
    r = router_cls([stub0, _Stub()], roles=["prefill", "decode"])
    assert r._plan_roles("fg") == (ROLE_PREFILL, True)
    assert r._plan_roles(None) == (ROLE_PREFILL, True)
    assert r._plan_roles("bg") == (ROLE_PREFILL, False)
    assert r._plan_roles("scraper") == (ROLE_PREFILL, False)
    r.stop()


# ---------------------------------------------------------------------------
# role-aware _pick
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router_cls", ROUTERS, ids=ROUTER_IDS)
def test_pick_prefill_balances_by_pending_prefill_tokens(router_cls):
    p0 = _Stub(active=0, pending=6, prefill_tokens=24)
    p1 = _Stub(active=0, pending=1, prefill_tokens=900)
    d = _Stub(active=0, pending=0, prefill_tokens=0)
    r = router_cls([p0, p1, d], roles=["prefill", "prefill", "decode"])
    for _ in range(4):
        r.submit([1, 2, 3])
    assert len(p0.got) == 4 and not p1.got and not d.got
    legacy = _Stub(active=1, pending=1)
    assert router_cls._prefill_load(legacy) == 2
    assert router_cls._prefill_load(p1) == 900
    r.stop()


@pytest.mark.parametrize("router_cls", ROUTERS, ids=ROUTER_IDS)
def test_pick_decode_prefers_decode_replicas(router_cls):
    p = _Stub(active=0, pending=0, prefill_tokens=0)
    d0, d1 = _Stub(active=3), _Stub(active=1)
    r = router_cls([p, d0, d1], roles=["prefill", "decode", "decode"])
    with r._lock:
        picks = [r._pick(role=ROLE_DECODE) for _ in range(3)]
    assert picks == [2, 2, 2]
    r.stop()


@pytest.mark.parametrize("router_cls", ROUTERS, ids=ROUTER_IDS)
def test_pick_role_falls_back_past_unhealthy_role(router_cls):
    p, d = _Stub(), _Stub()
    r = router_cls([p, d], roles=["prefill", "decode"],
                   breaker_threshold=1, breaker_reset_s=60.0)
    r._record_breaker_failure(1)
    assert r.breaker_states()[1]["state"] == "open"
    with r._lock:
        assert r._pick(role=ROLE_DECODE) == 0
    r._record_breaker_success(1)
    r._record_breaker_failure(0)
    with r._lock:
        assert r._pick(role=ROLE_PREFILL) == 1
    r._record_breaker_failure(1)
    with r._lock:
        assert r._pick(role=ROLE_PREFILL) is not None
    r.stop()


# ---------------------------------------------------------------------------
# handoff end to end
# ---------------------------------------------------------------------------


HANDOFF_PROMPTS = [LONG, MID, [7, 7, 2, 11, 30]]


def _handoff_fleet(mk, router_cls, weights):
    rp, rd = mk(weights, tracing=1.0), mk(weights, tracing=1.0)
    router = router_cls([rp, rd], roles=["prefill", "decode"])
    streams = [[] for _ in HANDOFF_PROMPTS]
    reqs = [router.submit(p, max_new_tokens=32, stream=st.append)
            for p, st in zip(HANDOFF_PROMPTS, streams)]
    _drive(router, reqs)
    return router, rp, rd, reqs, streams


def test_handoff_e2e_token_exact_and_one_tree(weights):
    """1 prefill + 1 decode port replica: every stream equals a lone
    reference server's (and the reference fleet's), each request's
    spans form one gap-free tree across both replicas, the decode
    replica generated the tokens after the handoff, and the exports
    took prefetched pages."""
    lone = _ref(weights)
    refs = [lone.generate([p], max_new_tokens=32)[0]
            for p in HANDOFF_PROMPTS]
    router, rp, rd, reqs, streams = _handoff_fleet(
        _port, ReplicatedRouter, weights)
    for r, ref, st in zip(reqs, refs, streams):
        assert r.finish_reason == "length"
        assert list(r.tokens) == ref
        assert st == ref
    assert _counter(router, "router_handoffs_total") == 3
    assert _counter(router, "router_handoff_success_total") == 3
    assert rp.tokens_emitted > 0 and rd.tokens_emitted > 0
    # the prefetch ran under each final chunk: its pages are a share of
    # the pages the exports moved
    moved = router.migration_stats()["pages_moved"]
    assert 0 < rp.handoff_prefetched_pages <= moved
    assert not rp._handoff_stash

    # the reference fleet: the same tokens and the same completed and
    # failed counts (how many tokens and pages each export carried
    # depends on when the router's handoff thread ran)
    rrouter, _, _, rreqs, _ = _handoff_fleet(_ref, RefRouter, weights)
    assert [r.tokens for r in reqs] == [r.tokens for r in rreqs]
    keys = ("out_started", "out_completed", "out_failed", "in_started",
            "in_completed", "in_failed", "success_rate")
    got, want = router.migration_stats(), rrouter.migration_stats()
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    rrouter.stop()

    trees = router.trace_trees()
    by_req = {}
    for t in trees:
        by_req.setdefault(t["request_id"], []).append(t)
    spans = []
    for r in reqs:
        ts = by_req.get(r.request_id, [])
        assert len(ts) == 1, f"{r.request_id}: {len(ts)} trees"
        sp = [c for c in ts[0]["root"]["children"]
              if c["name"] == "handoff"]
        assert len(sp) == 1
        spans.append(sp[0])
    for sp in spans:
        assert sp["tags"]["from_replica"] == 0
        assert sp["tags"]["replica"] == 1
        assert sp["tags"]["kv_pages"] >= 0
    for t in trees:
        if t["root"]["end"] is not None:
            _assert_gap_free(t)
    assert [st["role"] for st in router.breaker_states()] == \
        ["prefill", "decode"]
    recs = router.flight_window(4)
    assert recs and all(rec["role"] in ("prefill", "decode")
                        for rec in recs)
    payload = HttpFrontend(router)._stats_json(0)
    assert payload["roles"] == ["prefill", "decode"]
    snap = router.metrics_snapshot()
    assert snap["cloud_server_router_replica_role"
                '{replica="0",role="prefill"}']["value"] == 1
    assert snap["cloud_server_router_replica_role"
                '{replica="1",role="decode"}']["value"] == 1
    router.stop()


def test_handoff_without_decode_capacity_stays_local(weights):
    lone = _ref(weights)
    ref = lone.generate([MID], max_new_tokens=12)[0]
    rp = _port(weights)
    d = _Stub()
    router = ReplicatedRouter([rp, d], roles=["prefill", "decode"])
    req = router.submit(MID, max_new_tokens=12)
    deadline = time.time() + 60
    while not req.done and time.time() < deadline:
        rp.step()
        time.sleep(0.001)
    assert req.done and list(req.tokens) == ref
    assert _counter(router, "router_handoffs_total") == 0
    router.stop()


QOS = {"tenants": {"bg": {"priority": "batch", "weight": 1.0},
                   "fg": {"priority": "interactive", "weight": 8.0}}}


def test_batch_flood_decodes_on_prefill_interactive_hands_off(weights):
    rp = _port(weights, tracing=1.0, qos=QOS)
    rd = _port(weights, tracing=1.0, qos=QOS)
    router = ReplicatedRouter([rp, rd], roles=["prefill", "decode"])
    flood = [router.submit(LONG, max_new_tokens=10, tenant="bg")
             for _ in range(6)]
    fgs = [router.submit(MID, max_new_tokens=32, tenant="fg")
           for _ in range(2)]
    _drive(router, flood + fgs)
    assert all(r.finish_reason == "length" for r in flood + fgs)
    handoff_of = {}
    for t in router.trace_trees():
        for c in t["root"]["children"]:
            if c["name"] == "handoff":
                handoff_of[t["request_id"]] = c
    assert all(r.request_id in handoff_of for r in fgs)
    assert not any(r.request_id in handoff_of for r in flood)
    lone = _ref(weights)
    assert [r.tokens for r in fgs] == \
        lone.generate([MID], max_new_tokens=32) * 2
    router.stop()


# ---------------------------------------------------------------------------
# continuation admission bills no prompt tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "reg_cls,err", [(RefTenantRegistry, RefTenantQueueFullError),
                    (TenantRegistry, TenantQueueFullError)], ids=ROUTER_IDS)
def test_gate_submit_charge_tokens_override(reg_cls, err):
    reg = reg_cls({"tenants": {
        "t": {"prompt_tokens_per_s": 1.0, "prompt_burst": 40.0,
              "max_pending": 4}}})
    lvl0 = reg._state("t").prompt_bucket.level()
    reg.gate_submit("t", 100, charge_tokens=0)
    assert reg._state("t").prompt_bucket.level() == \
        pytest.approx(lvl0, abs=1e-3)
    reg.gate_submit("t", 10)
    assert reg._state("t").prompt_bucket.level() == \
        pytest.approx(lvl0 - 10, abs=1e-3)
    with pytest.raises(ValueError, match="burst"):
        reg.gate_submit("t", 100)
    reg.gate_submit("t", 5, charge_tokens=0)
    reg.gate_submit("t", 5, charge_tokens=0)
    with pytest.raises(err):
        reg.gate_submit("t", 5, charge_tokens=0)


def test_handoff_bills_prompt_tokens_exactly_once(weights):
    qos = {"tenants": {"t": {"prompt_tokens_per_s": 0.001,
                             "prompt_burst": 400.0}}}
    rp = _port(weights, qos=qos)
    rd = _port(weights, qos=qos)
    router = ReplicatedRouter([rp, rd], roles=["prefill", "decode"])
    req = router.submit(LONG, max_new_tokens=32, tenant="t")
    _drive(router, [req])
    assert req.finish_reason == "length"
    assert _counter(router, "router_handoff_success_total") == 1
    spent = sum(400.0 - srv.qos._state("t").prompt_bucket.level()
                for srv in (rp, rd))
    assert spent == pytest.approx(len(LONG), abs=0.5)
    assert router.tenant_stats()["t"]["submitted"] == 2
    router.stop()


def test_disagg_soak_mixed_fleet_with_drain(weights):
    """2 prefill + 2 decode port replicas under an interactive and
    batch mix, one decode replica drained mid-run: handed-off requests
    move again, everything finishes by length, one tree per request and
    no unmerged handoff continuation."""
    qos = {"tenants": {"fg": {"priority": "interactive", "weight": 4.0},
                       "bg": {"priority": "batch", "weight": 1.0}}}
    srvs = [_port(weights, tracing=1.0, qos=qos) for _ in range(4)]
    router = ReplicatedRouter(
        srvs, roles=["prefill", "prefill", "decode", "decode"])
    try:
        bgs = [router.submit(LONG, max_new_tokens=6, tenant="bg")
               for _ in range(6)]
        fgs = [router.submit(MID, max_new_tokens=32, tenant="fg")
               for _ in range(8)]
        for _ in range(6):
            router.step()
        router.drain(2, migrate=True)
        _drive(router, bgs + fgs, deadline_s=120)
        assert all(r.finish_reason == "length" for r in bgs + fgs)
        assert _counter(router, "router_handoff_success_total") >= 1
        trees = router.trace_trees()
        by_id = {}
        for t in trees:
            by_id.setdefault(t["request_id"], []).append(t)
        for r in bgs + fgs:
            assert len(by_id.get(r.request_id, ())) == 1, r.request_id
        assert not [t for t in trees
                    if t["root"]["tags"].get("handoff_of")], \
            "unmerged handoff continuation leaked"
        assert not router.breaker_states()[2]["ready"]
        assert srvs[2].num_active == 0 and srvs[2].num_pending == 0
        lone = _ref(weights)
        assert [r.tokens for r in fgs] == \
            lone.generate([MID], max_new_tokens=32) * 8
    finally:
        router.stop()
