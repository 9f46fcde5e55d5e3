"""The port's live migration (mirroring tests/test_migration.py case for
case): the allocator's chain import, export snapshots and evacuation,
token-exact export -> import, the guardrails and injected faults, the
router's failover and migrating drain, and the ledger. Every scenario
that serves runs through the reference too (its router over its
servers, on the same numpy weights): the port's fleet gives the same
greedy and seeded tokens and the same `migration_stats()`, its exported
pages equal the reference's, and a snapshot the reference exported
imports into a port server and continues token-exact. The int8 cache, a
draft model's pools and a grammar request each migrate too."""

import dataclasses
import gc
import functools
import threading
import time

import jax
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference.block_allocator import (
    BlockAllocator as RefAllocator)
from cloud_server_tpu.inference.faults import FaultPlan as RefFaultPlan
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.inference.router import (
    ReplicatedRouter as RefRouter)
from cloud_server_tpu.inference.sampling import (
    SamplingParams as RefSamplingParams)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
from cloud_server_tpu_torch.inference import graphs
from cloud_server_tpu_torch.inference.block_allocator import BlockAllocator
from cloud_server_tpu_torch.inference.faults import FaultPlan, InjectedFault
from cloud_server_tpu_torch.inference.http_server import HttpFrontend
from cloud_server_tpu_torch.inference.migration import (MIGRATION_VERSION,
                                                        MigrationLedger,
                                                        MigrationSnapshot)
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.request_trace import PHASES
from cloud_server_tpu_torch.inference.router import ReplicatedRouter
from cloud_server_tpu_torch.inference.sampling import SamplingParams
from cloud_server_tpu_torch.inference.server import Request
from cloud_server_tpu_torch.models.transformer import params_from_numpy

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
SRV_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])
LONG = [(i * 7) % 60 + 1 for i in range(30)]
MID = [3, 1, 4, 1, 5, 9, 2, 6]
# exported pages against the reference's (both float32 on the CPU)
KV_ATOL = 1e-5


def _tcfg(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the reference's compiled XLA programs when the module ends:
    each holds a few memory maps, and this module's leave about 14
    thousand; a test worker that runs it and other reference-heavy
    modules would otherwise reach the kernel's map limit
    (vm.max_map_count), where the next compile fails."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def weights():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    port = params_from_numpy(jax.tree.map(np.asarray, ref), _tcfg(CFG),
                             device="cpu")
    return ref, port


def _port(weights, icfg=GREEDY, cfg=CFG, **kw):
    return PagedInferenceServer(
        weights[1], _tcfg(cfg), TInferConfig(**dataclasses.asdict(icfg)),
        device="cpu", **{**SRV_KW, **kw})


def _ref(weights, icfg=GREEDY, cfg=CFG, **kw):
    return RefServer(weights[0], cfg, icfg, **{**SRV_KW, **kw})


# The two sides of every fleet scenario: a server factory, the router,
# the sampling and fault-plan types.
SIDES = {
    "ref": (_ref, RefRouter, RefSamplingParams, RefFaultPlan),
    "port": (_port, ReplicatedRouter, SamplingParams, FaultPlan),
}


def _assert_gap_free(tree):
    root = tree["root"]
    phases = [c for c in root["children"] if c["name"] in PHASES]
    assert phases, f"no phase spans in {tree['request_id']}"
    assert phases[0]["start"] == root["start"]
    for a, b in zip(phases, phases[1:]):
        assert a["end"] == b["start"], \
            f"gap between {a['name']} and {b['name']}"
    if root["end"] is not None:
        assert phases[-1]["end"] == root["end"]


def _drive(router, reqs, deadline_s=90.0):
    deadline = time.time() + deadline_s
    while not all(r.done for r in reqs) and time.time() < deadline:
        router.step()
        time.sleep(0.001)
    assert all(r.done for r in reqs), \
        [(r.request_id, len(r.tokens), r.finish_reason) for r in reqs]


@functools.lru_cache(maxsize=None)
def _lone_ref(prompt: tuple, max_new: int, sp=None) -> list:
    """The reference server's tokens for one request alone (the weights
    are made from the same seed every time)."""
    srv = RefServer(ref_transformer.init_params(CFG, jax.random.key(0)),
                    CFG, GREEDY, **SRV_KW)
    sampling = None if sp is None else RefSamplingParams(**dict(sp))
    r = srv.submit(list(prompt), max_new_tokens=max_new,
                   sampling=sampling)
    srv.run_until_idle()
    return list(r.tokens)


# ---------------------------------------------------------------------------
# allocator: import_chain
# ---------------------------------------------------------------------------


def _toks(n, base=0):
    return [base + i + 1 for i in range(n)]


@pytest.mark.parametrize("cls", [RefAllocator, BlockAllocator],
                         ids=["ref", "port"])
def test_import_chain_dedupe_partial_and_famine(cls):
    a = cls(8, page_size=4)
    fills = a.import_chain(_toks(12))
    assert len(fills) == 3
    assert [c for c, _ in fills] == [0, 1, 2]
    pages = [p for _, p in fills]
    assert len(set(pages)) == 3
    st = a.stats()
    assert st.pages_cached == 3
    assert st.pages_free + st.pages_cached + st.pages_active == 8
    shared, n_tok = a.lookup_prefix(_toks(13))
    assert len(shared) == 3 and n_tok == 12
    a.release(shared, _toks(12))
    assert a.import_chain(_toks(12)) == []
    fills = a.import_chain(_toks(20))
    assert [c for c, _ in fills] == [3, 4]
    assert a.stats().pages_cached == 5
    b = cls(2, page_size=4)
    fills = b.import_chain(_toks(16))
    assert len(fills) == 2
    assert b.stats().pages_cached == 2
    assert b.stats().pages_free == 0


# ---------------------------------------------------------------------------
# export: snapshot contents + atomic evacuation
# ---------------------------------------------------------------------------


def _export_after(side, weights, n_tokens, **kw):
    mk, _, sp_cls, _ = SIDES[side]
    srv = mk(weights, tracing=1.0, **kw)
    sp = sp_cls(seed=77, temperature=0.9, top_p=0.9)
    req = srv.submit(LONG, max_new_tokens=24, sampling=sp, deadline_s=45.0)
    while len(req.tokens) < n_tokens:
        srv.step()
    return srv, req, sp, srv.migrate_export(req, reason="drain")


def test_export_snapshot_fields_and_evacuation(weights):
    srv, req, sp, snap = _export_after("port", weights, 4)
    assert snap.version == MIGRATION_VERSION
    assert snap.request_id == req.request_id
    assert snap.reason == "drain"
    assert list(snap.prompt) == LONG
    assert len(snap.tokens) >= 4
    assert snap.tokens == tuple(req.tokens)
    assert snap.logprobs == tuple(req.logprobs)
    assert len(snap.emit_times) == len(snap.tokens)
    assert snap.seed_used == req.seed_used
    assert snap.sampling is sp
    assert snap.max_new_tokens == 24
    assert snap.remaining_new_tokens() == 24 - len(snap.tokens)
    assert 0 < snap.deadline_remaining_s <= 45.0
    assert snap.trace_ctx is not None
    n = snap.n_kv_pages()
    assert n >= 2
    full = list(LONG) + list(snap.tokens)
    assert list(snap.chain_tokens) == full[:n * srv.page_size]
    assert set(snap.kv_pages) == {"k", "v"}
    for name, arr in snap.kv_pages.items():
        assert arr.shape[1] == n, name
        assert isinstance(arr, torch.Tensor) and arr.device.type == "cpu"

    # the same request on the reference: the same snapshot, its pages
    # (same names and layout, no scratch page) within KV_ATOL
    rsrv, rreq, _, rsnap = _export_after("ref", weights, 4)
    assert snap.tokens == rsnap.tokens
    assert snap.chain_tokens == rsnap.chain_tokens
    assert set(snap.kv_pages) == set(rsnap.kv_pages)
    for name, arr in rsnap.kv_pages.items():
        np.testing.assert_allclose(np.asarray(snap.kv_pages[name]),
                                   np.asarray(arr), rtol=0, atol=KV_ATOL,
                                   err_msg=name)

    assert not req.done
    assert srv.num_active == 0 and srv.num_pending == 0
    st = srv.allocator.stats()
    assert st.pages_active == 0
    assert st.pages_free + st.pages_cached == st.pages_total
    trees = srv.trace_trees()
    src = next(t for t in trees if t["request_id"] == req.request_id)
    assert src["root"]["end"] is not None
    assert "finish_reason" not in src["root"]["tags"]
    _assert_gap_free(src)

    mstats = srv.migration_stats()
    assert mstats == rsrv.migration_stats()
    assert mstats["out_started"] == 1
    assert mstats["out_completed"] == 1
    assert mstats["out_failed"] == 0
    assert mstats["tokens_salvaged"] == len(snap.tokens)
    assert mstats["pages_moved"] == n
    snap_m = srv.metrics_snapshot()
    assert snap_m["cloud_server_migrations_started_total"]["value"] == 1
    assert snap_m["cloud_server_migrations_completed_total"][
        "value"] == 1
    assert snap_m["cloud_server_migrations_failed_total"]["value"] == 0


def test_export_pending_request_is_host_only(weights):
    srv = _port(weights, max_slots=2)
    hogs = [srv.submit(LONG, max_new_tokens=16) for _ in range(2)]
    srv.step()
    queued = srv.submit(MID, max_new_tokens=6)
    assert srv.num_pending == 1
    snap = srv.migrate_export(queued)
    assert snap.tokens == ()
    assert snap.n_kv_pages() == 0 and snap.kv_pages is None
    assert srv.num_pending == 0
    srv.run_until_idle()
    assert all(h.done for h in hogs)
    assert [h.tokens for h in hogs] == [_lone_ref(tuple(LONG), 16)] * 2


# ---------------------------------------------------------------------------
# live export -> import: token-exact resumption, KV actually reused
# ---------------------------------------------------------------------------


def _live_migration(side, weights):
    mk, _, sp_cls, _ = SIDES[side]
    sp = sp_cls(seed=123, temperature=0.8, top_p=0.9)
    r0, r1 = mk(weights), mk(weights)
    g_stream, s_stream = [], []
    g = r0.submit(LONG, max_new_tokens=24, stream=g_stream.append)
    s = r0.submit(MID, max_new_tokens=48, sampling=sp,
                  stream=s_stream.append)
    while len(g.tokens) < 5 or len(s.tokens) < 5:
        r0.step()
    gs = r0.migrate_export(g)
    ss = r0.migrate_export(s)
    before_hits = r1.allocator.stats().prefix_hit_pages
    g2 = r1.migrate_import(gs, stream=g_stream.append)
    s2 = r1.migrate_import(ss, stream=s_stream.append)
    assert list(g2.tokens) == list(gs.tokens)
    r1.run_until_idle()
    return dict(gs=gs, g2=g2, s2=s2, g_stream=g_stream, s_stream=s_stream,
                gained=r1.allocator.stats().prefix_hit_pages - before_hits,
                flight=r1.flight_window(), st0=r0.migration_stats(),
                st1=r1.migration_stats())


def test_live_migration_token_exact_greedy_and_seeded(weights):
    g_ref = _lone_ref(tuple(LONG), 24)
    s_ref = _lone_ref(tuple(MID), 48, (("seed", 123), ("temperature", 0.8),
                                       ("top_p", 0.9)))
    out = _live_migration("port", weights)
    ref = _live_migration("ref", weights)
    g2, s2, gs = out["g2"], out["s2"], out["gs"]
    assert gs.n_kv_pages() >= 2
    assert g2.done and g2.finish_reason == "length"
    assert s2.done and s2.finish_reason == "length"
    assert list(g2.tokens) == g_ref
    assert list(s2.tokens) == s_ref
    assert len(g2.logprobs) == 24
    assert out["g_stream"] == g_ref
    assert out["s_stream"] == s_ref
    assert out["gained"] >= gs.n_kv_pages()
    assert any(rec.get("migrated_in") for rec in out["flight"])
    st0, st1 = out["st0"], out["st1"]
    assert st0["out_completed"] == 2 and st0["out_failed"] == 0
    assert st1["in_completed"] == 2 and st1["in_failed"] == 0
    assert st1["pages_moved"] == 0
    # the reference's run of the same scenario: same tokens, same stats
    assert out["gs"].tokens == ref["gs"].tokens
    assert (st0, st1) == (ref["st0"], ref["st1"])
    assert out["gained"] == ref["gained"]


def test_reference_snapshot_imports_into_port(weights):
    """A snapshot the reference exported (numpy pages, its sampling
    type mapped to the port's) continues token-exact on a port server,
    its imported pages equal to the snapshot's."""
    sp = RefSamplingParams(seed=123, temperature=0.8, top_p=0.9)
    src = _ref(weights)
    req = src.submit(MID, max_new_tokens=48, sampling=sp)
    g = src.submit(LONG, max_new_tokens=24)
    while len(req.tokens) < 5 or len(g.tokens) < 5:
        src.step()
    snaps = [src.migrate_export(r) for r in (req, g)]
    dst = _port(weights)
    stream = []
    conts = []
    for snap in snaps:
        mapped = dataclasses.replace(
            snap, sampling=(None if snap.sampling is None else
                            SamplingParams(**dataclasses.asdict(
                                snap.sampling))))
        conts.append(dst.migrate_import(
            mapped, stream=stream.append if snap is snaps[0] else None))
    g_snap = snaps[1]
    assert g_snap.n_kv_pages() >= 2
    # the imported pages are in the pools under the chain's page ids
    shared, n_tok = dst.allocator.lookup_prefix(
        list(g_snap.chain_tokens) + [0])
    assert len(shared) == g_snap.n_kv_pages()
    for name, pool in (("k", dst.k_pool), ("v", dst.v_pool)):
        np.testing.assert_array_equal(
            pool[:, shared].numpy(), np.asarray(g_snap.kv_pages[name]))
    dst.allocator.release(shared, list(g_snap.chain_tokens))
    dst.run_until_idle()
    want = [_lone_ref(tuple(MID), 48, (("seed", 123), ("temperature", 0.8),
                                       ("top_p", 0.9))),
            _lone_ref(tuple(LONG), 24)]
    assert [list(c.tokens) for c in conts] == want
    assert stream == want[0][len(snaps[0].tokens):]


# ---------------------------------------------------------------------------
# import/export guardrails and injected faults
# ---------------------------------------------------------------------------


def test_migrate_import_rejections_and_injected_faults(weights):
    fp = FaultPlan()
    srv = _port(weights, faults=fp)
    req = srv.submit(MID, max_new_tokens=6)
    srv.step()
    fp.arm("migrate_export", count=1)
    with pytest.raises(InjectedFault):
        srv.migrate_export(req)
    srv.run_until_idle()
    assert req.done and req.finish_reason == "length"
    with pytest.raises(RuntimeError, match="not live"):
        srv.migrate_export(req)
    snap = srv.migrate_salvage(req)
    assert snap.tokens == tuple(req.tokens)
    assert snap.n_kv_pages() == 0
    with pytest.raises(ValueError, match="budget"):
        srv.migrate_import(snap)
    bad = dataclasses.replace(snap, version=MIGRATION_VERSION + 1,
                              max_new_tokens=12)
    with pytest.raises(ValueError, match="version"):
        srv.migrate_import(bad)
    good = dataclasses.replace(snap, max_new_tokens=12)
    fp.arm("migrate_import", count=1)
    with pytest.raises(InjectedFault):
        srv.migrate_import(good)
    # pages that do not fit the pool are refused before any is keyed:
    # the continuation re-prefills, exact
    wrong = dataclasses.replace(
        good, chain_tokens=tuple(MID),
        kv_pages={"k": torch.zeros(2, 1, 2, 8, 4),
                  "v": torch.zeros(2, 1, 2, 8, 4)})
    cached = srv.allocator.stats().pages_cached
    cont = srv.migrate_import(wrong)
    srv.run_until_idle()
    assert cont.finish_reason == "length"
    assert list(cont.tokens) == _lone_ref(tuple(MID), 12)
    assert srv.allocator.stats().pages_cached >= cached

    mstats = srv.migration_stats()
    assert mstats["out_failed"] == 2
    assert mstats["out_completed"] == 1
    assert mstats["in_failed"] == 3
    assert mstats["in_completed"] == 1
    assert srv.metrics_snapshot()[
        "cloud_server_migrations_failed_total"]["value"] == 5


def test_nonmigratable_mid_stream_failure_keeps_old_contract(weights):
    class _Stub:
        ready = True
        num_active = num_pending = 0

        def submit(self, prompt, **kw):
            raise AssertionError("must not be resubmitted")

    router = ReplicatedRouter([_Stub(), _Stub()])
    hook = router._make_fail_hook(0, [1, 2], {}, frozenset(), None)
    req = Request(prompt=[1, 2], max_new_tokens=4)
    req.finish_reason = "error: boom"
    req.tokens = [7, 8]
    assert hook(req) is False
    assert router.migration_stats()["out_started"] == 0

    fp = FaultPlan()
    fp.arm("migrate_export", count=0)
    srv = _port(weights, faults=fp)
    r = srv.submit(MID, max_new_tokens=6)
    srv.step()
    with pytest.raises(InjectedFault):
        srv.migrate_export(r)
    assert srv.migration_stats()["out_failed"] == 1
    srv.run_until_idle()
    assert r.done and r.finish_reason == "length"


# ---------------------------------------------------------------------------
# zero-cost when idle
# ---------------------------------------------------------------------------


def test_migration_armed_idle_keeps_dispatch_counts(weights):
    """Migration fault sites armed far in the future: a pipelined step
    still makes one launch and one sync, and nothing is exported."""
    fp = FaultPlan({"faults": [
        {"site": "migrate_export", "after": 10**6},
        {"site": "migrate_import", "after": 10**6}]})
    srv = _port(weights, scheduler="mixed", overlap=True, faults=fp)

    def counts():
        return graphs.launches, graphs.syncs

    warm = srv.submit([5, 9, 3, 1], max_new_tokens=24)
    l0, s0 = counts()
    srv.step()
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
    assert srv.migration_stats()["out_started"] == 0


# ---------------------------------------------------------------------------
# router drain(migrate=True): zero-loss evacuation
# ---------------------------------------------------------------------------


DRAIN_PROMPTS = [LONG, MID, [7, 7, 2, 11, 30]]


def _drain_scenario(side, weights):
    mk, router_cls, _, _ = SIDES[side]
    r0 = mk(weights, max_slots=2, tracing=1.0)
    r1 = mk(weights, tracing=1.0)
    router = router_cls([r0, r1])
    fillers = [r1.submit([5, 9, 3], max_new_tokens=16) for _ in range(3)]
    streams = [[] for _ in DRAIN_PROMPTS]
    reqs = [router.submit(p, max_new_tokens=20, stream=st.append)
            for p, st in zip(DRAIN_PROMPTS, streams)]
    while len(reqs[0].tokens) < 2 or len(reqs[1].tokens) < 2:
        router.step()
    assert r0.num_active == 2 and r0.num_pending == 1
    assert router.drain(0) is True
    assert r0.num_active == 0 and r0.num_pending == 0
    assert not r0.ready
    _drive(router, reqs + fillers)
    return router, r0, reqs, streams


def test_router_drain_migrate_evacuates_all(weights):
    router, r0, reqs, streams = _drain_scenario("port", weights)
    refs = [_lone_ref(tuple(p), 20) for p in DRAIN_PROMPTS]
    for r, ref, st in zip(reqs, refs, streams):
        assert r.finish_reason == "length"
        assert list(r.tokens) == ref
        assert st == ref
    mstats = router.migration_stats()
    assert mstats["out_started"] == 3
    assert mstats["out_completed"] == 3
    assert mstats["out_failed"] == 0
    assert mstats["in_completed"] == 3
    assert mstats["success_rate"] == 1.0
    rrouter, _, rreqs, _ = _drain_scenario("ref", weights)
    assert [r.tokens for r in reqs] == [r.tokens for r in rreqs]
    assert mstats == rrouter.migration_stats()

    payload = HttpFrontend(router)._stats_json(0)
    assert payload["migration"]["out_completed"] == 3
    assert payload["migration"]["success_rate"] == 1.0
    trees = router.trace_trees()
    spans = [c for t in trees for c in t["root"]["children"]
             if c["name"] == "migrate"]
    assert len(spans) == 3
    assert all(sp["tags"]["reason"] == "drain" for sp in spans)
    for t in trees:
        if t["root"]["end"] is not None:
            _assert_gap_free(t)
    r0.resume()
    assert r0.ready
    back = router.submit(MID, max_new_tokens=4)
    _drive(router, [back])
    assert back.finish_reason == "length"


# ---------------------------------------------------------------------------
# chaos: a replica killed mid-stream, every request finishes exactly
# ---------------------------------------------------------------------------

CHAOS_PROMPTS = [LONG, MID, [7, 7, 2, 11], list(range(1, 14))]
CHAOS_SP = [None, (("seed", 5), ("temperature", 0.9)),
            None, (("seed", 11), ("temperature", 0.7), ("top_p", 0.8))]


def _chaos(side, weights, max_new=12):
    mk, router_cls, sp_cls, fp_cls = SIDES[side]
    fp = fp_cls()
    r0 = mk(weights, faults=fp, tracing=1.0)
    r1 = mk(weights, tracing=1.0)
    router = router_cls([r0, r1], breaker_threshold=2)
    streams = [[] for _ in CHAOS_PROMPTS]
    reqs = [router.submit(p, max_new_tokens=max_new,
                          sampling=None if sp is None else sp_cls(**dict(sp)),
                          stream=st.append)
            for p, sp, st in zip(CHAOS_PROMPTS, CHAOS_SP, streams)]
    while min(len(r.tokens) for r in reqs) < 1:
        router.step()
    fp.arm("dispatch", count=1)
    _drive(router, reqs)
    return router, reqs, streams


def test_chaos_one_replica_kill_no_token_loss(weights):
    router, reqs, streams = _chaos("port", weights)
    refs = [_lone_ref(tuple(p), 12, sp)
            for p, sp in zip(CHAOS_PROMPTS, CHAOS_SP)]
    for r, ref, st in zip(reqs, refs, streams):
        assert r.finish_reason == "length"
        assert list(r.tokens) == ref, "token mismatch after migration"
        assert st == ref, "stream lost or duplicated tokens"
    mstats = router.migration_stats()
    assert mstats["out_failed"] == 0
    assert mstats["out_started"] >= 1
    assert mstats["in_completed"] == mstats["out_started"]
    rrouter, _, _ = _chaos("ref", weights)
    assert mstats == rrouter.migration_stats()
    for t in router.trace_trees():
        if t["root"]["end"] is not None:
            _assert_gap_free(t)


def test_chaos_soak_three_replicas(weights):
    """Replica 0 dies mid-stream, then replica 1 dies after absorbing
    migrations (some requests migrate twice), while replica 2 rides out
    a transient allocation famine: every request finishes with the
    reference's uninterrupted output, one trace id per hop chain."""
    prompts = [[(i * k + 3) % 60 + 1 for i in range(4 + k)]
               for k in range(8)]
    sps = [None if k % 2 == 0 else
           (("seed", 100 + k), ("temperature", 0.85), ("top_p", 0.9))
           for k in range(8)]
    refs = [_lone_ref(tuple(p), 24, sp) for p, sp in zip(prompts, sps)]
    fp0, fp1, fp2 = FaultPlan(), FaultPlan(), FaultPlan()
    fp2.arm("alloc_famine", count=2)
    servers = [_port(weights, faults=fp, tracing=1.0)
               for fp in (fp0, fp1, fp2)]
    router = ReplicatedRouter(servers, breaker_threshold=2)
    streams = [[] for _ in prompts]
    reqs = [router.submit(p, max_new_tokens=24,
                          sampling=None if sp is None
                          else SamplingParams(**dict(sp)),
                          stream=st.append)
            for p, sp, st in zip(prompts, sps, streams)]
    while min(len(r.tokens) for r in reqs) < 1:
        router.step()
    fp0.arm("dispatch", count=1)
    deadline = time.time() + 60
    while time.time() < deadline:
        router.step()
        time.sleep(0.001)
        if router.migration_stats()["in_completed"] >= 1:
            break
    fp1.arm("dispatch", count=1)
    _drive(router, reqs, deadline_s=180.0)
    for r, ref, st in zip(reqs, refs, streams):
        assert r.finish_reason == "length"
        assert list(r.tokens) == ref
        assert st == ref
    mstats = router.migration_stats()
    assert mstats["out_failed"] == 0
    assert mstats["in_completed"] == mstats["out_started"]
    assert mstats["out_started"] >= 2
    trees = router.trace_trees()
    for t in trees:
        if t["root"]["end"] is not None:
            _assert_gap_free(t)
    for r in reqs:
        chain = [t for t in trees
                 if t["request_id"] == r.request_id
                 or t["root"]["tags"].get("migrate_of") == r.request_id
                 or t["root"]["tags"].get("retry_of") == r.request_id]
        assert len({t["trace_id"] for t in chain}) == 1


# ---------------------------------------------------------------------------
# exactness under speculation (n-gram and a draft model's pools), the
# int8 cache, and grammar
# ---------------------------------------------------------------------------


def _hop(mk, prompt, max_new, after, sampling=None, **kw):
    """Serve `prompt` on one server, export it after `after` tokens and
    finish it on a second: (continuation, stream, snapshot)."""
    r0, r1 = mk(**kw), mk(**kw)
    stream = []
    req = r0.submit(prompt, max_new_tokens=max_new, sampling=sampling,
                    stream=stream.append)
    while len(req.tokens) < after:
        r0.step()
    snap = r0.migrate_export(req)
    cont = r1.migrate_import(snap, stream=stream.append)
    r1.run_until_idle()
    return cont, stream, snap


@pytest.mark.parametrize("draft", [False, True], ids=["ngram", "draft"])
def test_migration_exact_with_speculation(weights, draft):
    """Greedy outputs are exact at any draft schedule, so a mid-stream
    hand-off between speculating servers moves no token; a draft model's
    pools travel beside the target's ("draft/k", "draft/v")."""
    kw = dict(max_context=128, prompt_buckets=[16, 64], spec_drafts=2)
    rep = [3, 4, 5, 6] * 5 + [3, 4]
    ref_kw = dict(kw)
    port_kw = dict(kw, decode_chunk=1)  # a few tokens a step: export early
    if draft:
        dcfg = dataclasses.replace(CFG, num_layers=1)
        dref = ref_transformer.init_params(dcfg, jax.random.key(1))
        ref_kw.update(draft_params=dref, draft_cfg=dcfg)
        port_kw.update(draft_params=params_from_numpy(
            jax.tree.map(np.asarray, dref), _tcfg(dcfg), device="cpu"),
            draft_cfg=_tcfg(dcfg))
    lone = _ref(weights, **ref_kw)
    ref = lone.generate([rep], max_new_tokens=32)[0]
    cont, stream, snap = _hop(functools.partial(_port, weights, **port_kw),
                              rep, 32, 5)
    assert snap.n_kv_pages() >= 2
    names = {"k", "v"} | ({"draft/k", "draft/v"} if draft else set())
    assert set(snap.kv_pages) == names
    assert cont.done and cont.finish_reason == "length"
    assert list(cont.tokens) == ref
    assert stream == ref


def test_migration_exact_with_int8_cache(weights):
    """The int8 cache's pools and their scale pools move together; the
    continuation equals the reference's int8 server, and the pages equal
    the reference's export of the same request."""
    cfg8 = dataclasses.replace(CFG, kv_cache_dtype="int8")
    lone = RefServer(weights[0], cfg8, GREEDY, **SRV_KW)
    ref = lone.generate([LONG], max_new_tokens=24)[0]
    cont, stream, snap = _hop(functools.partial(_port, weights, cfg=cfg8),
                              LONG, 24, 5)
    assert set(snap.kv_pages) == {"k", "v", "k_scale", "v_scale"}
    assert snap.kv_pages["k"].dtype == torch.int8
    assert list(cont.tokens) == ref and stream == ref
    r0 = RefServer(weights[0], cfg8, GREEDY, **SRV_KW)
    req = r0.submit(LONG, max_new_tokens=24)
    while len(req.tokens) < 5:
        r0.step()
    rsnap = r0.migrate_export(req)
    assert rsnap.tokens == snap.tokens
    for name, arr in rsnap.kv_pages.items():
        got = np.asarray(snap.kv_pages[name])
        if name.endswith("scale"):
            np.testing.assert_allclose(got, np.asarray(arr), rtol=1e-5,
                                       atol=KV_ATOL, err_msg=name)
        else:  # a rounding boundary may move one int8 step
            assert np.abs(got.astype(np.int32)
                          - np.asarray(arr).astype(np.int32)).max() <= 1


def test_migration_exact_with_grammar():
    """The destination re-walks the salvaged tokens through its DFA, so
    a constrained stream migrates exact and still matches the pattern."""
    import re
    tok = ByteTokenizer()
    cfg = dataclasses.replace(CFG, vocab_size=300)
    icfg = InferConfig(max_decode_len=16, temperature=0.0,
                       eos_token_id=tok.eos_id, pad_token_id=0)
    kw = dict(max_slots=4, max_context=128, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32], tokenizer=tok)
    rparams = ref_transformer.init_params(cfg, jax.random.key(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, rparams),
                                _tcfg(cfg), device="cpu")
    prompt = tok.encode("The year is ")
    pattern = r"[0-9]{30,40}"
    lone = RefServer(rparams, cfg, icfg, **kw)
    ref_req = lone.submit(prompt, max_new_tokens=48,
                          sampling=RefSamplingParams(regex=pattern))
    lone.run_until_idle()
    ref = list(ref_req.tokens)
    body = ref[:-1] if ref and ref[-1] == tok.eos_id else ref
    assert re.fullmatch(pattern, tok.decode(body))

    def mk():
        return PagedInferenceServer(
            pparams, _tcfg(cfg), TInferConfig(**dataclasses.asdict(icfg)),
            device="cpu", **kw)

    cont, stream, _ = _hop(mk, prompt, 48, 3,
                           sampling=SamplingParams(regex=pattern))
    assert cont.done
    assert list(cont.tokens) == ref
    assert stream == ref


# ---------------------------------------------------------------------------
# pure host: snapshot math, ledger accounting, fleet merge
# ---------------------------------------------------------------------------


def _snap(**over):
    base = dict(
        version=MIGRATION_VERSION, request_id="r-1", reason="drain",
        prompt=(1, 2, 3), tokens=(7, 8), logprobs=(0.0, 0.0),
        emit_times=(0.0, 0.0), seed_used=17, sampling=None,
        adapter=None, tenant=None, slo_class=None, max_new_tokens=8,
        deadline_remaining_s=None, trace_ctx=None, chain_tokens=(),
        kv_pages=None)
    base.update(over)
    return MigrationSnapshot(**base)


def test_snapshot_budget_prompt_and_page_math():
    s = _snap()
    assert s.remaining_new_tokens() == 6
    assert s.full_prompt() == (1, 2, 3, 7, 8)
    assert _snap(tokens=tuple(range(8))).remaining_new_tokens() == 0
    assert _snap(tokens=tuple(range(11))).remaining_new_tokens() == 0
    assert _snap().n_kv_pages() == 0
    assert _snap(kv_pages={}).n_kv_pages() == 0
    pages = {"k": torch.zeros(2, 3, 8, 4), "v": torch.zeros(2, 3, 8, 4)}
    assert _snap(kv_pages=pages).n_kv_pages() == 3


def test_snapshot_frozen_and_versioned():
    assert MIGRATION_VERSION == 1
    s = _snap()
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.tokens = (9,)
    s2 = dataclasses.replace(s, version=MIGRATION_VERSION + 1)
    assert s2.version == MIGRATION_VERSION + 1
    assert s2.tokens == s.tokens and s.version == MIGRATION_VERSION


def test_ledger_stats_totals():
    led = MigrationLedger()
    led.record_export_start()
    led.record_export_done(n_tokens=5, n_pages=2)
    led.record_export_start()
    led.record_export_failed()
    led.record_import_start()
    led.record_import_done()
    led.record_import_start()
    led.record_import_failed()
    st = led.stats()
    assert st["out_started"] == 2 and st["out_completed"] == 1
    assert st["out_failed"] == 1
    assert st["in_started"] == 2 and st["in_completed"] == 1
    assert st["in_failed"] == 1
    assert st["started"] == 4 and st["completed"] == 2
    assert st["failed"] == 2
    assert st["tokens_salvaged"] == 5 and st["pages_moved"] == 2


def test_ledger_flight_deltas_consumed_once():
    led = MigrationLedger()
    assert led.drain_flight_deltas() == (0, 0)
    led.record_export_done(n_tokens=1, n_pages=0)
    led.record_import_done()
    led.record_import_done()
    assert led.drain_flight_deltas() == (2, 1)
    assert led.drain_flight_deltas() == (0, 0)
    assert led.stats()["in_completed"] == 2


def test_ledger_totals_exact_under_concurrency():
    led = MigrationLedger()
    n = 500

    def work():
        for _ in range(n):
            led.record_export_start()
            led.record_export_done(n_tokens=3, n_pages=1)
            led.record_import_done()

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    st = led.stats()
    assert st["out_started"] == 4 * n == st["out_completed"]
    assert st["tokens_salvaged"] == 12 * n
    assert st["pages_moved"] == 4 * n
    assert led.drain_flight_deltas() == (4 * n, 4 * n)


@pytest.mark.parametrize("router_cls", [RefRouter, ReplicatedRouter],
                         ids=["ref", "port"])
def test_router_migration_stats_skips_nonmigratable_replicas(router_cls):
    class _Migratable:
        def submit(self, prompt, **kw):
            raise AssertionError("stats-only stub")

        def __init__(self, **kv):
            self._st = {k: 0 for k in (
                "out_started", "out_completed", "out_failed",
                "in_started", "in_completed", "in_failed", "started",
                "completed", "failed", "tokens_salvaged",
                "pages_moved")}
            self._st.update(kv)

        def migration_stats(self):
            return dict(self._st)

    class _Legacy:
        def submit(self, prompt, **kw):
            raise AssertionError("stats-only stub")

    router = router_cls([
        _Migratable(out_started=4, out_completed=3, in_completed=2,
                    tokens_salvaged=11, pages_moved=5),
        _Legacy(),
        _Migratable(out_started=1, in_completed=2, in_failed=1),
    ])
    st = router.migration_stats()
    assert st["out_started"] == 5 and st["out_completed"] == 3
    assert st["in_completed"] == 4 and st["in_failed"] == 1
    assert st["tokens_salvaged"] == 11 and st["pages_moved"] == 5
    assert st["success_rate"] == pytest.approx(4 / 5)
    idle = router_cls([_Legacy()]).migration_stats()
    assert idle["out_started"] == 0
    assert idle["success_rate"] == 0.0
