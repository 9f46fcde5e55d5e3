"""The port's PagedInferenceServer against the reference's: greedy tokens
identical on the staggered mixed-scheduler workload, under a pool small
enough to force preemption, and with a repeated prefix served from the
radix cache; seeded requests at temperature > 0 identical token for
token (both draw from threefry's fold_in(key(seed), position)); both
page-allocation policies (tokens, occupancy and free pages, under every
scheduler); sequence embeddings through both attention routes."""

import dataclasses
import gc
import os
import sys
import weakref

import jax
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.inference.sampling import (
    SamplingParams as RefSamplingParams)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
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


def _port_cfgs(cfg=CFG, icfg=GREEDY):
    return (TModelConfig(**dataclasses.asdict(cfg)),
            TInferConfig(**dataclasses.asdict(icfg)))


@pytest.fixture(scope="module")
def weights():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    port = params_from_numpy(jax.tree.map(np.asarray, ref),
                             _port_cfgs()[0], device="cpu")
    return ref, port


def _staggered_run(srv, prompts, max_new):
    reqs = [srv.submit(p, max_new_tokens=max_new) for p in prompts[:2]]
    for _ in range(3):
        srv.step()
    reqs += [srv.submit(p, max_new_tokens=max_new) for p in prompts[2:]]
    srv.run_until_idle()
    return [r.result() for r in reqs]


def _port_server(params, cfg=CFG, icfg=GREEDY, **kw):
    tcfg, ticfg = _port_cfgs(cfg, icfg)
    return PagedInferenceServer(params, tcfg, ticfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def staggered_reference(weights):
    """The reference server's tokens on the staggered workload (its XLA
    attention path; its Pallas kernel is held equal to that path by the
    reference's own tests)."""
    return _staggered_run(
        RefServer(weights[0], CFG, GREEDY, overlap=False, **SRV_KW),
        PROMPTS, 12)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_greedy_staggered_tokens_identical(weights, staggered_reference,
                                           impl):
    """Mixed scheduler, admissions landing mid-decode: the port's tokens
    equal the reference's, with either attention implementation."""
    cfg = dataclasses.replace(CFG, decode_attention_impl=impl)
    got = _staggered_run(_port_server(weights[1], cfg, **SRV_KW),
                         PROMPTS, 12)
    assert got == staggered_reference


def test_greedy_identical_under_preemption(weights):
    """A pool too small for every chain at once: on-demand growth
    preempts the youngest slot, which re-admits as a continuation; the
    tokens still equal the reference's."""
    ref_params, params = weights
    kw = dict(SRV_KW, num_pages=12)
    prompts = [LONG[:20], LONG[5:25], list(range(1, 18)), LONG[:9]]
    ref = RefServer(ref_params, CFG, GREEDY, overlap=False, **kw)
    want = _staggered_run(ref, prompts, 16)
    srv = _port_server(params, **kw)
    got = _staggered_run(srv, prompts, 16)
    assert ref.preemptions > 0 and srv.preemptions > 0
    assert got == want


def test_repeated_prefix_served_from_cache(weights):
    """A second request sharing a prompt prefix hits the radix cache (its
    prefill skips the shared pages) and still decodes the same tokens."""
    _, params = weights
    srv = _port_server(params, **SRV_KW)
    first = srv.generate([LONG], max_new_tokens=6)[0]
    before = srv.prefix_cache_stats().prefix_hit_pages
    again = srv.generate([LONG], max_new_tokens=6)[0]
    assert srv.prefix_cache_stats().prefix_hit_pages > before
    assert again == first


def test_seeded_rows_reproducible_and_batch_independent(weights):
    """A seeded request's stream depends on (seed, position) alone: the
    same request alone or beside others gives the same tokens."""
    _, params = weights
    icfg = dataclasses.replace(GREEDY, temperature=1.0)
    sp = SamplingParams(seed=7, temperature=0.9, top_p=0.9)
    alone = _port_server(params, icfg=icfg, **SRV_KW)
    r0 = alone.submit(PROMPTS[2], max_new_tokens=8, sampling=sp)
    alone.run_until_idle()
    crowd = _port_server(params, icfg=icfg, **SRV_KW)
    others = [crowd.submit(p, max_new_tokens=8) for p in PROMPTS[:2]]
    r1 = crowd.submit(PROMPTS[2], max_new_tokens=8, sampling=sp)
    crowd.run_until_idle()
    assert r0.result() == r1.result()
    assert all(o.done for o in others)


SEEDED = [dict(seed=7, temperature=0.9, top_p=0.9),
          dict(seed=123456789, temperature=1.3, top_k=12),
          dict(seed=2 ** 32 - 5, temperature=0.8, min_p=0.05),
          dict(seed=42, temperature=1.0)]


def test_seeded_requests_token_exact_against_reference(weights):
    """Four seeded requests (temperature, top-k, top-p, min-p) on the
    staggered workload, some admitted mid-decode: the port's tokens equal
    the reference's token for token."""
    ref_params, params = weights
    icfg = dataclasses.replace(GREEDY, temperature=1.0)

    def run(srv, sp_cls):
        reqs = [srv.submit(p, max_new_tokens=10, sampling=sp_cls(**kw))
                for p, kw in zip(PROMPTS[:2], SEEDED[:2])]
        for _ in range(3):
            srv.step()
        reqs += [srv.submit(p, max_new_tokens=10, sampling=sp_cls(**kw))
                 for p, kw in zip(PROMPTS[2:], SEEDED[2:])]
        srv.run_until_idle()
        return [r.result() for r in reqs]

    want = run(RefServer(ref_params, CFG, icfg, overlap=False, **SRV_KW),
               RefSamplingParams)
    got = run(_port_server(params, icfg=icfg, **SRV_KW), SamplingParams)
    assert all(len(t) == 10 for t in want)
    assert got == want


class _FsdpMesh:
    """The reads the server makes of a mesh, for a (fsdp 2) mesh."""

    mesh_dim_names = ("dp", "pp", "fsdp", "ep", "sp", "tp")
    shape = (1, 1, 2, 1, 1, 1)


@pytest.mark.parametrize("kw", [
    dict(mesh=_FsdpMesh()),
    dict(cfg=dataclasses.replace(CFG, num_experts=4))],
    ids=["mesh", "moe"])
def test_unported_features_raise(weights, kw):
    """What stays unported is refused at construction: a mesh that
    shards over an axis other than tp (tensor-parallel serving itself is
    held by tests/test_torch_sharded_serving.py). MoE models are served:
    an MoE model built from the reference's init serves the engine's
    greedy tokens (tests/test_torch_moe.py holds them against the
    reference's servers)."""
    _, params = weights
    if "cfg" not in kw:
        with pytest.raises(NotImplementedError):
            _port_server(params, **SRV_KW, **kw)
        return
    from cloud_server_tpu.models import moe as ref_moe
    from cloud_server_tpu_torch.inference import engine
    from cloud_server_tpu_torch.utils import prng
    cfg = dataclasses.replace(kw["cfg"], expert_capacity_factor=2.0)
    moe_params = params_from_numpy(
        jax.tree.map(np.asarray, ref_moe.init_params(cfg, jax.random.key(2))),
        _port_cfgs(cfg)[0], device="cpu")
    got = _port_server(moe_params, cfg=cfg, **SRV_KW).generate(
        [PROMPTS[1]], max_new_tokens=6)[0]
    want = engine.generate(moe_params, torch.tensor([PROMPTS[1]]),
                           prng.key(0), cfg=_port_cfgs(cfg)[0],
                           infer_cfg=_port_cfgs(cfg, dataclasses.replace(
                               GREEDY, max_decode_len=6))[1])
    assert got == want[0].tolist()


@pytest.mark.parametrize("kw", [dict(adapter="a")])
def test_unported_request_options_raise(weights, kw):
    """Adapters are served now: an adapter that was never registered is
    the client's ValueError at submit, as in the reference, and nothing
    is queued."""
    ref_params, params = weights
    for srv in (RefServer(ref_params, CFG, GREEDY, **SRV_KW),
                _port_server(params, **SRV_KW)):
        with pytest.raises(ValueError, match="unknown adapter"):
            srv.submit([1, 2, 3], **kw)
        assert srv.num_pending == 0


SCHEDULERS = {"overlap": dict(scheduler="mixed", overlap=True),
              "sequential": dict(scheduler="mixed", overlap=False),
              "alternating": dict(scheduler="alternating")}


def _pool_trace(srv, prompts, max_new):
    """Tokens, then (active slots, free pages) after each step."""
    reqs = [srv.submit(p, max_new_tokens=max_new) for p in prompts]
    trace = []
    while srv.num_pending or srv.num_active or srv._jobs:
        srv.step()
        trace.append((srv.num_active, srv.allocator.available))
    return [r.result() for r in reqs], trace


@pytest.mark.parametrize(
    "allocation,sched",
    [("reserve", s) for s in SCHEDULERS] + [("ondemand", "overlap")])
def test_allocation_policies_match_reference(weights, allocation, sched):
    """Full reservation under every scheduler, and on-demand paging
    beside it (its other schedulers are test_torch_overlap.py's): the
    tokens, the occupancy and the free pages after every step equal the
    reference server's; "reserve" never preempts."""
    ref_params, params = weights
    kw = dict(SRV_KW, allocation=allocation, **SCHEDULERS[sched])
    want = _pool_trace(RefServer(ref_params, CFG, GREEDY, **kw), PROMPTS,
                       12)
    srv = _port_server(params, **kw)
    got = _pool_trace(srv, PROMPTS, 12)
    assert got == want
    assert srv.allocation == allocation
    if allocation == "reserve":
        assert srv.preemptions == 0
        # the first admission reserved each chain whole
        total = sum(-(-(len(p) + 12 + srv.window) // srv.page_size)
                    for p in PROMPTS)
        assert got[1][0][1] <= srv.allocator.num_pages - total


def test_reserve_serializes_where_ondemand_preempts(weights):
    """The reference's case: full reservation admits one request at a
    time on a pool on-demand paging shares by all six (preempting as
    chains outgrow it); tokens, occupancy and free pages equal the
    reference's under both policies."""
    ref_params, params = weights
    prompts = [[(i * 9 + k) % 60 + 1 for k in range(8)] for i in range(6)]
    kw = dict(max_slots=6, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16], num_pages=12, decode_chunk=2)
    for allocation, active in (("reserve", 1), ("ondemand", 6)):
        ref = RefServer(ref_params, CFG, GREEDY, allocation=allocation,
                        **kw)
        want = _pool_trace(ref, prompts, 40)
        srv = _port_server(params, allocation=allocation, **kw)
        got = _pool_trace(srv, prompts, 40)
        assert got == want
        assert got[1][0][0] == active
        assert srv.preemptions == ref.preemptions
        assert (srv.preemptions > 0) == (allocation == "ondemand")


def test_unknown_allocation_raises(weights):
    with pytest.raises(ValueError, match="allocation"):
        _port_server(weights[1], allocation="lazy", **SRV_KW)


EMBED_PROMPTS = [[5, 9, 3], LONG, [60], list(range(1, 14)), LONG[3:23]]


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_embed_matches_reference(weights, impl):
    """Mean-pooled, L2-normalised embeddings across two prompt buckets
    (groups padded to power-of-two rows) equal the reference's within
    1e-5 in f32, with plain causal attention and with the flash route
    (its plain version here; the reference's kernel in interpret mode);
    an embed under the overlap pipeline, a dispatch in flight, changes
    no token of the request decoding beside it."""
    from cloud_server_tpu_torch.ops import flash_attention as fa
    ref_params, params = weights
    cfg = dataclasses.replace(CFG, attention_impl=impl)
    want = RefServer(ref_params, cfg, GREEDY, **SRV_KW).embed(
        EMBED_PROMPTS)
    srv = _port_server(params, cfg=cfg, overlap=True, **SRV_KW)
    req = srv.submit(PROMPTS[1], max_new_tokens=20)
    srv.step()
    assert srv._inflight is not None
    plain0 = fa.plain_calls
    got = srv.embed(EMBED_PROMPTS)
    assert got.shape == (len(EMBED_PROMPTS), CFG.embed_dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               atol=1e-5)
    # one forward per (bucket, padded rows) group, every layer
    assert fa.plain_calls - plain0 == (2 * CFG.num_layers
                                       if impl == "flash" else 0)
    assert srv.embed([]).shape == (0, CFG.embed_dim)
    with pytest.raises(ValueError, match="empty"):
        srv.embed([[]])
    srv.run_until_idle()
    alone = _port_server(params, cfg=cfg, **SRV_KW)
    assert req.result() == alone.generate([PROMPTS[1]],
                                          max_new_tokens=20)[0]


def test_default_device_is_cuda():
    """Without a card the server refuses to start unless asked for the
    CPU; nothing falls back on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, icfg = _port_cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedInferenceServer({}, cfg, icfg, **SRV_KW)


def test_cancel_deadline_and_background_thread(weights):
    """A pending request cancels at once; an expired deadline finishes
    with reason "deadline"; the background scheduler thread serves a
    request and stops cleanly."""
    _, params = weights
    srv = _port_server(params, **SRV_KW)
    pending = srv.submit(PROMPTS[0], max_new_tokens=4)
    pending.cancel()
    assert pending.done and pending.finish_reason == "cancelled"
    late = srv.submit(PROMPTS[1], max_new_tokens=4, deadline_s=1e-9)
    srv.run_until_idle()
    assert late.finish_reason == "deadline"
    srv.start()
    try:
        req = srv.submit(PROMPTS[3], max_new_tokens=5)
        assert len(req.result(timeout=60)) == 5
        assert req.finish_reason == "length"
    finally:
        srv.stop()
    assert srv._thread is None


def test_finished_requests_do_not_pin_the_server(weights):
    """A caller that keeps finished requests does not keep the server and
    its page pools alive, and cancel() on them stays a no-op."""
    _, params = weights
    srv = _port_server(params, **SRV_KW)
    reqs = [srv.submit(p, max_new_tokens=3) for p in PROMPTS[:2]]
    srv.run_until_idle()
    alive = weakref.ref(srv)
    del srv
    gc.collect()
    assert alive() is None
    for r in reqs:
        r.cancel()
        assert r.finish_reason == "length" and len(r.result()) == 3
