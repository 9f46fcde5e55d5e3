"""The port's int8 KV cache against the reference's, on the CPU.

Quantization (`engine._kv_quant`, `paged_engine.quantize_pool`) equals
the reference's bit for bit; the plain int8 paged attention matches the
reference's XLA path (f32, within 1e-5) and its int8 Pallas kernel in
interpret mode (bf16 operands, within the reference test's 5e-3);
`window_forward` on an int8 cache writes the same values and scales and
gives the same logits; the int8 `PagedInferenceServer` decodes the same
greedy tokens as the reference's, with and without preemption, on a pool
of the same size. The CUDA kernel's int8 branch is held against the
plain version on the card by tests/test_torch_kernels_gpu.py."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference import engine as ref_engine
from cloud_server_tpu.inference import paged_engine as ref_pe
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu.ops import paged_attention as ref_pa
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import engine, paged_engine
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import paged_attention as pa

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

# --------------------------------------------------------------------------
# quantization
# --------------------------------------------------------------------------


def _rows(seed):
    """f32 rows with every sign and scale, an all-zero row (scale floor
    1e-8), and exact halves of a step (round half to even)."""
    r = np.random.default_rng(seed)
    x = (r.standard_normal((5, 7, 3, 16)) * r.uniform(
        0.01, 30, (5, 7, 3, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 1] = np.arange(16, dtype=np.float32) - 7.5  # max 8.5 -> halves
    x[1, 2, 1, 0] = 127.0 / 2  # scale 0.5: q = round(+-k.5) ties
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_kv_quant_bit_exact(seed):
    x = _rows(seed)
    want_q, want_s = ref_engine._kv_quant(jnp.asarray(x))
    got_q, got_s = engine._kv_quant(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    deq = engine._kv_dequant(got_q, got_s, torch.float32).numpy()
    np.testing.assert_array_equal(deq, np.asarray(ref_engine._kv_dequant(
        want_q, want_s, jnp.float32)))


def test_quantize_pool_bit_exact():
    r = np.random.default_rng(2)
    pool = (r.standard_normal((2, 5, 3, 16, 8)) * 4).astype(np.float32)
    pool[1, 3, 2, :, 5] = 0.0
    want_q, want_s = ref_pe.quantize_pool(jnp.asarray(pool))
    got_q, got_s = paged_engine.quantize_pool(torch.from_numpy(pool))
    assert got_q.shape == pool.shape and got_s.shape == (2, 5, 3, 8)
    assert got_q.is_contiguous() and got_s.is_contiguous()
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# --------------------------------------------------------------------------
# plain int8 paged attention
# --------------------------------------------------------------------------


def _case(seed, *, b, w, h=4, kh=2, d=8, ps=8, mp=12, num_pages=60,
          lengths=None, widths=None):
    """f32 q (rounded to bf16 values, so a bf16 cast of q is exact), int8
    pools and their scales from the reference's quantize_pool."""
    r = np.random.default_rng(seed)
    pool = r.standard_normal((2, 2, num_pages, kh, d, ps)).astype(np.float32)
    kq, ks = ref_pe.quantize_pool(jnp.asarray(pool[0]))
    vq, vs = ref_pe.quantize_pool(jnp.asarray(pool[1]))
    q = np.array(jnp.asarray(r.standard_normal((b, w, h, d)), jnp.bfloat16)
                 .astype(jnp.float32))
    tables = r.permutation(num_pages)[:b * mp].reshape(b, mp).astype(np.int32)
    if lengths is None:
        lengths = r.integers(w, mp * ps + 1, size=(b,))
    lengths = np.asarray(lengths, np.int32)
    widths = None if widths is None else np.asarray(widths, np.int32)
    return (q, np.array(kq), np.array(vq), np.array(ks), np.array(vs),
            lengths, tables, widths)


def _ref(fn, case, layer, **kw):
    q, kq, vq, ks, vs, lens, tabs, wid = case
    return np.asarray(fn(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(lens),
        jnp.asarray(tabs), layer, k_scale_pool=jnp.asarray(ks),
        v_scale_pool=jnp.asarray(vs),
        widths=None if wid is None else jnp.asarray(wid), **kw))


def _port(case, layer, fn=pa.paged_attention):
    q, kq, vq, ks, vs, lens, tabs, wid = case
    t = torch.from_numpy
    return fn(t(q), t(kq), t(vq), t(lens), t(tabs), layer,
              k_scale_pool=t(ks), v_scale_pool=t(vs),
              widths=None if wid is None else t(wid)).numpy()


def _valid(case):
    q, lens, wid = case[0], case[5], case[7]
    b, w = q.shape[:2]
    width = np.full((b,), w) if wid is None else wid
    return (np.arange(w)[None, :] < width[:, None]) & (lens > 0)[:, None]


CASES = {
    "narrow": dict(b=3, w=2),
    "narrow_mha": dict(b=2, w=1, h=4, kh=4),
    "wide": dict(b=2, w=48, lengths=[96, 60]),
    "ragged": dict(b=4, w=48, lengths=[48, 50, 3, 90],
                   widths=[48, 1, 3, 24]),
    "empty_slot": dict(b=3, w=1, lengths=[1, 0, 5]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_int8_matches_xla_f32(name):
    """f32: the port's plain version (through the wrapper's CPU path and
    directly) against the reference's `paged_attention_xla` with scale
    pools, within 1e-5, both layers."""
    case = _case(list(CASES).index(name), **CASES[name])
    valid = _valid(case)
    for layer in range(2):
        want = _ref(ref_pa.paged_attention_xla, case, layer)
        for fn in (pa.paged_attention, pa.paged_attention_ref):
            got = _port(case, layer, fn)
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got[valid], want[valid], atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("name", ["narrow", "wide", "ragged"])
def test_plain_int8_matches_interpret_kernel(name):
    """The reference's int8 Pallas kernel (interpret mode) computes with
    bf16 operands when the pools are int8 (q and the scaled probabilities
    round to bf16); the port's plain version, f32 throughout, within the
    reference test's 5e-3. Narrow (W 2), wide (W 48) and ragged widths."""
    case = _case(list(CASES).index(name) + 10, **CASES[name])
    valid = _valid(case)
    want = _ref(ref_pa.paged_attention, case, 1, pages_per_block=2,
                interpret=True)
    got = _port(case, 1)
    np.testing.assert_allclose(got[valid], want[valid], atol=5e-3,
                               rtol=5e-3)


def test_scale_pools_must_come_together():
    q, kq, vq, ks, vs, lens, tabs, _ = _case(3, b=1, w=1)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="together"):
        pa.paged_attention(t(q), t(kq), t(vq), t(lens), t(tabs), 0,
                           k_scale_pool=t(ks))


def test_gather_scale_pages_matches_reference():
    _, _, _, ks, _, _, tabs, _ = _case(4, b=3, w=1)
    tabs[1, 2:] = ks.shape[1]  # sentinel entries clamp
    want = ref_pa.gather_scale_pages(jnp.asarray(ks), jnp.asarray(tabs), 1)
    got = pa.gather_scale_pages(torch.from_numpy(ks), torch.from_numpy(tabs),
                                1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# window_forward on an int8 cache
# --------------------------------------------------------------------------

CFG = ModelConfig(vocab_size=61, embed_dim=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, head_dim=8, mlp_dim=64, max_seq_len=128,
                  dtype="float32", param_dtype="float32", remat="none",
                  kv_cache_dtype="int8")
PS, MP, NP = 8, 6, 30


@pytest.fixture(scope="module")
def weights():
    ref = ref_tf.init_params(CFG, jax.random.key(1))
    return ref, transformer.params_from_numpy(
        jax.tree.map(np.asarray, ref), TModelConfig(**dataclasses.asdict(CFG)),
        device="cpu")


def _int8_pools(seed, b):
    r = np.random.default_rng(seed)
    shape = (CFG.num_layers, NP, CFG.num_kv_heads, CFG.head_dim, PS)
    kq, ks = ref_pe.quantize_pool(jnp.asarray(r.standard_normal(shape),
                                              jnp.float32))
    vq, vs = ref_pe.quantize_pool(jnp.asarray(r.standard_normal(shape),
                                              jnp.float32))
    tables = r.permutation(NP)[:b * MP].reshape(b, MP).astype(np.int32)
    return [np.array(x) for x in (kq, vq, ks, vs)], tables


@pytest.mark.parametrize("impl,w,ragged", [("xla", 1, False),
                                           ("pallas", 1, False),
                                           ("pallas", 5, True)])
def test_window_forward_int8(weights, impl, w, ragged):
    """Logits within 1e-4; after the write the int8 pools equal the
    reference's up to one step where an f32 k or v lies within an ulp of
    a rounding boundary (no such element in these cases), and the scale
    pools within 1e-6 relative."""
    ref_params, params = weights
    (kq, vq, ks, vs), tables = _int8_pools(0, 3)
    lengths = np.asarray([3, 17, 30], np.int32)
    widths = np.asarray([w, 1, 3], np.int32) if ragged else None
    tokens = np.random.default_rng(1).integers(0, CFG.vocab_size, (3, w))
    at = np.asarray([0, 0, 0]) if ragged else np.asarray([w - 1, 0, 0])
    rcache = ref_pe.PagedKVCache(
        k=jnp.asarray(kq), v=jnp.asarray(vq), lengths=jnp.asarray(lengths),
        tables=jnp.asarray(tables), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    want, rcache = ref_pe.window_forward(
        ref_params, jnp.asarray(tokens), CFG, rcache, logits_at=at,
        widths=None if widths is None else jnp.asarray(widths))
    t = torch.from_numpy

    def scratch(pool):  # the port's pools carry the scratch page last
        return t(np.concatenate([pool, np.zeros_like(pool[:, :1])], 1))

    tcache = paged_engine.make_cache(scratch(kq), scratch(vq), lengths,
                                     tables, scratch(ks), scratch(vs))
    cfg = TModelConfig(**dataclasses.asdict(
        dataclasses.replace(CFG, decode_attention_impl=impl)))
    got, tcache = paged_engine.window_forward(
        params, t(tokens), cfg, tcache, logits_at=t(at), widths=widths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for mine, theirs in ((tcache.k, rcache.k), (tcache.v, rcache.v)):
        diff = np.abs(mine.numpy()[:, :NP].astype(np.int32)
                      - np.asarray(theirs).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    for mine, theirs in ((tcache.k_scale, rcache.k_scale),
                         (tcache.v_scale, rcache.v_scale)):
        np.testing.assert_allclose(mine.numpy()[:, :NP], np.asarray(theirs),
                                   rtol=1e-6, atol=0)
    # the window was written: the pools differ from their inputs
    assert not np.array_equal(tcache.k_scale.numpy()[:, :NP], ks)


def test_init_paged_cache_int8_and_hbm_bytes():
    tcfg = TModelConfig(**dataclasses.asdict(CFG))
    kw = dict(num_pages=NP, page_size=PS, batch=3, max_pages_per_slot=MP)
    cache = paged_engine.init_paged_cache(tcfg, device="cpu", **kw)
    ref = ref_pe.init_paged_cache(CFG, **kw)
    assert cache.k.dtype == torch.int8 and cache.k_scale.dtype == torch.float32
    # the reference's pools and, last, the scratch page
    assert cache.num_pages == NP
    assert tuple(cache.k_scale[:, :NP].shape) == ref.k_scale.shape
    assert tuple(cache.k[:, :NP].shape) == ref.k.shape
    assert paged_engine.hbm_bytes(cache) == ref_pe.hbm_bytes(ref)
    bf = paged_engine.init_paged_cache(
        dataclasses.replace(tcfg, kv_cache_dtype="model"), device="cpu", **kw)
    assert bf.k_scale is None
    assert paged_engine.hbm_bytes(bf) == ref_pe.hbm_bytes(
        ref_pe.init_paged_cache(dataclasses.replace(
            CFG, kv_cache_dtype="model"), **kw))


# --------------------------------------------------------------------------
# the int8 server
# --------------------------------------------------------------------------

SCFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none", kv_cache_dtype="int8")
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
SRV_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])
LONG = [(i * 7) % 60 + 1 for i in range(30)]
PROMPTS = [[5, 9, 3], [17, 2, 40, 8, 21], LONG, list(range(1, 14))]


@pytest.fixture(scope="module")
def server_weights():
    ref = ref_tf.init_params(SCFG, jax.random.key(0))
    port = transformer.params_from_numpy(
        jax.tree.map(np.asarray, ref), TModelConfig(**dataclasses.asdict(SCFG)),
        device="cpu")
    return ref, port


def _staggered_run(srv, prompts, max_new):
    reqs = [srv.submit(p, max_new_tokens=max_new) for p in prompts[:2]]
    for _ in range(3):
        srv.step()
    reqs += [srv.submit(p, max_new_tokens=max_new) for p in prompts[2:]]
    srv.run_until_idle()
    return [r.result() for r in reqs]


def _pools_of(ref_srv):
    pools = ref_srv.state["pools"]
    return ref_pe.PagedKVCache(
        k=pools["k"], v=pools["v"], lengths=None, tables=None,
        k_scale=pools.get("k_scale"), v_scale=pools.get("v_scale"))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("preempt", [False, True], ids=["roomy", "preempt"])
def test_int8_server_greedy_token_exact(server_weights, impl, preempt):
    """The staggered mixed-scheduler workload on an int8 cache (admissions
    landing mid-decode; with `preempt`, a pool of 12 pages that forces
    on-demand preemption and re-admission through the radix cache): the
    port's greedy tokens equal the reference's, and both pools hold the
    same bytes."""
    ref_params, params = server_weights
    kw = dict(SRV_KW, num_pages=12) if preempt else SRV_KW
    prompts = ([LONG[:20], LONG[5:25], list(range(1, 18)), LONG[:9]]
               if preempt else PROMPTS)
    max_new = 16 if preempt else 12
    ref = RefServer(ref_params, SCFG, GREEDY, overlap=False, **kw)
    want = _staggered_run(ref, prompts, max_new)
    cfg = TModelConfig(**dataclasses.asdict(
        dataclasses.replace(SCFG, decode_attention_impl=impl)))
    srv = PagedInferenceServer(params, cfg,
                               TInferConfig(**dataclasses.asdict(GREEDY)),
                               device="cpu", **kw)
    got = _staggered_run(srv, prompts, max_new)
    assert srv.k_pool.dtype == torch.int8 and srv.k_scale_pool is not None
    assert got == want
    if preempt:
        assert ref.preemptions > 0 and srv.preemptions > 0
    assert srv.kv_cache_bytes() == ref_pe.hbm_bytes(_pools_of(ref))
