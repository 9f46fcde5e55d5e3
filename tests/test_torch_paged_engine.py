"""The port's window_forward against the reference's: logits and the
written pools, for uniform and ragged windows, float32 on the CPU. A
write through a sentinel table leaves the pool's pages unchanged (it
lands on the scratch page the port's pools carry last)."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.inference import paged_engine as ref_pe
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import paged_engine
from cloud_server_tpu_torch.models import transformer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

CFG = ModelConfig(vocab_size=61, embed_dim=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, head_dim=8, mlp_dim=64, max_seq_len=128,
                  dtype="float32", param_dtype="float32", remat="none",
                  rope_scaling="llama3", rope_scaling_factor=8.0,
                  rope_original_max_len=16)
PS, MP, NP = 8, 6, 30


@pytest.fixture(scope="module")
def weights():
    ref = ref_tf.init_params(CFG, jax.random.key(1))
    return ref, transformer.params_from_numpy(
        jax.tree.map(np.asarray, ref), TModelConfig(**dataclasses.asdict(CFG)),
        device="cpu")


def _state(seed, b):
    r = np.random.default_rng(seed)
    shape = (CFG.num_layers, NP, CFG.num_kv_heads, CFG.head_dim, PS)
    k = r.standard_normal(shape).astype(np.float32)
    v = r.standard_normal(shape).astype(np.float32)
    tables = r.permutation(NP)[:b * MP].reshape(b, MP).astype(np.int32)
    return k, v, tables


def _with_scratch(pool: np.ndarray) -> torch.Tensor:
    """The port's pool: the reference's pages and the scratch page."""
    return torch.from_numpy(np.concatenate(
        [pool, np.zeros_like(pool[:, :1])], axis=1))


def _run_both(weights, tokens, lengths, k, v, tables, impl, widths=None,
              **kw):
    ref_params, params = weights
    # the reference runs its XLA path (its Pallas kernel is held equal to
    # it by the reference's own tests); the port runs `impl`
    cfg = dataclasses.replace(CFG, decode_attention_impl=impl)
    rcache = ref_pe.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                 lengths=jnp.asarray(lengths),
                                 tables=jnp.asarray(tables))
    rw = None if widths is None else jnp.asarray(widths)
    want, rcache = ref_pe.window_forward(ref_params, jnp.asarray(tokens),
                                         CFG, rcache, widths=rw, **kw)
    tcache = paged_engine.make_cache(_with_scratch(k), _with_scratch(v),
                                     lengths, tables)
    tkw = {key: (torch.from_numpy(np.asarray(val))
                 if key == "logits_at" and val is not None else val)
           for key, val in kw.items()}
    got, tcache = paged_engine.window_forward(
        params, torch.from_numpy(tokens), TModelConfig(
            **dataclasses.asdict(cfg)), tcache, widths=widths, **tkw)
    return want, got, rcache, tcache


@pytest.mark.parametrize("impl,w", [("xla", 1), ("pallas", 1),
                                    ("pallas", 5)])
def test_uniform_window_logits_and_pools(weights, impl, w):
    k, v, tables = _state(0, 3)
    lengths = np.asarray([3, 17, 30], np.int32)
    tokens = np.random.default_rng(1).integers(0, CFG.vocab_size, (3, w))
    want, got, rc, tc = _run_both(weights, tokens, lengths, k, v, tables,
                                  impl, logits_at=np.asarray([w - 1, 0, 1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tc.k.numpy()[:, :NP], np.asarray(rc.k),
                               atol=1e-5)
    np.testing.assert_allclose(tc.v.numpy()[:, :NP], np.asarray(rc.v),
                               atol=1e-5)
    assert torch.equal(tc.lengths, torch.from_numpy(lengths))


def test_ragged_window_all_logits_and_pools(weights):
    """Per-row widths: positions past a row's width write nothing and the
    valid rows' logits equal the reference's."""
    k, v, tables = _state(2, 4)
    lengths = np.asarray([0, 9, 20, 40], np.int32)
    widths = np.asarray([7, 1, 4, 0], np.int32)
    tokens = np.random.default_rng(3).integers(0, CFG.vocab_size, (4, 7))
    want, got, rc, tc = _run_both(weights, tokens, lengths, k, v, tables,
                                  "pallas", widths=widths, all_logits=True,
                                  logits_at=None)
    valid = np.arange(7)[None, :] < widths[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.k.numpy()[:, :NP], np.asarray(rc.k),
                               atol=1e-5)
    np.testing.assert_allclose(tc.v.numpy()[:, :NP], np.asarray(rc.v),
                               atol=1e-5)


def test_sentinel_table_writes_drop(weights):
    """A slot whose table is all sentinels (a freed slot riding along in
    a batch) writes nothing: the pools stay bit-identical."""
    _, params = weights
    k, v, _ = _state(4, 1)
    tables = np.full((2, MP), NP, np.int32)
    cache = paged_engine.make_cache(_with_scratch(k), _with_scratch(v),
                                    np.asarray([0, 13], np.int32), tables)
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, CFG.vocab_size, (2, 3)))
    logits, cache = paged_engine.window_forward(
        params, tokens, TModelConfig(**dataclasses.asdict(CFG)), cache,
        logits_at=torch.zeros(2, dtype=torch.long))
    assert torch.equal(cache.k[:, :NP], torch.from_numpy(k))
    assert torch.equal(cache.v[:, :NP], torch.from_numpy(v))
    assert bool(torch.isfinite(logits).all())


def test_write_plan_drops_what_the_reference_drops():
    # 4 pages and the scratch page (id 4, the sentinel)
    cache = paged_engine.make_cache(
        torch.zeros((1, 5, 1, 2, 4)), torch.zeros((1, 5, 1, 2, 4)),
        np.asarray([2, 6, 0], np.int32),
        np.asarray([[0, 4], [1, 2], [3, 4]], np.int32))
    valid, pages, offs = paged_engine.write_plan(
        cache, 3, widths=np.asarray([3, 3, 0], np.int32))
    # fixed shape: every window position has a target, and `valid` says
    # which of them write; the others aim at the scratch page
    assert valid.shape == pages.shape == offs.shape == (3, 3)
    assert (pages.numpy()[~valid.numpy()] == 4).all()
    rows, cols = np.nonzero(valid.numpy())
    got = sorted(zip(rows.tolist(), cols.tolist(),
                     pages.numpy()[rows, cols].tolist(),
                     offs.numpy()[rows, cols].tolist()))
    # slot 0: positions 2, 3 in page 0; position 4 is a sentinel page.
    # slot 1: positions 6, 7 in page 2 (slot 1); position 8 is past the
    # table. slot 2: width 0 writes nothing.
    assert got == [(0, 0, 0, 2), (0, 1, 0, 3), (1, 0, 2, 2), (1, 1, 2, 3)]


@pytest.mark.parametrize("widths", [None, np.asarray([2, 3, 0], np.int32)])
def test_dropped_positions_never_clobber_a_write(weights, widths):
    """Positions that must not write (a slot on sentinel tables, positions
    past a row's width) land on the scratch page, so a valid write to
    page 0's position 0 in the same window survives: the pools' pages
    equal the reference's (which drops them)."""
    k, v, _ = _state(6, 1)
    tables = np.full((3, MP), NP, np.int32)
    tables[0, :2] = [0, 1]            # slot 0 writes page 0 from offset 0
    lengths = np.asarray([0, 5, 9], np.int32)
    tokens = np.random.default_rng(7).integers(0, CFG.vocab_size, (3, 3))
    _, _, rc, tc = _run_both(weights, tokens, lengths, k, v, tables,
                             "pallas", widths=widths, logits_at=None)
    np.testing.assert_allclose(tc.k.numpy()[:, :NP], np.asarray(rc.k),
                               atol=1e-5)
    np.testing.assert_allclose(tc.v.numpy()[:, :NP], np.asarray(rc.v),
                               atol=1e-5)
    assert not np.array_equal(tc.k.numpy()[:, 0, :, :, 0], k[:, 0, :, :, 0])
