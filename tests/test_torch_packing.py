"""Packed rows in the port against the reference, float32 on the CPU, from
the same numpy weights and batches (tests/test_packing.py's cases but
its sharded one, which needs a device mesh):

  * the packer's layout and the segment helpers equal the reference's;
  * a packed row's logits equal each document's standalone logits
    (1e-4) and the reference's packed logits (1e-4);
  * the packed loss equals the token-weighted standalone losses (1e-5
    relative) on the dense and vocab-chunked CE, and the reference's
    packed loss (1e-5) with every gradient leaf within 1e-4 of its
    largest reference entry; the same for the fused CE route
    (ce_impl="pallas", the reference's kernels in interpret mode), the
    MoE loss (1e-4 relative against standalone, as the reference's test)
    and attention_impl="flash";
  * the flash wrapper's segment mask, forward (2e-5) and gradients
    (1e-4), against the reference's flash kernels in interpret mode.
"""

import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.data import packing as ref_packing
from cloud_server_tpu.models import moe as ref_moe
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu.ops import segments as ref_segments
from cloud_server_tpu_torch import config as tconfig
from cloud_server_tpu_torch.data.packing import (PackedTokenDataset,
                                                 pack_documents,
                                                 packing_efficiency)
from cloud_server_tpu_torch.models import moe, transformer
from cloud_server_tpu_torch.ops import flash_attention as fl
from cloud_server_tpu_torch.ops.segments import (positions_from_segments,
                                                 segment_target_mask)
from cloud_server_tpu_torch.training import optim

TINY = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=32, dtype="float32",
    param_dtype="float32", remat="none")
D1 = [5, 9, 3, 17, 6, 2]
D2 = [8, 4, 1, 2, 7, 11, 13, 9]


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the reference's compiled XLA programs when the module ends
    (each holds a few memory maps; see tests/test_torch_moe.py)."""
    yield
    jax.clear_caches()
    gc.collect()


def _t(cfg):
    return tconfig.ModelConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(ref_params, cfg, grad=False):
    p = transformer.params_from_numpy(_np(ref_params), _t(cfg), device="cpu",
                                      keep_param_dtype=True)
    return optim.map_tree(lambda x: x.requires_grad_(True), p) if grad else p


@pytest.fixture(scope="module")
def dense():
    return ref_tf.init_params(TINY, jax.random.key(0))


def _batch(docs, seq_len):
    toks, segs = pack_documents(docs, seq_len)
    return ({"tokens": jnp.asarray(toks), "segment_ids": jnp.asarray(segs)},
            {"tokens": torch.from_numpy(toks),
             "segment_ids": torch.from_numpy(segs)})


def _assert_grads(port_params, want, tol=1e-4):
    flat_want = dict(optim.flatten(_np(want)))
    flat_got = dict(optim.flatten(optim.map_tree(lambda p: p.grad,
                                                 port_params)))
    assert sorted(flat_got) == sorted(flat_want)
    for path, w in flat_want.items():
        np.testing.assert_allclose(
            flat_got[path].numpy(), w, rtol=0,
            atol=tol * max(float(np.abs(w).max()), 1e-30), err_msg=path)


# ---------------------------------------------------------------------------
# Packer and segment helpers
# ---------------------------------------------------------------------------

def test_pack_documents_layout():
    toks, segs = pack_documents([[1, 2, 3], [4, 5], [6, 7, 8, 9]], 6)
    np.testing.assert_array_equal(toks, [[1, 2, 3, 4, 5, 0],
                                         [6, 7, 8, 9, 0, 0]])
    np.testing.assert_array_equal(segs, [[1, 1, 1, 2, 2, 0],
                                         [1, 1, 1, 1, 0, 0]])
    assert packing_efficiency(segs) == pytest.approx(9 / 12)


def test_pack_documents_splits_long_docs():
    toks, segs = pack_documents([list(range(1, 11))], 4)
    np.testing.assert_array_equal(
        toks, [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 0, 0]])
    np.testing.assert_array_equal(
        segs, [[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 0, 0]])


def test_packer_and_dataset_match_reference():
    """Seeded documents of 1-40 tokens (some longer than a row, some
    empty) pack exactly as the reference packs them."""
    r = np.random.default_rng(3)
    docs = [list(r.integers(1, 64, int(n))) for n in r.integers(0, 40, 50)]
    got = PackedTokenDataset(docs, 32, pad_id=1)
    want = ref_packing.PackedTokenDataset(docs, 32, pad_id=1)
    assert len(got) == len(want)
    for i in (0, len(want) // 2, len(want) - 1):
        for key in ("tokens", "segment_ids"):
            np.testing.assert_array_equal(got[i][key], want[i][key])
    assert packing_efficiency(got.segment_ids) == \
        ref_packing.packing_efficiency(want.segment_ids)


def test_positions_restart_per_segment():
    segs = torch.tensor([[1, 1, 1, 2, 2, 0], [1, 1, 1, 1, 0, 0]])
    np.testing.assert_array_equal(positions_from_segments(segs),
                                  [[0, 1, 2, 0, 1, 0], [0, 1, 2, 3, 0, 1]])
    r = np.random.default_rng(5)
    seg = np.sort(r.integers(0, 6, (4, 40)), axis=1)[:, ::-1].copy()
    np.testing.assert_array_equal(
        positions_from_segments(torch.from_numpy(seg)).numpy(),
        np.asarray(ref_segments.positions_from_segments(jnp.asarray(seg))))


def test_segment_target_mask():
    segs = torch.tensor([[1, 1, 2, 2, 0, 0]])
    np.testing.assert_array_equal(segment_target_mask(segs),
                                  [[0, 1, 0, 1, 0, 0]])
    seg = np.random.default_rng(6).integers(0, 3, (3, 24))
    np.testing.assert_array_equal(
        segment_target_mask(torch.from_numpy(seg)).numpy(),
        np.asarray(ref_segments.segment_target_mask(jnp.asarray(seg))))


# ---------------------------------------------------------------------------
# Packed forward and losses
# ---------------------------------------------------------------------------

def test_packed_forward_matches_standalone(dense):
    """Logits inside a packed row equal each document's standalone logits
    (the segment mask AND the per-segment positions) and the reference's
    packed logits."""
    params = _port(dense, TINY)
    d1, d2 = D1[:5], D2[:7]
    ref_b, b = _batch([d1, d2], 16)
    cfg = _t(TINY)
    with torch.no_grad():
        packed = transformer.forward(params, b["tokens"], cfg,
                                     b["segment_ids"])
        alone1 = transformer.forward(params, torch.tensor([d1]), cfg)
        alone2 = transformer.forward(params, torch.tensor([d2]), cfg)
    np.testing.assert_allclose(packed[0, :5].numpy(), alone1[0].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(packed[0, 5:12].numpy(), alone2[0].numpy(),
                               atol=1e-4)
    want = ref_tf.forward(dense, ref_b["tokens"], TINY,
                          ref_b["segment_ids"])
    np.testing.assert_allclose(packed.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("vocab_chunk", [0, 32])
def test_packed_loss_matches_standalone(dense, vocab_chunk):
    """Packed loss == token-weighted mean of standalone per-doc losses
    (cross-boundary and padding targets masked) on both CE paths, and the
    reference's packed loss and gradients."""
    cfg = dataclasses.replace(TINY, vocab_chunk=vocab_chunk)
    params = _port(dense, cfg, grad=True)
    ref_b, b = _batch([D1, D2], 16)
    loss, metrics = transformer.next_token_loss(params, b, _t(cfg))
    loss.backward()

    def alone_nll(doc):
        with torch.no_grad():
            lo, _ = transformer.next_token_loss(
                params, {"tokens": torch.tensor([doc])}, _t(cfg))
        return float(lo) * (len(doc) - 1)

    want = (alone_nll(D1) + alone_nll(D2)) / (len(D1) + len(D2) - 2)
    assert float(loss.detach()) == pytest.approx(want, rel=1e-5)
    (ref_loss, ref_m), ref_g = jax.value_and_grad(
        ref_tf.next_token_loss, has_aux=True)(dense, ref_b, cfg)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    assert float(metrics["accuracy"]) == pytest.approx(
        float(ref_m["accuracy"]), abs=1e-6)
    _assert_grads(params, ref_g)


def test_packed_fused_ce_loss_matches_reference():
    """ce_impl="pallas" (the fused CE route: B7/B8 on the card, their
    plain versions here) honours the segment mask: the packed loss and
    gradients equal the reference's (its kernels in interpret mode) and
    the port's dense-CE packed loss."""
    cfg = dataclasses.replace(TINY, vocab_size=128, max_seq_len=64,
                              ce_impl="pallas")
    ref_params = ref_tf.init_params(cfg, jax.random.key(4))
    r = np.random.default_rng(8)
    docs = [list(r.integers(1, 128, int(n))) for n in (20, 33, 9, 41, 17)]
    ref_b, b = _batch(docs, 64)
    assert b["tokens"].shape == (2, 64)
    params = _port(ref_params, cfg, grad=True)
    loss, _ = transformer.next_token_loss(params, b, _t(cfg))
    loss.backward()
    (ref_loss, _), ref_g = jax.value_and_grad(
        ref_tf.next_token_loss, has_aux=True)(ref_params, ref_b, cfg)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    _assert_grads(params, ref_g)
    with torch.no_grad():
        dense_loss, _ = transformer.next_token_loss(
            _port(ref_params, cfg), b, _t(dataclasses.replace(
                cfg, ce_impl="dense")))
    assert float(loss.detach()) == pytest.approx(float(dense_loss), rel=1e-5)


def test_packed_moe_loss_matches_standalone():
    """The MoE family honours segment_ids the same way the dense one does
    (capacity generous, so routing is identical packed and alone), and
    the packed loss and gradients equal the reference's (router stats
    included)."""
    cfg = dataclasses.replace(TINY, num_experts=4,
                              expert_capacity_factor=8.0)
    ref_params = ref_moe.init_params(cfg, jax.random.key(0))
    params = _port(ref_params, cfg, grad=True)
    ref_b, b = _batch([D1, D2], 16)
    loss, metrics = moe.next_token_loss(params, b, _t(cfg),
                                        aux_loss_coef=0.0)

    def alone_nll(doc):
        with torch.no_grad():
            lo, _ = moe.next_token_loss(
                params, {"tokens": torch.tensor([doc])}, _t(cfg),
                aux_loss_coef=0.0)
        return float(lo) * (len(doc) - 1)

    want = (alone_nll(D1) + alone_nll(D2)) / (len(D1) + len(D2) - 2)
    assert float(loss.detach()) == pytest.approx(want, rel=1e-4)
    loss.backward()
    (ref_loss, ref_m), ref_g = jax.value_and_grad(
        lambda p: ref_moe.next_token_loss(p, ref_b, cfg, aux_loss_coef=0.0),
        has_aux=True)(ref_params)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    for key in ("load_balance", "router_z"):
        assert float(metrics[key]) == pytest.approx(float(ref_m[key]),
                                                    rel=1e-5)
    _assert_grads(params, ref_g)


def test_packed_flash_loss_matches_xla_loss(dense):
    """attention_impl="flash" on a packed batch reproduces the "xla"
    packed loss, and the reference's flash packed loss."""
    cfg_f = dataclasses.replace(TINY, attention_impl="flash")
    ref_b, b = _batch([[5, 9, 3, 17, 6], [8, 4, 1, 2, 7, 11]], 16)
    params = _port(dense, TINY)
    with torch.no_grad():
        loss_x, _ = transformer.next_token_loss(params, b, _t(TINY))
        loss_f, _ = transformer.next_token_loss(params, b, _t(cfg_f))
    np.testing.assert_allclose(float(loss_f), float(loss_x), rtol=1e-5)
    ref_f, _ = ref_tf.next_token_loss(dense, ref_b, cfg_f)
    np.testing.assert_allclose(float(loss_f), float(ref_f), rtol=1e-5)


# ---------------------------------------------------------------------------
# The flash wrapper's segment mask
# ---------------------------------------------------------------------------

def _rand_qkv(seed, b, s, h, kh, d):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, s, h, d)).astype(np.float32),
            r.standard_normal((b, s, kh, d)).astype(np.float32),
            r.standard_normal((b, s, kh, d)).astype(np.float32))


@pytest.mark.parametrize("block", [32, 128])
def test_flash_segments_match_reference(block):
    """The flash wrapper's segment mask (forward) against the reference's
    flash kernel in interpret mode, blocked and single-block."""
    from cloud_server_tpu.ops.flash_attention import flash_attention
    q, k, v = _rand_qkv(0, 2, 128, 4, 2, 8)
    segs = np.repeat([[1] * 40 + [2] * 50 + [3] * 30 + [0] * 8], 2, axis=0)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           segment_ids=jnp.asarray(segs), block_q=block,
                           block_kv=block, interpret=True)
    got = fl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), block_q=block,
                             block_kv=block,
                             segment_ids=torch.from_numpy(segs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("block", [32, 128])
def test_flash_segments_grads_match_reference(block):
    """Backward: the gradients of a segment-masked flash attention equal
    the reference's three backward kernels' (interpret mode)."""
    from cloud_server_tpu.ops.flash_attention import flash_attention
    q, k, v = _rand_qkv(1, 1, 128, 4, 4, 8)
    segs = np.asarray([[1] * 48 + [2] * 70 + [0] * 10])
    gx = jax.grad(lambda q_, k_, v_: (flash_attention(
        q_, k_, v_, segment_ids=jnp.asarray(segs), block_q=block,
        block_kv=block, interpret=True) ** 2).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    (fl.flash_attention(tq, tk, tv, block_q=block, block_kv=block,
                        segment_ids=torch.from_numpy(segs)) ** 2
     ).sum().backward()
    for got, want, n in zip((tq.grad, tk.grad, tv.grad), gx, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=f"d{n}")
