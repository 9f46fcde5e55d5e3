"""The port's flash attention (its plain version, which the wrapper runs
on CPU tensors) against the reference's Pallas flash attention run in
interpret mode, float32 on the CPU, on the same numpy inputs: the output,
the per-row LSE, and dQ, dK, dV for the blocked backward (S > block), the
fused backward (S <= block), GQA and packed segments; and the CUDA
path's pad of S to a multiple of 64 (and slice back) around the plain
version, at S 40 and 70, fused and blocked, with and without segments.

Tolerance: the forward within 1e-5 of the largest reference value, the
gradients within 1e-4 of the largest reference gradient (float32 both;
the sums run in other orders and the reference accumulates blockwise).
The CUDA kernels themselves are held against this plain version on the
card (tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.ops import flash_attention as ref_fa
from cloud_server_tpu_torch.ops import flash_attention as fl

FWD_TOL = 1e-5
GRAD_TOL = 1e-4

CASES = {
    # name: (B, S, H, KH, Dh, block, segments per row)
    "blocked": (2, 32, 4, 4, 8, 16, 0),
    "fused": (2, 16, 4, 4, 8, 16, 0),
    "gqa_blocked": (2, 32, 4, 2, 8, 8, 0),
    "gqa_fused": (1, 16, 4, 2, 16, 32, 0),
    "segments": (2, 32, 4, 2, 8, 16, 3),
}
# S the kernels do not take as it is: the wrapper pads it to 64 or 128.
# Blocks: 64 or 1024 (fused, S fits one block), 20 and 35 (blocked; the
# reference's blocks of S 40 and S 70 are divisors of S)
PADDED = {
    "s40_fused": (2, 40, 4, 2, 8, 64, 0),
    "s40_fused_segments": (2, 40, 4, 2, 8, 64, 3),
    "s40_blocked": (2, 40, 4, 2, 8, 20, 0),
    "s40_blocked_segments": (2, 40, 4, 2, 8, 20, 3),
    "s70_fused": (1, 70, 4, 2, 16, 1024, 0),
    "s70_fused_segments": (1, 70, 4, 2, 16, 1024, 4),
    "s70_blocked": (1, 70, 4, 2, 16, 35, 0),
    "s70_blocked_segments": (1, 70, 4, 2, 16, 35, 4),
}


def _inputs(name, cases=CASES):
    b, s, h, kh, d, block, docs = cases[name]
    r = np.random.default_rng(sum(map(ord, name)))
    q = r.standard_normal((b, s, h, d)).astype(np.float32)
    k = r.standard_normal((b, s, kh, d)).astype(np.float32)
    v = r.standard_normal((b, s, kh, d)).astype(np.float32)
    dout = r.standard_normal((b, s, h, d)).astype(np.float32)
    seg = None
    if docs:
        seg = np.stack([np.cumsum(np.isin(np.arange(s), np.sort(
            r.choice(np.arange(1, s), docs - 1, replace=False))))
            for _ in range(b)]).astype(np.int32)
    return q, k, v, dout, seg, block


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_lse_match_reference(name):
    q, k, v, _, seg, block = _inputs(name)
    d = q.shape[-1]
    want = ref_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block,
        block_kv=block, interpret=True,
        segment_ids=None if seg is None else jnp.asarray(seg))
    bq = ref_fa._default_block(q.shape[1], block)
    _, lse_want = ref_fa._fwd(
        jnp.asarray(q).transpose(0, 2, 1, 3),
        jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3),
        None if seg is None else jnp.asarray(seg), scale=d ** -0.5,
        block_q=bq, block_kv=bq, interpret=True)
    out, lse = fl.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if seg is None else torch.from_numpy(seg))
    _close(out.numpy(), want, FWD_TOL)
    _close(lse.numpy(), np.asarray(lse_want)[..., 0], FWD_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_gradients_match_reference(name):
    q, k, v, dout, seg, block = _inputs(name)
    jseg = None if seg is None else jnp.asarray(seg)

    def loss(q_, k_, v_):
        out = ref_fa.flash_attention(q_, k_, v_, block_q=block,
                                     block_kv=block, interpret=True,
                                     segment_ids=jseg)
        return (out * jnp.asarray(dout)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    out = fl.flash_attention(tq, tk, tv, block_q=block, block_kv=block,
                             segment_ids=None if seg is None
                             else torch.from_numpy(seg))
    (out * torch.from_numpy(dout)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got.numpy(), ref, GRAD_TOL)


def test_cpu_tensor_runs_the_plain_version_and_counts_it():
    q, k, v, _, _, _ = _inputs("gqa_fused")
    fl.reset_counters()
    out = fl.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v))
    assert out.shape == q.shape
    assert fl.counters() == {"launches_fwd": 0, "launches_bwd_dkdv": 0,
                             "launches_bwd_dq": 0, "launches_bwd_fused": 0,
                             "plain_calls": 1}


@pytest.mark.parametrize("seq,block", [(16, 16), (2048, 1024),
                                       (1024, 1024), (48, 32), (6, 1024),
                                       (1536, 1024), (1000, 1024),
                                       (2000, 1024)])
def test_block_rule_matches_reference(seq, block):
    """The backward's dispatch follows the reference's blocks: fused
    exactly when the whole sequence fits one block."""
    got = fl.default_block(seq, block)
    assert got == ref_fa._default_block(seq, block)
    assert fl.uses_fused_backward(seq, seq, block, block) == (seq <= got)


def test_unaligned_rows_are_copied_for_the_kernels():
    """The TMA kernels read 16-byte aligned rows: an aligned tensor goes
    to them as it is, an unaligned view as an aligned copy of its
    values."""
    seg = torch.arange(40, dtype=torch.int32)
    assert fl._aligned(seg) is seg
    view = seg[1:33]
    assert view.data_ptr() % 16
    got = fl._aligned(view)
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got, view)


def _lse_reference(q, k, v, seg, block):
    """The reference forward's LSE (B, H, S) at the reference's blocks."""
    bq = ref_fa._default_block(q.shape[1], block)
    _, lse = ref_fa._fwd(
        jnp.asarray(q).transpose(0, 2, 1, 3),
        jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3),
        None if seg is None else jnp.asarray(seg), scale=q.shape[-1] ** -0.5,
        block_q=bq, block_kv=bq, interpret=True)
    return np.asarray(lse)[..., 0]


@pytest.mark.parametrize("name", sorted(PADDED))
def test_padded_plain_matches_reference(name):
    """The CUDA path's layout copy with S padded to a multiple of 64
    (zero rows; segment ids padded with a fresh id) and its slice back,
    applied around the plain version, against the reference at the
    unpadded S: out, LSE, dQ, dK and dV. The pad is exact: the padded
    keys lie after every real query, and the padded query rows get no
    gradient."""
    q, k, v, dout, seg, block = _inputs(name, PADDED)
    s = q.shape[1]
    s_pad = fl.padded_len(s)
    assert s < s_pad and s_pad % fl.KERNEL_ROWS == 0
    assert fl.uses_fused_backward(s, s, block, block) == ("fused" in name)
    jseg = None if seg is None else jnp.asarray(seg)

    def loss(q_, k_, v_):
        out = ref_fa.flash_attention(q_, k_, v_, block_q=block,
                                     block_kv=block, interpret=True,
                                     segment_ids=jseg)
        return (out * jnp.asarray(dout)).sum(), out

    (_, out_want), grads_want = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    qp, kp, vp = (fl.to_kernel_layout(x, s_pad).transpose(1, 2)
                  for x in (tq, tk, tv))
    segp = None if seg is None else fl.pad_segments(torch.from_numpy(seg),
                                                    s_pad)
    out_pad, lse_pad = fl.flash_attention_ref(qp, kp, vp, segp)
    out = fl.from_kernel_layout(out_pad.transpose(1, 2), s)
    _close(out.detach().numpy(), out_want, FWD_TOL)
    _close(lse_pad[..., :s].detach().numpy(),
           _lse_reference(q, k, v, seg, block), FWD_TOL)
    (out * torch.from_numpy(dout)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), grads_want):
        _close(got.numpy(), want, GRAD_TOL)


def test_pad_segments_uses_a_fresh_id_per_row():
    """Padded positions get an id no real position of their row has; an
    S already a multiple of 64 is passed on without a pad."""
    seg = torch.tensor([[0, 0, 1, 1, 2], [7, 7, 3, 3, 3]])
    got = fl.pad_segments(seg, 64)
    assert got.dtype == torch.int32 and got.shape == (2, 64)
    assert torch.equal(got[:, :5], seg.to(torch.int32))
    assert got[0, 5:].eq(3).all() and got[1, 5:].eq(8).all()
    full = torch.zeros((2, 64), dtype=torch.int32)
    assert fl.pad_segments(full, 64) is full


@pytest.mark.parametrize("dtype,d,what", [
    (torch.bfloat16, 96, "head_dim 96"),
    (torch.float32, 128, "dtype torch.float32"),
    (torch.float16, 64, "dtype torch.float16")])
def test_unported_head_dims_and_dtypes_raise_not_implemented(dtype, d,
                                                             what):
    """What the kernels were not built for is refused as not ported,
    naming the value."""
    q = torch.zeros((1, 1000, 4, d), dtype=dtype)
    k = torch.zeros((1, 1000, 2, d), dtype=dtype)
    with pytest.raises(NotImplementedError, match=what):
        fl._validate(q, k, k, None)


def test_mismatched_shapes_raise_value_error():
    q = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    for k, seg in ((torch.zeros((1, 32, 2, 64), dtype=torch.bfloat16), None),
                   (torch.zeros((1, 64, 3, 64), dtype=torch.bfloat16), None),
                   (torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16),
                    torch.zeros((1, 63), dtype=torch.int32))):
        with pytest.raises(ValueError):
            fl._validate(q, k, k, seg)
    fl._validate(q, q[:, :, :2], q[:, :, :2], None)  # S 64, GQA 2: taken
