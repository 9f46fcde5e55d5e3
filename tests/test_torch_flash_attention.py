"""The port's flash attention (its plain version, which the wrapper runs
on CPU tensors) against the reference's Pallas flash attention run in
interpret mode, float32 on the CPU, on the same numpy inputs: the output,
the per-row LSE, and dQ, dK, dV for the blocked backward (S > block), the
fused backward (S <= block), GQA and packed segments.

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


def _inputs(name):
    b, s, h, kh, d, block, docs = CASES[name]
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
                                       (1536, 1024)])
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
