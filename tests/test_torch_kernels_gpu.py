"""The CUDA kernels of the port against their plain PyTorch versions on
the card. Every test here needs an NVIDIA GPU and skips without one. The
module imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from cloud_server_tpu_torch.ops import paged_attention as pa


def _case(seed, *, b, w, lengths, widths, h=32, kh=8, d=128, ps=128, mp=16):
    r = np.random.default_rng(seed)
    num_pages = b * mp + 3
    k_pool = r.standard_normal((2, num_pages, kh, d, ps)).astype(np.float32)
    v_pool = r.standard_normal((2, num_pages, kh, d, ps)).astype(np.float32)
    q = r.standard_normal((b, w, h, d)).astype(np.float32)
    tables = r.permutation(num_pages)[:b * mp].reshape(b, mp)
    widths = [w] * b if widths is None else widths
    return q, k_pool, v_pool, np.asarray(lengths), tables, np.asarray(widths)


@pytest.mark.gpu
@pytest.mark.parametrize("b,w,lengths,widths,d,ps,mp", [
    (8, 1, [1537, 2048, 977, 1800, 64, 1200, 1501, 333], None, 128, 128, 16),
    (2, 256, [2048, 1400], None, 128, 128, 16),
    (5, 256, [1700, 900, 1024, 77, 0], [1, 1, 256, 77, 0], 128, 128, 16),
    # head_dim 64, and page sizes off the 16-byte vector path (12)
    (3, 40, [200, 41, 500], [40, 3, 17], 64, 16, 40),
    (3, 5, [7, 300, 96], None, 128, 12, 30)])
def test_cuda_kernel_matches_plain(b, w, lengths, widths, d, ps, mp):
    """The Hopper kernel against the plain version on the card, bf16,
    at Llama-3.1-8B's head shapes and at other head dims and page sizes
    (H 32, KH 8). Tolerance, as in chip_smoke.py: about one bf16 ulp,
    |err| <= 8e-3 + 1e-2 * |plain|, and the error's RMS within 1% of the
    plain output's RMS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = _case(13, b=b, w=w, lengths=lengths, widths=widths, d=d,
                 ps=ps, mp=mp)
    q, kp, vp = (torch.from_numpy(x).cuda().to(torch.bfloat16)
                 for x in case[:3])
    lens, tabs, wid = (torch.from_numpy(x).cuda().to(torch.int32)
                       for x in case[3:])
    pa.reset_counters()
    got = pa.paged_attention(q, kp, vp, lens, tabs, 1, widths=wid)
    assert pa.launches_narrow + pa.launches_wide == 1
    want = pa.paged_attention_ref(q, kp, vp, lens, tabs, 1, widths=wid)
    valid = ((torch.arange(w, device="cuda")[None, :] < wid[:, None])
             & (lens > 0)[:, None])
    assert bool(torch.isfinite(got).all())
    diff = (got.float() - want.float()).abs()[valid]
    ref_abs = want.float().abs()[valid]
    assert bool((diff <= 8e-3 + 1e-2 * ref_abs).all())
    assert float(diff.square().mean().sqrt()
                 / ref_abs.square().mean().sqrt()) <= 1e-2
