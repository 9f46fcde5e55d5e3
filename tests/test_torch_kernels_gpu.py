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


@pytest.mark.gpu
@pytest.mark.parametrize("b,w,lengths,widths,d,ps,mp", [
    (8, 1, [1537, 2048, 977, 1800, 64, 1200, 1501, 333], None, 128, 128, 16),
    (2, 256, [2048, 1400], None, 128, 128, 16),
    (5, 256, [1700, 900, 1024, 77, 0], [1, 1, 256, 77, 0], 128, 128, 16),
    # head_dim 64, and page sizes off the 8-byte int8 vector path (12)
    (3, 40, [200, 41, 500], [40, 3, 17], 64, 16, 40),
    (3, 5, [7, 300, 96], None, 128, 12, 30)],
    ids=["decode", "prefill", "ragged", "dh64", "ps12"])
def test_cuda_kernel_int8_matches_plain(b, w, lengths, widths, d, ps, mp):
    """The int8 branch of the kernel (int8 pools + f32 scale pools from
    the port's quantize_pool) against the int8 plain version on the card,
    bf16 q, with the bf16 kernel's tolerance; the launch counts under the
    int8 class counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.inference.paged_engine import quantize_pool
    case = _case(17, b=b, w=w, lengths=lengths, widths=widths, d=d,
                 ps=ps, mp=mp)
    q = torch.from_numpy(case[0]).cuda().to(torch.bfloat16)
    kq, ks = quantize_pool(torch.from_numpy(case[1]).cuda())
    vq, vs = quantize_pool(torch.from_numpy(case[2]).cuda())
    lens, tabs, wid = (torch.from_numpy(x).cuda().to(torch.int32)
                       for x in case[3:])
    pa.reset_counters()
    got = pa.paged_attention(q, kq, vq, lens, tabs, 1, widths=wid,
                             k_scale_pool=ks, v_scale_pool=vs)
    torch.cuda.synchronize()
    c = pa.counters()
    assert (c["launches_narrow_int8"] + c["launches_wide_int8"] == 1
            and c["launches_narrow"] + c["launches_wide"] == 0)
    want = pa.paged_attention_ref(q, kq, vq, lens, tabs, 1, widths=wid,
                                  k_scale_pool=ks, v_scale_pool=vs)
    valid = ((torch.arange(w, device="cuda")[None, :] < wid[:, None])
             & (lens > 0)[:, None])
    assert bool(torch.isfinite(got).all())
    diff = (got.float() - want.float()).abs()[valid]
    ref_abs = want.float().abs()[valid]
    assert bool((diff <= 8e-3 + 1e-2 * ref_abs).all())
    assert float(diff.square().mean().sqrt()
                 / ref_abs.square().mean().sqrt()) <= 1e-2


@pytest.mark.gpu
def test_cuda_kernel_int8_checks_its_inputs():
    """The wrapper refuses what the int8 kernel does not take: bf16 pools
    with scales, one scale pool alone, scale pools of the wrong dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.inference.paged_engine import quantize_pool
    case = _case(19, b=2, w=1, lengths=[100, 7], widths=None, mp=4)
    q = torch.from_numpy(case[0]).cuda().to(torch.bfloat16)
    kp = torch.from_numpy(case[1]).cuda()
    kq, ks = quantize_pool(kp)
    lens, tabs = (torch.from_numpy(x).cuda().to(torch.int32)
                  for x in case[3:5])
    with pytest.raises(TypeError):
        pa.paged_attention(q, kp.bfloat16(), kp.bfloat16(), lens, tabs, 0,
                           k_scale_pool=ks, v_scale_pool=ks)
    with pytest.raises(ValueError):
        pa.paged_attention(q, kq, kq, lens, tabs, 0, k_scale_pool=ks)
    with pytest.raises(ValueError):
        pa.paged_attention(q, kq, kq, lens, tabs, 0, k_scale_pool=ks,
                           v_scale_pool=ks.double())


# The flash-attention kernels: the cases of chip_smoke.py's train_kernel
# phase, with its tolerances (atol one bf16 ulp at the size of the
# largest summed entries, rtol, and a relative RMS bound; PERF.md).
FLASH_TOL = {"out": (1.6e-2, 1e-2, 1e-2), "lse": (1e-5, 1e-6, 1e-6),
             "dq": (3.2e-2, 2e-2, 1e-2), "dk": (3.2e-2, 2e-2, 1e-2),
             "dv": (3.2e-2, 2e-2, 1e-3)}


def _flash_close(name, got, want):
    atol, rtol, rel = FLASH_TOL[name]
    g, w = got.detach().float(), want.detach().float()
    assert bool(torch.isfinite(g).all()), name
    diff = (g - w).abs()
    assert bool((diff <= atol + rtol * w.abs()).all()), name
    assert float(diff.square().mean().sqrt()
                 / w.square().mean().sqrt()) <= rel, name


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,docs,d", [(4, 2048, 0, 128), (4, 1024, 0, 128),
                                        (2, 2048, 4, 128), (2, 2048, 0, 64),
                                        (1, 1984, 0, 128), (2, 1000, 0, 128),
                                        (1, 2000, 0, 128), (2, 1024, 4, 128),
                                        (2, 1024, 0, 64), (2, 900, 3, 128),
                                        (1, 40, 0, 64)],
                         ids=["blocked", "fused", "segments", "dh64",
                              "s1984", "s1000", "s2000", "fused_segments",
                              "fused_dh64", "s900", "s40"])
def test_flash_kernels_match_plain(b, s, docs, d):
    """Forward, LSE and the three gradients of the flash kernels against
    the plain version on the card, bf16, at Llama-3.1-8B's head counts
    (H 32, KH 8) and head dims 128 and 64. S 2048 runs the dK/dV + dQ
    backward, S 1024 the fused one (also packed and at Dh 64); S 1984
    ends in a partial 128-row tile; S 1000 (fused) and S 2000 (blocked,
    the reference's block 16) run padded to a multiple of 64, S 900
    (fused, packed) and S 40 (fused, Dh 64) padded to 960 and 64, whose
    last 128-row tile is half empty."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.ops import flash_attention as fl
    r = np.random.default_rng(s + docs + 128 - d)
    q, k, v, dout = (torch.from_numpy(r.standard_normal(shape).astype(
        np.float32)).cuda().to(torch.bfloat16) for shape in (
        (b, s, 32, d), (b, s, 8, d), (b, s, 8, d), (b, s, 32, d)))
    seg = None
    if docs:
        cuts = [np.sort(r.choice(np.arange(1, s), docs - 1, replace=False))
                for _ in range(b)]
        seg = torch.from_numpy(np.stack([np.cumsum(np.isin(np.arange(s), c))
                                         for c in cuts]).astype(np.int32))
        seg = seg.cuda()
    fl.reset_counters()
    kq, kk, kv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = fl.flash_attention(kq, kk, kv, segment_ids=seg)
    out.backward(dout)
    pq, pk, pv = (t.clone().requires_grad_(True) for t in (q, k, v))
    want, lse_want = fl.flash_attention_ref(pq, pk, pv, seg)
    want.backward(dout)
    torch.cuda.synchronize()
    fused = fl.uses_fused_backward(s, s, 1024, 1024)
    assert fused == (s <= 1024)
    assert fl.counters() == {"launches_fwd": 1, "plain_calls": 1,
                             "launches_bwd_fused": int(fused),
                             "launches_bwd_dkdv": int(not fused),
                             "launches_bwd_dq": int(not fused)}
    s_pad = fl.padded_len(s)
    qt, kt, vt = (fl.to_kernel_layout(t, s_pad) for t in (q, k, v))
    segt = None if seg is None else fl.pad_segments(seg, s_pad)
    _, lse = fl.forward_bhsd(qt, kt, vt, segt, d ** -0.5)
    _flash_close("out", out, want)
    _flash_close("lse", lse[..., :s], lse_want)
    _flash_close("dq", kq.grad, pq.grad)
    _flash_close("dk", kk.grad, pk.grad)
    _flash_close("dv", kv.grad, pv.grad)


# The unembed on the card: chip_smoke.py's unembed phase on a slice of the
# train shapes, with its tolerances (relative RMS error, largest error over
# the largest reference entry; 3-4x the errors measured there): summation
# order only for the logits; two bf16 roundings of up to 2^-9 in the
# backward.
UNEMBED_TOL = {"logits": (1.5e-5, 2.5e-5), "dx": (5e-3, 1e-2),
               "dw": (4e-3, 8e-3)}


@pytest.mark.gpu
def test_unembed_f32_logits_and_grads_on_card():
    """bf16 hidden states and an f32 master head (D 4096, 2048 rows, a
    32768-entry slice of the vocabulary): the logits are float32 and match
    the widened f32 product; the gradients of the mean cross-entropy
    w.r.t. the hidden states and the head match the widened product's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.nn.functional as F
    from cloud_server_tpu_torch.config import ModelConfig
    from cloud_server_tpu_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    n, d, vocab = 2048, 4096, 32768
    cfg = ModelConfig(vocab_size=vocab, embed_dim=d, dtype="bfloat16",
                      param_dtype="float32")
    r = np.random.default_rng(5)
    x = torch.from_numpy(r.standard_normal((n, d)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    head = torch.from_numpy((r.standard_normal((d, vocab)) * d ** -0.5)
                            .astype(np.float32)).cuda()
    targets = torch.from_numpy(r.integers(0, vocab, n)).cuda()

    def run(xx, hh, fn):
        xx.requires_grad_(True)
        hh.requires_grad_(True)
        logits = fn(xx, hh)
        F.cross_entropy(logits, targets).backward()
        return logits.detach(), xx.grad, hh.grad

    got = run(x.clone(), head.clone(), lambda xx, hh: transformer.unembed(
        xx, {"lm_head": {"kernel": hh}}, cfg))
    assert got[0].dtype == torch.float32
    want = run(x.float(), head.to(torch.bfloat16).float(),
               lambda xx, hh: xx @ hh)
    for key, g, w in zip(("logits", "dx", "dw"), got, want):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        rms_lim, max_lim = UNEMBED_TOL[key]
        assert float(diff.square().mean().sqrt()
                     / w.square().mean().sqrt()) <= rms_lim, key
        assert float(diff.max() / w.abs().max()) <= max_lim, key


# The fused-CE kernels (B7, B8) against their plain version on the card at
# a slice of the train shapes, with chip_smoke.py's ce_kernel limits
# (CE_TOL there; PERF.md): logz and the target logit are f32 sums of the
# same bf16 products in another order; dx and dW carry the bf16 rounding
# of d, which the two versions may round to neighbouring values where the
# logits differ in their last bits.
CE_TOL = {"logz": 8e-6, "tl": 8e-6, "dx": (3e-5, 1e-2), "dw": (1e-5, 2e-3)}


# (N, V, case): the base slice; V 32896 = 257 x 128 (the last 256-column
# tile half past V); N 2176 = 17 x 128; ties: equal head columns, the
# largest for many rows, straddling a 256-column tile boundary and the
# boundary of two vocabulary ranges, where the first index must win; and
# rows whose g or h cotangent is 0.
CE_CASES = [(2048, 32768, "base"), (2048, 32896, "half_tile"),
            (2176, 32768, "odd_rows"), (2048, 32768, "ties"),
            (2048, 32896, "zero_cotangents")]


@pytest.mark.gpu
@pytest.mark.parametrize("n,vocab,case", CE_CASES)
def test_fused_ce_kernels_match_plain(n, vocab, case):
    """B7's statistics and B8's dx, and the dW built from B8's d, against
    the plain version on bf16 inputs (D 4096, a slice of the vocabulary);
    the argmax may differ only where the two logits lie within the logz
    limit of each other, and on tied columns it is the first of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.ops import fused_ce as fc
    torch.backends.cuda.matmul.allow_tf32 = False
    d = 4096
    r = np.random.default_rng(6)
    x = torch.from_numpy(r.standard_normal((n, d)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    head_np = (r.standard_normal((d, vocab)) * d ** -0.5).astype(np.float32)
    tied = []
    if case == "ties":
        splits = fc.vocab_splits(n, vocab,
                                 torch.cuda.get_device_properties(
                                     0).multi_processor_count)
        first = fc.range_tiles(1, splits, fc.col_tiles(vocab))[0]
        edge = first * fc.COL_TILE  # first column of the second range
        tied = [255, 256, edge - 1, edge, vocab - 1]
        head_np[:, tied] = 4 * head_np[:, :1]
    head = torch.from_numpy(head_np).cuda().to(torch.bfloat16)
    t = torch.from_numpy(r.integers(0, vocab, n)).cuda()
    gz = torch.from_numpy(r.standard_normal(n).astype(np.float32)).cuda()
    gt = torch.from_numpy(r.standard_normal(n).astype(np.float32)).cuda()
    if case == "zero_cotangents":
        gz[::3] = 0
        gt[1::3] = 0

    def run(fn):
        xx = x.clone().requires_grad_(True)
        hh = head.clone().requires_grad_(True)
        logz, tl, am = fn(xx, hh, t)
        ((logz * gz).sum() + (tl * gt).sum()).backward()
        return logz.detach(), tl.detach(), am, xx.grad, hh.grad

    fc.reset_counters()
    got = run(fc.fused_ce_stats)
    torch.cuda.synchronize()
    assert fc.counters() == {"launches_fwd": 1, "launches_dx": 1,
                             "plain_calls": 0}
    want = run(fc.fused_ce_stats_ref)
    for key, g, w in zip(("logz", "tl"), got[:2], want[:2]):
        assert bool(torch.isfinite(g).all()), key
        assert float((g - w).abs().max()) <= CE_TOL[key], key
    logits = torch.mm(x, head, out_dtype=torch.float32)
    rows = torch.arange(n, device="cuda")
    gap = logits[rows, want[2]] - logits[rows, got[2]]
    assert float(gap.max()) <= CE_TOL["logz"]
    if tied:
        on_tie = torch.isin(got[2], torch.tensor(tied, device="cuda"))
        assert bool(on_tie.any())
        assert bool((got[2][on_tie] == tied[0]).all())
    # the plain statistics in the kernel's order, over the ranges the
    # wrapper chose for this card
    with torch.no_grad():
        by_ranges = fc.stats_by_ranges_ref(
            x, head, t, fc.device_splits(n, vocab, x.device))
    for key, g, w in zip(("logz", "tl"), got[:2], by_ranges[:2]):
        assert float((g - w).abs().max()) <= CE_TOL[key], key
    gap = logits[rows, by_ranges[2]] - logits[rows, got[2]]
    assert float(gap.abs().max()) <= CE_TOL["logz"]
    for key, g, w in zip(("dx", "dw"), got[3:], want[3:]):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        rms_lim, max_lim = CE_TOL[key]
        assert float(diff.square().mean().sqrt()
                     / w.square().mean().sqrt()) <= rms_lim, key
        assert float(diff.max() / w.abs().max()) <= max_lim, key


# (N, V): the shapes of tests/test_torch_fused_ce.py's schedule test
CE_SCHEDULE_SHAPES = [(n, v) for n in (128, 2176, 8192)
                      for v in (384, 32896, 128256)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,v", CE_SCHEDULE_SHAPES)
def test_ce_schedule_matches_the_kernels_units(n, v):
    """The wrapper's ce_schedule, which the CPU tests check, lists the
    units that csrc/fused_ce.cu's unit_of gives each block (its host
    entry ce_units): for B7 and d on this card's ranges, and for dx."""
    import ctypes
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.ops import fused_ce as fc
    d = 4096
    rows = n // fc.TILE
    for cols, splits, is_dx, group in (
            (v, fc.device_splits(n, v, torch.device("cuda")), 0,
             fc.ROW_GROUP),
            (d, fc.col_tiles(d), 1, fc.DX_ROW_GROUP)):
        out = np.zeros((rows * splits, 4), np.int32)
        assert fc._kernel("ce_units")(
            n, cols, splits, is_dx, out.ctypes.data_as(ctypes.c_void_p)) == 0
        want = fc.ce_schedule(rows, fc.col_tiles(cols), splits, group)
        assert [tuple(u) for u in out.tolist()] == want
