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


# (B, W, lengths, widths, Dh, ps, max_pages) at H 32, KH 8 (G 4). The
# narrow kernel takes W <= 32 and B <= 16 (split-KV in clusters of up to 8
# blocks); the wide kernel the rest (row blocks of 128 folded rows).
# ps % 64 == 0 runs the TMA loader, ps 16 the cp.async one, ps 12 the
# element-wise one.
PAGED_CASES = [
    pytest.param(8, 1, [1537, 2048, 977, 1800, 64, 1200, 1501, 333], None,
                 128, 128, 16, id="decode"),
    pytest.param(2, 256, [2048, 1400], None, 128, 128, 16, id="prefill"),
    pytest.param(5, 256, [1700, 900, 1024, 77, 0], [1, 1, 256, 77, 0], 128,
                 128, 16, id="ragged"),
    # head_dim 64, and page sizes off the TMA box (16) and off the 8-wide
    # copies (12)
    pytest.param(3, 40, [200, 41, 500], [40, 3, 17], 64, 16, 40, id="dh64"),
    pytest.param(3, 5, [7, 300, 96], None, 128, 12, 30, id="ps12"),
    # decode width in the wide class (B > 16)
    pytest.param(17, 1, [1 + 121 * i for i in range(17)], None, 128, 128,
                 16, id="wide_decode"),
    # the narrow class's edge: 128 folded rows, clusters of 8
    pytest.param(16, 32, [32 + 127 * i for i in range(16)], None, 128, 128,
                 16, id="narrow_edge"),
    # whole wide row blocks past a slot's width (they write zeros), a
    # width-1 row of length 1
    pytest.param(4, 256, [2000, 300, 256, 1], [3, 256, 40, 1], 128, 128, 16,
                 id="ragged_dead_blocks"),
    # lengths across the tile (64) and split (4 tiles) boundaries, and
    # shorter than one tile: narrow, then wide
    pytest.param(8, 1, [1, 63, 64, 65, 256, 257, 1025, 2047], None, 128,
                 128, 16, id="narrow_split_edges"),
    pytest.param(4, 8, [8, 70, 520, 1999], [8, 2, 8, 5], 128, 128, 16,
                 id="verify_split_edges"),
    pytest.param(3, 40, [40, 129, 700], [40, 5, 33], 128, 128, 16,
                 id="wide_tile_edges"),
    # ps 64, the smallest TMA page: a tile is a whole page
    pytest.param(4, 1, [1, 64, 65, 900], None, 128, 64, 16, id="narrow_ps64"),
    pytest.param(2, 48, [48, 700], None, 128, 64, 12, id="wide_ps64"),
    # the cp.async and element-wise loaders on the other kernel
    pytest.param(3, 1, [16, 100, 333], None, 128, 16, 30, id="narrow_ps16"),
    pytest.param(2, 40, [40, 200], [40, 7], 128, 12, 30, id="wide_ps12"),
    # head dim 64 through the TMA loader, both kernels
    pytest.param(4, 8, [300, 70, 1, 2000], [8, 3, 1, 8], 64, 128, 16,
                 id="narrow_dh64"),
    pytest.param(2, 64, [64, 900], None, 64, 128, 8, id="wide_dh64"),
]


def _check_paged(got, want, w, lens, wid):
    """Tolerance, as in chip_smoke.py: about one bf16 ulp, |err| <= 8e-3 +
    1e-2 * |plain|, and the error's RMS within 1% of the plain output's
    RMS, on the rows inside each slot's width; every row finite."""
    valid = ((torch.arange(w, device="cuda")[None, :] < wid[:, None])
             & (lens > 0)[:, None])
    assert bool(torch.isfinite(got).all())
    diff = (got.float() - want.float()).abs()[valid]
    ref_abs = want.float().abs()[valid]
    assert bool((diff <= 8e-3 + 1e-2 * ref_abs).all())
    assert float(diff.square().mean().sqrt()
                 / ref_abs.square().mean().sqrt()) <= 1e-2


def _launched_class(b, w, int8, d=128):
    """The counters the call must have moved (its class, and the bf16
    breakdowns by verify window and head dim; the calls below flag every
    window wider than 1 as a verify), and the others at 0."""
    narrow = pa.uses_narrow_kernel(b, w, 32 // 8)
    want = dict.fromkeys(pa.counters(), 0)
    want[("launches_narrow" if narrow else "launches_wide")
         + ("_int8" if int8 else "")] = 1
    if not int8:
        want["launches_narrow_verify"] = int(narrow and w > 1)
        want["launches_narrow_d64"] = int(narrow and d == 64)
        want["launches_wide_d64"] = int(not narrow and d == 64)
    return want


@pytest.mark.gpu
@pytest.mark.parametrize("b,w,lengths,widths,d,ps,mp", PAGED_CASES)
def test_cuda_kernel_matches_plain(b, w, lengths, widths, d, ps, mp):
    """The Hopper kernels (narrow and wide) against the plain version on
    the card, bf16, at Llama-3.1-8B's head shapes and at other head dims
    and page sizes (H 32, KH 8); uniform windows reach the kernels with a
    null widths pointer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    case = _case(13, b=b, w=w, lengths=lengths, widths=widths, d=d,
                 ps=ps, mp=mp)
    q, kp, vp = (torch.from_numpy(x).cuda().to(torch.bfloat16)
                 for x in case[:3])
    lens, tabs, wid = (torch.from_numpy(x).cuda().to(torch.int32)
                       for x in case[3:])
    wid_arg = None if widths is None else wid
    pa.reset_counters()
    got = pa.paged_attention(q, kp, vp, lens, tabs, 1, widths=wid_arg,
                             verify=w > 1)
    torch.cuda.synchronize()
    assert pa.counters() == _launched_class(b, w, False, d)
    want = pa.paged_attention_ref(q, kp, vp, lens, tabs, 1, widths=wid)
    _check_paged(got, want, w, lens, wid)


@pytest.mark.gpu
@pytest.mark.parametrize("b,w,lengths,widths,d,ps,mp", PAGED_CASES)
def test_cuda_kernel_int8_matches_plain(b, w, lengths, widths, d, ps, mp):
    """The int8 kernels (int8 pools + f32 scale pools from the port's
    quantize_pool) against the int8 plain version on the card, bf16 q,
    with the bf16 kernels' tolerance; the launch counts under the int8
    counters."""
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
    wid_arg = None if widths is None else wid
    pa.reset_counters()
    got = pa.paged_attention(q, kq, vq, lens, tabs, 1, widths=wid_arg,
                             k_scale_pool=ks, v_scale_pool=vs)
    torch.cuda.synchronize()
    assert pa.counters() == _launched_class(b, w, True)
    want = pa.paged_attention_ref(q, kq, vq, lens, tabs, 1, widths=wid,
                                  k_scale_pool=ks, v_scale_pool=vs)
    _check_paged(got, want, w, lens, wid)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b,w,lengths,widths", [
    pytest.param(4, 1, [700, 300, 129, 900], None, id="narrow"),
    pytest.param(3, 128, [800, 256, 400], [128, 128, 90], id="wide"),
])
def test_sentinel_tables_read_the_last_real_page(b, w, lengths, widths,
                                                 int8):
    """A pool with a scratch page after its real pages (the paged
    engine's), its scratch page full of large values, and tables that
    name the sentinel (the scratch page's id) inside each slot's length:
    B1 (narrow) and B2 (wide), on bf16 and int8 pools, given the last
    real page, agree with the plain version and with the same tables
    where every sentinel is replaced by that page, so no row reads the
    scratch page."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.inference.paged_engine import quantize_pool
    ps, mp, kh, h, d = 128, 8, 8, 32, 128
    r = np.random.default_rng(29)
    num_pages = b * mp                  # real pages; id num_pages: scratch
    shape = (2, num_pages + 1, kh, d, ps)
    pools = [r.standard_normal(shape).astype(np.float32) for _ in "kv"]
    for pool in pools:
        pool[:, num_pages] = 50.0
    tabs_np = r.permutation(num_pages).reshape(b, mp).astype(np.int32)
    tabs_np[0, 2] = num_pages           # a sentinel inside slot 0's length
    tabs_np[1, :] = num_pages           # a row with sentinel tables
    tabs_np[:, -1] = num_pages          # past every length
    q = torch.from_numpy(r.standard_normal((b, w, h, d)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    wid = torch.tensor([w] * b if widths is None else widths,
                       dtype=torch.int32, device="cuda")
    tabs = torch.from_numpy(tabs_np).cuda()
    real = torch.where(tabs == num_pages, num_pages - 1, tabs)
    if int8:
        (kp, ks), (vp, vs) = (quantize_pool(torch.from_numpy(x).cuda())
                              for x in pools)
        scales = dict(k_scale_pool=ks, v_scale_pool=vs)
    else:
        kp, vp = (torch.from_numpy(x).cuda().to(torch.bfloat16)
                  for x in pools)
        scales = {}
    wid_arg = None if widths is None else wid
    got = pa.paged_attention(q, kp, vp, lens, tabs, 1, widths=wid_arg,
                             last_page=num_pages - 1, **scales)
    named = pa.paged_attention(q, kp, vp, lens, real, 1, widths=wid_arg,
                               last_page=num_pages - 1, **scales)
    torch.cuda.synchronize()
    assert torch.equal(got, named)
    want = pa.paged_attention_ref(q, kp, vp, lens, tabs, 1, widths=wid,
                                  last_page=num_pages - 1, **scales)
    _check_paged(got, want, w, lens, wid)


def _reference_kernel_arithmetic(q, kq, ks, vq, vs, lens, tabs, wids,
                                 layer):
    """The reference kernels' int8 arithmetic, which the CUDA kernels keep:
    an online softmax over 64-key tiles in log2 units, each tile's
    unnormalized probabilities times the value scales rounded to bf16
    before P.V, one division by the row sum at the end. The plain version
    rounds normalized probabilities instead, so on rows with a few visible
    keys the two differ by up to two roundings of terms as large as the
    values themselves."""
    neg = -0.7 * float(torch.finfo(torch.float32).max)
    b, w, h, d = q.shape
    kh = kq.shape[2]
    g = h // kh
    k = pa.gather_pages(kq, tabs, layer).float()
    v = pa.gather_pages(vq, tabs, layer).float()
    ksc = pa.gather_scale_pages(ks, tabs, layer)[..., 0]
    vsc = pa.gather_scale_pages(vs, tabs, layer)[..., 0]
    out = torch.zeros(b, w, h, d, device=q.device)
    log2_scale = d ** -0.5 * 1.4426950408889634
    for bi in range(b):
        kv_len, width = int(lens[bi]), int(wids[bi])
        anchor = kv_len - width
        rows = anchor + torch.arange(w, device=q.device)
        qb = q[bi].float().reshape(w, kh, g, d)
        for hh in range(kh):
            m = torch.full((w, g), neg, device=q.device)
            l = torch.zeros(w, g, device=q.device)
            acc = torch.zeros(w, g, d, device=q.device)
            for t0 in range(0, max(0, min(kv_len, anchor + width)), 64):
                cols = torch.arange(t0, t0 + 64, device=q.device)
                s = torch.einsum("wgd,td->wgt", qb[:, hh], k[bi, cols, hh])
                s = s * (log2_scale * ksc[bi, cols, hh])
                seen = (cols[None] <= rows[:, None]) & (cols[None] < kv_len)
                s = torch.where(seen[:, None], s,
                                torch.tensor(neg, device=q.device))
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                pv = (p * vsc[bi, cols, hh]).to(torch.bfloat16).float()
                acc = acc * corr[..., None] + torch.einsum(
                    "wgt,td->wgd", pv, v[bi, cols, hh])
                m = m_new
            out[bi, :, hh * g:(hh + 1) * g] = acc / l.clamp_min(1e-30)[
                ..., None]
    return out.to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("b,w,lengths,widths,d", [
    (4, 8, [8, 70, 1, 2000], [8, 3, 1, 8], 64),
    (3, 40, [40, 41, 77], [40, 2, 77], 128)], ids=["narrow", "wide"])
def test_cuda_kernel_int8_few_keys_match_reference_arithmetic(
        b, w, lengths, widths, d):
    """Rows that see a few keys, on int8 pools: the kernels against the
    reference kernels' own arithmetic (`_reference_kernel_arithmetic`)
    within 2^-7 of each value plus 1e-3 (the bf16 rounding of the output
    and the order of f32 sums, which split-KV changes), every row
    finite. Against the plain version these rows sit at INT8_TOL's
    elementwise limit (PERF.md)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.inference.paged_engine import quantize_pool
    case = _case(17, b=b, w=w, lengths=lengths, widths=widths, d=d)
    q = torch.from_numpy(case[0]).cuda().to(torch.bfloat16)
    kq, ks = quantize_pool(torch.from_numpy(case[1]).cuda())
    vq, vs = quantize_pool(torch.from_numpy(case[2]).cuda())
    lens, tabs, wid = (torch.from_numpy(x).cuda().to(torch.int32)
                       for x in case[3:])
    got = pa.paged_attention(q, kq, vq, lens, tabs, 1, widths=wid,
                             k_scale_pool=ks, v_scale_pool=vs).float()
    want = _reference_kernel_arithmetic(q, kq, ks, vq, vs, lens, tabs, wid,
                                        1).float()
    valid = ((torch.arange(w, device="cuda")[None, :] < wid[:, None])
             & (lens > 0)[:, None])
    assert bool(torch.isfinite(got).all())
    diff = (got - want).abs()[valid]
    assert bool((diff <= 1e-3 + 2.0 ** -7 * want.abs()[valid]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("h,kh,w", [(8, 8, 1), (8, 8, 32), (64, 8, 1),
                                    (64, 8, 32)],
                         ids=["mha_decode", "mha_verify", "g8_decode",
                              "g8_verify"])
def test_cuda_kernel_group_sizes(h, kh, w):
    """Groups of 1 (MHA) and 8 query heads a kv head, bf16 and int8: at
    G 8 a W 32 window folds into 256 rows, more than the narrow kernel
    takes, so that narrow-class call runs the wide kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.inference.paged_engine import quantize_pool
    b = 3
    case = _case(29, b=b, w=w, lengths=[w, 500, 1300], widths=None, h=h,
                 kh=kh, mp=12)
    q, kp, vp = (torch.from_numpy(x).cuda().to(torch.bfloat16)
                 for x in case[:3])
    lens, tabs, wid = (torch.from_numpy(x).cuda().to(torch.int32)
                       for x in case[3:])
    kq, ks = quantize_pool(torch.from_numpy(case[1]).cuda())
    vq, vs = quantize_pool(torch.from_numpy(case[2]).cuda())
    narrow = pa.uses_narrow_kernel(b, w, h // kh)
    assert narrow == (h // kh * w <= 128)
    for pools, scales in (((kp, vp), {}),
                          ((kq, vq), dict(k_scale_pool=ks, v_scale_pool=vs))):
        pa.reset_counters()
        got = pa.paged_attention(q, *pools, lens, tabs, 1, **scales)
        torch.cuda.synchronize()
        key = ("launches_narrow" if narrow else "launches_wide") + (
            "_int8" if scales else "")
        assert pa.counters()[key] == 1
        want = pa.paged_attention_ref(q, *pools, lens, tabs, 1, widths=wid,
                                      **scales)
        _check_paged(got, want, w, lens, wid)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b,w,lengths", [
    (8, 1, [1537, 2048, 977, 1800, 64, 1200, 1501, 333]),
    (2, 256, [2048, 1400])], ids=["decode", "prefill"])
@pytest.mark.parametrize("tp", [2, 4], ids=["kh4", "kh2"])
def test_cuda_kernel_tp_shard_heads(tp, b, w, lengths, int8):
    """One tensor-parallel rank's share of Llama-3.1-8B's heads (H 32, KH
    8 over tp 2 and 4: 16 q heads on 4 kv heads, 8 on 2) through
    `paged_attention_tp`, decode (narrow kernel) and prefill (wide), bf16
    and int8, against the plain version; the ranks' outputs concatenate
    to the whole model's over the head axis."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.inference.paged_engine import quantize_pool
    case = _case(31, b=b, w=w, lengths=lengths, widths=None)
    q, kp, vp = (torch.from_numpy(x).cuda().to(torch.bfloat16)
                 for x in case[:3])
    lens, tabs, wid = (torch.from_numpy(x).cuda().to(torch.int32)
                       for x in case[3:])
    scales = {}
    if int8:
        kp, ks = quantize_pool(torch.from_numpy(case[1]).cuda())
        vp, vs = quantize_pool(torch.from_numpy(case[2]).cuda())
        scales = dict(k_scale_pool=ks, v_scale_pool=vs)
    narrow = pa.uses_narrow_kernel(b, w, 4)
    key = ("launches_narrow" if narrow else "launches_wide") + (
        "_int8" if int8 else "")
    hq, hk = 32 // tp, 8 // tp
    outs = []
    for r in range(tp):
        kv = {name: t[:, :, r * hk:(r + 1) * hk].contiguous()
              for name, t in scales.items()}
        pr, vr = (t[:, :, r * hk:(r + 1) * hk].contiguous() for t in (kp, vp))
        qr = q[:, :, r * hq:(r + 1) * hq].contiguous()
        pa.reset_counters()
        got = pa.paged_attention_tp(qr, pr, vr, lens, tabs, 1,
                                    heads=(32, 8), tp=tp, **kv)
        torch.cuda.synchronize()
        assert pa.counters()[key] == 1
        want = pa.paged_attention_ref(qr, pr, vr, lens, tabs, 1, widths=wid,
                                      **kv)
        _check_paged(got, want, w, lens, wid)
        outs.append(got)
    whole = pa.paged_attention_ref(q, kp, vp, lens, tabs, 1, widths=wid,
                                   **scales)
    _check_paged(torch.cat(outs, dim=2), whole, w, lens, wid)


@pytest.mark.gpu
def test_narrow_split_count():
    """The narrow kernel's blocks per (slot, kv head): 1 to 8, at most one
    for every two tiles of a full table, 0 for shapes it does not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for int8 in (False, True):
        for b, w in ((1, 1), (8, 1), (16, 1), (8, 32)):
            n = pa.narrow_splits(b, w, 8, 4, 128, int8, 16, 128)
            assert 1 <= n <= 8, (b, w, int8, n)
        assert pa.narrow_splits(8, 1, 8, 4, 128, int8, 1, 64) == 1
        assert pa.narrow_splits(8, 1, 8, 4, 128, int8, 2, 128) <= 2
        assert pa.narrow_splits(8, 33, 8, 4, 128, int8, 16, 128) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("b,w", [(8, 1), (2, 40)], ids=["narrow", "wide"])
def test_cuda_kernel_layouts(b, w):
    """q read through its strides (a view of a wider tensor) gives the
    contiguous copy's output bit for bit; a null widths pointer gives the
    uniform widths tensor's output bit for bit; rows of a wide row block
    past every slot's width are zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lengths = [300 + 97 * i for i in range(b)]
    case = _case(23, b=b, w=w, lengths=lengths, widths=None, mp=8)
    kp, vp = (torch.from_numpy(x).cuda().to(torch.bfloat16)
              for x in case[1:3])
    lens, tabs, wid = (torch.from_numpy(x).cuda().to(torch.int32)
                       for x in case[3:])
    wide_q = torch.from_numpy(np.concatenate([case[0], case[0]], axis=-1))
    q_view = wide_q.cuda().to(torch.bfloat16)[..., :128]
    assert not q_view.is_contiguous()
    q = q_view.contiguous()
    got = pa.paged_attention(q, kp, vp, lens, tabs, 0)
    assert torch.equal(pa.paged_attention(q_view, kp, vp, lens, tabs, 0),
                       got)
    assert torch.equal(pa.paged_attention(q, kp, vp, lens, tabs, 0,
                                          widths=wid), got)
    if w == 40:
        # rows 32 .. 39 of the window (folded rows 128 ..) form a block
        # wholly past width 32
        short = torch.full_like(wid, 32)
        out = pa.paged_attention(q, kp, vp, lens, tabs, 0, widths=short)
        assert bool((out[:, 32:] == 0).all())


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
    _flash_case(b, s, docs, d, 32, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,docs,h,kh", [(4, 2048, 0, 16, 4),
                                           (2, 2048, 0, 8, 2),
                                           (4, 1024, 0, 16, 4),
                                           (4, 1024, 3, 16, 4)],
                         ids=["tp2", "tp4", "ulysses_sp2",
                              "ulysses_sp2_packed"])
def test_flash_kernels_match_plain_per_rank_heads(b, s, docs, h, kh):
    """The flash kernels on one rank's heads of Llama-3.1-8B under a mesh:
    H/tp and KH/tp at tp 2 and 4 (S 2048, the blocked backward), and the
    H/sp heads over the whole sequence that Ulysses attention hands them
    at sp 2 (S 1024, the fused backward; packed rows too)."""
    _flash_case(b, s, docs, 128, h, kh)


def _flash_case(b, s, docs, d, h, kh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.ops import flash_attention as fl
    r = np.random.default_rng(s + docs + 128 - d + h)
    q, k, v, dout = (torch.from_numpy(r.standard_normal(shape).astype(
        np.float32)).cuda().to(torch.bfloat16) for shape in (
        (b, s, h, d), (b, s, kh, d), (b, s, kh, d), (b, s, h, d)))
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


@pytest.mark.gpu
@pytest.mark.parametrize("v", [32064, 64128, 16032])
def test_fused_ce_shard_kernels_match_plain(v):
    """B7 and B8 on one tp rank's vocabulary shard of Llama-3.1-8B's
    128256 rows: 32064 (tp 4) and 16032 (tp 8), not multiples of 128, so
    padded with zero columns masked out of the statistics and of d, and
    64128 (tp 2), against the plain version of the same padded shard
    (logz, target logit, row max, argmax, dx, dW) at the 2048 rows of
    CE_CASES, with CE_TOL; and two shards' statistics combined
    (`combine_shard_stats`) against the plain statistics of the whole
    2v-row head."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.ops import fused_ce as fc
    torch.backends.cuda.matmul.allow_tf32 = False
    n, d = 2048, 4096
    r = np.random.default_rng(v)
    x = torch.from_numpy(r.standard_normal((n, d)).astype(
        np.float32)).cuda().to(torch.bfloat16)
    head = torch.from_numpy((r.standard_normal((d, 2 * v)) * d ** -0.5)
                            .astype(np.float32)).cuda().to(torch.bfloat16)
    t = torch.from_numpy(r.integers(0, 2 * v, n)).cuda()
    gz = torch.from_numpy(r.standard_normal(n).astype(np.float32)).cuda()
    gt = torch.from_numpy(r.standard_normal(n).astype(np.float32)).cuda()

    def run(fn, hh, tt, inside):
        xx = x.clone().requires_grad_(True)
        hh = hh.clone().requires_grad_(True)
        logz, tl, am, mx = fn(xx, hh, tt)
        tl = torch.where(inside, tl, 0.0)
        ((logz * gz).sum() + (tl * gt).sum()).backward()
        return logz.detach(), tl.detach(), am, mx, xx.grad, hh.grad

    shards = []
    for i in range(2):
        local = t - i * v
        inside = (local >= 0) & (local < v)
        local = local.clamp(0, v - 1)
        hs = head[:, i * v:(i + 1) * v]
        fc.reset_counters()
        got = run(fc.fused_ce_shard_stats, hs, local, inside)
        torch.cuda.synchronize()
        assert fc.counters() == {"launches_fwd": 1, "launches_dx": 1,
                                 "plain_calls": 0}
        want = run(fc.fused_ce_shard_stats_ref, hs, local, inside)
        for key, g, w in zip(("logz", "tl", "mx"), (got[0], got[1], got[3]),
                             (want[0], want[1], want[3])):
            assert bool(torch.isfinite(g).all()), key
            assert float((g - w).abs().max()) <= CE_TOL["logz"], key
        logits = torch.mm(x, hs, out_dtype=torch.float32)
        rows = torch.arange(n, device="cuda")
        assert bool((got[2] < v).all())
        gap = logits[rows, want[2]] - logits[rows, got[2]]
        assert float(gap.max()) <= CE_TOL["logz"]
        for key, g, w in zip(("dx", "dw"), got[4:], want[4:]):
            g, w = g.float(), w.float()
            diff = (g - w).abs()
            rms_lim, max_lim = CE_TOL[key]
            assert float(diff.square().mean().sqrt()
                         / w.square().mean().sqrt()) <= rms_lim, key
            assert float(diff.max() / w.abs().max()) <= max_lim, key
        shards.append((got[0], got[1], got[2] + i * v, got[3]))
    logz, tl, am = fc.combine_shard_stats(shards)
    with torch.no_grad():
        want = fc.fused_ce_shard_stats_ref(x, head, t)
    assert float((logz - want[0]).abs().max()) <= CE_TOL["logz"]
    assert float((tl - want[1]).abs().max()) <= CE_TOL["tl"]
    full = torch.mm(x, head, out_dtype=torch.float32)
    rows = torch.arange(n, device="cuda")
    assert float((full[rows, want[2]] - full[rows, am]).abs().max()) <= (
        CE_TOL["logz"])


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


# --------------------------------------------------------------------------
# The server's captured programs (inference/graphs.py)
# --------------------------------------------------------------------------

# A small model the kernels take (head dim 64, page size 64 for the TMA
# loader), 2 layers, random bf16 weights from a seed.
GRAPH_PROMPTS = [[(7 * i + 3 * j) % 500 + 1 for j in range(n)]
                 for i, n in enumerate((5, 90, 200, 33, 150, 64))]


def _graph_server(cuda_graphs=True, kv="model", temperature=0.0,
                  impl="pallas", top_p=1.0, **kw):
    from cloud_server_tpu_torch.config import InferConfig, ModelConfig
    from cloud_server_tpu_torch.inference.paged_server import (
        PagedInferenceServer)
    from cloud_server_tpu_torch.models import transformer
    cfg = ModelConfig(vocab_size=512, embed_dim=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=64, mlp_dim=512,
                      max_seq_len=512, dtype="bfloat16",
                      param_dtype="bfloat16", remat="none",
                      decode_attention_impl=impl, kv_cache_dtype=kv)
    icfg = InferConfig(max_decode_len=16, temperature=temperature,
                       top_k=40 if temperature else 0, top_p=top_p,
                       eos_token_id=-1, pad_token_id=0)
    params = transformer.init_params(cfg, 0, device="cuda")
    srv_kw = dict(max_slots=4, max_context=512, page_size=64,
                  prefill_chunk=128, seed=5, device="cuda",
                  cuda_graphs=cuda_graphs)
    srv_kw.update(kw)
    return PagedInferenceServer(params, cfg, icfg, **srv_kw)


def _staggered_graph_run(srv, max_new=12, per_request=False):
    """Request i samples with its own seed, temperature and top-p when
    `per_request` (the programs that sample per row), else as the
    server's config says."""
    from cloud_server_tpu_torch.inference.sampling import SamplingParams

    def submit(i):
        sp = (SamplingParams(seed=100 + i, temperature=0.8, top_p=0.9)
              if per_request else None)
        return srv.submit(GRAPH_PROMPTS[i], max_new_tokens=max_new,
                          sampling=sp)

    reqs = [submit(i) for i in range(3)]
    for _ in range(2):
        srv.step()
    reqs += [submit(i) for i in range(3, len(GRAPH_PROMPTS))]
    srv.run_until_idle()
    torch.cuda.synchronize()
    return [r.result() for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "kv,temperature,top_p,per_request,scheduler,overlap", [
        ("model", 0.0, 1.0, False, "mixed", True),
        ("int8", 0.0, 1.0, False, "mixed", True),
        ("model", 0.9, 1.0, False, "mixed", True),
        ("model", 0.0, 1.0, False, "mixed", False),
        ("model", 0.9, 1.0, False, "alternating", False),
        ("model", 0.9, 0.9, False, "mixed", True),
        ("model", 0.0, 1.0, True, "mixed", True),
        ("model", 0.0, 1.0, True, "alternating", False)],
    ids=["bf16", "int8", "seeded", "sequential", "alternating_seeded",
         "seeded_top_p", "per_request_seeded",
         "alternating_per_request_seeded"])
def test_graphed_server_matches_graphs_off(kv, temperature, top_p,
                                           per_request, scheduler, overlap):
    """The same staggered requests (6 prompts on 4 slots: admissions
    landing mid-decode, compacted decode rows) through captured graphs
    and through eager launches on the same buffers give the same tokens,
    greedy, int8, server-global seeded (top-k, and top-p) and per-request
    seeded (per-row programs); and the graphed run's kernel counts are
    the eager run's plus one warm-up per captured program."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = {}
    for graphed in (False, True):
        srv = _graph_server(graphed, kv, temperature, top_p=top_p,
                            scheduler=scheduler, overlap=overlap)
        pa.reset_counters()
        toks = _staggered_graph_run(srv, per_request=per_request)
        per_row = any(dict(key[2]).get(f) for key in srv._programs.keys()
                      for f in ("rows", "rows_p", "rows_d"))
        counts = pa.counters()
        warm = {k: sum(p.replay_counts.get(k, 0)
                       for p in srv._programs._programs.values())
                for k in counts}
        runs[graphed] = (toks, counts, warm, len(srv._programs))
        srv.stop()
        assert per_row == per_request
    (eager, c_eager, _, _), (graphed, c_graph, warm, n_prog) = (
        runs[False], runs[True])
    assert all(len(t) == 12 for t in graphed)
    assert graphed == eager
    assert n_prog >= 2
    assert c_graph["plain_calls"] == c_eager["plain_calls"] == 0
    sfx = "_int8" if kv == "int8" else ""
    for name in ("launches_narrow" + sfx, "launches_wide" + sfx):
        assert c_eager[name] > 0
        assert c_graph[name] == c_eager[name] + warm[name]


@pytest.mark.gpu
def test_graphed_moe_server_matches_graphs_off():
    """A small MoE model (4 experts, top-2, dropless) on the paged server:
    its routing (gathers, scatter-adds, batched expert products) records
    inside the captured programs, and the staggered requests give the
    same tokens graphed and with graphs off, both kernel classes
    launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.config import InferConfig, ModelConfig
    from cloud_server_tpu_torch.inference.paged_server import (
        PagedInferenceServer)
    from cloud_server_tpu_torch.models import moe
    cfg = ModelConfig(vocab_size=512, embed_dim=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=64, mlp_dim=512,
                      max_seq_len=512, dtype="bfloat16",
                      param_dtype="bfloat16", remat="none",
                      decode_attention_impl="pallas", num_experts=4,
                      num_experts_per_token=2, expert_capacity_factor=2.0)
    icfg = InferConfig(max_decode_len=16, temperature=0.0, eos_token_id=-1,
                       pad_token_id=0)
    params = moe.init_params(cfg, 0, device="cuda")
    runs = {}
    for graphed in (False, True):
        srv = PagedInferenceServer(params, cfg, icfg, max_slots=4,
                                   max_context=512, page_size=64,
                                   prefill_chunk=128, seed=5, device="cuda",
                                   cuda_graphs=graphed)
        pa.reset_counters()
        runs[graphed] = (_staggered_graph_run(srv), pa.counters(),
                         len(srv._programs))
        srv.stop()
    (eager, c_eager, _), (graphed, _, n_prog) = runs[False], runs[True]
    assert all(len(t) == 12 for t in graphed)
    assert graphed == eager
    assert n_prog >= 2
    assert c_eager["launches_narrow"] > 0 and c_eager["launches_wide"] > 0
    assert c_eager["plain_calls"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("draft,per_request,scheduler,overlap", [
    (False, False, "mixed", True), (True, False, "mixed", True),
    (False, True, "mixed", True), (True, True, "alternating", False)],
    ids=["ngram", "draft", "ngram_seeded_penalties",
         "alternating_draft_seeded_penalties"])
def test_graphed_spec_server_matches_graphs_off(draft, per_request,
                                                scheduler, overlap):
    """Speculation (2 drafts a round, n-gram or a 1-layer draft model at
    head dim 64 on its own pools) through captured graphs and through
    eager launches gives the same tokens, greedy and per-request seeded
    with penalties and a logit_bias (the per-slot state a capture's
    warm-up must leave as it found it); the verify windows run on the
    narrow kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.config import ModelConfig
    from cloud_server_tpu_torch.inference.sampling import SamplingParams
    from cloud_server_tpu_torch.models import transformer
    kw = dict(spec_drafts=2, spec_control=False, scheduler=scheduler,
              overlap=overlap)
    if draft:
        dcfg = ModelConfig(vocab_size=512, embed_dim=128, num_layers=1,
                           num_heads=2, num_kv_heads=2, head_dim=64,
                           mlp_dim=256, max_seq_len=512, dtype="bfloat16",
                           param_dtype="bfloat16", remat="none",
                           decode_attention_impl="pallas")
        kw.update(draft_cfg=dcfg,
                  draft_params=transformer.init_params(dcfg, 1,
                                                       device="cuda"))
    runs = {}
    for graphed in (False, True):
        srv = _graph_server(graphed, **kw)
        pa.reset_counters()
        reqs = [srv.submit(p, max_new_tokens=12, sampling=(
            SamplingParams(seed=200 + i, temperature=0.8, top_p=0.9,
                           frequency_penalty=0.5, presence_penalty=0.3,
                           logit_bias=((5, 2.0),))
            if per_request else None))
            for i, p in enumerate(GRAPH_PROMPTS)]
        srv.run_until_idle()
        torch.cuda.synchronize()
        runs[graphed] = ([r.result() for r in reqs], pa.counters())
        srv.stop()
    assert runs[True][0] == runs[False][0]
    assert all(len(t) == 12 for t in runs[True][0])
    for _, counts in runs.values():
        assert counts["launches_narrow_verify"] > 0
        assert counts["plain_calls"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_graphed_plain_attention_server(kv):
    """The plain attention path (decode_attention_impl "xla") captures
    too: the same tokens graphed and with graphs off, every call counted
    as a plain call and none as a kernel launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = []
    for graphed in (False, True):
        srv = _graph_server(graphed, kv, impl="xla")
        pa.reset_counters()
        runs.append((_staggered_graph_run(srv, max_new=6), pa.counters()))
        srv.stop()
    (eager, c_eager), (graphed, c_graph) = runs
    assert graphed == eager and all(len(t) == 6 for t in graphed)
    for c in (c_eager, c_graph):
        assert c["plain_calls"] > 0
        assert c["launches_narrow"] == c["launches_wide"] == 0


@pytest.mark.gpu
def test_graph_replays_add_to_counters():
    """A replay launches what its capture recorded: the capture itself
    adds nothing (its counts are taken back), and each later replay of
    the same program adds its recorded counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    srv = _graph_server()
    srv.submit(GRAPH_PROMPTS[1], max_new_tokens=40)
    while srv._jobs or srv.num_pending:
        srv.step()
    srv.step()  # the decode program is captured by now
    torch.cuda.synchronize()
    decode = [p for k, p in srv._programs._programs.items()
              if k[0] == "_decode_rounds"]
    assert decode and decode[0].graph is not None
    per = decode[0].replay_counts
    assert per["launches_narrow"] > 0 and per["plain_calls"] == 0
    before = pa.counters()
    srv.step()
    torch.cuda.synchronize()
    after = pa.counters()
    assert after["launches_narrow"] - before["launches_narrow"] == \
        per["launches_narrow"]
    srv.stop()


@pytest.mark.gpu
def test_capture_failure_raises(monkeypatch):
    """A program that cannot be captured (here: a host read inside it)
    raises out of step(); nothing falls back to eager launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.inference import paged_server as ps
    real = ps._mixed_step

    def with_host_read(m, bufs, **kw):
        out = real(m, bufs, **kw)
        out["ptoks"].sum().item()  # refused while a graph captures
        return out

    monkeypatch.setattr(ps, "_mixed_step", with_host_read)
    srv = _graph_server(overlap=False)
    req = srv.submit(GRAPH_PROMPTS[0], max_new_tokens=4)
    with pytest.raises(RuntimeError):
        srv.step()
    assert not req.done and not req.tokens
    monkeypatch.setattr(ps, "_mixed_step", real)
    srv._programs.release()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_stop_releases_graph_memory():
    """stop() releases the captured graphs, their buffers and their pool:
    device memory falls back from what the captures held, and a second
    serve (captured again) falls back to the same level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import gc
    srv = _graph_server()
    levels = []
    for _ in range(2):
        srv.start()
        reqs = [srv.submit(p, max_new_tokens=8) for p in GRAPH_PROMPTS]
        for r in reqs:
            r.result(timeout=300)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        assert len(srv._programs) > 0
        srv.stop()
        gc.collect()
        levels.append((held, torch.cuda.memory_allocated()))
        assert len(srv._programs) == 0
    (held1, after1), (held2, after2) = levels
    assert held1 > after1 and held2 > after2
    assert after2 == after1


@pytest.mark.gpu
def test_profiler_window_holds_graphed_dispatches(tmp_path):
    """POST /debug/trace's window on the card: programs captured while
    it is open replay to the same tokens as graphs off, and a window
    closing under the overlap pipeline waits on the dispatch in flight,
    so its trace holds that program's narrow-kernel launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json
    eager = _staggered_graph_run(_graph_server(cuda_graphs=False))
    srv = _graph_server()
    srv.request_trace(2, tmp_path / "captures")  # the first two steps
    assert _staggered_graph_run(srv) == eager
    assert len(list((tmp_path / "captures").glob("*.pt.trace.json"))) == 1
    srv.submit(GRAPH_PROMPTS[1], max_new_tokens=64)
    while srv._jobs or srv.num_pending:
        srv.step()
    srv.step()
    srv.request_trace(2, tmp_path / "steady")
    for _ in range(2):
        srv.step()
    assert not srv.tracer.active and srv._inflight is not None
    (path,) = (tmp_path / "steady").glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    narrow = sum(1 for e in events if e.get("cat") == "kernel"
                 and "paged_narrow_kernel" in e.get("name", ""))
    # 2 layers x decode_chunk rounds a program, two programs at least
    assert narrow >= 2 * 2 * srv.decode_chunk
    srv.stop()


@pytest.mark.gpu
def test_fail_all_waits_on_the_dispatch_in_flight():
    """_fail_all under the overlap pipeline: holding the step lock it
    waits on the launched program before tearing the slots down, and
    every request ends with the error."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    srv = _graph_server()
    reqs = [srv.submit(p, max_new_tokens=32) for p in GRAPH_PROMPTS[:4]]
    for _ in range(3):
        srv.step()
    prog = srv._inflight.program
    srv._fail_all(RuntimeError("boom"))
    assert prog.settle(0.0) and srv._inflight is None
    assert all(r.done and r.finish_reason.startswith("error") for r in reqs)
    assert srv.unserialized_teardowns == 0
    srv.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_graphs_captured_before_an_import_replay_its_pages(kv):
    """A request exported mid-decode from one server and imported into
    another whose programs were captured before the import: the pages
    land bit-equal in the destination's pools (in place, where the
    graphs read them), and the continuation's tokens equal the same
    migration run with every program launched eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = {}
    for graphed in (False, True):
        src = _graph_server(graphed, kv)
        dst = _graph_server(graphed, kv)
        # the destination captures its programs first
        dst.generate(GRAPH_PROMPTS[:3], max_new_tokens=12)
        n_programs = len(dst._programs)
        req = src.submit(GRAPH_PROMPTS[4], max_new_tokens=40)
        while len(req.tokens) < 6:
            src.step()
        snap = src.migrate_export(req)
        assert snap.n_kv_pages() >= 2
        cont = dst.migrate_import(snap)
        torch.cuda.synchronize()
        shared, _ = dst.allocator.lookup_prefix(
            list(snap.chain_tokens) + [0])
        assert len(shared) == snap.n_kv_pages()
        for name, pool in dst._pool_items():
            assert torch.equal(pool[:, shared].cpu(),
                               snap.kv_pages[name]), name
        dst.allocator.release(shared, list(snap.chain_tokens))
        dst.run_until_idle()
        torch.cuda.synchronize()
        assert cont.finish_reason == "length"
        runs[graphed] = list(cont.tokens)
        if graphed:
            assert n_programs >= 2
            assert any(p.graph is not None
                       for p in dst._programs._programs.values())
        src.stop()
        dst.stop()
    assert runs[True] == runs[False]


@pytest.mark.gpu
def test_two_servers_capture_on_two_threads():
    """Two servers on one card, each on its own scheduler thread,
    capturing their programs at the same time: both serve the tokens
    they serve alone, and the kernel counts of the two together are the
    sum of each alone (a capture counts only its own thread's calls)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import time

    def serve(srvs, threaded):
        reqs = [[s.submit(p, max_new_tokens=12) for p in GRAPH_PROMPTS]
                for s in srvs]
        if threaded:
            for s in srvs:
                s.start()
            deadline = time.time() + 300
            while (not all(r.done for rs in reqs for r in rs)
                   and time.time() < deadline):
                time.sleep(0.01)
        else:
            for s in srvs:
                s.run_until_idle()
        torch.cuda.synchronize()
        return [[r.result(timeout=0) for r in rs] for rs in reqs]

    alone, counts = [], []
    for seed in (5, 6):
        srv = _graph_server(seed=seed, temperature=0.9)
        pa.reset_counters()
        alone += serve([srv], threaded=False)
        counts.append(pa.counters())
        srv.stop()
    pair = [_graph_server(seed=s, temperature=0.9) for s in (5, 6)]
    pa.reset_counters()
    together = serve(pair, threaded=True)
    both = pa.counters()
    for s in pair:
        s.stop()
    assert together == alone
    assert both == {k: counts[0][k] + counts[1][k] for k in both}
    assert both["launches_narrow"] > 0 and both["plain_calls"] == 0


@pytest.mark.gpu
def test_restack_under_a_dispatch_in_flight_recaptures():
    """Adapted requests mid-decode under the overlap pipeline (every
    captured program reads the adapter stacks): an adapter whose rank
    outgrows the stacks restacks them, releases every program, the one
    in flight after its commit, and the next captures take a fresh graph
    pool; the graphed tokens equal the graphs-off run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.models.lora import (LoRAConfig,
                                                    init_lora_params)
    runs = []
    for graphed in (False, True):
        srv = _graph_server(graphed, overlap=True)
        cfg = srv.cfg
        for name, rank, seed in (("a", 4, 1), ("grow", 16, 2)):
            lcfg = LoRAConfig(rank=rank, alpha=8.0, targets=("wq", "wv"))
            lp = init_lora_params(cfg, lcfg, seed, device="cuda")
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed + 100)
            for ab in lp["layers"].values():
                ab["b"] = (torch.randn(ab["b"].shape, generator=gen,
                                       device="cuda") * 0.1).to(
                                           ab["b"].dtype)
            if name == "a":
                srv.add_adapter(name, lp, lcfg)
                reqs = [srv.submit(p, max_new_tokens=12, adapter="a")
                        for p in GRAPH_PROMPTS]
                for _ in range(3):
                    srv.step()
                assert srv._inflight is not None
                pool = srv._programs._pool
            else:
                srv.add_adapter(name, lp, lcfg)
        if graphed:
            assert srv._programs.dropped_in_flight == 1
            assert len(srv._programs) == 0
            assert srv._programs._pool is None
        srv.run_until_idle()
        if graphed:
            assert len(srv._programs) > 0
            assert srv._programs._pool not in (None, pool)
        runs.append([r.result() for r in reqs])
        srv.stop()
    assert runs[0] == runs[1]
    assert all(len(t) == 12 for t in runs[1])


@pytest.mark.gpu
def test_contiguous_server_prefills_on_b3():
    """The contiguous server on a 2-layer bf16 slice: every admission
    prefills through the flash forward kernel (B3) under captured
    programs (counted per replay and warm-up, no plain call), graphed
    equals graphs off, and the plain attention route launches no B3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cloud_server_tpu_torch.config import InferConfig, ModelConfig
    from cloud_server_tpu_torch.inference.server import InferenceServer
    from cloud_server_tpu_torch.models import transformer
    from cloud_server_tpu_torch.ops import flash_attention as fl
    base = dict(vocab_size=512, embed_dim=256, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=64, mlp_dim=512, max_seq_len=512,
                dtype="bfloat16", param_dtype="bfloat16", remat="none")
    icfg = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                       pad_token_id=0)
    params = transformer.init_params(ModelConfig(**base), 0, device="cuda")

    def run(impl, graphed):
        srv = InferenceServer(params, ModelConfig(**base,
                                                  attention_impl=impl),
                              icfg, max_slots=4, max_len=256, seed=5,
                              device="cuda", cuda_graphs=graphed)
        fl.reset_counters()
        reqs = _staggered_graph_run(srv, max_new=8)
        torch.cuda.synchronize()
        counts = fl.counters()
        admits = sum(1 for k in srv._programs.keys()
                     if k[0].startswith("_admit"))
        srv.stop()
        return reqs, counts, admits

    (flash, c_flash, admits), (eager, c_eager, _), (plain, c_plain, _) = (
        run("flash", True), run("flash", False), run("xla", True))
    assert flash == eager
    assert c_flash["plain_calls"] == c_eager["plain_calls"] == 0
    assert c_flash["launches_fwd"] >= 2 * (admits + 1)
    assert c_flash["launches_fwd"] % 2 == 0
    assert c_plain["launches_fwd"] == 0
    assert all(len(t) == 8 for t in flash)
