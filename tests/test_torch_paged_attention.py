"""The port's plain paged attention against the reference's Pallas kernel
(interpret mode) and its XLA gather path. The CUDA kernel is held
against this plain version on the card by tests/test_torch_kernels_gpu.py.

Cases: narrow and wide windows, GQA and MHA, ragged widths, short
lengths, sentinel table entries, and a length-0 slot that must stay
finite."""

import os
import sys
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cloud_server_tpu.ops import paged_attention as ref_pa
from cloud_server_tpu_torch.ops import paged_attention as pa

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

ATOL = 1e-5


def _case(seed, *, b, w, h, kh, d=8, ps=8, mp=6, L=2, num_pages=40,
          lengths=None, widths=None, dtype=np.float32):
    r = np.random.default_rng(seed)
    k_pool = r.standard_normal((L, num_pages, kh, d, ps)).astype(dtype)
    v_pool = r.standard_normal((L, num_pages, kh, d, ps)).astype(dtype)
    q = r.standard_normal((b, w, h, d)).astype(dtype)
    tables = r.permutation(num_pages)[:b * mp].reshape(b, mp).astype(
        np.int32)
    if lengths is None:
        lengths = r.integers(w, mp * ps + 1, size=(b,))
    lengths = np.asarray(lengths, np.int32)
    if widths is not None:
        widths = np.asarray(widths, np.int32)
    return q, k_pool, v_pool, lengths, tables, widths


def _ref(fn, case, layer, **kw):
    q, kp, vp, lens, tabs, wid = case
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(lens), jnp.asarray(tabs), layer,
                         widths=None if wid is None else jnp.asarray(wid),
                         **kw))


def _port(case, layer):
    q, kp, vp, lens, tabs, wid = case
    return pa.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(lens), torch.from_numpy(tabs), layer,
        widths=None if wid is None else torch.from_numpy(wid)).numpy()


def _valid_rows(case):
    q, _, _, lens, _, wid = case
    b, w = q.shape[:2]
    width = np.full((b,), w) if wid is None else wid
    return (np.arange(w)[None, :] < width[:, None]) & (lens > 0)[:, None]


@pytest.mark.parametrize("w", [1, 4, 48, 64])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2)])
def test_plain_matches_reference(w, h, kh):
    """Both shape classes of the reference (narrow W <= 32, wide W > 32)
    against the port's plain version, every layer."""
    case = _case(w * 10 + kh, b=3, w=w, h=h, kh=kh, mp=12)
    for layer in range(2):
        got = _port(case, layer)
        _np = np.testing.assert_allclose
        _np(got, _ref(ref_pa.paged_attention_xla, case, layer),
            atol=ATOL, rtol=ATOL)
        if w == 4 and kh == 2 and layer == 1:  # interpret mode is slow
            _np(got, _ref(ref_pa.paged_attention, case, layer,
                          pages_per_block=2, interpret=True),
                atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("b,w", [(17, 1), (16, 32)],
                         ids=["wide_b17_w1", "narrow_b16_w32"])
def test_plain_matches_reference_class_edges(b, w):
    """The two shapes where the classes meet, which the CUDA wrapper sends
    to different kernels: B 17 x W 1 runs the reference's wide kernel and
    B 16 x W 32 its narrow kernel (interpret mode); the port's plain
    version against both and against the XLA path."""
    mp = 6
    case = _case(b * 100 + w, b=b, w=w, h=4, kh=2, mp=mp,
                 num_pages=b * mp + 3)
    assert pa.is_narrow(b, w) == (b <= 16)
    got = _port(case, 1)
    np.testing.assert_allclose(
        got, _ref(ref_pa.paged_attention_xla, case, 1), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        got, _ref(ref_pa.paged_attention, case, 1, pages_per_block=2,
                  interpret=True), atol=2e-4, rtol=2e-4)


def test_wide_kernel_interpret_matches_plain():
    case = _case(5, b=2, w=48, h=4, kh=2, mp=12,
                 lengths=[96, 60], widths=[48, 17])
    valid = _valid_rows(case)
    got = _port(case, 1)
    want = _ref(ref_pa.paged_attention, case, 1, pages_per_block=2,
                interpret=True)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("w", [4, 48])
def test_ragged_widths(w):
    """Per-row widths: row b's window anchors at lengths[b] - widths[b];
    rows past their width are garbage and not compared."""
    case = _case(7, b=4, w=w, h=4, kh=2, mp=12, num_pages=60,
                 lengths=[w, 50, 3, 90], widths=[w, 1, 3, w // 2])
    valid = _valid_rows(case)
    got = _port(case, 0)
    want = _ref(ref_pa.paged_attention_xla, case, 0)
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL,
                               rtol=ATOL)
    assert np.isfinite(got).all()


def test_short_lengths_sentinels_and_empty_slot():
    """Lengths inside the first page, sentinel entries past each slot's
    pages, and an inactive length-0 slot whose output must stay finite."""
    case = _case(9, b=3, w=1, h=4, kh=2, lengths=[1, 0, 5])
    q, kp, vp, lens, tabs, wid = case
    tabs[:, 1:] = kp.shape[1]  # sentinel: "no page"
    case = (q, kp, vp, lens, tabs, wid)
    got = _port(case, 0)
    want = _ref(ref_pa.paged_attention_xla, case, 0)
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=ATOL,
                               rtol=ATOL)
    assert np.isfinite(got).all()


def test_counters_and_shape_class():
    pa.reset_counters()
    case = _case(11, b=2, w=1, h=4, kh=2)
    _port(case, 0)
    assert pa.counters() == {"launches_narrow": 0, "launches_wide": 0,
                             "launches_narrow_int8": 0,
                             "launches_wide_int8": 0,
                             "launches_narrow_verify": 0,
                             "launches_narrow_d64": 0,
                             "launches_wide_d64": 0, "plain_calls": 1}
    assert pa.is_narrow(16, 32) and not pa.is_narrow(17, 1)
    assert not pa.is_narrow(2, 33)


@pytest.mark.parametrize("b,w,g,narrow", [
    (8, 1, 4, True), (16, 32, 4, True), (17, 1, 4, False),
    (16, 33, 4, False), (16, 32, 8, False), (2, 256, 4, False)])
def test_kernel_for_each_class(b, w, g, narrow):
    """The CUDA wrapper's dispatch: the narrow kernel for the reference's
    narrow class where its W * G rows fit one block (128), else the wide
    kernel."""
    assert pa.uses_narrow_kernel(b, w, g) == narrow


@pytest.mark.parametrize("ps,pools,scales,elem,rows,loader", [
    (128, (0, 1 << 20), (), 2, 1 << 20, pa.LOADER_TMA),
    (64, (256, 512), (1024, 2048), 1, 1 << 20, pa.LOADER_TMA),
    (128, (0, 8), (), 1, 1 << 20, pa.LOADER_VEC),     # a pool off 16 bytes
    (128, (0, 8), (), 2, 1 << 20, pa.LOADER_SCALAR),  # ... off 8 positions
    (128, (0, 0), (4, 0), 1, 1 << 20, pa.LOADER_VEC),  # a scale pool
    (128, (0, 0), (), 2, 1 << 31, pa.LOADER_VEC),     # past the maps' rows
    (16, (0, 16), (), 2, 1 << 20, pa.LOADER_VEC),
    (16, (0, 8), (), 1, 1 << 20, pa.LOADER_VEC),
    (16, (0, 8), (), 2, 1 << 20, pa.LOADER_SCALAR),
    (12, (0, 16), (), 2, 1 << 20, pa.LOADER_SCALAR)])
def test_loader_for_page_size_and_alignment(ps, pools, scales, elem, rows,
                                            loader):
    """TMA where a 64-position tile is one box inside a page and every
    pointer is 16-byte aligned; cp.async of 8 positions where ps % 8 == 0
    and the pools are aligned to them; else element by element."""
    assert pa.loader_mode(ps, pools, scales, elem, rows) == loader
