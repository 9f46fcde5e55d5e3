"""The port's fused cross-entropy (`ops/fused_ce.py`; on the CPU its plain
version) against the reference's Pallas kernels, which run here in
interpret mode as the reference's own tests run them:

  * the statistics (logz, target logit, argmax) and the gradients of
    x and head on the shapes of tests/test_fused_ce.py, float32: logz and
    target logit within 1e-5, argmax equal, dx and dW within rtol 2e-4 /
    atol 2e-5 (the reference's own gradient tolerance);
  * the same in bfloat16 inputs: statistics within 1e-5; dx and dW (bf16,
    from the bf16-rounded d) within one bf16 ulp of the largest entry
    (a d entry may round to the neighbouring bf16 value where the two
    versions' logits differ in their last bits);
  * the ValueError on N or V not divisible by 128, in both packages, and
    the counters on the CPU;
  * `next_token_loss` with ce_impl="pallas" on a tiny float32 model with
    the reference's weights (mask, z-loss, untied or tied head): loss
    within 1e-5, accuracy equal, every gradient leaf within rtol 5e-4 /
    atol 1e-5, as tests/test_fused_ce.py holds the kernels to the dense
    path.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu.ops import fused_ce as ref_fc
from cloud_server_tpu_torch import config as tconfig
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import fused_ce as fc
from cloud_server_tpu_torch.training import optim

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

SHAPES = [(256, 64, 512), (128, 64, 384)]


def _case(n, d, v, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, d)).astype(np.float32)
    w = (r.standard_normal((d, v)) * 0.05).astype(np.float32)
    t = r.integers(0, v, n).astype(np.int32)
    gz = r.standard_normal(n).astype(np.float32)
    gt = r.standard_normal(n).astype(np.float32)
    return x, w, t, gz, gt


def _reference(x, w, t, gz, gt, dtype):
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tj = jnp.asarray(t)

    def obj(xx, ww):
        logz, tl, _ = ref_fc.fused_ce_stats(xx, ww, tj)
        return (logz * gz).sum() + (tl * gt).sum()

    stats = ref_fc.fused_ce_stats(xj, wj, tj)
    grads = jax.grad(obj, argnums=(0, 1))(xj, wj)
    return ([np.asarray(s) for s in stats],
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(x, w, t, gz, gt, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    logz, tl, am = fc.fused_ce_stats(xt, wt, torch.from_numpy(t))
    ((logz * torch.from_numpy(gz)).sum()
     + (tl * torch.from_numpy(gt)).sum()).backward()
    assert xt.grad.dtype == wt.grad.dtype == dtype
    return ([logz.detach().numpy(), tl.detach().numpy(), am.numpy()],
            [xt.grad.float().numpy(), wt.grad.float().numpy()])


@pytest.mark.parametrize("n,d,v", SHAPES)
def test_stats_and_grads_match_reference_f32(n, d, v):
    case = _case(n, d, v, seed=n + v)
    (want_s, want_g) = _reference(*case, jnp.float32)
    (got_s, got_g) = _port(*case, torch.float32)
    np.testing.assert_allclose(got_s[0], want_s[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_s[1], want_s[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_s[2], want_s[2])
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n,d,v", SHAPES)
def test_stats_and_grads_match_reference_bf16(n, d, v):
    case = _case(n, d, v, seed=n + v + 1)
    (want_s, want_g) = _reference(*case, jnp.bfloat16)
    (got_s, got_g) = _port(*case, torch.bfloat16)
    np.testing.assert_allclose(got_s[0], want_s[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_s[1], want_s[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_s[2], want_s[2])
    for got, want in zip(got_g, want_g):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2 ** -8 * np.abs(want).max())


def test_argmax_takes_the_first_index_on_ties():
    """Columns 3 and 200 of the head are equal, so every row's largest
    logit appears twice when it falls on them: both versions answer 3."""
    n, d, v = 128, 8, 256
    r = np.random.default_rng(0)
    x = np.abs(r.standard_normal((n, d))).astype(np.float32)
    w = (r.standard_normal((d, v)) * 0.01).astype(np.float32)
    w[:, 3] = w[:, 200] = 1.0
    t = np.zeros(n, np.int32)
    _, _, want = ref_fc.fused_ce_stats(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(t))
    _, _, got = fc.fused_ce_stats(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(t))
    assert (np.asarray(want) == 3).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("package", ["reference", "port"])
@pytest.mark.parametrize("n,v", [(100, 128), (128, 100)])
def test_indivisible_n_or_v_raises(package, n, v):
    with pytest.raises(ValueError, match="divisible by 128"):
        if package == "reference":
            ref_fc.fused_ce_stats(jnp.zeros((n, 8)), jnp.zeros((8, v)),
                                  jnp.zeros((n,), jnp.int32))
        else:
            fc.fused_ce_stats(torch.zeros((n, 8)), torch.zeros((8, v)),
                              torch.zeros((n,), dtype=torch.long))


def test_counters_on_the_cpu():
    """On the CPU the plain version runs: one plain call for the forward
    and one for the backward; the kernel counters stay 0."""
    x, w, t, _, _ = _case(128, 16, 256, seed=4)
    fc.reset_counters()
    xt = torch.from_numpy(x).requires_grad_(True)
    logz, tl, _ = fc.fused_ce_stats(xt, torch.from_numpy(w),
                                    torch.from_numpy(t))
    (logz - tl).sum().backward()
    assert fc.counters() == {"launches_fwd": 0, "launches_dx": 0,
                             "plain_calls": 2}
    fc.reset_counters()
    assert fc.counters() == {"launches_fwd": 0, "launches_dx": 0,
                             "plain_calls": 0}


CFG = ModelConfig(
    vocab_size=256, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=64, dtype="float32",
    param_dtype="float32", remat="none", ce_impl="pallas")


@pytest.mark.parametrize("name,masked,z,tied", [
    ("mask", True, 0.0, False), ("zloss", False, 1e-3, False),
    ("tied_mask_zloss", True, 1e-3, True)])
def test_pallas_loss_and_grads_match_reference(name, masked, z, tied):
    cfg = dataclasses.replace(CFG, tie_embeddings=tied)
    ref_params = ref_tf.init_params(cfg, jax.random.key(2))
    r = np.random.default_rng(5)
    tokens = r.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    mask = np.ones((2, 64), np.float32)
    mask[1, 40:] = 0.0
    batch = {"tokens": jnp.asarray(tokens)}
    tbatch = {"tokens": torch.from_numpy(tokens)}
    if masked:
        batch["mask"] = jnp.asarray(mask)
        tbatch["mask"] = torch.from_numpy(mask)
    (want_loss, want_m), want_g = jax.value_and_grad(
        ref_tf.next_token_loss, has_aux=True)(ref_params, batch, cfg, z)

    tcfg = tconfig.ModelConfig(**dataclasses.asdict(cfg))
    params = transformer.params_from_numpy(
        jax.tree.map(np.asarray, ref_params), tcfg, device="cpu",
        keep_param_dtype=True)
    params = optim.map_tree(lambda p: p.requires_grad_(True), params)
    fc.reset_counters()
    loss, metrics = transformer.next_token_loss(params, tbatch, tcfg, z)
    loss.backward()
    assert fc.counters()["plain_calls"] == 2
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert float(metrics["accuracy"]) == pytest.approx(
        float(want_m["accuracy"]), abs=1e-7)
    if z:
        np.testing.assert_allclose(float(metrics["z_loss"]),
                                   float(want_m["z_loss"]), rtol=1e-5)
    want_flat = dict(optim.flatten(jax.tree.map(np.asarray, want_g)))
    got_flat = dict(optim.flatten(optim.map_tree(lambda p: p.grad, params)))
    assert sorted(got_flat) == sorted(want_flat)
    for path, want in want_flat.items():
        np.testing.assert_allclose(got_flat[path].numpy(), want, rtol=5e-4,
                                   atol=1e-5, err_msg=path)


# The B7 kernel's order of work: vocabulary ranges of whole 256-column
# tiles (V 1664 is 6.5 of them: the last range ends in a half tile),
# each range's statistics, then the ranges combined in order. The data
# make every logit exact in float32 (integers times multiples of 1/8), so
# ties are exact: equal columns straddle tile and range boundaries and
# are often the largest, and the first index must win across ranges.
RANGE_SPLITS = [1, 2, 3, 7]
TIE_COLS = [255, 256, 511, 512, 767, 768, 1023, 1024, 1663]


def _tie_case(n=128, d=32, v=1664, seed=11):
    r = np.random.default_rng(seed)
    x = r.integers(-1, 3, (n, d)).astype(np.float32)
    w = (r.integers(-4, 5, (d, v)) / 8).astype(np.float32)
    w[:, TIE_COLS] = 0.5
    t = r.integers(0, v, n).astype(np.int32)
    t[:4] = TIE_COLS[1:5]  # target logits on tied columns too
    return x, w, t


@pytest.mark.parametrize("splits", RANGE_SPLITS)
def test_stats_by_ranges_match_reference(splits):
    x, w, t = _tie_case()
    want = ref_fc.fused_ce_stats(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(t))
    got = fc.stats_by_ranges_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(t), splits)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the tied columns win for some rows, and then the first of them
    assert (got[2].numpy() == TIE_COLS[0]).any()
    assert not np.isin(got[2].numpy(), TIE_COLS[1:]).any()


# (N, V) of the schedule: the half tile (V 384 and 32896), N an odd
# multiple of 128 (2176), and the train shape.
SCHEDULE_SHAPES = [(n, v) for n in (128, 2176, 8192)
                   for v in (384, 32896, 128256)]


@pytest.mark.parametrize("n,v", SCHEDULE_SHAPES)
def test_schedule_covers_every_tile_once_in_order(n, v):
    """B7's and d's units: every (row tile, vocabulary tile) exactly once,
    each range a run of increasing tiles that follows the previous range,
    whole waves of 132 SMs where the ranges allow it, and a first wave
    within one raster group on at most ROW_GROUP row tiles. dx's units:
    every (row tile, D tile) once, the blocks of a raster group launched
    together on one D tile."""
    rows, tiles = n // fc.TILE, fc.col_tiles(v)
    splits = fc.vocab_splits(n, v, sms=132)
    assert 1 <= splits <= tiles
    units = fc.ce_schedule(rows, tiles, splits, fc.ROW_GROUP)
    assert len(units) == rows * splits
    seen = np.zeros((rows, tiles), np.int64)
    ranges = {}
    for row, split, t0, t1 in units:
        assert t0 < t1
        seen[row, t0:t1] += 1
        assert ranges.setdefault(split, (t0, t1)) == (t0, t1)
    assert (seen == 1).all()
    bounds = [ranges[s] for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == tiles
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert sorted((r, s) for r, s, _, _ in units) == [
        (r, s) for r in range(rows) for s in range(splits)]
    if splits < tiles:
        assert len(units) % 132 == 0
    if fc.ROW_GROUP * splits >= 132:  # a wave within one raster group
        assert len({r for r, _, _, _ in units[:132]}) <= fc.ROW_GROUP

    dtiles = fc.col_tiles(4096)
    group = min(fc.DX_ROW_GROUP, rows)
    dx_units = fc.ce_schedule(rows, dtiles, dtiles, fc.DX_ROW_GROUP)
    assert sorted((r, s) for r, s, _, _ in dx_units) == [
        (r, s) for r in range(rows) for s in range(dtiles)]
    assert all((t0, t1) == (s, s + 1) for _, s, t0, t1 in dx_units)
    # blocks launched together share one D tile of head
    assert [s for _, s, _, _ in dx_units[:group * dtiles]] == [
        s for s in range(dtiles) for _ in range(group)]
