"""Fused unembed + cross-entropy statistics: per row of x (N, D) against
head (D, V), (logz f32, target_logit f32, argmax int64) without the
(N, V) float32 logits.

The reference's contract (`ops/fused_ce.py`): N and V multiples of 128
(else ValueError); the argmax takes the first index on ties; the forward
saves x, head, targets and logz; the backward rebuilds
d = g·softmax + h·onehot per row from the saved logz, rounds d to x's
dtype, and computes dx = d @ headᵀ (f32 accumulate, in x's dtype) and
dW = xᵀ @ d (f32, in head's dtype). Differentiable in x and head.

Two versions of one function:

  * `fused_ce_stats_ref` — the plain PyTorch version, a
    `torch.autograd.Function` whose forward materialises the f32 logits
    and whose backward follows the steps above (in bf16 it rounds d where
    the reference does).
  * `fused_ce_stats` — the kernel wrapper. On a CUDA bf16 tensor its
    forward launches `csrc/fused_ce.cu`'s B7 entry (the reference's
    `_fwd_kernel`: the vocabulary split into ranges of whole 256-column
    tiles, one block per row tile and range, blocks in pairs that share
    head's tiles, then an in-order combine of the ranges) and its
    backward launches B8 (the reference's `_dx_kernel`) as two kernels, d
    from the recomputed logits and then dx = d @ headᵀ; dW stays a
    library product over the emitted d, as in the reference. Anything the
    kernels do not take raises. On a CPU tensor it runs the plain version.
  * `stats_by_ranges_ref` — the plain forward statistics computed the way
    the B7 kernel orders them: per vocabulary range, then combined in
    order. `ce_schedule` lists the kernels' work units in launch order
    (the arithmetic of `unit_of` in the CUDA source, whose host entry
    `ce_units` the card tests compare it with), `vocab_splits` picks the
    number of ranges.

A vocabulary shard of a tensor-parallel head (`fused_ce_shard_stats`)
also takes V/tp columns that are not a multiple of 128: the head is
padded with zero columns to the next multiple, and the statistics and
d see only the first `valid` columns (the kernels mask the pad out of
the max, the sum, the argmax and d). It returns the row max beside the
statistics, for the combine over the shards.

Counters, one per TPU kernel: `launches_fwd` counts B7 calls (two CUDA
launches each: the ranges and their combine), `launches_dx` counts B8
calls (two CUDA launches each: d, then dx, counted at the dx launch that
ends every call); `plain_calls` counts the plain version's forward and
backward calls.
"""

from __future__ import annotations

import ctypes
import math

import torch

from cloud_server_tpu_torch.ops import cuda_build
from cloud_server_tpu_torch.ops.matmul import matmul_f32

TILE = 128  # N and V must be multiples of it (the reference's rule)
NEG_INF = -1e30  # the kernels' mask value
COL_TILE = 256  # the kernels' output tile: 128 rows x 256 columns
# row tiles per raster group, kRowGroup in csrc/fused_ce.cu (for the tests)
ROW_GROUP = 16  # B7 and d
DX_ROW_GROUP = 8  # dx

launches_fwd = 0
launches_dx = 0
plain_calls = 0


def reset_counters() -> None:
    global launches_fwd, launches_dx, plain_calls
    launches_fwd = launches_dx = plain_calls = 0


def counters() -> dict:
    return {"launches_fwd": launches_fwd, "launches_dx": launches_dx,
            "plain_calls": plain_calls}


def _check_shapes(x, head) -> None:
    n, v = x.shape[0], head.shape[1]
    if n % TILE or v % TILE or n == 0 or v == 0:
        raise ValueError(
            f"fused_ce_stats needs N ({n}) and V ({v}) divisible by "
            f"{TILE}; pad the batch or use the dense/chunked CE path")


def _masked_logits(x, head, valid: int) -> torch.Tensor:
    """The f32 logits, the columns from `valid` on masked to NEG_INF."""
    logits = matmul_f32(x, head)
    if valid < head.shape[1]:
        logits[:, valid:] = NEG_INF
    return logits


def _dlogits_ref(x, head, targets, logz, g, h, valid=None) -> torch.Tensor:
    """d = g·exp(logits - logz) + h·onehot(targets), rounded to x's
    dtype; 0 in the columns from `valid` on."""
    logits = _masked_logits(x, head, head.shape[1] if valid is None
                            else valid)
    d = g[:, None] * torch.exp(logits - logz[:, None])
    d[torch.arange(x.shape[0], device=x.device), targets] += h
    return d.to(x.dtype)


def _grads_of_d(x, head, d) -> tuple:
    """dx = d @ headᵀ in x's dtype and dW = xᵀ @ d in head's dtype, both
    summed in float32."""
    return (matmul_f32(d, head.t()).to(x.dtype),
            matmul_f32(x.t(), d).to(head.dtype))


def _cotangents(x, g_logz, g_tl) -> tuple:
    n = x.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=x.device)
    g = zeros if g_logz is None else g_logz.float().contiguous()
    h = zeros if g_tl is None else g_tl.float().contiguous()
    return g, h


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


class _FusedCERef(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, head, targets, valid):
        global plain_calls
        plain_calls += 1
        targets = targets.long()
        logits = _masked_logits(x, head, valid)
        logz = torch.logsumexp(logits, dim=-1)
        tl = torch.gather(logits, 1, targets[:, None])[:, 0]
        mx, am = logits.max(dim=-1)
        ctx.valid = valid
        ctx.save_for_backward(x, head, targets, logz)
        ctx.mark_non_differentiable(am, mx)
        return logz, tl, am, mx

    @staticmethod
    def backward(ctx, g_logz, g_tl, g_am, g_mx):
        global plain_calls
        plain_calls += 1
        x, head, targets, logz = ctx.saved_tensors
        g, h = _cotangents(x, g_logz, g_tl)
        d = _dlogits_ref(x, head, targets, logz, g, h, ctx.valid)
        dx, dw = _grads_of_d(x, head, d)
        return dx, dw, None, None


def fused_ce_stats_ref(x, head, targets):
    """The plain version: x (N, D), head (D, V), targets (N,) int ->
    (logz (N,) f32, target_logit (N,) f32, argmax (N,) int64)."""
    _check_shapes(x, head)
    return _FusedCERef.apply(x, head, targets, head.shape[1])[:3]


# ---------------------------------------------------------------------------
# The kernels' work schedule, and the statistics in its order
# ---------------------------------------------------------------------------


def col_tiles(cols: int) -> int:
    return -(-cols // COL_TILE)


def vocab_splits(n: int, v: int, sms: int) -> int:
    """Vocabulary ranges of B7 and d: a multiple of sms / gcd(N / 128,
    sms), so that the (row tile, range) units fill whole waves of `sms`
    SMs, near 16 tiles a range, and at most one range per tile."""
    rows = n // TILE
    wave = sms // math.gcd(rows, sms)
    tiles = col_tiles(v)
    return min(tiles, wave * max(1, round(tiles / (16 * wave))))


def range_tiles(split: int, splits: int, tiles: int) -> tuple:
    """Column tiles [t0, t1) of range `split` of `splits`."""
    return split * tiles // splits, (split + 1) * tiles // splits


def ce_schedule(row_tiles: int, tiles: int, splits: int,
                group: int) -> list:
    """The kernels' work units in launch order, (row tile, range, t0, t1):
    groups of `group` row tiles (fewer in the last), the row tile fastest
    within a group, then the range; each block walks tiles t0 .. t1 - 1
    in order. The arithmetic of `unit_of` in csrc/fused_ce.cu."""
    units = []
    per_group = group * splits
    for b in range(row_tiles * splits):
        grp, rem = divmod(b, per_group)
        rows = min(group, row_tiles - grp * group)
        split, r = divmod(rem, rows)
        units.append((grp * group + r, split, *range_tiles(split, splits,
                                                           tiles)))
    return units


def stats_by_ranges_ref(x, head, targets, splits: int) -> tuple:
    """(logz, target_logit, argmax int64) as B7 orders the work: the
    statistics of each vocabulary range (whole 256-column tiles, the
    ranges of `range_tiles`) and then the ranges combined in order, a later
    range taking the argmax only on a strictly greater max."""
    _check_shapes(x, head)
    v = head.shape[1]
    tiles = col_tiles(v)
    if not 1 <= splits <= tiles:
        raise ValueError(f"splits {splits} outside [1, {tiles}]")
    targets = targets.long()
    m = l = tl = am = None
    for split in range(splits):
        t0, t1 = range_tiles(split, splits, tiles)
        c0, c1 = t0 * COL_TILE, min(t1 * COL_TILE, v)
        logits = matmul_f32(x, head[:, c0:c1])
        m2, a2 = logits.max(dim=-1)
        l2 = torch.exp(logits - m2[:, None]).sum(dim=-1)
        inside = (targets >= c0) & (targets < c1)
        t2 = torch.where(
            inside, torch.gather(logits, 1, (targets - c0).clamp(
                0, c1 - c0 - 1)[:, None])[:, 0], torch.zeros_like(m2))
        if m is None:
            m, l, tl, am = m2, l2, t2, a2 + c0
            continue
        mn = torch.maximum(m, m2)
        l = l * torch.exp(m - mn) + l2 * torch.exp(m2 - mn)
        tl = tl + t2
        am = torch.where(m2 > m, a2 + c0, am)
        m = mn
    return m + torch.log(l), tl, am


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, head, targets, part_m, part_l, part_tl, part_am, logz, tl, am,
    # mx | n, d, v, valid, splits | stream
    "ce_fwd_bf16": [_P] * 11 + [_I] * 5 + [_P],
    # x, head, targets, logz, g, h, d | n, d, v, valid, splits | stream
    "ce_dlogits_bf16": [_P] * 7 + [_I] * 5 + [_P],
    # d, head, dx | n, d, v | stream
    "ce_dx_bf16": [_P] * 3 + [_I] * 3 + [_P],
    # n, cols, splits, dx | out (host int32, (N / 128 * splits, 4))
    "ce_units": [_I] * 4 + [_P],
}


def _kernel(name: str):
    """The ctypes function of one C entry of csrc/fused_ce.cu (built at
    first use)."""
    fn = getattr(cuda_build.load("fused_ce"), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"fused_ce {what} kernel launch failed: CUDA "
                           f"error {err}")


def _validate(x, head, targets) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if x.dim() != 2 or head.dim() != 2 or x.shape[1] != head.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not fit head "
                         f"{tuple(head.shape)}")
    if targets.shape != (x.shape[0],):
        raise ValueError(f"targets {tuple(targets.shape)} must be "
                         f"({x.shape[0]},)")
    if not (x.dtype == head.dtype == torch.bfloat16):
        raise TypeError("the CUDA fused-CE kernels take bfloat16 x and "
                        f"head; got {x.dtype}, {head.dtype}")
    if x.shape[1] % TILE:
        raise ValueError(f"the CUDA fused-CE kernels need D ({x.shape[1]}) "
                         f"divisible by {TILE}")
    for name, t in (("head", head), ("targets", targets)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for t in (x, head):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the CUDA fused-CE kernels need contiguous, "
                             "16-byte aligned x and head")


def device_splits(n: int, v: int, device) -> int:
    """`vocab_splits` for the SMs of `device`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return vocab_splits(n, v, sms)


def forward_stats(x, head, targets32, valid: int | None = None,
                  with_max: bool = False):
    """One B7 call on validated CUDA tensors over the first `valid`
    columns of head (all by default): (logz, tl, am int32), and the row
    max (f32) after them with `with_max`."""
    global launches_fwd
    n, d = x.shape
    v = head.shape[1]
    valid = v if valid is None else valid
    splits = device_splits(n, valid, x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    part = torch.empty((4, splits, n), **f32)
    part_am = torch.empty((splits, n), dtype=torch.int32, device=x.device)
    logz = torch.empty(n, **f32)
    tl = torch.empty(n, **f32)
    am = torch.empty(n, dtype=torch.int32, device=x.device)
    mx = torch.empty(n, **f32) if with_max else None
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _check(_kernel("ce_fwd_bf16")(
        x.data_ptr(), head.data_ptr(), targets32.data_ptr(),
        part[0].data_ptr(), part[1].data_ptr(), part[2].data_ptr(),
        part_am.data_ptr(), logz.data_ptr(), tl.data_ptr(), am.data_ptr(),
        None if mx is None else mx.data_ptr(), n, d, v, valid, splits,
        stream), "forward")
    launches_fwd += 1
    return (logz, tl, am, mx) if with_max else (logz, tl, am)


def _launch_dlogits(x, head, targets32, logz, g, h, dbuf,
                    valid: int | None = None) -> None:
    """B8's first launch: d (N, V) into dbuf, 0 from column `valid` on.
    Counts nothing: a B8 call is counted at its dx launch."""
    n, dim = x.shape
    v = head.shape[1]
    valid = v if valid is None else valid
    _check(_kernel("ce_dlogits_bf16")(
        x.data_ptr(), head.data_ptr(), targets32.data_ptr(),
        logz.data_ptr(), g.data_ptr(), h.data_ptr(), dbuf.data_ptr(), n,
        dim, v, valid, device_splits(n, valid, x.device),
        torch.cuda.current_stream(x.device).cuda_stream), "d_logits")


def _launch_dx(dbuf, head, dx) -> None:
    """B8's second launch, which ends every B8 call: dx = d @ headᵀ into
    dx, counted in `launches_dx`."""
    global launches_dx
    n, dim = dx.shape
    _check(_kernel("ce_dx_bf16")(
        dbuf.data_ptr(), head.data_ptr(), dx.data_ptr(), n, dim,
        head.shape[1], torch.cuda.current_stream(dx.device).cuda_stream),
        "dx")
    launches_dx += 1


def backward_dx(x, head, targets32, logz, g, h, valid: int | None = None):
    """One B8 call on validated CUDA tensors: (d (N, V), dx (N, D)), both
    in x's dtype."""
    dbuf = torch.empty((x.shape[0], head.shape[1]), dtype=x.dtype,
                       device=x.device)
    dx = torch.empty_like(x)
    _launch_dlogits(x, head, targets32, logz, g, h, dbuf, valid)
    _launch_dx(dbuf, head, dx)
    return dbuf, dx


class _FusedCE(torch.autograd.Function):
    """The kernels on (N, D) x and (D, V) head, bf16 CUDA tensors, over
    head's first `valid` columns."""

    @staticmethod
    def forward(ctx, x, head, targets, valid):
        targets32 = targets.to(torch.int32).contiguous()
        logz, tl, am, mx = forward_stats(x, head, targets32, valid,
                                         with_max=True)
        ctx.valid = valid
        ctx.save_for_backward(x, head, targets32, logz)
        am = am.long()
        ctx.mark_non_differentiable(am, mx)
        return logz, tl, am, mx

    @staticmethod
    def backward(ctx, g_logz, g_tl, g_am, g_mx):
        x, head, targets32, logz = ctx.saved_tensors
        g, h = _cotangents(x, g_logz, g_tl)
        dbuf, dx = backward_dx(x, head, targets32, logz, g, h, ctx.valid)
        dw = torch.mm(x.t(), dbuf, out_dtype=torch.float32).to(head.dtype)
        return dx, dw, None, None


def fused_ce_stats(x, head, targets):
    """x: (N, D) model dtype; head: (D, V) model dtype; targets: (N,) int.
    Returns (logz (N,) f32, target_logit (N,) f32, argmax (N,) int64),
    differentiable in x and head. N and V must be multiples of 128. On a
    CPU tensor this is the plain version; on a CUDA tensor the kernels run
    or this raises."""
    _check_shapes(x, head)
    if x.device.type == "cpu":
        return fused_ce_stats_ref(x, head, targets)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ce_stats: unsupported device {x.device}")
    x, head = x.contiguous(), head.contiguous()
    _validate(x, head, targets)
    return _FusedCE.apply(x, head, targets, head.shape[1])[:3]


def _pad_shard(x, head):
    n, valid = x.shape[0], head.shape[1]
    if n % TILE or n == 0 or valid == 0:
        raise ValueError(
            f"fused_ce_shard_stats needs N ({n}) divisible by {TILE} and a "
            "non-empty vocabulary shard")
    pad = -valid % TILE
    return (torch.nn.functional.pad(head, (0, pad)) if pad else head), valid


def fused_ce_shard_stats_ref(x, head, targets):
    """The plain version of `fused_ce_shard_stats`, on any device: the
    same zero pad, masked the same way."""
    head, valid = _pad_shard(x, head)
    return _FusedCERef.apply(x, head, targets, valid)


def combine_shard_stats(parts) -> tuple:
    """(logz, target_logit, argmax) over the whole vocabulary from each
    shard's (logz, target_logit (0 off the shard), argmax as a global
    index, row max), shards in vocabulary order: the logsumexp of the
    logz, the sum of the target logits, and the first shard's argmax
    among those with the greatest max (a later shard wins only on a
    strictly greater max, as the kernels combine their ranges)."""
    logz = torch.logsumexp(torch.stack([p[0] for p in parts]), dim=0)
    tl = torch.stack([p[1] for p in parts]).sum(dim=0)
    mx = torch.stack([p[3].float() for p in parts])
    best = mx.argmax(dim=0)  # the first of equal maxima
    am = torch.gather(torch.stack([p[2] for p in parts]), 0, best[None])[0]
    return logz, tl, am


def fused_ce_shard_stats(x, head, targets):
    """`fused_ce_stats` over one vocabulary shard of a tensor-parallel
    head: x (N, D), head (D, V_shard) with any V_shard, targets (N,) in
    [0, V_shard). A V_shard that is not a multiple of 128 is padded with
    zero columns up to one, masked out of the statistics and of d (the
    pad's gradient is dropped). Returns (logz, target_logit, argmax
    int64, row max f32); the last two are not differentiable. On a CPU
    tensor the plain version, on a CUDA tensor the kernels."""
    head, valid = _pad_shard(x, head)
    if x.device.type == "cpu":
        return _FusedCERef.apply(x, head, targets, valid)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ce_shard_stats: unsupported device "
                         f"{x.device}")
    x, head = x.contiguous(), head.contiguous()
    _validate(x, head, targets)
    return _FusedCE.apply(x, head, targets, valid)
