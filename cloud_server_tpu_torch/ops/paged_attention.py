"""Paged attention: uniform or ragged query windows against a page pool.

The serving path's cached attention at every window width W (decode
W = 1, chunked prefill W = chunk, mixed batches with ragged per-row
`widths`). Layouts are the reference's:

  q        (B, W, H, Dh)
  pools    (L, P, KH, Dh, ps)   transposed pages, positions minor
  tables   (B, max_pages) int32; an entry past `last_page` (the
           sentinel, "no page") reads page `last_page`
  lengths  (B,) int32           kv entries INCLUDING the window
  widths   (B,) int32           valid window rows per slot (<= W)

Row b's valid queries are window indices [0, widths[b]) at absolute
positions [lengths[b] - widths[b], lengths[b]); rows past their width
and slots of length 0 produce finite garbage that the caller masks.

Two versions of one function:

  * `paged_attention_ref` — the plain PyTorch version (a port of the
    reference's `gather_pages` + `paged_attention_xla`): gather every
    slot's pages into a contiguous cache, then `causal_attention`.
  * `paged_attention` — the kernel wrapper. On a CUDA tensor it launches
    one of the two hand-written Hopper kernels of
    `csrc/paged_attention.cu` (or raises): the narrow kernel (split-KV in
    clusters of blocks, one launch) for the reference's narrow class, the
    wide kernel (TMA, an mbarrier ring and wgmma) for the rest. On a CPU
    tensor it runs the plain version.

The int8 KV cache: int8 pools plus (L, P, KH, ps) f32 absmax scale
pools (`k_scale_pool`, `v_scale_pool`, one scale per position and kv
head). Both versions fold the scales into the score and probability
columns; neither builds a dequantized cache.

The wrapper counts launches in module counters named after the TPU
kernels each CUDA kernel replaces: `launches_narrow` counts the narrow
kernel (the reference's `_paged_attention_kernel`: W <= 32 and B <= 16)
and `launches_wide` the wide one (`_paged_attention_wide_kernel`:
everything else, and a narrow-class call whose W * G rows exceed
NARROW_MAX_ROWS), `launches_narrow_int8` / `launches_wide_int8` the
same kernels on the int8 cache. Three counters break the bf16 launches
down further: `launches_narrow_verify` (narrow launches of speculation's
verify windows, the calls made with `verify=True`), `launches_narrow_d64`
and `launches_wide_d64` (head dim 64, a Llama-3.2-1B draft model's).
`plain_calls` counts calls of the plain version. The counters are
updated under a lock (two servers' scheduler threads launch at once). A
call made while a CUDA graph captures launches nothing: inside
`recording()` the calling thread's calls count into the capture's own
tally instead, and each replay adds that tally (`add_counts`,
inference/graphs.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from cloud_server_tpu_torch.ops import cuda_build
from cloud_server_tpu_torch.ops.attention import causal_attention

# The reference's shape classes (ops/paged_attention.py there).
NARROW_MAX_W = 32
NARROW_MAX_B = 16
KERNEL_HEAD_DIMS = (64, 128)

launches_narrow = 0
launches_wide = 0
launches_narrow_int8 = 0
launches_wide_int8 = 0
launches_narrow_verify = 0
launches_narrow_d64 = 0
launches_wide_d64 = 0
plain_calls = 0

_COUNTERS = ("launches_narrow", "launches_wide", "launches_narrow_int8",
             "launches_wide_int8", "launches_narrow_verify",
             "launches_narrow_d64", "launches_wide_d64", "plain_calls")


_counts_lock = threading.Lock()
# per thread: the tally of an open `recording()`, else unset
_recording = threading.local()


def reset_counters() -> None:
    with _counts_lock:
        for name in _COUNTERS:
            globals()[name] = 0


def counters() -> dict:
    with _counts_lock:
        return {name: globals()[name] for name in _COUNTERS}


def add_counts(delta: dict) -> None:
    """Add `delta` (a dict shaped like `counters()`) to the counters: a
    CUDA graph's replay launches what its capture recorded (see
    inference/graphs.py), though no Python call runs."""
    with _counts_lock:
        for name, n in delta.items():
            globals()[name] += n


def _count(*names: str) -> None:
    """One call of each counter in `names`: into this thread's open
    recording, else into the counters."""
    tally = getattr(_recording, "tally", None)
    if tally is not None:
        for name in names:
            tally[name] += 1
        return
    with _counts_lock:
        for name in names:
            globals()[name] += 1


@contextlib.contextmanager
def recording():
    """Count this thread's calls into the yielded dict instead of the
    counters (a CUDA graph's capture, whose calls launch nothing; other
    threads keep counting theirs)."""
    tally = dict.fromkeys(_COUNTERS, 0)
    _recording.tally = tally
    try:
        yield tally
    finally:
        _recording.tally = None


def is_narrow(b: int, w: int) -> bool:
    return w <= NARROW_MAX_W and b <= NARROW_MAX_B


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def page_limit(num_pages: int, last_page: int | None) -> int:
    """The largest page id a table entry reads: `last_page`, or the
    pool's last page (P - 1) when it is None. A pool that carries a
    scratch page after its real pages (inference/paged_engine.py) passes
    its last real page, so a sentinel entry reads that page, as the
    reference's gather does (its pool has no scratch page), and never
    what masked writes left in the scratch page."""
    limit = num_pages - 1 if last_page is None else int(last_page)
    if not 0 <= limit < num_pages:
        raise ValueError(f"last_page {last_page} out of range "
                         f"[0, {num_pages})")
    return limit


def gather_pages(pool: torch.Tensor, tables: torch.Tensor,
                 layer: int = 0, last_page: int | None = None
                 ) -> torch.Tensor:
    """(L, P, KH, Dh, ps), (B, MP) -> contiguous (B, MP*ps, KH, Dh) for
    `layer`. Table entries are clamped into [0, last_page] (`page_limit`)."""
    b, mp = tables.shape
    _, num_pages, kh, d, ps = pool.shape
    idx = tables.to(pool.device).long().clamp(
        0, page_limit(num_pages, last_page))
    pages = pool[int(layer)][idx]                # (B, MP, KH, Dh, ps)
    return pages.permute(0, 1, 4, 2, 3).reshape(b, mp * ps, kh, d)


def gather_scale_pages(scale_pool: torch.Tensor, tables: torch.Tensor,
                       layer: int = 0, last_page: int | None = None
                       ) -> torch.Tensor:
    """(L, P, KH, ps), (B, MP) -> (B, MP*ps, KH, 1) f32 for `layer`,
    clamped as `gather_pages`."""
    b, mp = tables.shape
    _, num_pages, kh, ps = scale_pool.shape
    idx = tables.to(scale_pool.device).long().clamp(
        0, page_limit(num_pages, last_page))
    pages = scale_pool[int(layer)][idx]          # (B, MP, KH, ps)
    return pages.permute(0, 1, 3, 2).reshape(b, mp * ps, kh, 1)


def paged_attention_ref(q, k_pool, v_pool, lengths, tables, layer=0, *,
                        scale=None, widths=None, pages_per_block=None,
                        k_scale_pool=None, v_scale_pool=None,
                        last_page=None):
    """Plain PyTorch paged attention (gather + masked dense attention).
    Same arguments and result as `paged_attention`; `pages_per_block`
    is accepted and unused."""
    if (k_scale_pool is None) != (v_scale_pool is None):
        raise ValueError("k_scale_pool and v_scale_pool must be given "
                         "together")
    _count("plain_calls")
    b, w = q.shape[:2]
    dev = q.device
    lengths = lengths.to(dev)
    k = gather_pages(k_pool, tables, layer, last_page)
    v = gather_pages(v_pool, tables, layer, last_page)
    scales = {}
    if k_scale_pool is not None:
        scales = dict(
            k_scale=gather_scale_pages(k_scale_pool, tables, layer,
                                       last_page),
            v_scale=gather_scale_pages(v_scale_pool, tables, layer,
                                       last_page))
    anchor = lengths - (w if widths is None else widths.to(dev))
    pos = anchor[:, None] + torch.arange(w, device=dev)[None, :]
    return causal_attention(q, k, v, scale=scale, q_positions=pos,
                            kv_length=lengths, **scales)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

# The narrow kernel takes at most this many folded rows (W * G) a kv head;
# it splits each (slot, kv head)'s keys over a cluster of up to 8 blocks,
# as many as fill one wave of the card at its occupancy (chosen in
# csrc/paged_attention.cu from the shapes and the device, never from the
# lengths; `narrow_splits` reports the count).
NARROW_MAX_ROWS = 128
TILE = 64  # kv positions a tile
# Loaders of csrc/paged_attention.cu: TMA boxes of a tile (page sizes
# that are a multiple of TILE, 16-byte aligned pools), cp.async of 8
# positions (page sizes that are a multiple of 8), element by element.
LOADER_TMA, LOADER_VEC, LOADER_SCALAR = 0, 1, 2


def uses_narrow_kernel(b: int, w: int, g: int) -> bool:
    """The narrow kernel serves the reference's narrow class where its
    W * G rows fit one block; any other call runs the wide kernel."""
    return is_narrow(b, w) and w * g <= NARROW_MAX_ROWS


def narrow_splits(b: int, w: int, kh: int, g: int, d: int, int8: bool,
                  max_pages: int, page_size: int) -> int:
    """Blocks of the narrow kernel's cluster for each (slot, kv head) at
    these shapes on the current CUDA device (0 where it does not run)."""
    fn = cuda_build.load("paged_attention").paged_attention_narrow_splits
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 8
        fn.restype = ctypes.c_int
    return fn(b, w, kh, g, d, int(int8), max_pages, page_size)


def loader_mode(page_size: int, pool_ptrs, scale_ptrs, elem_size: int,
                rows: int) -> int:
    """TMA where a tile is one box inside a page and every pointer the
    copies start from is 16-byte aligned (the pool, seen as `rows` rows
    of page_size, within the maps' 32-bit coordinates); cp.async where
    page_size % 8 == 0 and the pools are aligned to 8 positions; else by
    element."""
    if (page_size % TILE == 0 and rows < 2 ** 31
            and all(p % 16 == 0 for p in (*pool_ptrs, *scale_ptrs))):
        return LOADER_TMA
    if page_size % 8 == 0 and all(p % (8 * elem_size) == 0
                                  for p in pool_ptrs):
        return LOADER_VEC
    return LOADER_SCALAR


def _kernel(int8: bool = False):
    """The C entry for bf16 pools, or for int8 pools (which takes the two
    scale-pool pointers after the value pools)."""
    lib = cuda_build.load("paged_attention")
    fn = lib.paged_attention_int8 if int8 else lib.paged_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * (9 if int8 else 7)
                       + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _int32_on(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def paged_attention(q, k_pool, v_pool, lengths, tables, layer=0, *,
                    scale=None, pages_per_block=None, widths=None,
                    k_scale_pool=None, v_scale_pool=None, verify=False,
                    last_page=None):
    """Uniform- or ragged-window attention against a paged KV cache.

    Args:
      q: (B, W, H, Dh); slot b's window sits at absolute positions
        [lengths[b] - widths[b], lengths[b]). Its kv must already be
        written to the pools (write-then-attend). The kernels read it
        through its strides.
      k_pool, v_pool: (L, P, KH, Dh, ps) page pools (bf16, or int8 with
        the scale pools); `layer` selects inside the kernel, so no
        per-layer slice is materialised.
      lengths: (B,) int32 kv entries per slot including the window.
      tables: (B, max_pages) int32 page table; entries past a slot's
        length may be anything (they are clamped and masked).
      last_page: the largest page id an entry reads (`page_limit`):
        entries past it, the sentinel among them, read it. None = the
        pool's last page; a pool with a scratch page passes its last
        real page.
      widths: optional (B,) int32 ragged widths; None = W for every row
        (the kernels take a null pointer, so nothing is filled).
      pages_per_block: accepted for the reference's signature; the CUDA
        kernels tile kv by 64 positions whatever the page size.
      k_scale_pool, v_scale_pool: (L, P, KH, ps) f32 scales of int8
        pools, given together or not at all.
      verify: the windows are speculation's verify windows; only the
        launch counters read it.

    Returns (B, W, H, Dh) in q.dtype. On a CPU tensor this is the plain
    version; on a CUDA tensor one kernel launches (the narrow one for the
    narrow class, else the wide one) or this raises.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, k_pool, v_pool, lengths, tables, layer, scale=scale,
            widths=widths, k_scale_pool=k_scale_pool,
            v_scale_pool=v_scale_pool, last_page=last_page)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    b, w, h, d = q.shape
    if k_pool.dim() != 5 or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must both be (L, P, KH, Dh, ps); got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    n_layers, num_pages, kh, dp, ps = k_pool.shape
    if dp != d or h % kh:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}")
    int8 = k_scale_pool is not None or v_scale_pool is not None
    pool_dtype = torch.int8 if int8 else torch.bfloat16
    if q.dtype != torch.bfloat16 or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise TypeError(f"the CUDA paged-attention kernel takes bfloat16 q "
                        f"and {pool_dtype} pools"
                        f"{' with scale pools' if int8 else ''}; got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {KERNEL_HEAD_DIMS}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")
    scale_ptrs = []
    if int8:
        for name, t in (("k_scale_pool", k_scale_pool),
                        ("v_scale_pool", v_scale_pool)):
            if t is None:
                raise ValueError("k_scale_pool and v_scale_pool must be "
                                 "given together")
            if (t.shape != (n_layers, num_pages, kh, ps)
                    or t.dtype != torch.float32 or t.device != q.device
                    or not t.is_contiguous()):
                raise ValueError(
                    f"{name} must be contiguous float32 "
                    f"{(n_layers, num_pages, kh, ps)} on {q.device}; got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
            scale_ptrs.append(t.data_ptr())
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError("tables must be (B, max_pages), lengths (B,)")
    if widths is not None and widths.shape != (b,):
        raise ValueError(f"widths must be (B,); got {tuple(widths.shape)}")
    layer = int(layer)
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range [0, {n_layers})")
    if scale is None:
        scale = d ** -0.5
    limit = page_limit(num_pages, last_page)
    dev = q.device
    out = torch.empty((b, w, h, d), dtype=q.dtype, device=dev)
    if b == 0 or w == 0:
        return out
    g = h // kh
    lens = _int32_on(lengths, dev)
    tabs = _int32_on(tables, dev)
    wid = None if widths is None else _int32_on(widths, dev)
    # the kernels read q's rows in 16-byte pieces through its strides
    if (q.stride(3) != 1 or q.data_ptr() % 16
            or any(st % 8 for st in q.stride()[:3])):
        q = q.contiguous()
    narrow = uses_narrow_kernel(b, w, g)
    loader = loader_mode(ps, (k_pool.data_ptr(), v_pool.data_ptr()),
                         scale_ptrs, k_pool.element_size(),
                         n_layers * num_pages * kh * d)
    err = _kernel(int8)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scale_ptrs,
        lens.data_ptr(), tabs.data_ptr(),
        None if wid is None else wid.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *out.stride()[:3], b, w, kh, g, d, num_pages, limit,
        ps, tabs.shape[1], n_layers, layer, float(scale), loader, int(narrow),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    if int8:
        names = ["launches_narrow_int8" if narrow else "launches_wide_int8"]
    else:
        kind = "narrow" if narrow else "wide"
        names = [f"launches_{kind}"]
        if narrow and verify:
            names.append("launches_narrow_verify")
        if d == 64:
            names.append(f"launches_{kind}_d64")
    _count(*names)
    return out


def check_tp_heads(num_heads: int, num_kv_heads: int, tp: int) -> None:
    """Tensor parallelism shards attention by whole kv heads: tp must
    divide both head counts (q heads are ordered kv-head-major, so a
    contiguous split of the q heads lines up with the kv-head split)."""
    if num_kv_heads % tp or num_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_kv_heads={num_kv_heads} (and "
            f"heads={num_heads}) to shard the paged-attention kernel")


def paged_attention_tp(q, k_pool, v_pool, lengths, tables, layer=0, *,
                       heads: tuple[int, int], tp: int, **kwargs):
    """`paged_attention` under tensor parallelism: one rank's share.

    The kernels are embarrassingly parallel over kv heads (per-head
    softmax state, per-head page slices), so each rank attends with its
    own q heads against its own kv-head shard of the pools, and no
    collective is needed: the head-sharded output feeds the row-parallel
    attention-out projection, whose sum over the group is the only one
    (`transformer.attention_out`).

    Args:
      q: (B, W, H / tp, Dh), this rank's contiguous block of q heads.
      k_pool, v_pool: (L, P, KH / tp, Dh, ps), this rank's kv heads (the
        scale pools of an int8 cache, in **kwargs, likewise).
      heads: the model's (num_heads, num_kv_heads).
      tp: the tensor-parallel size.
      The rest as `paged_attention` (the kernels on the card, the plain
      version on the CPU).
    """
    h, kh = heads
    check_tp_heads(h, kh, tp)
    if q.shape[2] != h // tp or k_pool.shape[2] != kh // tp:
        raise ValueError(
            f"q {tuple(q.shape)} and pools {tuple(k_pool.shape)} are not "
            f"one rank's share of {h} heads and {kh} kv heads over tp={tp}")
    return paged_attention(q, k_pool, v_pool, lengths, tables, layer,
                           **kwargs)
