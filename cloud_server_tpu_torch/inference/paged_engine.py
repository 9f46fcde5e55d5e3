"""Paged inference engine: the window-forward primitive over a page pool.

One global pool of fixed-size pages per layer plus per-slot page tables;
pages can be shared between slots (refcounted prefix reuse —
inference/block_allocator.py). Everything the paged server dispatches is
one primitive, `window_forward(tokens (B, W))`: embed W new positions per
slot at absolute positions [lengths, lengths + W), write their kv into
the pool through the page table, and attend each window row against the
slot's whole paged history (the CUDA kernel of `ops.paged_attention` on
the card when `decode_attention_impl == "pallas"`, else the plain gather
+ attention). `window_forward` does not advance `lengths`: the caller
commits however many window positions survive.

Where the metadata lives. The pools live on the device. `lengths` and
`tables` are host-authoritative (the server keeps them in numpy), so the
cache carries them as CPU int32 tensors. Which window positions write
where is decided on the host, once per call, from those host arrays —
that is how writes "drop" without a device sync: sentinel table entries
(page id == num_pages), positions past a ragged row's width, and
positions past the table's reach are simply not in the write list.
Shared pages are never written: the allocator guarantees writes happen
at positions >= every sharing slot's private start.

The int8 KV cache (`cfg.kv_cache_dtype == "int8"`): int8 pools plus
(L, P, KH, ps) f32 scale pools, one absmax scale per position and kv
head. A write quantizes the window's k and v (`engine._kv_quant`) and
stores values and scales through the same write plan, so a page and its
scales always travel together by page id.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.inference.engine import _kv_quant, _mlp_apply
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import rms_norm, rope_table
from cloud_server_tpu_torch.ops.paged_attention import (paged_attention,
                                                        paged_attention_ref)

# Widest window the kernel path serves (the reference's cap); wider
# windows take the plain path.
PALLAS_MAX_W = 256


class PagedKVCache(NamedTuple):
    """Page pool + per-slot view. One pool serves every slot and layer."""

    k: torch.Tensor        # (L, num_pages, KH, Dh, ps) on the device,
    #                        cfg.dtype or int8
    v: torch.Tensor        # (L, num_pages, KH, Dh, ps) — transposed pages
    lengths: torch.Tensor  # (B,) int32 on the host — committed kv entries
    tables: torch.Tensor   # (B, max_pages_per_slot) int32 on the host
    k_scale: torch.Tensor | None = None  # (L, num_pages, KH, ps) f32
    v_scale: torch.Tensor | None = None  # scales of int8 pools, else None

    @property
    def page_size(self) -> int:
        return self.k.shape[4]

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def max_context(self) -> int:
        return self.tables.shape[1] * self.page_size


def _host_i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(device="cpu", dtype=torch.int32)


def make_cache(k, v, lengths, tables, k_scale=None,
               v_scale=None) -> PagedKVCache:
    """A cache view over existing pools with host metadata."""
    return PagedKVCache(k=k, v=v, lengths=_host_i32(lengths),
                        tables=_host_i32(tables), k_scale=k_scale,
                        v_scale=v_scale)


def init_paged_cache(cfg: ModelConfig, *, num_pages: int, page_size: int,
                     batch: int, max_pages_per_slot: int,
                     device=None) -> PagedKVCache:
    """Zeroed pool on `device` (int8 with zeroed scale pools when
    cfg.kv_cache_dtype == "int8"); all tables at the sentinel."""
    if cfg.kv_cache_dtype not in ("model", "int8"):
        raise ValueError(f"unknown kv_cache_dtype: {cfg.kv_cache_dtype!r}")
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.num_kv_heads, cfg.head_dim,
             page_size)
    meta = dict(lengths=torch.zeros((batch,), dtype=torch.int32),
                tables=torch.full((batch, max_pages_per_slot), num_pages,
                                  dtype=torch.int32))
    if cfg.kv_cache_dtype == "int8":
        sshape = shape[:3] + (page_size,)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            v_scale=torch.zeros(sshape, dtype=torch.float32, device=dev),
            **meta)
    dtype = transformer.torch_dtype(cfg.dtype)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev),
                        **meta)


def quantize_pool(pool: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8-quantize a transposed page pool (L, P, KH, Dh, ps): absmax over
    Dh (axis 3), the per-(position, head) granularity `_write_window`
    stores. Returns (int8 pool, (L, P, KH, ps) f32 scales)."""
    q, sc = _kv_quant(pool.transpose(3, 4))
    return q.transpose(3, 4).contiguous(), sc[..., 0].contiguous()


def hbm_bytes(cache: PagedKVCache) -> int:
    """Device bytes held by the pools (values, and the int8 cache's
    scales)."""
    n = cache.k.numel() * cache.k.element_size() * 2
    if cache.k_scale is not None:
        n += cache.k_scale.numel() * 4 * 2
    return n


def write_plan(cache: PagedKVCache, w: int, widths=None):
    """Host-side write list for a W-wide window: (rows, cols, pages,
    offsets) of every window position that really writes. Dropped:
    positions at window index >= widths[b], positions whose page slot is
    past the table, and sentinel (or otherwise out-of-pool) pages."""
    lengths = cache.lengths.long()
    tables = cache.tables.long()
    ps, mp = cache.page_size, tables.shape[1]
    col = torch.arange(w)
    pos = lengths[:, None] + col[None, :]
    valid = pos >= 0
    if widths is not None:
        valid &= col[None, :] < _host_i32(widths).long()[:, None]
    slot = torch.div(pos, ps, rounding_mode="floor")
    valid &= slot < mp
    page = tables.gather(1, slot.clamp(0, mp - 1))
    valid &= (page >= 0) & (page < cache.num_pages)
    rows, cols = valid.nonzero(as_tuple=True)
    return rows, cols, page[rows, cols], (pos % ps)[rows, cols]


def _write_window(cache: PagedKVCache, layer: int, k, v, plan) -> None:
    """Write fresh (B, W, KH, Dh) k/v through the page table, in place
    (the reference donates the pools to its compiled step and rebuilds
    them; here the pool tensors are updated where they lie). An int8
    cache stores each written position quantized, with its scales."""
    rows, cols, pages, offs = plan
    if rows.numel() == 0:
        return
    for pool, spool, src in ((cache.k, cache.k_scale, k),
                             (cache.v, cache.v_scale, v)):
        fresh = src[rows, cols]                  # (N, KH, Dh)
        if spool is not None:
            fresh, sc = _kv_quant(fresh)
            spool[layer][pages, :, offs] = sc[..., 0]
        pool[layer][pages, :, :, offs] = fresh.to(pool.dtype)


@torch.no_grad()
def window_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
                   cache: PagedKVCache, *, logits_at=None,
                   all_logits: bool = False, widths=None, rope=None):
    """Forward W new positions per slot against the paged cache.

    Args:
      tokens: (B, W) int — slot b's tokens for absolute positions
        [lengths[b], lengths[b] + W), on the pools' device.
      logits_at: (B,) in-window indices — return (B, V) f32 logits at
        that position per slot.
      all_logits: return (B, W, V) f32. With neither, returns None.
      widths: optional (B,) ragged valid widths: positions at window
        index >= widths[b] neither write kv nor anchor attention.
      rope: optional precomputed (cos, sin) for cache.max_context
        positions on the device (a server computes it once).

    Returns (logits, cache); the pools hold the window's kv, lengths are
    unchanged.
    """
    dev = cache.k.device
    b, w = tokens.shape
    lengths = cache.lengths.long()
    pos = lengths[:, None] + torch.arange(w)[None, :]
    # positions past the table (garbage rows) read the last rope entry,
    # as the reference's clamped gather does
    rope_pos = pos.clamp(0, cache.max_context - 1).to(dev)
    cos, sin = rope if rope is not None else rope_table(
        cfg, cache.max_context, device=dev)
    x = transformer.embed(params, tokens, cfg)

    use_kernel = cfg.decode_attention_impl == "pallas" and w <= PALLAS_MAX_W
    attend = paged_attention if use_kernel else paged_attention_ref
    lens_after = lengths + (w if widths is None else _host_i32(widths))
    lens_dev = lens_after.to(device=dev, dtype=torch.int32)
    tables_dev = cache.tables.to(dev)
    widths_dev = None if widths is None else _host_i32(widths).to(dev)
    plan = tuple(t.to(dev) for t in write_plan(cache, w, widths))

    for layer in range(cfg.num_layers):
        lp = transformer.layer_params(params, layer)
        q, k, v = transformer.attention_qkv(x, lp, cfg, cos, sin, rope_pos)
        _write_window(cache, layer, k, v, plan)
        o = attend(q, cache.k, cache.v, lens_dev, tables_dev, layer,
                   widths=widths_dev, k_scale_pool=cache.k_scale,
                   v_scale_pool=cache.v_scale)
        x = transformer.attention_out(x, o, lp, cfg)
        x = _mlp_apply(x, lp, cfg)

    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if all_logits:
        return transformer.unembed(x, params, cfg), cache
    if logits_at is not None:
        at = torch.as_tensor(logits_at).to(dev).long().clamp(0, w - 1)
        x_sel = x[torch.arange(b, device=dev), at]
        return transformer.unembed(x_sel, params, cfg), cache
    return None, cache
