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

Where the metadata lives. The pools live on the device, and so do the
`lengths` and `tables` a server passes in (its captured programs read
them from static device buffers; the host keeps the authoritative copy
in numpy). A cache made from numpy metadata carries CPU tensors, which
`window_forward` moves to the pools' device first. Inside the forward
everything is fixed-shape device work, with no host read and no
host-to-device copy, so a CUDA graph can capture it: the write plan
covers all B x W window positions, and a position that must not write
(at window index >= widths[b], past the table's reach, or on a sentinel
or otherwise out-of-pool page) writes to the scratch page instead. The
pools hold one page more than the tables may name: page `num_pages`,
the tables' sentinel id, which no kernel reads for a live position
(past each slot's length, attention masks it). Only the scratch page
takes duplicate targets, so the scatter is exact for every real page.
Shared pages are never written: the allocator guarantees writes happen
at positions >= every sharing slot's private start.

The int8 KV cache (`cfg.kv_cache_dtype == "int8"`): int8 pools plus
(L, P, KH, ps) f32 scale pools, one absmax scale per position and kv
head. A write quantizes the window's k and v (`engine._kv_quant`) and
stores values and scales through the same write plan, so a page and its
scales always travel together by page id.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.inference import multi_lora
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

    k: torch.Tensor        # (L, num_pages + 1, KH, Dh, ps) on the device,
    #                        cfg.dtype or int8; the last page is scratch
    v: torch.Tensor        # (L, num_pages + 1, KH, Dh, ps) — transposed
    lengths: torch.Tensor  # (B,) int32 on the host — committed kv entries
    tables: torch.Tensor   # (B, max_pages_per_slot) int32 on the host
    k_scale: torch.Tensor | None = None  # (L, num_pages + 1, KH, ps) f32
    v_scale: torch.Tensor | None = None  # scales of int8 pools, else None

    @property
    def page_size(self) -> int:
        return self.k.shape[4]

    @property
    def num_pages(self) -> int:
        """Pages the tables may name; the pools hold the scratch page
        besides, at id num_pages (the sentinel)."""
        return self.k.shape[1] - 1

    @property
    def max_context(self) -> int:
        return self.tables.shape[1] * self.page_size


def _i32(x) -> torch.Tensor:
    """int32 metadata: numpy and lists on the host, tensors where they
    lie."""
    return torch.as_tensor(x).to(dtype=torch.int32)


def make_cache(k, v, lengths, tables, k_scale=None,
               v_scale=None) -> PagedKVCache:
    """A cache view over existing pools with int32 metadata. The pools
    carry the scratch page last (see the module docstring)."""
    return PagedKVCache(k=k, v=v, lengths=_i32(lengths),
                        tables=_i32(tables), k_scale=k_scale,
                        v_scale=v_scale)


def init_paged_cache(cfg: ModelConfig, *, num_pages: int, page_size: int,
                     batch: int, max_pages_per_slot: int,
                     device=None) -> PagedKVCache:
    """Zeroed pool of `num_pages` pages and the scratch page on `device`
    (int8 with zeroed scale pools when cfg.kv_cache_dtype == "int8"); all
    tables at the sentinel."""
    if cfg.kv_cache_dtype not in ("model", "int8"):
        raise ValueError(f"unknown kv_cache_dtype: {cfg.kv_cache_dtype!r}")
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_pages + 1, cfg.num_kv_heads, cfg.head_dim,
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
    """Device bytes of the pools' `num_pages` pages (values, and the int8
    cache's scales); the scratch page is not counted."""
    per_page = cache.k[:, 0].numel() * cache.k.element_size()
    if cache.k_scale is not None:
        per_page += cache.k_scale[:, 0].numel() * 4
    return 2 * per_page * cache.num_pages


def write_plan(cache: PagedKVCache, w: int, widths=None):
    """Fixed-shape write targets of a W-wide window on the pools' device:
    (valid (B, W) bool, pages (B, W), offsets (B, W)) int64. Not valid,
    and aimed at the scratch page: positions at window index >=
    widths[b], positions whose page slot is past the table, and sentinel
    (or otherwise out-of-pool) pages."""
    dev = cache.k.device
    lengths = cache.lengths.to(dev).long()
    tables = cache.tables.to(dev).long()
    ps, mp = cache.page_size, tables.shape[1]
    col = torch.arange(w, device=dev)
    pos = lengths[:, None] + col[None, :]
    valid = pos >= 0
    if widths is not None:
        valid &= col[None, :] < torch.as_tensor(widths).to(dev).long()[:, None]
    slot = torch.div(pos, ps, rounding_mode="floor")
    valid &= slot < mp
    page = tables.gather(1, slot.clamp(0, mp - 1))
    valid &= (page >= 0) & (page < cache.num_pages)
    return valid, torch.where(valid, page, cache.num_pages), pos % ps


def _write_window(cache: PagedKVCache, layer: int, k, v, plan) -> None:
    """Write fresh (B, W, KH, Dh) k/v through the page table, in place
    (the reference donates the pools to its compiled step and rebuilds
    them; here the pool tensors are updated where they lie). Positions
    that must not write land on the scratch page. An int8 cache stores
    each written position quantized, with its scales."""
    pages, offs = plan[1].reshape(-1), plan[2].reshape(-1)
    for pool, spool, src in ((cache.k, cache.k_scale, k),
                             (cache.v, cache.v_scale, v)):
        fresh = src.reshape(-1, *src.shape[2:])      # (N, KH, Dh)
        if spool is not None:
            fresh, sc = _kv_quant(fresh)
            spool[layer][pages, :, offs] = sc[..., 0]
        pool[layer][pages, :, :, offs] = fresh.to(pool.dtype)


@torch.no_grad()
def window_forward(params, tokens: torch.Tensor, cfg: ModelConfig,
                   cache: PagedKVCache, *, logits_at=None,
                   all_logits: bool = False, widths=None, rope=None,
                   lora=None, aid=None):
    """Forward W new positions per slot against the paged cache.

    Args:
      tokens: (B, W) int — slot b's tokens for absolute positions
        [lengths[b], lengths[b] + W), on the pools' device.
      logits_at: (B,) in-window indices — return (B, V) f32 logits at
        that position per slot.
      all_logits: return (B, W, V) f32 (speculation's verify windows,
        counted as such by the kernel). With neither, returns None.
      widths: optional (B,) ragged valid widths: positions at window
        index >= widths[b] neither write kv nor anchor attention.
      rope: optional precomputed (cos, sin) for cache.max_context
        positions on the device (a server computes it once).
      lora, aid: multi-adapter serving — (stacks, scales) from
        inference.multi_lora.AdapterSet.device_args and per-row adapter
        ids (B,); each layer gathers its per-row (a, b, scale) and the
        transformer blocks add the low-rank deltas (id 0 adds exactly 0).

    Returns (logits, cache); the pools hold the window's kv, lengths are
    unchanged.
    """
    dev = cache.k.device
    b, w = tokens.shape
    lengths = cache.lengths.to(dev).long()
    pos = lengths[:, None] + torch.arange(w, device=dev)[None, :]
    # positions past the table (garbage rows) read the last rope entry,
    # as the reference's clamped gather does
    rope_pos = pos.clamp(0, cache.max_context - 1)
    cos, sin = rope if rope is not None else rope_table(
        cfg, cache.max_context, device=dev)
    x = transformer.embed(params, tokens, cfg)

    use_kernel = cfg.decode_attention_impl == "pallas" and w <= PALLAS_MAX_W
    attend = (functools.partial(paged_attention, verify=all_logits)
              if use_kernel else paged_attention_ref)
    widths_dev = (None if widths is None
                  else torch.as_tensor(widths).to(device=dev,
                                                  dtype=torch.int32))
    lens_dev = (lengths + (w if widths is None else widths_dev.long())).to(
        torch.int32)
    tables_dev = cache.tables.to(device=dev, dtype=torch.int32)
    plan = write_plan(cache, w, widths_dev)

    for layer in range(cfg.num_layers):
        lp = transformer.layer_params(params, layer)
        ll = (None if lora is None
              else multi_lora.layer_lora(lora, aid, layer))
        q, k, v = transformer.attention_qkv(x, lp, cfg, cos, sin, rope_pos,
                                            lora=ll)
        _write_window(cache, layer, k, v, plan)
        o = attend(q, cache.k, cache.v, lens_dev, tables_dev, layer,
                   widths=widths_dev, k_scale_pool=cache.k_scale,
                   v_scale_pool=cache.v_scale)
        x = transformer.attention_out(x, o, lp, cfg, lora=ll)
        x = _mlp_apply(x, lp, cfg, lora=ll)

    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    if all_logits:
        return transformer.unembed(x, params, cfg), cache
    if logits_at is not None:
        at = torch.as_tensor(logits_at).to(dev).long().clamp(0, w - 1)
        x_sel = x[torch.arange(b, device=dev), at]
        return transformer.unembed(x_sel, params, cfg), cache
    return None, cache
