"""Ulysses (all-to-all) sequence/context parallelism over the `sp` axis.

The second sequence-parallel scheme next to ring attention
(`parallel/ring_attention.py`), selected with
ModelConfig(attention_impl="ulysses"). One all-to-all turns the
sequence split into a head split: every rank then runs causal attention
over the full sequence for H/sp of its heads, and a second all-to-all
restores the sequence split. Both are `collectives.all_to_all_ad`, whose
backward is the inverse all-to-all.

Layout: with local q (B, S/sp, H, Dh), splitting the head axis into sp
blocks and concatenating the received pieces along the sequence gives
(B, S, H/sp, Dh) in global order, so the causal mask needs no position
bookkeeping.

GQA: when sp divides the local kv-head count, k/v ride the same
all-to-all (head blocks then align with kv groups). Otherwise kv heads
are first repeated up to the q-head layout (the MHA expansion).

The inner attention is the reference's `causal_attention` over the full
sequence. In bfloat16 it is `ops.flash_attention.flash_attention`, the
same function: on the card the flash kernels (B3 forward, B5/B6
backward), which keep the S x S scores off the card, and on the CPU
their plain version. In float32 it is the plain `causal_attention`.
"""

from __future__ import annotations

import torch

from cloud_server_tpu_torch.ops.attention import causal_attention
from cloud_server_tpu_torch.ops.flash_attention import flash_attention
from cloud_server_tpu_torch.parallel import collectives
from cloud_server_tpu_torch.parallel.mesh import axis_size


def _inner(q, k, v, segment_ids, scale, block_q, block_kv):
    if q.dtype == torch.bfloat16:
        return flash_attention(q, k, v, scale=scale, segment_ids=segment_ids,
                               block_q=block_q, block_kv=block_kv)
    return causal_attention(q, k, v, scale=scale, segment_ids=segment_ids)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segment_ids: torch.Tensor | None = None, *, group,
                      scale: float | None = None, block_q: int = 1024,
                      block_kv: int = 1024) -> torch.Tensor:
    """Causal GQA over a sequence split over `group` (the sp ranks).

    q: (B, Sq_local, H, Dh); k, v: (B, Skv_local, KH, Dh), this rank's
    chunks in ring order. segment_ids: optional (B, Sq_local) packed ids
    split like the tokens; every rank attends over the full sequence
    after the all-to-all, so the ids are all-gathered (B*S ints). Returns
    (B, Sq_local, H, Dh). Raises ValueError when sp does not divide the
    local head count."""
    sp = 1 if group is None else group.size()
    if sp == 1:
        return _inner(q, k, v, segment_ids, scale, block_q, block_kv)
    h, kh = q.shape[2], k.shape[2]
    if h % sp:
        raise ValueError(
            f"ulysses attention needs local head count divisible by the "
            f"sp axis: heads={h}, sp={sp}")
    if kh % sp:
        # MHA expansion: kv head j serves q heads [j g, (j+1) g)
        g = h // kh
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    # sequence split -> head split: (B, S/sp, H, Dh) -> (B, S, H/sp, Dh)
    q_full, k_full, v_full = (
        collectives.all_to_all_ad(t, group, split_axis=2, concat_axis=1)
        for t in (q, k, v))
    seg_full = None
    if segment_ids is not None:
        seg_full = collectives.all_gather_ad(
            segment_ids.to(q.device).long(), group, tiled_axis=1)
    out = _inner(q_full, k_full, v_full, seg_full, scale, block_q, block_kv)
    # head split -> sequence split: (B, S, H/sp, Dh) -> (B, S/sp, H, Dh)
    return collectives.all_to_all_ad(out, group, split_axis=1,
                                     concat_axis=2)


def ulysses_attention_sharded(q, k, v, mesh, *, segment_ids=None,
                              scale=None, seq_axis: str = "sp",
                              block_q: int = 1024, block_kv: int = 1024):
    """Ulysses attention over the mesh's `seq_axis`: each rank passes its
    local chunks (as `ring_attention_sharded` takes them) and gets its
    output chunk back. A drop-in alternative to the ring."""
    group = mesh.get_group(seq_axis) if axis_size(mesh, seq_axis) > 1 \
        else None
    return ulysses_attention(q, k, v, segment_ids, group=group, scale=scale,
                             block_q=block_q, block_kv=block_kv)
