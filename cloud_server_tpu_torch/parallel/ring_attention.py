"""Ring attention: causal sequence/context parallelism over the `sp` axis.

Each rank holds one contiguous chunk of the sequence (queries and kv).
The kv chunks rotate around the ring (`collectives.ppermute_ad`) while
every rank folds the visiting chunk into a running online-softmax
accumulator (m, l, acc) in float32, so the full S x S attention is
computed with S/n-sized chunks and n-1 exchanges.

Causality across chunks uses absolute positions: every chunk carries
its origin, so a visiting chunk wholly in this rank's future adds
nothing (fully masked rows are zeroed explicitly, no NaN from an
all-masked softmax). Packed segment ids ride the ring with their chunk.

The fold is plain PyTorch (the reference folds in einsums, with no
Pallas kernel); its backward is autograd through the fold and the
exchanges, whose backward shifts the gradients back around the ring.
`ring_attention_sharded` takes the mesh's sp group; the transformer
dispatches to it under ModelConfig(attention_impl="ring").
"""

from __future__ import annotations

import torch

from cloud_server_tpu_torch.parallel import collectives
from cloud_server_tpu_torch.parallel.mesh import axis_size

NEG_INF = -1e30


def _chunk_merge(carry, q, k, v, q_off, kv_off, scale, seg_q=None,
                 seg_kv=None):
    """Fold one visiting kv chunk into the online-softmax accumulators.

    carry: (acc (B,KH,G,Sq,Dh) f32, m (B,KH,G,Sq,1) f32, l same).
    q: (B, Sq, H, Dh); k, v: (B, Skv, KH, Dh). q_off / kv_off: absolute
    position of element 0 of each chunk. seg_q / seg_kv: optional
    (B, Sq) / (B, Skv) packed-segment ids."""
    acc, m, l = carry
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    q_pos = q_off + torch.arange(sq, device=q.device)
    kv_pos = kv_off + torch.arange(skv, device=q.device)
    mask = (q_pos[:, None] >= kv_pos[None, :])[None, None, None]
    if seg_q is not None:
        same = seg_q[:, :, None] == seg_kv[:, None, :]  # (B, Sq, Skv)
        mask = mask & same[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # zero masked entries explicitly: a wholly masked row would give
    # exp(s - m_new) = 1
    p = torch.where(mask, torch.exp(s - m_new), 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v.float())
    return acc_new, m_new, l_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   segment_ids: torch.Tensor | None = None, *, group,
                   scale: float | None = None) -> torch.Tensor:
    """Causal GQA over a sequence split over `group` (the sp ranks).

    q: (B, Sq_local, H, Dh); k, v: (B, Skv_local, KH, Dh), this rank's
    chunks in ring order (rank i holds positions [i Sq, (i+1) Sq)).
    segment_ids: optional (B, Sq_local) packed ids, split like the
    tokens; the kv chunk's ids rotate with it. Returns this rank's
    output chunk (B, Sq_local, H, Dh), differentiable in q, k and v."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    if scale is None:
        scale = dh ** -0.5
    n = 1 if group is None else group.size()
    idx = 0 if group is None else group.rank()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, sq, dh), **f32)
    m = torch.full((b, kh, g, sq, 1), NEG_INF, **f32)
    l = torch.zeros((b, kh, g, sq, 1), **f32)
    has_seg = segment_ids is not None
    segc = (segment_ids.to(q.device).long() if has_seg
            else torch.zeros((b, skv), dtype=torch.long, device=q.device))
    kc, vc = k, v
    for t in range(n):
        src = (idx - t) % n  # the rank this kv chunk belongs to
        acc, m, l = _chunk_merge((acc, m, l), q, kc, vc, idx * sq,
                                 src * skv, scale,
                                 segment_ids.to(q.device).long()
                                 if has_seg else None,
                                 segc if has_seg else None)
        if t < n - 1:  # n-1 exchanges; the last fold rotates nothing
            kc, vc = collectives.ring_exchange_ad((kc, vc), group)
            if has_seg:
                segc = collectives.ppermute_ad(segc, group)
    out = acc / torch.clamp(l, min=1e-30)  # (B, KH, G, Sq, Dh)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, *, segment_ids=None, scale=None,
                           seq_axis: str = "sp"):
    """Ring attention over the mesh's `seq_axis`: each rank passes its
    local (B_local, S/sp, H_local, Dh) chunks (its rows over the batch
    axes and heads over tp, as the reference's shard_map specs split
    them) and gets its output chunk back."""
    group = mesh.get_group(seq_axis) if axis_size(mesh, seq_axis) > 1 \
        else None
    return ring_attention(q, k, v, segment_ids, group=group, scale=scale)
