"""Attention ops (plain PyTorch path).

Grouped-query causal attention as two batched products, softmax in
float32 (bfloat16 exp/sum loses mass at long context):

  q: (B, S, H,  Dh)      k, v: (B, S, KH, Dh)      H = KH * q_per_kv

returning (B, S, H, Dh).
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float | None = None,
                     kv_segment_start: int = 0,
                     q_positions: torch.Tensor | None = None,
                     kv_length: torch.Tensor | None = None) -> torch.Tensor:
    """Causal grouped-query attention.

    Args:
      q: (B, Sq, H, Dh).
      k, v: (B, Skv, KH, Dh) with H a multiple of KH.
      scale: qk scale; defaults to Dh ** -0.5.
      kv_segment_start: absolute position of k[:, 0].
      q_positions: optional (B, Sq) absolute query positions; defaults to
        arange(Sq) + kv_segment_start.
      kv_length: optional (B,) number of valid kv entries.

    Scores and softmax are float32; the probabilities are cast to q's
    dtype before the product with v, as in the reference.
    Returns (B, Sq, H, Dh) in q.dtype.
    """
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    if scale is None:
        scale = dh ** -0.5
    qg = q.reshape(b, sq, kh, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * scale
    dev = q.device
    if q_positions is None:
        q_pos = (torch.arange(sq, device=dev) + kv_segment_start)[None, :]
    else:
        q_pos = q_positions.to(dev)
    kv_pos = (torch.arange(skv, device=dev) + kv_segment_start)[None, :]
    causal = q_pos[:, :, None] >= kv_pos[:, None, :]
    if kv_length is not None:
        valid = kv_pos < kv_length.to(dev)[:, None]
        causal = causal & valid[:, None, :]
    scores = torch.where(causal[:, None, None, :, :], scores,
                         torch.tensor(NEG_INF, device=dev))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype).reshape(b, sq, h, dh)
