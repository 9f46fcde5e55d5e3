"""Attention ops (plain PyTorch path).

Grouped-query causal attention as two batched products, softmax in
float32 (bfloat16 exp/sum loses mass at long context):

  q: (B, S, H,  Dh)      k, v: (B, S, KH, Dh)      H = KH * q_per_kv

returning (B, S, H, Dh).
"""

from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _score_columns(s: torch.Tensor) -> torch.Tensor:
    """(B, Skv, KH, 1) per-key scales -> (B, KH, 1, 1, Skv), broadcast
    over the (B, KH, G, Sq, Skv) scores."""
    return s[..., 0].float().permute(0, 2, 1)[:, :, None, None, :]


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float | None = None,
                     kv_segment_start: int = 0,
                     q_positions: torch.Tensor | None = None,
                     kv_length: torch.Tensor | None = None,
                     segment_ids: torch.Tensor | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Causal grouped-query attention.

    Args:
      q: (B, Sq, H, Dh).
      k, v: (B, Skv, KH, Dh) with H a multiple of KH.
      scale: qk scale; defaults to Dh ** -0.5.
      kv_segment_start: absolute position of k[:, 0].
      q_positions: optional (B, Sq) absolute query positions; defaults to
        arange(Sq) + kv_segment_start.
      kv_length: optional (B,) number of valid kv entries.
      segment_ids: optional (B, S) packed-sequence ids (Sq == Skv):
        attention is further masked to same-segment pairs, the
        block-diagonal causal structure of packed training rows.
      k_scale, v_scale: optional (B, Skv, KH, 1) f32 absmax scales of an
        int8 k/v (`engine._kv_quant`). The scales are constant along Dh,
        so they fold into the scores (after `* scale`) and into the
        probabilities (after normalisation): no dequantized k/v is built.

    Scores and softmax are float32; the probabilities are cast to q's
    dtype before the product with v, as in the reference.
    Returns (B, Sq, H, Dh) in q.dtype.
    """
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    if scale is None:
        scale = dh ** -0.5
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be given together")
    qg = q.reshape(b, sq, kh, g, dh)
    # int8 values are exact in bf16 and f32
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores * scale
    if k_scale is not None:
        scores = scores * _score_columns(k_scale)
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
    if segment_ids is not None:
        seg = segment_ids.to(dev)
        causal = causal & (seg[:, :, None] == seg[:, None, :])
    scores = torch.where(causal[:, None, None, :, :], scores, NEG_INF)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        probs = probs * _score_columns(v_scale)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(q.dtype).float(),
                       v.float())
    return out.to(q.dtype).reshape(b, sq, h, dh)
