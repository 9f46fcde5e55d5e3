"""Normalisation ops.

RMSNorm is computed in float32 regardless of the activation dtype — the
mean-of-squares reduction underflows in bfloat16 — and cast back.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Root-mean-square layer norm: x * scale / rms(x).

    Args:
      x: (..., d) activations, any float dtype.
      scale: (d,) learned gain.
      eps: numerical floor inside the rsqrt.
    """
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)
