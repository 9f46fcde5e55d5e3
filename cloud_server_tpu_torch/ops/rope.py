"""Rotary position embeddings.

Frequencies are computed in float32 (tiny — S x Dh/2) and the rotation
is applied in float32 then cast back, because bfloat16 phase error
compounds visibly at long context.
"""

from __future__ import annotations

import math

import torch


def _scale_inv_freq(inv_freq: torch.Tensor, scaling: dict) -> torch.Tensor:
    """Frequency scaling for long-context checkpoints.

    "linear": every frequency divided by `factor`.
    "llama3": Llama 3.1's band-wise scheme — wavelengths short relative
    to the original context window keep their frequency, long
    wavelengths are divided by `factor`, and the band between
    `high_freq_factor` and `low_freq_factor` interpolates smoothly.
    """
    kind = scaling["type"]
    factor = float(scaling["factor"])
    if kind == "linear":
        return inv_freq / factor
    if kind == "llama3":
        low = float(scaling["low_freq_factor"])
        high = float(scaling["high_freq_factor"])
        orig = float(scaling["original_max_len"])
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (orig / wavelen - low) / (high - low)
        interp = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        return torch.where(wavelen > orig / low, inv_freq / factor,
                           torch.where(wavelen < orig / high, inv_freq,
                                       interp))
    raise ValueError(f"unknown rope scaling type: {kind!r}")


def rope_frequencies(head_dim: int, max_seq_len: int, theta: float = 10000.0,
                     *, scaling: dict | None = None,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin), each (max_seq_len, head_dim // 2), float32."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, half, dtype=torch.float32, device=device) / half))
    if scaling is not None:
        inv_freq = _scale_inv_freq(inv_freq, scaling)
    pos = torch.arange(max_seq_len, dtype=torch.float32, device=device)
    angles = torch.outer(pos, inv_freq)
    return torch.cos(angles), torch.sin(angles)


def rope_table(cfg, seq_len: int,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables from a ModelConfig (reads its rope scaling)."""
    scaling = None
    if cfg.rope_scaling != "none":
        scaling = {"type": cfg.rope_scaling,
                   "factor": cfg.rope_scaling_factor,
                   "low_freq_factor": cfg.rope_low_freq_factor,
                   "high_freq_factor": cfg.rope_high_freq_factor,
                   "original_max_len": cfg.rope_original_max_len}
    return rope_frequencies(cfg.head_dim, seq_len, cfg.rope_theta,
                            scaling=scaling, device=device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor | None = None) -> torch.Tensor:
    """Rotate q or k.

    Args:
      x: (B, S, H, Dh).
      cos/sin: (max_seq_len, Dh//2) tables from `rope_frequencies`.
      positions: optional (B, S) int absolute positions (in range of the
        table); defaults to arange(S).
    """
    s = x.shape[1]
    half = x.shape[-1] // 2
    if positions is None:
        c = cos[:s][None, :, None, :]
        sn = sin[:s][None, :, None, :]
    else:
        c = cos[positions][:, :, None, :]
        sn = sin[positions][:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)
    return out.to(x.dtype)
