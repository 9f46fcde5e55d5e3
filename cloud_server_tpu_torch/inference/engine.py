"""The pieces of the reference's contiguous engine the paged path uses:
the MLP residual block selected by the config, and the int8 KV-cache
quantization. The contiguous KV cache and its generate loop are not
ported yet."""

from __future__ import annotations

import torch

from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models import transformer


def _kv_quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last (head_dim) axis, in f32:
    scale = max(max|x| / 127, 1e-8), q = round(x / scale) (half to even,
    as jnp.round). Returns (int8 values, f32 scales with a kept last
    axis of 1)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(xf / scale).to(torch.int8), scale


def _kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of `_kv_quant`, for tests only: attention folds the scales
    into its scores and probabilities and never builds this copy."""
    return (q.float() * scale).to(dtype)


def _mlp_apply(x, lp, cfg: ModelConfig):
    """Dense MLP residual block. Mixture-of-experts models are not
    ported yet and raise."""
    if cfg.num_experts >= 2:
        raise NotImplementedError("MoE models are not ported yet")
    return transformer.mlp_block(x, lp, cfg)
