"""The pieces of the reference's contiguous engine the paged path uses:
the MLP residual block selected by the config, the int8 KV-cache
quantization, and sequence embeddings (`encode`). The contiguous KV
cache and its generate loop are not ported yet."""

from __future__ import annotations

import torch

from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import rms_norm, rope_table


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


def _mlp_apply(x, lp, cfg: ModelConfig, lora=None):
    """Dense MLP residual block; `lora`: per-row multi-adapter deltas.
    Mixture-of-experts models are not ported yet and raise."""
    if cfg.num_experts >= 2:
        raise NotImplementedError("MoE models are not ported yet")
    return transformer.mlp_block(x, lp, cfg, lora=lora)


@torch.no_grad()
def encode(params, tokens: torch.Tensor, lengths: torch.Tensor, *,
           cfg: ModelConfig) -> torch.Tensor:
    """Sequence embeddings: the decoder run WITHOUT unembedding,
    final-norm hidden states mean-pooled over each sequence's valid
    positions in f32, L2-normalised. tokens: (B, P) right-padded int;
    lengths: (B,) int, both on the parameters' device. Returns
    (B, embed_dim) f32, unit norm.

    Right-padding is exact under causal attention (real positions never
    attend to the trailing pads; pad positions are masked out of the
    pool), so one batched pass serves ragged inputs. Attention is
    `transformer._get_attention_fn(cfg)`'s: with attention_impl "flash"
    the flash-attention forward kernel on the card (its log-sum-exp
    unused), with "xla" the plain causal attention."""
    if cfg.num_experts >= 2:
        raise NotImplementedError("MoE models are not ported yet")
    b, p = tokens.shape
    x = transformer.embed(params, tokens, cfg)
    cos, sin = rope_table(cfg, p, device=x.device)
    attn_fn = transformer._get_attention_fn(cfg)
    for layer in range(cfg.num_layers):
        lp = transformer.layer_params(params, layer)
        q, k, v = transformer.attention_qkv(x, lp, cfg, cos, sin)
        x = transformer.attention_out(x, attn_fn(q, k, v), lp, cfg)
        x = _mlp_apply(x, lp, cfg)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    lengths = lengths.to(x.device).long()
    mask = torch.arange(p, device=x.device)[None, :] < lengths[:, None]
    pooled = (x.float() * mask[..., None]).sum(dim=1)
    pooled = pooled / lengths[:, None].clamp(min=1)
    norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
    return pooled / norm.clamp(min=1e-9)
