"""Dense decoder-only LM (LLaMA-style: RMSNorm, RoPE, GQA, SwiGLU).

Parameters are the reference's plain nested dict, with the same names,
layouts and stacked leading layer axis (`param_shapes`), held as torch
tensors; the functions here are plain functions on tensors. Layers run
in an eager Python loop.

Precision: activations and weights in `cfg.dtype`; norms, rope, softmax
and the logits are float32. On the CPU in float32 every product is
float32. In bfloat16 on the card a product rounds its output to
bfloat16 — the unembed included, whose logits are then widened to
float32 (the reference asks its compiler for float32 logits directly).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.ops import (apply_rope, causal_attention,
                                        rms_norm, rope_table, swiglu)

Params = dict

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    L, D, H, KH, Dh, F, V = (cfg.num_layers, cfg.embed_dim, cfg.num_heads,
                             cfg.num_kv_heads, cfg.head_dim, cfg.mlp_dim,
                             cfg.vocab_size)
    shapes = {
        "embed": {"tokens": (V, D)},
        "layers": {
            "attn_norm": (L, D),
            "mlp_norm": (L, D),
            "wq": (L, D, H, Dh),
            "wk": (L, D, KH, Dh),
            "wv": (L, D, KH, Dh),
            "wo": (L, H, Dh, D),
            "w_gate": (L, D, F),
            "w_up": (L, D, F),
            "w_down": (L, F, D),
        },
        "final_norm": {"scale": (D,)},
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = {"kernel": (D, V)}
    return shapes


def _fan_in(name: str, cfg: ModelConfig) -> int:
    D, H, Dh, F = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.mlp_dim
    table = {"tokens": D, "kernel": D, "wq": D, "wk": D, "wv": D,
             "wo": H * Dh, "w_gate": D, "w_up": D, "w_down": F}
    return table[name]


def _trunc_normal_(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], in place (inverse-CDF draw,
    the method of torch.nn.init.trunc_normal_, with an explicit
    generator)."""
    lo = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0
    hi = (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    t.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return t


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                dtype: torch.dtype | None = None) -> Params:
    """The reference's initialisation drawn on `device`: truncated normal
    (+-2 sd) with std 1/sqrt(fan_in), norm scales 1. The draws come from
    a torch.Generator seeded with `seed`, so the values differ from the
    reference's; the distribution is the same. `device` defaults to
    CUDA, as for every entry point. `dtype` defaults to
    cfg.param_dtype. Stacked leaves are drawn one layer at a time, so the
    float32 scratch is one layer's slice, not the whole stack."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype) if dtype is None else dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: dict = {}
    for group, leaves in param_shapes(cfg).items():
        out[group] = {}
        for name, shape in leaves.items():
            if "norm" in group or "norm" in name:
                out[group][name] = torch.ones(shape, dtype=dtype,
                                              device=device)
                continue
            std = 1.0 / math.sqrt(_fan_in(name, cfg))
            t = torch.empty(shape, dtype=dtype, device=device)
            parts = t if group == "layers" else t[None]
            for part in parts:
                scratch = torch.empty(part.shape, dtype=torch.float32,
                                      device=device)
                part.copy_(_trunc_normal_(scratch, gen).mul_(std))
            out[group][name] = t
    return out


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> Params:
    """The reference's parameter dict as numpy arrays -> the port's
    parameters on `device` (CUDA unless named), same names, layouts and
    stacked L axis.
    Float32 leaves are cast to cfg.dtype, as the paged server casts its
    parameters."""
    device = resolve_device(device)
    target = torch_dtype(cfg.dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        arr = np.asarray(x)
        t = torch.from_numpy(np.array(arr)).to(device)
        if t.dtype == torch.float32 and t.dim() >= 1:
            t = t.to(target)
        return t

    return conv(tree)


def params_from_npz(path, cfg: ModelConfig, device=None) -> Params:
    """`params_from_numpy` of a parameter dict saved with np.savez under
    '/'-joined keys ('layers/wq', 'embed/tokens', ...)."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            group, name = key.split("/")
            tree.setdefault(group, {})[name] = data[key]
    return params_from_numpy(tree, cfg, device)


def cast_params(params: Params, cfg: ModelConfig) -> Params:
    """Float32 leaves cast to cfg.dtype (others unchanged)."""
    target = torch_dtype(cfg.dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if x.dtype == torch.float32 and x.dim() >= 1:
            return x.to(target)
        return x

    return conv(params)


def layer_params(params: Params, i: int) -> dict:
    """Layer i's slice of the stacked block parameters (views)."""
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _proj(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """x (..., Din) @ w (Din, *out) -> (..., *out)."""
    din = w.shape[0]
    y = x @ w.to(dtype).reshape(din, -1)
    return y.reshape(*x.shape[:-1], *w.shape[1:])


def attention_qkv(x, lp, cfg: ModelConfig, cos, sin, positions=None):
    """Pre-norm + q/k/v projection + rope."""
    dtype = torch_dtype(cfg.dtype)
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = _proj(h, lp["wq"], dtype)
    k = _proj(h, lp["wk"], dtype)
    v = _proj(h, lp["wv"], dtype)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    return q, k, v


def attention_out(x, o, lp, cfg: ModelConfig):
    """Output projection + residual add."""
    dtype = torch_dtype(cfg.dtype)
    b, s = o.shape[:2]
    wo = lp["wo"].to(dtype)
    y = o.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    return x + y


def mlp_block(x, lp, cfg: ModelConfig):
    dtype = torch_dtype(cfg.dtype)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = h @ lp["w_gate"].to(dtype)
    up = h @ lp["w_up"].to(dtype)
    return x + swiglu(gate, up) @ lp["w_down"].to(dtype)


def _unembed_head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"]["tokens"].T if cfg.tie_embeddings
            else params["lm_head"]["kernel"])


def unembed(x, params: Params, cfg: ModelConfig) -> torch.Tensor:
    """Final-norm'd hidden states (..., D) -> softcapped f32 logits."""
    head = _unembed_head(params, cfg).to(torch_dtype(cfg.dtype))
    logits = (x @ head).float()
    if cfg.logits_softcap > 0:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    table = params["embed"]["tokens"]
    return table[tokens.to(table.device).long()].to(torch_dtype(cfg.dtype))


def forward_hidden(params: Params, tokens: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """(B, S) int -> final-normed hidden states (B, S, D) in cfg.dtype."""
    if cfg.attention_impl != "xla":
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} is not ported yet "
            "(only the plain 'xla' path)")
    if cfg.num_experts >= 2:
        raise NotImplementedError("MoE models are not ported yet")
    x = embed(params, tokens, cfg)
    cos, sin = rope_table(cfg, tokens.shape[1], device=x.device)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        q, k, v = attention_qkv(x, lp, cfg, cos, sin)
        x = attention_out(x, causal_attention(q, k, v), lp, cfg)
        x = mlp_block(x, lp, cfg)
    return rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)


@torch.no_grad()
def forward(params: Params, tokens: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward pass: (B, S) int -> (B, S, V) float32."""
    return unembed(forward_hidden(params, tokens, cfg), params, cfg)
