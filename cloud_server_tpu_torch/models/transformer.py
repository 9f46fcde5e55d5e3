"""Dense decoder-only LM (LLaMA-style: RMSNorm, RoPE, GQA, SwiGLU).

Parameters are the reference's plain nested dict, with the same names,
layouts and stacked leading layer axis (`param_shapes`), held as torch
tensors; the functions here are plain functions on tensors. Layers run
in an eager Python loop.

Precision: activations and weights in `cfg.dtype`; norms, rope, softmax
and the logits are float32. On the CPU in float32 every product is
float32. In bfloat16 on the card a product rounds its output to
bfloat16, except the unembed, which writes float32 logits from bfloat16
operands as the reference does (`ops.matmul_f32`).

Training: `forward_hidden`/`forward` are differentiable (weights cast to
`cfg.dtype` inside the graph, so float32 masters get float32 gradients),
with the remat policy applied per layer and attention from
`_get_attention_fn` ("xla": plain; "flash": the flash-attention
kernels). The losses (`next_token_loss`, `hidden_state_loss`,
`masked_cross_entropy`, the vocab-chunked CE, and the fused CE of
ce_impl="pallas" through the B7/B8 kernels) mirror the reference's.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any

import numpy as np
import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.ops import (apply_rope, causal_attention,
                                        matmul_f32, rms_norm, rope_table,
                                        swiglu)
from cloud_server_tpu_torch.ops.flash_attention import flash_attention
from cloud_server_tpu_torch.ops.fused_ce import fused_ce_stats

Params = dict

NEG_INF = -1e30  # finite stand-in for -inf (keeps exp/where NaN-free)

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


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None, *,
                      keep_param_dtype: bool = False) -> Params:
    """The reference's parameter dict as numpy arrays -> the port's
    parameters on `device` (CUDA unless named), same names, layouts and
    stacked L axis.
    Float32 leaves are cast to cfg.dtype, as the paged server casts its
    parameters; with `keep_param_dtype` (training: float32 masters) they
    are held at cfg.param_dtype instead."""
    device = resolve_device(device)
    target = torch_dtype(cfg.param_dtype if keep_param_dtype else cfg.dtype)

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


def lora_row_delta(h, ab) -> torch.Tensor:
    """Per-ROW low-rank delta for multi-adapter serving: each batch row
    carries its own (A, B) pair (gathered from a stacked adapter set by
    the row's adapter id). h: (B, S, Din); ab = (a (B, Din, r),
    b (B, r, Dout), scale (B,)) -> (B, S, Dout), in h's dtype."""
    a, b, scale = ab
    z = torch.bmm(h, a.to(h.dtype))
    d = torch.bmm(z, b.to(h.dtype))
    return d * scale[:, None, None].to(h.dtype)


def attention_qkv(x, lp, cfg: ModelConfig, cos, sin, positions=None,
                  lora=None):
    """Pre-norm + q/k/v projection + rope.

    `lora` (serving only): {target: (a, b, scale)} per-row adapters —
    deltas land BEFORE rope, exactly where a merged weight would."""
    dtype = torch_dtype(cfg.dtype)
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = _proj(h, lp["wq"], dtype)
    k = _proj(h, lp["wk"], dtype)
    v = _proj(h, lp["wv"], dtype)
    if lora:
        if "wq" in lora:
            q = q + lora_row_delta(h, lora["wq"]).reshape(q.shape)
        if "wk" in lora:
            k = k + lora_row_delta(h, lora["wk"]).reshape(k.shape)
        if "wv" in lora:
            v = v + lora_row_delta(h, lora["wv"]).reshape(v.shape)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    return q, k, v


def attention_out(x, o, lp, cfg: ModelConfig, lora=None):
    """Output projection + residual add; a `wo` adapter's delta lands on
    the flattened head output."""
    dtype = torch_dtype(cfg.dtype)
    b, s = o.shape[:2]
    wo = lp["wo"].to(dtype)
    flat = o.reshape(b, s, -1)
    y = flat @ wo.reshape(-1, wo.shape[-1])
    if lora and "wo" in lora:
        y = y + lora_row_delta(flat, lora["wo"])
    return x + y


def mlp_block(x, lp, cfg: ModelConfig, lora=None):
    """SwiGLU MLP residual block; adapters land on gate and up before
    the activation and on down after it."""
    dtype = torch_dtype(cfg.dtype)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    gate = h @ lp["w_gate"].to(dtype)
    up = h @ lp["w_up"].to(dtype)
    if lora:
        if "w_gate" in lora:
            gate = gate + lora_row_delta(h, lora["w_gate"])
        if "w_up" in lora:
            up = up + lora_row_delta(h, lora["w_up"])
    act = swiglu(gate, up)
    down = act @ lp["w_down"].to(dtype)
    if lora and "w_down" in lora:
        down = down + lora_row_delta(act, lora["w_down"])
    return x + down


def _unembed_head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"]["tokens"].T if cfg.tie_embeddings
            else params["lm_head"]["kernel"])


def apply_logits_softcap(logits: torch.Tensor,
                         cfg: ModelConfig) -> torch.Tensor:
    if cfg.logits_softcap > 0:
        return cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def unembed(x, params: Params, cfg: ModelConfig) -> torch.Tensor:
    """Final-norm'd hidden states (..., D) -> softcapped f32 logits."""
    head = _unembed_head(params, cfg).to(torch_dtype(cfg.dtype))
    return apply_logits_softcap(matmul_f32(x, head), cfg)


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    table = params["embed"]["tokens"]
    return table[tokens.to(table.device).long()].to(torch_dtype(cfg.dtype))


def _block(x, lp, cfg: ModelConfig, cos, sin, attn_fn):
    q, k, v = attention_qkv(x, lp, cfg, cos, sin)
    x = attention_out(x, attn_fn(q, k, v), lp, cfg)
    return mlp_block(x, lp, cfg)


def apply_remat(block, cfg: ModelConfig):
    """Wrap a layer-block fn with the configured remat policy.

      * "none": save everything.
      * "full": recompute the whole block in the backward
        (`torch.utils.checkpoint`, non-reentrant); only the block's
        input is kept.
    The reference's "dots" and "attn" (save named residuals) are not
    ported yet. Without autograd (inference) nothing is checkpointed."""
    if cfg.remat == "none":
        return block
    if cfg.remat == "full":
        def checkpointed(*args):
            if not torch.is_grad_enabled():
                return block(*args)
            return torch.utils.checkpoint.checkpoint(
                block, *args, use_reentrant=False)
        return checkpointed
    if cfg.remat in ("dots", "attn"):
        raise NotImplementedError(
            f"remat={cfg.remat!r} is not ported yet (use 'full' or 'none')")
    raise ValueError(f"unknown remat policy: {cfg.remat!r}")


def _get_attention_fn(cfg: ModelConfig, segment_ids=None):
    """The attention-impl dispatch table: "xla" is the plain PyTorch
    attention, "flash" the flash-attention kernels."""
    if cfg.attention_impl == "xla":
        return partial(causal_attention, segment_ids=segment_ids)
    if cfg.attention_impl == "flash":
        return partial(flash_attention, segment_ids=segment_ids,
                       block_q=cfg.flash_block_q,
                       block_kv=cfg.flash_block_kv)
    if cfg.attention_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} (sequence parallel) is "
            "not ported yet")
    raise ValueError(f"unknown attention_impl: {cfg.attention_impl!r}")


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """(B, S) int -> final-normed hidden states (B, S, D) in cfg.dtype.

    Differentiable: weights are cast to cfg.dtype inside the graph, so
    float32 masters receive float32 gradients. The stacked layer leaves
    are split with `unbind`, whose backward stacks the layer gradients
    once (a per-layer index would zero-fill a full stack per layer)."""
    if cfg.num_experts >= 2:
        raise NotImplementedError("MoE models are not ported yet")
    if segment_ids is not None:
        raise NotImplementedError(
            "packed rows (segment_ids: per-document RoPE positions and "
            "loss masks) are not ported yet")
    x = embed(params, tokens, cfg)
    cos, sin = rope_table(cfg, tokens.shape[1], device=x.device)
    block = apply_remat(
        partial(_block, cfg=cfg, cos=cos, sin=sin,
                attn_fn=_get_attention_fn(cfg)), cfg)
    names = sorted(params["layers"])
    per_layer = [params["layers"][n].unbind(0) for n in names]
    for i in range(cfg.num_layers):
        x = block(x, {n: t[i] for n, t in zip(names, per_layer)})
    return rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            segment_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence forward pass: (B, S) int -> (B, S, V) float32
    logits. Differentiable; call under torch.no_grad() for inference."""
    return unembed(forward_hidden(params, tokens, cfg, segment_ids),
                   params, cfg)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def masked_cross_entropy(logits: torch.Tensor, batch: dict,
                         z_loss_coef: float = 0.0):
    """Next-token CE over full-S logits.

    logits: (B, S, V) f32 for the full sequence (the last position is
    dropped here); batch: {"tokens": (B, S), optional "mask": (B, S)}.
    Returns (loss, metrics)."""
    tokens = batch["tokens"].to(logits.device).long()
    logits = logits[:, :-1]
    targets = tokens[:, 1:]
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, device=logits.device)
            if mask is None else mask[:, 1:].to(logits.device).float())
    logz = torch.logsumexp(logits, dim=-1)
    target_logit = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - target_logit
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    with torch.no_grad():
        acc = ((logits.argmax(-1) == targets) * mask).sum() / denom
    metrics = {"loss": loss.detach(), "ppl_log": loss.detach(),
               "accuracy": acc}
    if z_loss_coef > 0.0:
        z = (logz.square() * mask).sum() / denom
        loss = loss + z_loss_coef * z
        metrics["z_loss"] = z.detach()
    return loss, metrics


def _chunk_body(x, hc, base, m, l, tgt, bidx, targets, cfg):
    """One vocab chunk of `_chunked_logz_target_argmax`."""
    logits = apply_logits_softcap(matmul_f32(x, hc.to(x.dtype)), cfg)
    c = hc.shape[1]
    mc = logits.amax(-1)
    # m doubles as the running best logit, so the argmax update compares
    # against the pre-update m
    am = base + logits.argmax(-1)
    bidx = torch.where(mc > m, am, bidx)
    m_new = torch.maximum(m, mc)
    l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
    in_chunk = (targets >= base) & (targets < base + c)
    off = (targets - base).clamp(0, c - 1)
    tl = torch.gather(logits, -1, off[..., None])[..., 0]
    tgt = torch.where(in_chunk, tl, tgt)
    return m_new, l, tgt, bidx


def _chunked_logz_target_argmax(x, head, targets, cfg: ModelConfig):
    """Blockwise-vocab logsumexp + target-logit gather + running argmax.

    x: (B, S, D); head: (D, V); targets: (B, S) int. Returns (logz,
    target_logit, argmax_idx), each (B, S), without materialising
    (B, S, V) logits: a Python loop over vocab chunks of cfg.vocab_chunk,
    each checkpointed, so the backward also recomputes the logits one
    chunk at a time."""
    b, s, _ = x.shape
    v = head.shape[1]
    size = cfg.vocab_chunk
    dev = x.device
    m = torch.full((b, s), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, s), dtype=torch.float32, device=dev)
    tgt = torch.full((b, s), NEG_INF, dtype=torch.float32, device=dev)
    bidx = torch.zeros((b, s), dtype=torch.long, device=dev)
    for base in range(0, v, size):
        hc = head[:, base:base + size]
        if torch.is_grad_enabled():
            m, l, tgt, bidx = torch.utils.checkpoint.checkpoint(
                _chunk_body, x, hc, base, m, l, tgt, bidx, targets, cfg,
                use_reentrant=False)
        else:
            m, l, tgt, bidx = _chunk_body(x, hc, base, m, l, tgt, bidx,
                                          targets, cfg)
    return m + torch.log(l), tgt, bidx


def _shifted_targets_mask(batch: dict, device=None):
    """Position i predicts token i+1; the last position is masked out, so
    the sequence keeps its full length."""
    tokens = batch["tokens"].to(device).long()
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = batch.get("mask")
    mask = (torch.ones(tokens.shape, device=tokens.device) if mask is None
            else mask.to(tokens.device).float())
    mask = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1)
    return targets, mask


def _stats_loss(logz, target_logit, argmax_idx, targets, mask,
                z_loss_coef: float):
    """(loss, metrics) from per-position CE statistics."""
    nll = logz - target_logit
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    metrics = {"loss": loss.detach(), "ppl_log": loss.detach(),
               "accuracy": ((argmax_idx == targets) * mask).sum() / denom}
    if z_loss_coef > 0.0:
        z = (logz.square() * mask).sum() / denom
        loss = loss + z_loss_coef * z
        metrics["z_loss"] = z.detach()
    return loss, metrics


def fused_cross_entropy(x, params: Params, batch: dict, cfg: ModelConfig,
                        z_loss_coef: float = 0.0):
    """Next-token CE over final hidden states, chunked over the vocab."""
    targets, mask = _shifted_targets_mask(batch, x.device)
    head = _unembed_head(params, cfg).to(torch_dtype(cfg.dtype))
    logz, target_logit, argmax_idx = _chunked_logz_target_argmax(
        x, head, targets, cfg)
    return _stats_loss(logz, target_logit, argmax_idx, targets, mask,
                       z_loss_coef)


def pallas_cross_entropy(x, params: Params, batch: dict, cfg: ModelConfig,
                         z_loss_coef: float = 0.0):
    """Next-token CE through the fused CE kernels (`ops/fused_ce.py`):
    the per-row (logz, target_logit, argmax) come out of B7 without f32
    logits in device memory, and the backward's products run in the model
    dtype (B8). Same contract and metrics as `fused_cross_entropy`."""
    b, s = batch["tokens"].shape
    targets, mask = _shifted_targets_mask(batch, x.device)
    head = _unembed_head(params, cfg).to(torch_dtype(cfg.dtype))
    logz, target_logit, argmax_idx = fused_ce_stats(
        x.reshape(b * s, -1), head, targets.reshape(-1))
    return _stats_loss(logz.reshape(b, s), target_logit.reshape(b, s),
                       argmax_idx.reshape(b, s), targets, mask, z_loss_coef)


def hidden_state_loss(x, params: Params, batch: dict, cfg: ModelConfig,
                      z_loss_coef: float = 0.0):
    """Next-token CE from final hidden states: ce_impl="pallas" -> the
    fused CE kernels; vocab_chunk > 0 -> chunked; else dense unembed +
    masked CE."""
    if cfg.ce_impl == "pallas":
        return pallas_cross_entropy(x, params, batch, cfg, z_loss_coef)
    if cfg.vocab_chunk > 0:
        return fused_cross_entropy(x, params, batch, cfg, z_loss_coef)
    return masked_cross_entropy(unembed(x, params, cfg), batch, z_loss_coef)


def next_token_loss(params: Params, batch: dict, cfg: ModelConfig,
                    z_loss_coef: float = 0.0):
    """Causal LM loss. batch: {"tokens": (B, S) int, optional "mask":
    (B, S)}. Predicts tokens[:, 1:] from tokens[:, :-1]; the forward runs
    on the full S and the last position is dropped inside the loss.
    Packed batches ("segment_ids") are not ported yet."""
    if batch.get("segment_ids") is not None:
        raise NotImplementedError("packed batches (segment_ids) are not "
                                  "ported yet")
    if cfg.ce_impl == "pallas" or cfg.vocab_chunk > 0:
        x = forward_hidden(params, batch["tokens"], cfg)
        return hidden_state_loss(x, params, batch, cfg, z_loss_coef)
    logits = forward(params, batch["tokens"], cfg)
    return masked_cross_entropy(logits, batch, z_loss_coef)
