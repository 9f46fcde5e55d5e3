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
kernels). Packed rows (`segment_ids`, data/packing.py) restart RoPE
positions per document, mask attention to same-document pairs and mask
the loss's cross-document and padding targets. The losses
(`next_token_loss`, `hidden_state_loss`, `masked_cross_entropy`, the
vocab-chunked CE, and the fused CE of ce_impl="pallas" through the
B7/B8 kernels) mirror the reference's.

Tensor-parallel serving (`parallel/`): `param_logical_axes` names each
leaf's logical axes, and `embed`, `attention_qkv`, `attention_out`,
`mlp_block` and `unembed` take the tp process group of a rank's shard
(`tp=`); without one they are the single-device functions, unchanged.

Training on a mesh (`MeshPlan`, which the train and eval steps build
and pass to `next_token_loss(plan=)`): each rank holds its shards of the leaves (`parallel.sharding`),
its rows of the batch over (dp, fsdp) and its slice of the sequence over
sp. Each layer's fsdp-split leaves are gathered for its forward (and
again for its rematerialised forward), the gather's backward
reduce-scattering the gradient; tp regions enter through
`collectives.identity_ad` and leave through `psum_ad`; attention under
sp is "ring" or "ulysses"; the loss combines each rank's vocabulary
shard's statistics over tp and divides by the global token count, so
the sum of the ranks' losses over the data axes is the reference's
loss.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.ops import (apply_rope, causal_attention,
                                        matmul_f32, rms_norm, rope_table,
                                        swiglu)
from cloud_server_tpu_torch.ops.flash_attention import (flash_attention,
                                                        flash_fwd_op)
from cloud_server_tpu_torch.ops.fused_ce import (combine_shard_stats,
                                                 fused_ce_shard_stats,
                                                 fused_ce_stats)
from cloud_server_tpu_torch.ops.segments import (positions_from_segments,
                                                 segment_target_mask)
from cloud_server_tpu_torch.parallel import collectives
from cloud_server_tpu_torch.parallel.collectives import all_gather, psum

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


def param_logical_axes(cfg: ModelConfig) -> dict[str, Any]:
    """Same structure as params; leaves are tuples of logical axis names
    (`parallel.sharding` maps them to mesh axes)."""
    axes = {
        "embed": {"tokens": ("vocab", "embed")},
        "layers": {
            "attn_norm": ("layers", "norm"),
            "mlp_norm": ("layers", "norm"),
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": {"scale": ("norm",)},
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = {"kernel": ("embed", "vocab")}
    return axes


def _fan_in(name: str, cfg: ModelConfig) -> int:
    D, H, Dh, F = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.mlp_dim
    table = {"tokens": D, "kernel": D, "wq": D, "wk": D, "wv": D,
             "wo": H * Dh, "w_gate": D, "w_up": D, "w_down": F,
             "router": D}
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
                dtype: torch.dtype | None = None,
                shapes: dict | None = None, leaf_fn=None) -> Params:
    """The reference's initialisation drawn on `device`: truncated normal
    (+-2 sd) with std 1/sqrt(fan_in), norm scales 1. The draws come from
    a torch.Generator seeded with `seed`, so the values differ from the
    reference's; the distribution is the same. `device` defaults to
    CUDA, as for every entry point. `dtype` defaults to
    cfg.param_dtype. Stacked leaves are drawn one layer at a time, so the
    float32 scratch is one layer's slice, not the whole stack. `shapes`
    (default `param_shapes(cfg)`) lets another family (models.moe) draw
    its own tree the same way. `leaf_fn(group, name, tensor)`, when
    given, replaces each leaf as soon as it is drawn (a rank of a mesh
    keeps its slice, so one full leaf at a time is ever held)."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.param_dtype) if dtype is None else dtype
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out: dict = {}
    shapes = param_shapes(cfg) if shapes is None else shapes
    for group, leaves in shapes.items():
        out[group] = {}
        for name, shape in leaves.items():
            if "norm" in group or "norm" in name:
                out[group][name] = torch.ones(shape, dtype=dtype,
                                              device=device)
                if leaf_fn is not None:
                    out[group][name] = leaf_fn(group, name,
                                               out[group][name])
                continue
            std = 1.0 / math.sqrt(_fan_in(name, cfg))
            t = torch.empty(shape, dtype=dtype, device=device)
            parts = t if group == "layers" else t[None]
            for part in parts:
                scratch = torch.empty(part.shape, dtype=torch.float32,
                                      device=device)
                part.copy_(_trunc_normal_(scratch, gen).mul_(std))
            out[group][name] = t if leaf_fn is None else leaf_fn(group, name,
                                                                  t)
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
    """Float32 leaves cast to cfg.dtype (others unchanged). Int8
    weight-only leaves (`models.quantization.QTensor`) stay quantized:
    their `.to(dtype)` dequantizes at each use."""
    from cloud_server_tpu_torch.models.quantization import QTensor
    target = torch_dtype(cfg.dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, QTensor):
            return x
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
    """x (..., Din) @ w (Din, *out) -> (..., *out); a QTensor `w`
    dequantizes in `.to(dtype)`."""
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


def _tp_sum(y: torch.Tensor, tp) -> torch.Tensor:
    """The partial sums of a row-parallel product summed over the tp
    group: in place when nothing differentiates through it (serving),
    else `psum_ad` (its backward the identity)."""
    if tp is None or tp.size() == 1:
        return y
    if torch.is_grad_enabled() and y.requires_grad:
        return collectives.psum_ad(y, tp)
    return psum(y, tp)


def _tp_enter(h: torch.Tensor, tp) -> torch.Tensor:
    """A replicated activation entering a tp region: `identity_ad` when
    something differentiates through it, else `h` itself."""
    if tp is None or tp.size() == 1 or not (torch.is_grad_enabled()
                                            and h.requires_grad):
        return h
    return collectives.identity_ad(h, tp)


def attention_qkv(x, lp, cfg: ModelConfig, cos, sin, positions=None,
                  lora=None, tp=None):
    """Pre-norm + q/k/v projection + rope.

    `lora` (serving only): {target: (a, b, scale)} per-row adapters —
    deltas land BEFORE rope, exactly where a merged weight would.
    `tp`: the tp group, whose ranks hold their heads' columns: the
    normed input enters the tp region (`identity_ad`, whose backward
    sums each rank's share of the input's gradient)."""
    dtype = torch_dtype(cfg.dtype)
    h = _tp_enter(rms_norm(x, lp["attn_norm"], cfg.norm_eps), tp)
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


def attention_out(x, o, lp, cfg: ModelConfig, lora=None, tp=None):
    """Output projection + residual add; a `wo` adapter's delta lands on
    the flattened head output.

    `tp` (serving under tensor parallelism): the tp process group. `o`
    and `wo` hold this rank's heads, so the product is a partial sum
    (row-parallel), summed over the group before the residual add."""
    dtype = torch_dtype(cfg.dtype)
    b, s = o.shape[:2]
    wo = lp["wo"].to(dtype)
    flat = o.reshape(b, s, -1)
    y = flat @ wo.reshape(-1, wo.shape[-1])
    if lora and "wo" in lora:
        y = y + lora_row_delta(flat, lora["wo"])
    return x + _tp_sum(y, tp)


def mlp_block(x, lp, cfg: ModelConfig, lora=None, tp=None):
    """SwiGLU MLP residual block; adapters land on gate and up before
    the activation and on down after it. With `tp` (the tp process
    group) gate and up hold this rank's columns and down its rows, so
    the down product is summed over the group before the residual
    add."""
    dtype = torch_dtype(cfg.dtype)
    h = _tp_enter(rms_norm(x, lp["mlp_norm"], cfg.norm_eps), tp)
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
    return x + _tp_sum(down, tp)


def _unembed_head(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"]["tokens"].T if cfg.tie_embeddings
            else params["lm_head"]["kernel"])


def apply_logits_softcap(logits: torch.Tensor,
                         cfg: ModelConfig) -> torch.Tensor:
    if cfg.logits_softcap > 0:
        return cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    return logits


def unembed(x, params: Params, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Final-norm'd hidden states (..., D) -> softcapped f32 logits.
    With `tp` (the tp process group) the head holds this rank's vocab
    rows: its f32 logits are gathered over the group, so every rank
    holds the same full row."""
    head = _unembed_head(params, cfg).to(torch_dtype(cfg.dtype))
    logits = apply_logits_softcap(matmul_f32(x, head), cfg)
    return all_gather(logits, tp, tiled_axis=-1)


def embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
          tp=None):
    """Token embeddings in cfg.dtype. With `tp` (the tp process group)
    the table holds this rank's contiguous block of vocab rows: tokens
    outside it embed to zero, and the sum over the group (one nonzero
    term, so exact) is the full lookup."""
    table = params["embed"]["tokens"]
    ids = tokens.to(table.device).long()
    dtype = torch_dtype(cfg.dtype)
    if tp is None or tp.size() == 1:
        return table[ids].to(dtype)
    n = table.shape[0]
    local = ids - tp.rank() * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(dtype)
    return _tp_sum(torch.where(inside[..., None], rows, 0), tp)


def _block(x, lp, cfg: ModelConfig, cos, sin, attn_fn, positions=None,
           plan=None):
    """One layer; on a mesh (`plan`) its fsdp-split leaves are gathered
    first and its tp regions run on the rank's heads and columns."""
    tp = None
    if plan is not None:
        lp = plan.gather_layer(lp)
        tp = plan.group("tp")
    q, k, v = attention_qkv(x, lp, cfg, cos, sin, positions, tp=tp)
    x = attention_out(x, attn_fn(q, k, v), lp, cfg, tp=tp)
    return mlp_block(x, lp, cfg, tp=tp)


# What the selective policies save: the flash forward's (out, lse)
# (`flash_fwd_op`), and for "dots" every matmul without batch dims too
# (the q/k/v/o, MLP and router projections; the MoE experts' batched
# GEMMs are `bmm`, which have one, so they are recomputed, as in the
# reference's `dots_with_no_batch_dims_saveable`).
_REMAT_SAVES = {
    "attn": frozenset({flash_fwd_op}),
    "dots": frozenset({flash_fwd_op, torch.ops.aten.mm.default,
                       torch.ops.aten.addmm.default}),
}


def _save_only(ops):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def apply_remat(block, cfg: ModelConfig):
    """Wrap a layer-block fn with the configured remat policy (the
    single selection point for the dense and MoE stacks):

      * "none": save everything.
      * "full": recompute the whole block in the backward
        (`torch.utils.checkpoint`, non-reentrant); only the block's
        input is kept.
      * "dots": save the matmul outputs without batch dims AND the flash
        forward's (out, lse), so the backward runs no flash forward;
        recompute the rest (selective activation checkpointing).
      * "attn": save ONLY the flash forward's (out, lse); recompute
        everything else (the big (B, S, mlp_dim) gate/up tensors too).
        Only meaningful with attention_impl="flash": other impls emit no
        flash residuals, so this is "full".
    Without autograd (inference) nothing is checkpointed."""
    if cfg.remat == "none":
        return block
    if cfg.remat == "full":
        context_fn = None
    elif cfg.remat in _REMAT_SAVES:
        context_fn = partial(create_selective_checkpoint_contexts,
                             _save_only(_REMAT_SAVES[cfg.remat]))
    else:
        raise ValueError(f"unknown remat policy: {cfg.remat!r}")

    def checkpointed(*args):
        if not torch.is_grad_enabled():
            return block(*args)
        if context_fn is None:
            return checkpoint(block, *args, use_reentrant=False)
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=context_fn)
    return checkpointed


def _get_attention_fn(cfg: ModelConfig, segment_ids=None, plan=None):
    """The attention-impl dispatch table: "xla" is the plain PyTorch
    attention, "flash" the flash-attention kernels, "ring" and "ulysses"
    the sequence-parallel ones over the sp axis of `plan`'s mesh (the
    MeshPlan of the step; without one, one chunk). `segment_ids` are the
    rank's (B, S_local)."""
    impl = cfg.attention_impl
    sp = 1 if plan is None else plan.size("sp")
    if sp > 1 and impl in ("xla", "flash"):
        raise NotImplementedError(
            f"attention_impl={impl!r} with sp={sp}: sequence-parallel "
            "attention is 'ring' or 'ulysses'")
    if impl == "xla":
        return partial(causal_attention, segment_ids=segment_ids)
    if impl == "flash":
        return partial(flash_attention, segment_ids=segment_ids,
                       block_q=cfg.flash_block_q,
                       block_kv=cfg.flash_block_kv)
    if impl == "ring":
        from cloud_server_tpu_torch.parallel.ring_attention import (
            ring_attention)
        return partial(ring_attention, segment_ids=segment_ids,
                       group=None if plan is None else plan.group("sp"))
    if impl == "ulysses":
        from cloud_server_tpu_torch.parallel.ulysses import ulysses_attention
        return partial(ulysses_attention, segment_ids=segment_ids,
                       group=None if plan is None else plan.group("sp"),
                       block_q=cfg.flash_block_q,
                       block_kv=cfg.flash_block_kv)
    raise ValueError(f"unknown attention_impl: {impl!r}")


def apply_segment_loss_mask(batch: dict) -> dict:
    """If the batch is packed, fold the segment boundary/padding mask into
    batch['mask'] (shared by the dense and MoE losses). No-op otherwise."""
    seg = batch.get("segment_ids")
    if seg is None:
        return batch
    tmask = segment_target_mask(seg)
    if batch.get("mask") is not None:
        tmask = tmask * batch["mask"].to(tmask.device).float()
    return {**batch, "mask": tmask}


def packed_inputs(cfg: ModelConfig, segment_ids, device):
    """(attention fn, RoPE positions) of a forward: with (B, S) packed
    segment ids, positions restart per document and attention is masked
    to same-document pairs; without, the plain causal forward."""
    if segment_ids is None:
        return _get_attention_fn(cfg), None
    seg = segment_ids.to(device)
    return _get_attention_fn(cfg, seg), positions_from_segments(seg)


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   segment_ids: torch.Tensor | None = None,
                   plan: "MeshPlan | None" = None) -> torch.Tensor:
    """(B, S) int -> final-normed hidden states (B, S, D) in cfg.dtype.

    segment_ids: optional (B, S) packed-sequence ids (data/packing.py):
    attention becomes block-diagonal causal and RoPE positions restart
    per document, so each packed document sees the math it would see
    alone.

    Differentiable: weights are cast to cfg.dtype inside the graph, so
    float32 masters receive float32 gradients. The stacked layer leaves
    are split with `unbind`, whose backward stacks the layer gradients
    once (a per-layer index would zero-fill a full stack per layer).

    On a mesh (`plan`, the step's MeshPlan) `params` are the rank's
    shards, `tokens` and `segment_ids` its (B_local, S_local) block, and
    the result its block of the hidden states."""
    if plan is None:
        x = embed(params, tokens, cfg)
        cos, sin = rope_table(cfg, tokens.shape[1], device=x.device)
        attn_fn, positions = packed_inputs(cfg, segment_ids, x.device)
    else:
        x, cos, sin, attn_fn, positions = plan.inputs(params, tokens, cfg,
                                                      segment_ids)
    block = apply_remat(
        partial(_block, cfg=cfg, cos=cos, sin=sin, attn_fn=attn_fn,
                positions=positions, plan=plan), cfg)
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


def _chunked_logz_target_argmax(x, head, targets, cfg: ModelConfig,
                                with_max: bool = False):
    """Blockwise-vocab logsumexp + target-logit gather + running argmax.

    x: (B, S, D); head: (D, V); targets: (B, S) int. Returns (logz,
    target_logit, argmax_idx), each (B, S), and the row max after them
    with `with_max`, without materialising
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
    if with_max:
        return m + torch.log(l), tgt, bidx, m.detach()
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
                    z_loss_coef: float = 0.0, plan: "MeshPlan | None" = None):
    """Causal LM loss. batch: {"tokens": (B, S) int, optional "mask":
    (B, S), optional "segment_ids": (B, S) for packed rows}. Predicts
    tokens[:, 1:] from tokens[:, :-1]; the forward runs on the full S and
    the last position is dropped inside the loss. With segment_ids,
    attention and positions follow the packing (`forward_hidden`) and
    targets crossing a document boundary (or in padding) are masked out
    of the loss, on every CE route. On a mesh (`plan`) the rank's part
    of it (`MeshPlan.next_token_loss`)."""
    if plan is not None:
        return plan.next_token_loss(params, batch, cfg, z_loss_coef)
    seg = batch.get("segment_ids")
    batch = apply_segment_loss_mask(batch)
    if cfg.ce_impl == "pallas" or cfg.vocab_chunk > 0:
        x = forward_hidden(params, batch["tokens"], cfg, seg)
        return hidden_state_loss(x, params, batch, cfg, z_loss_coef)
    logits = forward(params, batch["tokens"], cfg, seg)
    return masked_cross_entropy(logits, batch, z_loss_coef)


# ---------------------------------------------------------------------------
# Training on a mesh
# ---------------------------------------------------------------------------

class _GroupLogSumExp(torch.autograd.Function):
    """log(sum over the group's ranks of exp(z)), elementwise; the
    backward gives each rank its share, g * exp(z - out), with no
    collective (every rank holds the same loss)."""

    @staticmethod
    def forward(ctx, z, group):
        zs = collectives.all_gather_ad(z[None].contiguous(), group)
        out = torch.logsumexp(zs, dim=0)
        ctx.save_for_backward(z, out)
        return out

    @staticmethod
    def backward(ctx, g):
        z, out = ctx.saved_tensors
        return g * torch.exp(z - out), None


class MeshPlan:
    """A rank's view of the mesh its training step runs on: the axis
    sizes, groups and coordinates, and the model-side collectives of a
    step (the fsdp gathers, the sequence slice, the loss's combines).

    `rules` (the logical-axis table, `parallel.sharding.DEFAULT_RULES`
    by default) say how the rank's leaves are split: the pipeline's
    `{**DEFAULT_RULES, "layers": "pp"}` splits the stacked layer axis
    over pp. `logical` is the parameter tree's logical axes (the model
    family's `param_logical_axes` by default)."""

    DATA_AXES = ("dp", "fsdp", "sp")

    def __init__(self, mesh, cfg: ModelConfig, rules=None, logical=None):
        from cloud_server_tpu_torch.models import moe
        from cloud_server_tpu_torch.parallel.mesh import axis_size
        from cloud_server_tpu_torch.parallel.sharding import DEFAULT_RULES
        self.mesh = mesh
        names = mesh.mesh_dim_names or ()
        self._size = {a: axis_size(mesh, a) for a in names}
        self._groups = {a: mesh.get_group(a) for a in names
                        if self._size[a] > 1}
        self._rank = {a: mesh.get_local_rank(a) for a in self._groups}
        self.rules = DEFAULT_RULES if rules is None else rules
        self.axes = (moe.module_for(cfg).param_logical_axes(cfg)
                     if logical is None else logical)
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)

    def size(self, axis: str) -> int:
        return self._size.get(axis, 1)

    def group(self, axis: str):
        """The axis's process group (None for an axis of size 1)."""
        return self._groups.get(axis)

    def rank(self, axis: str) -> int:
        return self._rank.get(axis, 0)

    def splits_over(self, name, axis: str) -> bool:
        """Whether the logical axis `name` maps to mesh axis `axis`."""
        rule = self.rules.get(name) if name is not None else None
        return rule == axis or (isinstance(rule, tuple) and axis in rule)

    # -- parameters ----------------------------------------------------

    def gather(self, x: torch.Tensor, logical) -> torch.Tensor:
        """The leaf `x` (this rank's shard, laid out by `logical`) with
        its fsdp-split dimensions gathered (`all_gather_ad`: the backward
        reduce-scatters its gradient); tp and ep splits stay. A leaf that
        is gathered is cast to the compute dtype first, so the gather and
        the gradient's reduce-scatter move cfg.dtype bytes (FSDP's mixed
        precision); one that is not is returned as it is."""
        fsdp = self.group("fsdp")
        dims = [d for d, name in enumerate(logical)
                if self.splits_over(name, "fsdp")]
        if fsdp is None or not dims:
            return x
        x = x.to(self.dtype)
        for dim in dims:
            x = collectives.all_gather_ad(x, fsdp, tiled_axis=dim)
        return x

    def gather_layer(self, lp: dict) -> dict:
        """One layer's leaves (the stacked L axis dropped), gathered."""
        return {k: self.gather(v, self.axes["layers"][k][1:])
                for k, v in lp.items()}

    def head(self, params: Params, cfg: ModelConfig) -> torch.Tensor:
        """The unembedding (D, V/tp) in cfg.dtype, gathered over fsdp."""
        if cfg.tie_embeddings:
            head = self.gather(params["embed"]["tokens"],
                               self.axes["embed"]["tokens"]).T
        else:
            head = self.gather(params["lm_head"]["kernel"],
                               self.axes["lm_head"]["kernel"])
        return head.to(torch_dtype(cfg.dtype))

    # -- inputs --------------------------------------------------------

    def seq_offset(self, s_local: int) -> int:
        return self.rank("sp") * s_local

    def whole_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(B_local, S_local) -> the rank's whole rows (B_local, S),
        gathered over sp (ints or a mask: no gradient)."""
        with torch.no_grad():
            return collectives.all_gather_ad(t, self.group("sp"),
                                             tiled_axis=1)

    def gather_tokens(self, t: torch.Tensor, axes) -> torch.Tensor:
        """(B_local, S_local, ...) -> the rows and positions of every
        rank of `axes` (a subset of the data axes), in the global batch's
        order: over sp on the sequence, then fsdp and dp (outer) on the
        rows (`all_gather_ad`: the backward sums each rank's rows'
        gradients into their owner)."""
        for axis, dim in (("sp", 1), ("fsdp", 0), ("dp", 0)):
            if axis in axes:
                t = collectives.all_gather_ad(t, self.group(axis),
                                              tiled_axis=dim)
        return t

    def scatter_tokens(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The inverse of `gather_tokens`: partial sums over the gathered
        rows and positions summed over the ranks of `axes`, each keeping
        its own block (`reduce_scatter_ad`)."""
        for axis, dim in (("dp", 0), ("fsdp", 0), ("sp", 1)):
            if axis in axes:
                t = collectives.reduce_scatter_ad(t, self.group(axis),
                                                  scatter_axis=dim)
        return t

    def inputs(self, params: Params, tokens, cfg: ModelConfig, segment_ids):
        """(x, cos, sin, attention fn, positions) of the rank's block:
        the embedding over the rank's vocabulary rows summed over tp, the
        RoPE table of the whole sequence and the block's positions in it
        (restarting per document when packed, from the whole rows'
        segment ids)."""
        tp = self.group("tp")
        table = self.gather(params["embed"]["tokens"],
                            self.axes["embed"]["tokens"])
        x = embed({"embed": {"tokens": table}}, tokens, cfg, tp=tp)
        b, s_loc = tokens.shape
        off = self.seq_offset(s_loc)
        cos, sin = rope_table(cfg, s_loc * self.size("sp"), device=x.device)
        seg = None if segment_ids is None else segment_ids.to(x.device)
        if seg is not None:
            positions = positions_from_segments(
                self.whole_rows(seg))[:, off:off + s_loc]
        elif off:
            positions = (off + torch.arange(s_loc, device=x.device)).expand(
                b, s_loc)
        else:
            positions = None
        return x, cos, sin, _get_attention_fn(cfg, seg, self), positions

    # -- loss ----------------------------------------------------------

    def psum_data(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the data axes (dp, fsdp, sp): a new tensor, no
        gradient."""
        x = x.detach().clone()
        for axis in self.DATA_AXES:
            g = self.group(axis)
            if g is not None:
                x = collectives._host_staged(psum, x, g)
        return x

    def ce_stats(self, x, head, targets, cfg: ModelConfig):
        """(logz, target_logit, argmax) of the rank's rows over the whole
        vocabulary, from its (D, V/tp) shard of the head: each shard's
        statistics (the fused CE kernels with ce_impl="pallas", the
        vocab-chunked or dense ones otherwise), then the combine over tp
        as the kernels combine their vocabulary ranges (logsumexp; the
        target logit from the shard that holds it; the first argmax, a
        later shard winning only on a strictly greater max)."""
        tp = self.group("tp")
        b, s = targets.shape
        v_loc = head.shape[1]
        base = self.rank("tp") * v_loc
        x = _tp_enter(x, tp)
        local = targets - base
        inside = (local >= 0) & (local < v_loc)
        local = local.clamp(0, v_loc - 1)
        if cfg.ce_impl == "pallas":
            logz, tl, am, mx = (t.reshape(b, s) for t in fused_ce_shard_stats(
                x.reshape(b * s, -1), head, local.reshape(-1)))
        elif cfg.vocab_chunk > 0:
            logz, tl, am, mx = _chunked_logz_target_argmax(
                x, head, local, cfg, with_max=True)
        else:
            logits = apply_logits_softcap(matmul_f32(x, head), cfg)
            logz = torch.logsumexp(logits, dim=-1)
            tl = torch.gather(logits, -1, local[..., None])[..., 0]
            mx, am = logits.detach().max(dim=-1)
        tl = torch.where(inside, tl, 0.0)
        if tp is None:
            return logz, tl, am
        logz = _GroupLogSumExp.apply(logz, tp)
        tl = _tp_sum(tl, tp)
        with torch.no_grad():
            both = torch.stack([mx.float(), (am + base).float()])
            allv = collectives.all_gather_ad(both[None].contiguous(), tp)
            _, _, am = combine_shard_stats(
                [(logz, tl, a[1].long(), a[0]) for a in allv])
        return logz, tl, am

    def hidden_loss(self, x, params: Params, batch: dict, cfg: ModelConfig,
                    z_loss_coef: float = 0.0):
        """The rank's part of the reference's loss from its hidden states
        `x` (B_local, S_local, D) of `batch`'s rows: their masked CE sum
        over the global token count, so the parts sum to the reference's
        loss over the data axes (the backward of each rank's part gives
        its share of the gradient). The metrics are the global ones,
        equal on every rank."""
        tokens = batch["tokens"]
        s_loc = tokens.shape[1]
        off = self.seq_offset(s_loc)
        whole = {"tokens": self.whole_rows(tokens)}
        for k in ("mask", "segment_ids"):
            if batch.get(k) is not None:
                whole[k] = self.whole_rows(batch[k])
        whole = apply_segment_loss_mask(whole)
        targets, mask = _shifted_targets_mask(whole, x.device)
        targets = targets[:, off:off + s_loc]
        mask = mask[:, off:off + s_loc]
        logz, tl, am = self.ce_stats(x, self.head(params, cfg), targets,
                                     cfg)
        denom = self.psum_data(mask.sum()).clamp_min(1.0)
        loss = ((logz - tl) * mask).sum() / denom
        metrics = {"loss": self.psum_data(loss)}
        metrics["ppl_log"] = metrics["loss"]
        metrics["accuracy"] = self.psum_data(
            ((am == targets) * mask).sum() / denom)
        if z_loss_coef > 0.0:
            z = (logz.square() * mask).sum() / denom
            loss = loss + z_loss_coef * z
            metrics["z_loss"] = self.psum_data(z)
        return loss, metrics

    def next_token_loss(self, params: Params, batch: dict, cfg: ModelConfig,
                        z_loss_coef: float = 0.0):
        """The rank's part of the reference's `next_token_loss`
        (`hidden_loss` of the rank's forward)."""
        x = forward_hidden(params, batch["tokens"], cfg,
                           batch.get("segment_ids"), self)
        return self.hidden_loss(x, params, batch, cfg, z_loss_coef)
