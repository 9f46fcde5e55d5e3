"""Sparse Mixture-of-Experts decoder LM (Mixtral-style).

The reference's `models/moe.py` on torch tensors: the same parameter
tree (a router (L, D, E) and expert stacks w_gate/w_up (L, E, D, F),
w_down (L, E, F, D) in place of the dense MLP), the same GShard top-k
routing with per-expert capacity, and the same aux statistics
(load_balance, router_z, dropped_frac) averaged over layers.

Dispatch is index-based: the reference contracts one-hot (T, E, C)
dispatch and combine tensors with the tokens; here each (expert, slot)
holds the index of the token it serves (T, a zero row, when empty) and
that token's renormalised gate weight, so the experts' inputs are one
gather (E, C, D) and their outputs one weighted scatter-add back to the
tokens. The slots, drops and weights are the reference's
(`top_k_routing` rebuilds its dense tensors from them). Everything is
static-shaped with no host reads, so the routing records inside a
captured CUDA graph like every other op. The expert products are
batched matmuls over the expert axis; every expert runs its C slots,
filled or not (the reference's dense dispatch does the same work).

Attention, norms and RoPE are the dense model's (`models.transformer`);
only the MLP is replaced. Packed rows (segment_ids) are refused, as in
the dense model.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, NamedTuple

import torch

from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import rms_norm, rope_table, swiglu

Params = dict


# ---------------------------------------------------------------------------
# Routing (GShard top-k with capacity)
# ---------------------------------------------------------------------------

def _capacity(cfg: ModelConfig, num_tokens: int) -> int:
    cap = int(math.ceil(cfg.expert_capacity_factor * num_tokens
                        * cfg.num_experts_per_token / cfg.num_experts))
    return max(cap, 4)


class Routing(NamedTuple):
    token: torch.Tensor   # (E, C) int64: the token slot (e, c) serves; T
    #                       (the zero row) when empty
    weight: torch.Tensor  # (E, C) f32: its renormalised gate weight, 0
    #                       when empty
    aux: dict             # load_balance, router_z, dropped_frac (0-d f32)


def route(router_logits: torch.Tensor, k: int, capacity: int) -> Routing:
    """Top-k routing of (T, E) float32 logits into `capacity` slots per
    expert.

    Softmax in float32; the top k per token, ties to the lower expert
    index (as lax.top_k), weights renormalised over max(sum, 1e-9).
    Slots fill by priority (k-slot, then token order): every primary
    assignment ranks before any secondary one. An assignment whose
    position in its expert is >= capacity is dropped."""
    t, e = router_logits.shape
    dev = router_logits.device
    logits = router_logits.float()
    unnorm = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = unnorm / unnorm.sum(-1, keepdim=True)
    # a stable descending sort keeps equal probabilities in index order
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # assignments flattened (k, T): the cumsum over one-hots gives each
    # its position in its expert's buffer
    idx_kt = gate_idx.T.reshape(-1)  # (k*T,)
    onehot = torch.nn.functional.one_hot(idx_kt, e)  # (k*T, E) int64
    pos_kt = (onehot.cumsum(0) * onehot).sum(-1) - 1
    keep_kt = pos_kt < capacity
    slot = torch.where(keep_kt, idx_kt * capacity + pos_kt,
                       torch.full_like(pos_kt, e * capacity))
    tok_kt = torch.arange(t, device=dev).repeat(k)
    # one spare slot takes every drop, then is cut off
    token = torch.full((e * capacity + 1,), t, dtype=torch.int64,
                       device=dev).scatter(0, slot, tok_kt)
    weight = torch.zeros((e * capacity + 1,), dtype=torch.float32,
                         device=dev).scatter(0, slot, gate_vals.T.reshape(-1))

    frac_tokens = onehot[:t].float().mean(0)  # top-1 view, (E,)
    aux = {
        "load_balance": (frac_tokens * probs.mean(0)).sum() * e,
        "router_z": torch.logsumexp(logits, -1).square().mean(),
        # counted in integers: exactly 0 when nothing drops
        "dropped_frac": (t - keep_kt[:t].sum()).float() / t,
    }
    return Routing(token[:-1].reshape(e, capacity),
                   weight[:-1].reshape(e, capacity), aux)


def top_k_routing(router_logits: torch.Tensor, k: int, capacity: int):
    """The reference's dense form of `route`: (dispatch (T, E, C) 0/1,
    combine (T, E, C) f32 gate weights, aux)."""
    t, e = router_logits.shape
    r = route(router_logits, k, capacity)
    dev = router_logits.device
    dispatch = torch.zeros((t + 1, e, capacity), dtype=torch.float32,
                           device=dev)
    combine = torch.zeros_like(dispatch)
    ei = torch.arange(e, device=dev)[:, None].expand(e, capacity)
    ci = torch.arange(capacity, device=dev)[None, :].expand(e, capacity)
    dispatch[r.token, ei, ci] = 1.0
    combine[r.token, ei, ci] = r.weight
    return dispatch[:t], combine[:t], r.aux


def moe_mlp(x: torch.Tensor, lp: dict, cfg: ModelConfig):
    """SwiGLU MoE layer. x: (B, S, D); lp: router (D, E), w_gate/w_up
    (E, D, F), w_down (E, F, D). Returns (out (B, S, D), aux dict).

    Capacity is contended over all B*S rows of the call, padding rows
    included, as in the reference."""
    b, s, d = x.shape
    dtype = transformer.torch_dtype(cfg.dtype)
    tokens = x.reshape(b * s, d)
    t = b * s
    capacity = _capacity(cfg, t)
    router_logits = tokens.float() @ lp["router"].float()
    r = route(router_logits, cfg.num_experts_per_token, capacity)
    padded = torch.cat([tokens, tokens.new_zeros((1, d))])
    xs = padded[r.token]  # (E, C, D)
    grad = torch.is_grad_enabled()
    gate = torch.bmm(xs, lp["w_gate"].to(dtype))
    up = torch.bmm(xs, lp["w_up"].to(dtype))
    # without autograd (serving) the activation and the weighting run in
    # place: two (E, C, F) buffers and one (E, C, D) less at the peak
    act = (swiglu(gate, up) if grad
           else torch.nn.functional.silu(gate, inplace=True).mul_(up))
    ys = torch.bmm(act, lp["w_down"].to(dtype))  # (E, C, D)
    # combine in float32: each token sums its k weighted expert rows
    w = r.weight[..., None]
    rows = (ys.float() * w if grad else ys.float().mul_(w)).reshape(-1, d)
    out = torch.zeros((t + 1, d), dtype=torch.float32, device=x.device)
    out = out.index_add(0, r.token.reshape(-1), rows)
    return out[:t].to(dtype).reshape(b, s, d), r.aux


# ---------------------------------------------------------------------------
# Model: dense attention + MoE MLP blocks
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    shapes = transformer.param_shapes(cfg)
    L, D, E, F = (cfg.num_layers, cfg.embed_dim, cfg.num_experts,
                  cfg.mlp_dim)
    layers = shapes["layers"]
    for k in ("w_gate", "w_up", "w_down"):
        del layers[k]
    layers["router"] = (L, D, E)
    layers["w_gate"] = (L, E, D, F)
    layers["w_up"] = (L, E, D, F)
    layers["w_down"] = (L, E, F, D)
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                dtype: torch.dtype | None = None) -> Params:
    """The reference's initialisation (truncated normal, std
    1/sqrt(fan_in), the router's fan-in D), drawn as
    `transformer.init_params` draws: a layer at a time from a
    torch.Generator seeded with `seed`."""
    if cfg.num_experts < 2:
        raise ValueError("MoE model needs num_experts >= 2")
    return transformer.init_params(cfg, seed, device=device, dtype=dtype,
                                   shapes=param_shapes(cfg))


def moe_mlp_block(x, lp, cfg: ModelConfig):
    """Residual MoE MLP sub-block: norm -> route/experts -> add. Shared
    by training and the inference engines (`engine._mlp_apply`)."""
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    out, aux = moe_mlp(h, lp, cfg)
    return x + out, aux


def _moe_block(x, lp, cfg: ModelConfig, cos, sin, attn_fn, positions=None):
    q, k, v = transformer.attention_qkv(x, lp, cfg, cos, sin, positions)
    x = transformer.attention_out(x, attn_fn(q, k, v), lp, cfg)
    x, aux = moe_mlp_block(x, lp, cfg)
    return x, aux["load_balance"], aux["router_z"], aux["dropped_frac"]


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   segment_ids: torch.Tensor | None = None):
    """(B, S) -> (final-normed hidden (B, S, D), aux dict of router stats
    averaged over layers). Differentiable, with the remat policy applied
    per layer, and packed rows (`segment_ids`) handled, as
    `transformer.forward_hidden`."""
    x = transformer.embed(params, tokens, cfg)
    cos, sin = rope_table(cfg, tokens.shape[1], device=x.device)
    attn_fn, positions = transformer.packed_inputs(cfg, segment_ids,
                                                   x.device)
    block = transformer.apply_remat(
        partial(_moe_block, cfg=cfg, cos=cos, sin=sin, attn_fn=attn_fn,
                positions=positions), cfg)
    names = sorted(params["layers"])
    per_layer = [params["layers"][n].unbind(0) for n in names]
    lb = rz = dropped = torch.zeros((), dtype=torch.float32,
                                    device=x.device)
    for i in range(cfg.num_layers):
        x, a, z, d = block(x, {n: t[i] for n, t in zip(names, per_layer)})
        lb, rz, dropped = lb + a, rz + z, dropped + d
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    n = cfg.num_layers
    return x, {"load_balance": lb / n, "router_z": rz / n,
               "dropped_frac": dropped / n}


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            segment_ids: torch.Tensor | None = None):
    """(B, S) -> (logits (B, S, V) f32, aux dict of router stats)."""
    x, aux = forward_hidden(params, tokens, cfg, segment_ids)
    return transformer.unembed(x, params, cfg), aux


def next_token_loss(params: Params, batch: dict, cfg: ModelConfig,
                    z_loss_coef: float = 0.0, aux_loss_coef: float = 0.01,
                    router_z_coef: float = 0.0):
    """The dense model's next-token CE (the hidden-state route when
    ce_impl is "pallas" or vocab_chunk > 0) plus aux_loss_coef ·
    load_balance and, when set, router_z_coef · router_z; the metrics
    carry the three router stats. Packed batches ("segment_ids") mask the
    CE as the dense model's do."""
    seg = batch.get("segment_ids")
    batch = transformer.apply_segment_loss_mask(batch)
    if cfg.ce_impl == "pallas" or cfg.vocab_chunk > 0:
        x, aux = forward_hidden(params, batch["tokens"], cfg, seg)
        loss, metrics = transformer.hidden_state_loss(x, params, batch, cfg,
                                                      z_loss_coef)
    else:
        logits, aux = forward(params, batch["tokens"], cfg, seg)
        loss, metrics = transformer.masked_cross_entropy(logits, batch,
                                                         z_loss_coef)
    metrics.update(load_balance=aux["load_balance"].detach(),
                   router_z=aux["router_z"].detach(),
                   dropped_frac=aux["dropped_frac"].detach())
    loss = loss + aux_loss_coef * aux["load_balance"]
    if router_z_coef > 0.0:
        loss = loss + router_z_coef * aux["router_z"]
    return loss, metrics


def module_for(cfg: ModelConfig):
    """The model family of `cfg`: this module for num_experts >= 2, else
    `models.transformer` (the choice the reference's entry points make)."""
    from cloud_server_tpu_torch.models import moe
    return moe if cfg.num_experts >= 2 else transformer
