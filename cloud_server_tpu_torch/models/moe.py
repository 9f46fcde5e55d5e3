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
only the MLP is replaced.

Expert parallelism (training on a mesh, `plan=`, a
`transformer.MeshPlan`): the expert leaves (L, E, D, F) split E over ep
and F over tp (`param_logical_axes`, the reference's rules), the rest
follows the dense model's. Routing is global, as the reference's jit
routes all B*S tokens of the batch at once: each rank's router logits
are gathered over the data axes (T x E in float32), every rank routes
the whole batch the same way, and the slots are split between the ranks
— each expert's to the ep rank that holds it, its C slots in blocks over
the data ranks. A rank gathers the tokens its slots serve, runs its
experts on its columns of F, and the weighted rows are summed over
(ep, tp) and reduce-scattered back to the rows' owners. Inside a
pipeline stage a microbatch is routed alone over the rank's rows, as the
reference's stage routes its shard (`route_axes`).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, NamedTuple

import torch

from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import rms_norm, rope_table, swiglu
from cloud_server_tpu_torch.parallel import collectives

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


def _to_region(t: torch.Tensor, plan) -> torch.Tensor:
    """A tensor every (ep, tp) rank holds alike, entering the expert
    region where each uses it for its own experts and columns: the
    identity, the backward summing the ranks' gradients."""
    for axis in ("ep", "tp"):
        if plan.group(axis) is not None:
            t = collectives.identity_ad(t, plan.group(axis))
    return t


def moe_mlp_mesh(x: torch.Tensor, lp: dict, cfg: ModelConfig, plan,
                 route_axes=("dp", "fsdp", "sp")):
    """`moe_mlp` on a rank of a mesh. x: the rank's (B_loc, S_loc, D)
    block (alike on its ep and tp ranks); lp: the layer's leaves as
    `plan.gather_layer` gives them (router (D, E), experts (E/ep, D,
    F/tp) and (E/ep, F/tp, D)). The tokens of every rank of
    `route_axes` are routed together, in the global batch's order.
    Returns (the rank's out block, aux of the routed tokens, the number
    of ranks that routed them together)."""
    b, s, d = x.shape
    dtype = transformer.torch_dtype(cfg.dtype)
    axes = tuple(a for a in route_axes if plan.group(a) is not None)
    e = cfg.num_experts
    logits = plan.gather_tokens(
        (x.reshape(b * s, d).float() @ lp["router"].float()).reshape(
            b, s, e), axes).reshape(-1, e)
    t = logits.shape[0]
    capacity = _capacity(cfg, t)
    r = route(logits, cfg.num_experts_per_token, capacity)
    # this rank's slots: its experts (ep), a block of their C (data ranks)
    n_d, q = 1, 0
    for a in ("dp", "fsdp", "sp"):
        if a in axes:
            q = q * plan.size(a) + plan.rank(a)
            n_d *= plan.size(a)
    e_loc = lp["w_gate"].shape[0]
    e0 = plan.rank("ep") * e_loc
    c_blk = -(-capacity // n_d)
    pad = c_blk * n_d - capacity
    token = torch.nn.functional.pad(r.token, (0, pad), value=t)
    weight = torch.nn.functional.pad(_to_region(r.weight, plan), (0, pad))
    token = token[e0:e0 + e_loc, q * c_blk:(q + 1) * c_blk]
    weight = weight[e0:e0 + e_loc, q * c_blk:(q + 1) * c_blk]
    tokens = _to_region(plan.gather_tokens(x, axes).reshape(-1, d), plan)
    padded = torch.cat([tokens, tokens.new_zeros((1, d))])
    xs = padded[token]  # (E/ep, C/n_d, D)
    gate = torch.bmm(xs, lp["w_gate"].to(dtype))
    up = torch.bmm(xs, lp["w_up"].to(dtype))
    ys = torch.bmm(swiglu(gate, up), lp["w_down"].to(dtype))
    rows = (ys.float() * weight[..., None]).reshape(-1, d)
    out = torch.zeros((t + 1, d), dtype=torch.float32, device=x.device)
    out = out.index_add(0, token.reshape(-1), rows)[:t]
    s_all = s * (plan.size("sp") if "sp" in axes else 1)
    out = plan.scatter_tokens(out.reshape(-1, s_all, d), axes)
    for axis in ("ep", "tp"):
        if plan.group(axis) is not None:
            out = collectives.psum_ad(out, plan.group(axis))
    return out.to(dtype), r.aux, n_d


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


def param_logical_axes(cfg: ModelConfig) -> dict[str, Any]:
    """The dense model's logical axes with the router (replicated over
    experts) and the expert stacks: E over "experts" (ep), F over
    "expert_mlp" (tp), D over "embed" (fsdp)."""
    axes = transformer.param_logical_axes(cfg)
    layers = axes["layers"]
    for k in ("w_gate", "w_up", "w_down"):
        del layers[k]
    layers["router"] = ("layers", "embed", None)
    layers["w_gate"] = ("layers", "experts", "embed", "expert_mlp")
    layers["w_up"] = ("layers", "experts", "embed", "expert_mlp")
    layers["w_down"] = ("layers", "experts", "expert_mlp", "embed")
    return axes


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


def _moe_block(x, lp, cfg: ModelConfig, cos, sin, attn_fn, positions=None,
               plan=None, route_axes=("dp", "fsdp", "sp")):
    """One layer: (x, load_balance, router_z, dropped_frac). On a mesh
    (`plan`) the layer's fsdp-split leaves are gathered, attention runs
    on the rank's tp heads and the experts as `moe_mlp_mesh`; the aux
    statistics are then those of the tokens routed together, divided by
    the number of ranks that routed them (so their sum over the data
    axes is the statistic once)."""
    if plan is None:
        q, k, v = transformer.attention_qkv(x, lp, cfg, cos, sin, positions)
        x = transformer.attention_out(x, attn_fn(q, k, v), lp, cfg)
        x, aux = moe_mlp_block(x, lp, cfg)
        return x, aux["load_balance"], aux["router_z"], aux["dropped_frac"]
    lp = plan.gather_layer(lp)
    tp = plan.group("tp")
    q, k, v = transformer.attention_qkv(x, lp, cfg, cos, sin, positions,
                                        tp=tp)
    x = transformer.attention_out(x, attn_fn(q, k, v), lp, cfg, tp=tp)
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    out, aux, n = moe_mlp_mesh(h, lp, cfg, plan, route_axes)
    return (x + out, aux["load_balance"] / n, aux["router_z"] / n,
            aux["dropped_frac"] / n)


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   segment_ids: torch.Tensor | None = None, plan=None):
    """(B, S) -> (final-normed hidden (B, S, D), aux dict of router stats
    averaged over layers). Differentiable, with the remat policy applied
    per layer, and packed rows (`segment_ids`) handled, as
    `transformer.forward_hidden`. On a mesh (`plan`) the rank's block of
    the hidden states, and its part of the aux statistics (their sum
    over the data axes is the reference's)."""
    if plan is None:
        x = transformer.embed(params, tokens, cfg)
        cos, sin = rope_table(cfg, tokens.shape[1], device=x.device)
        attn_fn, positions = transformer.packed_inputs(cfg, segment_ids,
                                                       x.device)
    else:
        x, cos, sin, attn_fn, positions = plan.inputs(params, tokens, cfg,
                                                      segment_ids)
    block = transformer.apply_remat(
        partial(_moe_block, cfg=cfg, cos=cos, sin=sin, attn_fn=attn_fn,
                positions=positions, plan=plan), cfg)
    names = sorted(params["layers"])
    per_layer = [params["layers"][n].unbind(0) for n in names]
    lb = rz = dropped = torch.zeros((), dtype=torch.float32,
                                    device=x.device)
    for i in range(len(per_layer[0])):
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


def add_aux_loss(loss, metrics: dict, aux: dict, aux_loss_coef: float,
                 router_z_coef: float, metric_of=lambda v: v.detach()):
    """The router terms of the MoE loss and their metrics (`metric_of`
    maps a rank's part of a statistic to the global value)."""
    metrics.update({k: metric_of(aux[k]) for k in
                    ("load_balance", "router_z", "dropped_frac")})
    loss = loss + aux_loss_coef * aux["load_balance"]
    if router_z_coef > 0.0:
        loss = loss + router_z_coef * aux["router_z"]
    return loss, metrics


def next_token_loss(params: Params, batch: dict, cfg: ModelConfig,
                    z_loss_coef: float = 0.0, aux_loss_coef: float = 0.01,
                    router_z_coef: float = 0.0, plan=None):
    """The dense model's next-token CE (the hidden-state route when
    ce_impl is "pallas" or vocab_chunk > 0) plus aux_loss_coef ·
    load_balance and, when set, router_z_coef · router_z; the metrics
    carry the three router stats. Packed batches ("segment_ids") mask the
    CE as the dense model's do. On a mesh (`plan`) the rank's part of
    it, as `transformer.MeshPlan.next_token_loss`."""
    if plan is not None:
        x, aux = forward_hidden(params, batch["tokens"], cfg,
                                batch.get("segment_ids"), plan)
        loss, metrics = plan.hidden_loss(x, params, batch, cfg, z_loss_coef)
        return add_aux_loss(loss, metrics, aux, aux_loss_coef,
                            router_z_coef, plan.psum_data)
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
    return add_aux_loss(loss, metrics, aux, aux_loss_coef, router_z_coef)


def module_for(cfg: ModelConfig):
    """The model family of `cfg`: this module for num_experts >= 2, else
    `models.transformer` (the choice the reference's entry points make)."""
    from cloud_server_tpu_torch.models import moe
    return moe if cfg.num_experts >= 2 else transformer
