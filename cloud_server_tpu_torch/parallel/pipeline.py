"""Pipeline parallelism over the `pp` mesh axis: the reference's
`parallel/pipeline.py` on torch.distributed, one process a rank.

SPMD GPipe: the stacked layer axis is split over pp (the rules'
`"layers": "pp"`), so each rank holds L/pp layers. Every rank runs the
same loop of M + pp - 1 ticks: at tick t it applies its stage to the
microbatch it holds (stage 0 takes microbatch t, the others what the
previous stage handed on), then hands its output to the next stage
with `collectives.ppermute_ad`, whose backward is the reverse shift.
After the last tick the last stage's outputs reach every rank by a
masked sum over pp (`psum_ad`: its backward is the identity, and the
mask gives the cotangent to the last stage's outputs alone, so every
stage computing the same replicated loss counts it once).

The backward is autograd over that loop: GPipe, with no hand-written
1F1B, as in the reference's design note. Every rank's loop runs the
same operations in the same order (a stage in its bubble computes on a
zero carry, as the reference's; the where-select keeps both inputs in
the graph), so every rank's backward issues the same collectives in the
same order. 1F1B's bound on live activations comes, as in the
reference, from wrapping the pipelined loss in the train step's
gradient accumulation (`TrainConfig.microbatch_steps`).

Around the stack: every stage embeds its rows (the embedding enters
through `identity_ad` over pp, so the embedding's gradient, formed on
stage 0 alone, is summed onto every stage's copy of the table: the
activation's bytes, not the table's), and every stage computes the final
norm, the head and the loss on the broadcast hidden states (their
gradients are whole on every stage). Inside a stage each layer runs with
the step's `transformer.MeshPlan` (fsdp gathers, tp regions) under the
model's remat policy; the loss goes through the plan's single CE
dispatch, so ce_impl "pallas" runs the fused CE kernels on every stage.

Payloads are tuples: x for a dense model, (x, aux3) for MoE (the three
router statistics accumulated over layers ride with the activations),
with (segment ids, positions) added for packed rows. A microbatch of an
MoE stage is routed alone over the rank's rows (and the sequence over
sp), as the reference's stage routes its shard.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import matmul_f32, rms_norm
from cloud_server_tpu_torch.parallel import collectives
from cloud_server_tpu_torch.parallel.mesh import axis_size
from cloud_server_tpu_torch.parallel.sharding import DEFAULT_RULES


def pipeline_rules(rules=None) -> dict:
    """`rules` (DEFAULT_RULES by default) with the stacked layer axis
    split over pp."""
    return {**(DEFAULT_RULES if rules is None else rules), "layers": "pp"}


def pipeline_spmd(stage_params, microbatches, stage_fn: Callable, *,
                  group):
    """Run microbatches through the pipeline over `group` (the pp
    process group; None runs them in turn on this rank).

    Args:
      stage_params: this rank's slice of the stacked layer params (L/pp
        layers).
      microbatches: a tensor, or a tuple of tensors, of (M, mb, ...)
        microbatches (alike on every stage).
      stage_fn: (stage_params, payload) -> payload of the same structure
        and shapes, applying this stage's layers.
      group: the pp process group.

    Returns:
      the outputs, structured as `microbatches`, on every rank.
    """
    single = isinstance(microbatches, torch.Tensor)
    mbs = (microbatches,) if single else tuple(microbatches)
    pp = 1 if group is None else group.size()
    stage = 0 if group is None else group.rank()
    m = mbs[0].shape[0]
    dev = mbs[0].device
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == pp - 1, device=dev)
    recv = tuple(torch.zeros_like(a[0]) for a in mbs)
    outs = []
    for t in range(m + pp - 1):
        i = min(t, m - 1)
        x_in = tuple(torch.where(first, a[i], r) for a, r in zip(mbs, recv))
        y = stage_fn(stage_params, x_in[0] if single else x_in)
        y = (y,) if single else tuple(y)
        if t >= pp - 1:
            outs.append(y)
        if t < m + pp - 2:  # the last tick's hand-off has no receiver
            recv = tuple(collectives.ppermute_ad(v, group, 1) for v in y)
    out = []
    for j in range(len(mbs)):
        stacked = torch.stack([o[j] for o in outs])
        out.append(collectives.psum_ad(
            torch.where(last, stacked, torch.zeros_like(stacked)), group))
    return out[0] if single else tuple(out)


def _is_moe_module(loss_fn_module) -> bool:
    """Capability check, not name sniffing: a module pipelines as MoE iff
    it exposes the (x, aux)-returning `_moe_block` stage primitive."""
    return hasattr(loss_fn_module, "_moe_block")


def _stage_factory(model_cfg, plan, cos, sin, attn_fn, positions,
                   is_moe: bool, packed: bool):
    """stage_fn(layers, payload) of the dense or the MoE stack: the
    rank's layers in turn, each under the model's remat policy."""
    from cloud_server_tpu_torch.models import moe

    def stage_fn(layers, payload):
        payload = list(payload)
        x = payload[0]
        attn, pos = attn_fn, positions
        if packed:
            seg, pos = payload[-2:]
            attn = transformer._get_attention_fn(model_cfg, seg, plan)
        elif pos is not None:
            pos = pos[:x.shape[0]]
        if is_moe:
            block = partial(moe._moe_block, cfg=model_cfg, cos=cos, sin=sin,
                            attn_fn=attn, positions=pos, plan=plan,
                            route_axes=("sp",))
        else:
            block = partial(transformer._block, cfg=model_cfg, cos=cos,
                            sin=sin, attn_fn=attn, positions=pos, plan=plan)
        block = transformer.apply_remat(block, model_cfg)
        names = sorted(layers)
        per_layer = [layers[n].unbind(0) for n in names]
        aux = payload[1] if is_moe else None
        for i in range(len(per_layer[0])):
            lp = {n: t[i] for n, t in zip(names, per_layer)}
            if is_moe:
                x, a, z, d = block(x, lp)
                aux = aux + torch.stack([a, z, d])
            else:
                x = block(x, lp)
        payload[0] = x
        if is_moe:
            payload[1] = aux
        return tuple(payload)
    return stage_fn


def make_pipelined_hidden(model_cfg, mesh, num_microbatches: int,
                          rules=None, loss_fn_module=transformer):
    """Return hidden(params, tokens, segment_ids=None) with the block
    stack run as a pipeline over the mesh's pp axis.

    `params` are the rank's shards under `pipeline_rules(rules)`; tokens
    (and segment ids) the rank's (B_local, S_local) block, B_local
    divisible by `num_microbatches`. Dense (`loss_fn_module=transformer`):
    hidden -> the rank's final-normed (B_local, S_local, D). MoE
    (`loss_fn_module=models.moe`): hidden -> (x, aux dict of the rank's
    part of the router statistics averaged over microbatches and layers;
    their sum over the data axes is the reference's average over its
    batch shards).

    Embedding, final norm and head run on every stage (they are cheap
    beside the stack); only the layers are pipelined."""
    from cloud_server_tpu_torch.models import moe
    pp = axis_size(mesh, "pp")
    if model_cfg.num_layers % pp:
        raise ValueError(f"num_layers={model_cfg.num_layers} not divisible "
                         f"by pp={pp}")
    is_moe = _is_moe_module(loss_fn_module)
    logical = (moe if is_moe else transformer).param_logical_axes(model_cfg)
    plan = transformer.MeshPlan(mesh, model_cfg, pipeline_rules(rules),
                                logical)
    group = plan.group("pp")
    m = num_microbatches

    def hidden(params, tokens, segment_ids=None):
        cfg = model_cfg
        packed = segment_ids is not None
        if packed and cfg.attention_impl not in ("xla", "flash"):
            raise ValueError(
                "pipelined packed batches need attention_impl 'xla' or "
                "'flash' (ring/ulysses would nest their sequence exchange "
                f"inside the pipeline); got {cfg.attention_impl!r}")
        x, cos, sin, attn_fn, positions = plan.inputs(params, tokens, cfg,
                                                      segment_ids)
        if group is not None and torch.is_grad_enabled() and x.requires_grad:
            x = collectives.identity_ad(x, group)
        b = x.shape[0]
        if b % m:
            raise ValueError(f"the rank's {b} rows do not split into "
                             f"{m} microbatches")
        mb = b // m
        micro = [x.reshape(m, mb, *x.shape[1:])]
        if is_moe:
            micro.append(torch.zeros((m, 3), dtype=torch.float32,
                                     device=x.device))
        if packed:
            seg = segment_ids.to(x.device)
            micro += [seg.reshape(m, mb, -1), positions.reshape(m, mb, -1)]
        stage_fn = _stage_factory(cfg, plan, cos, sin, attn_fn, positions,
                                  is_moe, packed)
        out = pipeline_spmd(params["layers"], tuple(micro), stage_fn,
                            group=group)
        xo = rms_norm(out[0].reshape(x.shape), params["final_norm"]["scale"],
                      cfg.norm_eps)
        if not is_moe:
            return xo
        # per-microbatch layer sums -> the mean over microbatches, layers
        # and (summed over the data axes) the batch shards
        shards = plan.size("dp") * plan.size("fsdp")
        avg = out[1].sum(0) / (m * cfg.num_layers * shards)
        return xo, {"load_balance": avg[0], "router_z": avg[1],
                    "dropped_frac": avg[2]}

    hidden.plan = plan
    return hidden


def make_pipelined_forward(model_cfg, mesh, num_microbatches: int,
                           rules=None, loss_fn_module=transformer):
    """Return forward(params, tokens, segment_ids=None) with the block
    stack pipelined: dense -> f32 logits; MoE -> (logits, aux dict of the
    global router statistics), mirroring the unpipelined module forwards.
    The logits are those of the rank's share of each microbatch, in
    microbatch order (`microbatch_rows`: the rank's own rows when the
    batch is not split)."""
    hidden = make_pipelined_hidden(model_cfg, mesh, num_microbatches, rules,
                                   loss_fn_module)
    plan = hidden.plan
    is_moe = _is_moe_module(loss_fn_module)

    def forward(params, tokens, segment_ids=None):
        rows = microbatch_rows(plan, {"tokens": tokens,
                                      "segment_ids": segment_ids},
                               num_microbatches)
        out = hidden(params, rows["tokens"], rows["segment_ids"])
        x, aux = out if is_moe else (out, None)
        logits = transformer.apply_logits_softcap(
            matmul_f32(x, plan.head(params, model_cfg)), model_cfg)
        logits = collectives.all_gather(logits, plan.group("tp"),
                                        tiled_axis=-1)
        if is_moe:
            return logits, {k: plan.psum_data(v) for k, v in aux.items()}
        return logits

    return forward


def microbatch_rows(plan, batch: dict, m: int) -> dict:
    """The rank's rows of each microbatch, as the reference lays them out:
    microbatch i is global rows [i B / m, (i + 1) B / m), split over the
    batch axes like the global batch, so the rank's share of it comes
    from the gathered global batch (ints: no gradient). Returned in
    microbatch order: of a global batch of B rows over n batch ranks,
    rank q holds rows i B / m + q B / (m n) + r, for each microbatch i
    and r < B / (m n)."""
    shards = plan.size("dp") * plan.size("fsdp")
    if m == 1 or shards == 1:
        return batch
    q = plan.rank("dp") * plan.size("fsdp") + plan.rank("fsdp")
    out = {}
    with torch.no_grad():
        for k, v in batch.items():
            if v is None:
                out[k] = v
                continue
            whole = plan.gather_tokens(v, ("dp", "fsdp"))
            rows = whole.shape[0] // (m * shards)
            out[k] = whole.reshape(m, shards, rows, *whole.shape[1:])[
                :, q].reshape(m * rows, *whole.shape[1:]).contiguous()
    return out


def make_pipelined_loss(model_cfg, mesh, num_microbatches: int,
                        z_loss_coef: float = 0.0, loss_fn_module=transformer,
                        aux_loss_coef: float = 0.01,
                        router_z_coef: float = 0.0, rules=None):
    """Pipelined replacement for <module>.next_token_loss, the rank's
    part of it; signature (params, batch, cfg, plan=None), so it drops
    into `make_train_step(loss_fn=..., rules=pipeline_rules())` (the
    step's `plan` is ignored: the pipeline has its own, with the
    pipeline's rules).

    Honors cfg.vocab_chunk and cfg.ce_impl through the plan's single CE
    dispatch. With loss_fn_module=models.moe the MoE stack pipelines and
    the router aux losses are added as moe.next_token_loss adds them."""
    from cloud_server_tpu_torch.models import moe
    hidden = make_pipelined_hidden(model_cfg, mesh, num_microbatches, rules,
                                   loss_fn_module)
    pipe = hidden.plan
    is_moe = _is_moe_module(loss_fn_module)

    def loss_fn(params, batch, cfg, plan=None):
        # The stack is built from the closed-over model_cfg; the runtime
        # cfg is ignored so the head/softcap/chunking cannot diverge from
        # the pipelined body.
        del cfg, plan
        batch = microbatch_rows(pipe, batch, num_microbatches)
        out = hidden(params, batch["tokens"], batch.get("segment_ids"))
        x, aux = out if is_moe else (out, None)
        loss, metrics = pipe.hidden_loss(x, params, batch, model_cfg,
                                         z_loss_coef)
        if is_moe:
            loss, metrics = moe.add_aux_loss(loss, metrics, aux,
                                             aux_loss_coef, router_z_coef,
                                             pipe.psum_data)
        return loss, metrics

    return loss_fn
