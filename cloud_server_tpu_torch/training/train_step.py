"""The training step, on one device or as one rank of a mesh.

`make_train_step` returns step(state, batch) -> (state, metrics): the
loss and its backward (with gradient accumulation over
`microbatch_steps`), then the optimizer's in-place update. Metrics are
0-d device tensors; nothing here reads the device on the host, so steps
queue on the card back to back.

The model family comes from `loss_fn_module` (`models.transformer`,
`models.moe`, or a LoRA module from `models.lora.make_lora_module`),
as in the reference.

On a mesh (`mesh=`, a DeviceMesh over the dp, pp, fsdp, ep, sp and tp
axes; one process a rank) each rank holds its shards of the parameters
and of the optimizer state, placed by `rules` (`parallel.sharding.
DEFAULT_RULES` by default; `parallel.pipeline.pipeline_rules()` splits
the layers over pp), through `state_shardings` (moments shard like their
parameters), and its block of the global batch (rows over (dp, fsdp),
the sequence over sp). The loss is called with the step's
`transformer.MeshPlan` (`plan=`): fsdp gathers each layer's leaves
(reduce-scattering their gradients in the backward), tp's and ep's
activations cross ranks through the autograd-aware collectives, MoE
experts run on their ep rank (`models.moe.moe_mlp_mesh`), adapters merge
onto the rank's shards (`models.lora`), and a pipelined loss
(`parallel.pipeline.make_pipelined_loss`) runs the layers as a GPipe
schedule over pp. After the backward each gradient is summed over the
data axes its leaf is not split over (dp and sp always, fsdp for the
leaves it does not split); every other axis holds a leaf's whole
gradient on each rank that holds the leaf (the collectives' pairs make
it so), and the global norm counts each element once, whatever the
leaf's split (layers over pp, experts over ep, adapters); AdamW updates
each rank's shards.
"""

from __future__ import annotations

import inspect
from functools import partial
from typing import Any, Callable, NamedTuple

import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from cloud_server_tpu_torch.models import lora as lora_mod
from cloud_server_tpu_torch.models import moe, transformer
from cloud_server_tpu_torch.parallel import collectives
from cloud_server_tpu_torch.parallel.mesh import axis_size
from cloud_server_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                      logical_to_sharding,
                                                      shard_tensor)
from cloud_server_tpu_torch.training.optim import (flatten, map_tree,
                                                   optimizer_for_module,
                                                   sharded_global_norm)

class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


def mesh_config_of(mesh) -> MeshConfig:
    """The MeshConfig of a DeviceMesh's shape."""
    return MeshConfig(**{a: axis_size(mesh, a)
                         for a in MeshConfig.AXIS_ORDER})


def check_mesh(mesh_cfg: MeshConfig | None, model_cfg: ModelConfig | None
               = None, loss_fn_module=None) -> None:
    """Raise ValueError for a mesh the model cannot be split over: ep
    must divide an MoE model's expert count."""
    if mesh_cfg is None or model_cfg is None or mesh_cfg.ep == 1:
        return
    if model_cfg.num_experts >= 2 and model_cfg.num_experts % mesh_cfg.ep:
        raise ValueError(f"num_experts={model_cfg.num_experts} not "
                         f"divisible by ep={mesh_cfg.ep}")


def state_shardings(model_cfg: ModelConfig, mesh, rules=DEFAULT_RULES,
                    loss_fn_module=None) -> dict:
    """Per parameter leaf, the splits this mesh makes (`parallel.sharding.
    logical_to_sharding`: (dimension, mesh axis) pairs). The optimizer's
    moments and the EMA shard like their parameters; the step counters
    are replicated."""
    module = loss_fn_module or moe.module_for(model_cfg)
    return logical_to_sharding(module.param_logical_axes(model_cfg), mesh,
                               rules or DEFAULT_RULES)


def shard_tree(tree: dict, splits: dict, mesh) -> dict:
    """This rank's slice of every leaf of a full tree (params-shaped)."""
    return {k: shard_tree(v, splits[k], mesh) if isinstance(v, dict)
            else shard_tensor(v, splits[k], mesh) for k, v in tree.items()}


def _init_sharded(module, model_cfg: ModelConfig, seed: int, device,
                  splits: dict, mesh) -> dict:
    """`module.init_params`' values with each leaf cut to this rank's
    slice as soon as it is drawn (a LoRA module's adapters, small, are
    drawn whole and cut)."""
    lcfg = getattr(module, "lora_config", None)
    if lcfg is None:
        return transformer.init_params(
            model_cfg, seed, device=device,
            shapes=module.param_shapes(model_cfg),
            leaf_fn=lambda g, n, t: shard_tensor(t, splits[g][n], mesh))
    if module.base_params is None:
        base = _init_sharded(module.base_module, model_cfg, seed, device,
                             splits["base"], mesh)
    else:
        base = shard_tree(module.base_params, splits["base"], mesh)
    adapters = lora_mod.init_lora_params(model_cfg, lcfg, seed + 1,
                                         device=device,
                                         base_module=module.base_module)
    return {"base": base,
            "lora": shard_tree(adapters, splits["lora"], mesh)}


def init_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                     seed: int = 0, device=None, loss_fn_module=None,
                     mesh=None, rules=None) -> TrainState:
    """Parameters of `loss_fn_module` (the family of model_cfg by
    default: `models.moe.module_for`) drawn on `device` (CUDA unless
    named) at cfg.param_dtype, the trainable ones marked as autograd
    leaves, and the optimizer state. On a mesh each rank keeps only its
    shards (placed by `rules`) of the values one device would draw from
    `seed`: every rank draws each leaf whole, keeps its slice and drops
    the leaf before the next is drawn."""
    module = loss_fn_module or moe.module_for(model_cfg)
    device = resolve_device(device)
    if mesh is None:
        params = module.init_params(model_cfg, seed, device=device)
        return train_state_from_params(params, train_cfg, model_cfg, module)
    check_mesh(mesh_config_of(mesh), model_cfg, module)
    splits = state_shardings(model_cfg, mesh, rules, module)
    params = _init_sharded(module, model_cfg, seed, device, splits, mesh)
    return train_state_from_params(params, train_cfg, model_cfg, module)


def train_state_from_params(params: dict, train_cfg: TrainConfig,
                            model_cfg: ModelConfig | None = None,
                            loss_fn_module=None, mesh=None,
                            rules=None) -> TrainState:
    """A fresh TrainState over `params`. With a module that labels its
    params (LoRA), only the trainable leaves become autograd leaves and
    get optimizer moments; the frozen ones never form a gradient. On a
    mesh, `params` are the full leaves and each rank keeps its slices
    (placed by `rules`)."""
    if mesh is not None:
        splits = state_shardings(model_cfg, mesh, rules, loss_fn_module)
        params = shard_tree(params, splits, mesh)
    opt = optimizer_for_module(train_cfg, model_cfg, loss_fn_module)
    trainable = {id(p) for _, p in flatten(opt.trainable(params))}
    params = map_tree(lambda p: p.requires_grad_(id(p) in trainable),
                      params)
    return TrainState(step=0, params=params, opt_state=opt.init(params))


class _GradSync:
    """The gradient sums of a mesh step: per leaf, the data axes it is
    not split over, and the number of ranks that hold it identically
    (for the global norm)."""

    def __init__(self, mesh, splits: dict):
        self.mesh = mesh
        self.groups = {a: mesh.get_group(a) for a in MeshConfig.AXIS_ORDER
                       if axis_size(mesh, a) > 1}
        world = 1
        for a in self.groups:
            world *= axis_size(mesh, a)
        self.axes = {}
        self.replicas = {}
        for path, leaf_splits in flatten(splits):
            split_axes = {a for _, a in leaf_splits}
            self.axes[path] = [a for a in transformer.MeshPlan.DATA_AXES
                               if a in self.groups and a not in split_axes]
            held = 1
            for a in split_axes:
                held *= axis_size(mesh, a)
            self.replicas[path] = world // held

    def sum_(self, x: torch.Tensor, axes) -> torch.Tensor:
        """x summed over `axes`' groups, in place; returns x."""
        for a in axes:
            collectives.psum_(x, self.groups[a])
        return x

    @torch.no_grad()
    def grads_(self, grads: dict) -> None:
        for path, g in flatten(grads):
            self.sum_(g, self.axes[path])

    @torch.no_grad()
    def norm(self, grads: dict) -> torch.Tensor:
        flat = flatten(grads)
        return sharded_global_norm(
            [g for _, g in flat], [self.replicas[p] for p, _ in flat],
            lambda x: self.sum_(x, list(self.groups)))

    def gather_batch_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's rows (this rank's sequence slice): gathered
        over fsdp, then dp (the batch's layout, dp outer)."""
        for a in ("fsdp", "dp"):
            if a in self.groups:
                t = collectives.all_gather_ad(t, self.groups[a])
        return t


def _microbatches(batch: dict, nsteps: int, sync: _GradSync | None,
                  batch_index: int, batch_shards: int) -> list[dict]:
    """The step's microbatches. On one device the batch's rows in nsteps
    blocks. On a mesh each microbatch is split over the batch axes like
    the global batch (the reference's constraint): microbatch i holds
    global rows [i B / n, (i + 1) B / n), of which this rank keeps its
    1/shards block, so the rows come from the gathered global batch."""
    if nsteps == 1:
        return [batch]
    if sync is None or batch_shards == 1:
        return [dict(zip(batch, parts)) for parts in zip(
            *(v.chunk(nsteps, dim=0) for v in batch.values()))]
    out = [dict() for _ in range(nsteps)]
    with torch.no_grad():
        for k, v in batch.items():
            whole = sync.gather_batch_rows(v)
            rows = whole.shape[0] // (nsteps * batch_shards)
            blocks = whole.reshape(nsteps, batch_shards, rows,
                                   *whole.shape[1:])
            for i in range(nsteps):
                out[i][k] = blocks[i, batch_index].contiguous()
    return out


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    mesh_cfg: MeshConfig | None = None,
                    loss_fn: Callable | None = None, loss_fn_module=None,
                    mesh=None, rules=None):
    """(state, batch) -> (state, metrics). batch: {"tokens": (B, S) int
    tensor on the parameters' device}: on a mesh, this rank's block of
    the global batch (`data.loader.DataLoader` with the mesh). The
    state's trainable parameters and optimizer moments are updated in
    place.

    `loss_fn_module` (the family of model_cfg by default) gives the loss
    when `loss_fn` is None: its `next_token_loss` with the z-loss
    coefficient, and the MoE aux coefficients where it takes them.
    `mesh`: the DeviceMesh this rank trains on (a `mesh_cfg` of more
    than one device needs it); on it the loss is called with `plan=`,
    the step's `transformer.MeshPlan` over `rules`, as `next_token_loss`
    takes it. A pipelined `loss_fn` (`parallel.pipeline.
    make_pipelined_loss`) goes with `rules=pipeline_rules()`, the layout
    of its parameters."""
    module = loss_fn_module or moe.module_for(model_cfg)
    if mesh is not None:
        mesh_cfg = mesh_config_of(mesh)
    check_mesh(mesh_cfg, model_cfg, module)
    if mesh is None and mesh_cfg is not None and mesh_cfg.num_devices > 1:
        raise ValueError(
            f"mesh {mesh_cfg.axis_sizes()}: pass the DeviceMesh this rank "
            "trains on (mesh=; parallel.make_mesh builds it)")
    if mesh is not None and mesh_cfg.num_devices == 1:
        mesh = None
    if loss_fn is None:
        kwargs = {"z_loss_coef": train_cfg.z_loss_coef}
        sig = inspect.signature(module.next_token_loss).parameters
        if "aux_loss_coef" in sig:
            kwargs["aux_loss_coef"] = train_cfg.moe_aux_loss_coef
        if "router_z_coef" in sig:
            kwargs["router_z_coef"] = train_cfg.moe_router_z_coef
        loss_fn = partial(module.next_token_loss, **kwargs)
    opt = optimizer_for_module(train_cfg, model_cfg, module)
    nsteps = train_cfg.microbatch_steps
    sync = plan = None
    batch_index, batch_shards = 0, 1
    if mesh is not None:
        sync = _GradSync(mesh, state_shardings(model_cfg, mesh, rules,
                                               module))
        plan = transformer.MeshPlan(mesh, model_cfg, rules)
        batch_shards = mesh_cfg.dp * mesh_cfg.fsdp
        batch_index = (plan.rank("dp") * mesh_cfg.fsdp + plan.rank("fsdp"))
    on_mesh = {} if plan is None else {"plan": plan}

    def step(state: TrainState, batch: dict):
        params = state.params
        trainable = opt.trainable(params)
        leaves = [p for _, p in flatten(trainable)]
        for p in leaves:
            p.grad = None
        micro = _microbatches(batch, nsteps, sync, batch_index,
                              batch_shards)
        msum: dict = {}
        for mb in micro:
            loss, metrics = loss_fn(params, mb, model_cfg, **on_mesh)
            loss.backward()  # .grad accumulates the microbatch sum
            for k, v in metrics.items():
                msum[k] = msum[k] + v if k in msum else v
        grads = map_tree(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), trainable)
        gnorm = None
        if sync is not None:
            sync.grads_(grads)
            gnorm = sync.norm(grads)
        if nsteps > 1:
            torch._foreach_div_([g for _, g in flatten(grads)], nsteps)
            msum = {k: v / nsteps for k, v in msum.items()}
            if gnorm is not None:
                gnorm = gnorm / nsteps
        opt_state, gnorm = opt.step_(grads, state.opt_state, params, gnorm)
        for p in leaves:
            p.grad = None  # the update was built in the grads; free them
        msum["grad_norm"] = gnorm
        return TrainState(state.step + 1, params, opt_state), msum

    return step
