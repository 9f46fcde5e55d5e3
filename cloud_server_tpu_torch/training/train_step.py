"""The training step on one device.

`make_train_step` returns step(state, batch) -> (state, metrics): the
loss and its backward (with gradient accumulation over
`microbatch_steps`), then the optimizer's in-place update. Metrics are
0-d device tensors; nothing here reads the device on the host, so steps
queue on the card back to back.

The model family comes from `loss_fn_module` (`models.transformer`,
`models.moe`, or a LoRA module from `models.lora.make_lora_module`),
as in the reference. Only a single device is ported: a MeshConfig with
any axis > 1 raises.
"""

from __future__ import annotations

import inspect
from functools import partial
from typing import Any, Callable, NamedTuple

import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from cloud_server_tpu_torch.models import moe
from cloud_server_tpu_torch.training.optim import (flatten, map_tree,
                                                   optimizer_for_module)


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


def check_single_device(mesh_cfg: MeshConfig | None) -> None:
    if mesh_cfg is not None and mesh_cfg.num_devices > 1:
        raise NotImplementedError(
            f"mesh {mesh_cfg.axis_sizes()}: training on more than one "
            "device is not ported yet")


def init_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                     seed: int = 0, device=None,
                     loss_fn_module=None) -> TrainState:
    """Parameters of `loss_fn_module` (the family of model_cfg by
    default: `models.moe.module_for`) drawn on `device` (CUDA unless
    named) at cfg.param_dtype, the trainable ones marked as autograd
    leaves, and the optimizer state."""
    module = loss_fn_module or moe.module_for(model_cfg)
    params = module.init_params(model_cfg, seed,
                                device=resolve_device(device))
    return train_state_from_params(params, train_cfg, model_cfg, module)


def train_state_from_params(params: dict, train_cfg: TrainConfig,
                            model_cfg: ModelConfig | None = None,
                            loss_fn_module=None) -> TrainState:
    """A fresh TrainState over `params`. With a module that labels its
    params (LoRA), only the trainable leaves become autograd leaves and
    get optimizer moments; the frozen ones never form a gradient."""
    opt = optimizer_for_module(train_cfg, model_cfg, loss_fn_module)
    trainable = {id(p) for _, p in flatten(opt.trainable(params))}
    params = map_tree(lambda p: p.requires_grad_(id(p) in trainable),
                      params)
    return TrainState(step=0, params=params, opt_state=opt.init(params))


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    mesh_cfg: MeshConfig | None = None,
                    loss_fn: Callable | None = None, loss_fn_module=None):
    """(state, batch) -> (state, metrics). batch: {"tokens": (B, S) int
    tensor on the parameters' device}. The state's trainable parameters
    and optimizer moments are updated in place.

    `loss_fn_module` (the family of model_cfg by default) gives the loss
    when `loss_fn` is None: its `next_token_loss` with the z-loss
    coefficient, and the MoE aux coefficients where it takes them."""
    check_single_device(mesh_cfg)
    module = loss_fn_module or moe.module_for(model_cfg)
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

    def step(state: TrainState, batch: dict):
        params = state.params
        trainable = opt.trainable(params)
        leaves = [p for _, p in flatten(trainable)]
        for p in leaves:
            p.grad = None
        if nsteps == 1:
            micro = [batch]
        else:
            micro = [dict(zip(batch, parts)) for parts in zip(
                *(v.chunk(nsteps, dim=0) for v in batch.values()))]
        msum: dict = {}
        for mb in micro:
            loss, metrics = loss_fn(params, mb, model_cfg)
            loss.backward()  # .grad accumulates the microbatch sum
            for k, v in metrics.items():
                msum[k] = msum[k] + v if k in msum else v
        grads = map_tree(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), trainable)
        if nsteps > 1:
            torch._foreach_div_([g for _, g in flatten(grads)], nsteps)
            msum = {k: v / nsteps for k, v in msum.items()}
        opt_state, gnorm = opt.step_(grads, state.opt_state, params)
        for p in leaves:
            p.grad = None  # the update was built in the grads; free them
        msum["grad_norm"] = gnorm
        return TrainState(state.step + 1, params, opt_state), msum

    return step
