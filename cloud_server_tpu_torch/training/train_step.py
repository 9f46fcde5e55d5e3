"""The training step on one device.

`make_train_step` returns step(state, batch) -> (state, metrics): the
loss and its backward (with gradient accumulation over
`microbatch_steps`), then the optimizer's in-place update. Metrics are
0-d device tensors; nothing here reads the device on the host, so steps
queue on the card back to back.

Only a single device is ported: a MeshConfig with any axis > 1 raises.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple

import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.training.optim import (flatten, make_optimizer,
                                                   map_tree)


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
                     seed: int = 0, device=None) -> TrainState:
    """Parameters drawn on `device` (CUDA unless named) at
    cfg.param_dtype, marked as autograd leaves, and the optimizer state."""
    params = transformer.init_params(model_cfg, seed,
                                     device=resolve_device(device))
    return train_state_from_params(params, train_cfg)


def train_state_from_params(params: dict,
                            train_cfg: TrainConfig) -> TrainState:
    params = map_tree(lambda p: p.requires_grad_(True), params)
    return TrainState(step=0, params=params,
                      opt_state=make_optimizer(train_cfg).init(params))


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    mesh_cfg: MeshConfig | None = None,
                    loss_fn: Callable | None = None):
    """(state, batch) -> (state, metrics). batch: {"tokens": (B, S) int
    tensor on the parameters' device}. The state's parameters and
    optimizer moments are updated in place."""
    check_single_device(mesh_cfg)
    if model_cfg.num_experts >= 2:
        raise NotImplementedError("MoE training is not ported yet")
    if loss_fn is None:
        loss_fn = partial(transformer.next_token_loss,
                          z_loss_coef=train_cfg.z_loss_coef)
    opt = make_optimizer(train_cfg)
    nsteps = train_cfg.microbatch_steps

    def step(state: TrainState, batch: dict):
        params = state.params
        leaves = [p for _, p in flatten(params)]
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
                         else torch.zeros_like(p), params)
        if nsteps > 1:
            torch._foreach_div_([g for _, g in flatten(grads)], nsteps)
            msum = {k: v / nsteps for k, v in msum.items()}
        opt_state, gnorm = opt.step_(grads, state.opt_state, params)
        for p in leaves:
            p.grad = None  # the update was built in the grads; free them
        msum["grad_norm"] = gnorm
        return TrainState(state.step + 1, params, opt_state), msum

    return step
