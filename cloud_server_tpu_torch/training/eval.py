"""Evaluation: an eval step and a token-weighted sweep over batches.

The eval step reuses the model's `next_token_loss` with every auxiliary
coefficient at zero, so the reported number is pure token-level
cross-entropy; perplexity is exp(mean nll). Batches are weighted by
their masked token counts, so the result does not depend on batch size.
With `ce_impl="pallas"` the loss runs the fused CE forward (B7) alone:
no backward, no (N, V) logits.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Iterable

import torch

from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models import moe, transformer


def make_eval_step(model_cfg: ModelConfig, loss_fn: Callable | None = None,
                   loss_fn_module=None, mesh=None, rules=None):
    """eval_step(params, batch) -> {"nll_sum", "n_tokens", "n_correct"}:
    sums (0-d float32 tensors on the batch's device, not read on the
    host), so the caller aggregates exactly across batches of different
    masked sizes. Runs under torch.no_grad.

    `loss_fn` ((params, batch, cfg) -> (loss, metrics with "loss" and
    "accuracy")) keeps eval on the objective of a custom training loss;
    without it, `loss_fn_module`'s (the family of model_cfg by default;
    its "loss" metric is the CE alone for every family).

    `mesh`: the DeviceMesh this rank evaluates on (its params the
    rank's shards, its batch the rank's block; the loss is called with
    `plan=`, over `rules`, as in the train step); the sums are the
    global batch's, equal on every rank."""
    loss_fn = loss_fn or (loss_fn_module
                          or moe.module_for(model_cfg)).next_token_loss
    plan = None if mesh is None else transformer.MeshPlan(mesh, model_cfg,
                                                             rules)
    on_mesh = {} if plan is None else {"plan": plan}

    def count(batch):
        tokens = batch["tokens"]
        mask = batch.get("mask")
        if plan is None:
            if mask is None:
                return torch.tensor(
                    float(tokens.shape[0] * (tokens.shape[1] - 1)),
                    device=tokens.device)
            return mask[:, 1:].float().sum()
        # the whole rows' count, once per row (sp rank 0's)
        whole = plan.whole_rows(torch.ones_like(tokens) if mask is None
                                else mask)
        n = whole[:, 1:].float().sum()
        return plan.psum_data(n if plan.rank("sp") == 0 else n * 0)

    @torch.no_grad()
    def step(params, batch):
        _, metrics = loss_fn(params, batch, model_cfg, **on_mesh)
        n = count(batch)
        # "loss" is the CE alone (the z-loss is added to the returned loss)
        return {"nll_sum": metrics["loss"] * n, "n_tokens": n,
                "n_correct": metrics["accuracy"] * n}

    return step


def evaluate(params, batches: Iterable[dict], eval_step,
             max_batches: int | None = None) -> dict[str, float]:
    """Sweep `batches` through `eval_step`; return token-weighted
    eval_loss, eval_ppl, eval_accuracy and eval_tokens (NaNs, and 0
    tokens, for an empty sweep). Stops after `max_batches` if given."""
    nll = n_tokens = n_correct = 0.0
    if max_batches is not None:
        batches = itertools.islice(batches, max_batches)
    for batch in batches:
        out = eval_step(params, batch)
        nll += float(out["nll_sum"])
        n_tokens += float(out["n_tokens"])
        n_correct += float(out["n_correct"])
    if n_tokens == 0:
        return {"eval_loss": float("nan"), "eval_ppl": float("nan"),
                "eval_accuracy": float("nan"), "eval_tokens": 0.0}
    mean_nll = nll / n_tokens
    return {"eval_loss": mean_nll,
            "eval_ppl": math.exp(min(mean_nll, 30.0)),
            "eval_accuracy": n_correct / n_tokens,
            "eval_tokens": n_tokens}
