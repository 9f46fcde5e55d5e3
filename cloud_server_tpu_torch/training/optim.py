"""Optimizer: AdamW with global-norm clipping and the reference's
learning-rate schedules.

`fused_adamw` is the reference's single-pass AdamW (== optax.chain(
clip_by_global_norm, adamw) with weight decay masked off norm scales):
bias correction with t starting at 1, the schedule evaluated at the
pre-increment count, eps outside the sqrt. Here it is PyTorch's fused
AdamW (`torch._fused_adamw_`, one read and write of parameters,
gradients and moments), called once for the decayed leaves and once for
the norm scales, with the clip folded in as its `grad_scale`. It updates
parameters and moments IN PLACE under torch.no_grad(): where the
reference's jitted step donates the old state to XLA, the port
overwrites it. The optimizer is plain jnp in the reference, not a TPU
kernel, so a library call stands in for it.

The schedule is evaluated on the host from a Python step count (no
device read per step); its values agree with optax's float32 ones to
float32 rounding.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from cloud_server_tpu_torch.config import TrainConfig

Schedule = Callable[[int], float]


def flatten(tree: dict, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict in sorted-key order (the order
    of the reference's jax.tree flattening), paths '/'-joined."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            out.extend(flatten(tree[k], path))
        else:
            out.append((path, tree[k]))
    return out


def map_tree(fn, tree: dict) -> dict:
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _decay_mask(params: dict) -> list[bool]:
    """Per flattened leaf: decayed unless its path names a norm."""
    return ["norm" not in path for path, _ in flatten(params)]


# ---------------------------------------------------------------------------
# Schedules (optax's, as the reference composes them)
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _constant(value: float) -> Schedule:
    return lambda count: value


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def make_schedule(cfg: TrainConfig) -> Schedule:
    """count -> learning rate, as the reference's `make_schedule`."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "warmup_cosine":
        decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1)
        end = lr * 0.1
        alpha = 0.0 if lr == 0.0 else end / lr
        return _join([_linear(0.0, lr, cfg.warmup_steps),
                      _cosine(lr, decay_steps - cfg.warmup_steps, alpha)],
                     [cfg.warmup_steps])
    if cfg.lr_schedule == "constant":
        return _join([_linear(0.0, lr, max(1, cfg.warmup_steps)),
                      _constant(lr)], [cfg.warmup_steps])
    if cfg.lr_schedule == "wsd":
        # warmup -> stable at peak -> linear cooldown to 1% over the last
        # lr_decay_frac of total_steps
        decay_steps = max(1, int(cfg.total_steps * cfg.lr_decay_frac))
        stable_steps = max(0, cfg.total_steps - cfg.warmup_steps
                           - decay_steps)
        return _join([_linear(0.0, lr, max(1, cfg.warmup_steps)),
                      _constant(lr),
                      _linear(lr, lr * 0.01, decay_steps)],
                     [cfg.warmup_steps, cfg.warmup_steps + stable_steps])
    raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule!r}")


# ---------------------------------------------------------------------------
# Fused AdamW
# ---------------------------------------------------------------------------


class FusedAdamWState(NamedTuple):
    count: int  # number of completed updates
    mu: dict
    nu: dict


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every element of every tensor (a 0-d
    float32 tensor on their device; no host read)."""
    norms = torch._foreach_norm(tensors)
    return torch.linalg.vector_norm(torch.stack(norms).float())


def _f32(x: float) -> float:
    """x rounded to float32, as the reference computes its scalars."""
    return float(torch.tensor(x, dtype=torch.float32))


class FusedAdamW:
    """Single-pass AdamW == clip_by_global_norm + adamw(mask=norm-free)."""

    def __init__(self, cfg: TrainConfig, eps: float = 1e-8):
        self.cfg = cfg
        self.eps = eps
        self.schedule = make_schedule(cfg)

    def init(self, params: dict) -> FusedAdamWState:
        def zeros(p):
            return torch.zeros_like(p, memory_format=torch.contiguous_format)
        return FusedAdamWState(count=0, mu=map_tree(zeros, params),
                               nu=map_tree(zeros, params))

    @torch.no_grad()
    def step_(self, grads: dict, state: FusedAdamWState,
              params: dict) -> tuple[FusedAdamWState, torch.Tensor]:
        """Apply one update in place to `params` and the moments of
        `state`; `grads` are consumed. Returns (new state, the global norm
        of `grads` before clipping)."""
        cfg = self.cfg
        g = [t for _, t in flatten(grads)]
        m = [t for _, t in flatten(state.mu)]
        v = [t for _, t in flatten(state.nu)]
        p = [t for _, t in flatten(params)]
        gnorm = global_norm(g)
        # optax.clip_by_global_norm scales by clip/norm when norm > clip;
        # the fused kernel divides the gradients by grad_scale as it reads
        # them, so grad_scale = max(norm / clip, 1)
        grad_scale = torch.clamp(
            torch.clamp(gnorm, min=1e-30) / cfg.grad_clip_norm, min=1.0)
        count_inc = state.count + 1
        # the schedule sees the pre-increment count; bias correction the
        # post-increment one
        lr = _f32(self.schedule(state.count))
        step = torch.full((), float(count_inc), dtype=torch.float32,
                          device=gnorm.device)
        decayed = _decay_mask(params)
        for group, weight_decay in ((True, cfg.weight_decay), (False, 0.0)):
            idx = [i for i, d in enumerate(decayed) if d == group]
            if idx:
                torch._fused_adamw_(
                    [p[i] for i in idx], [g[i] for i in idx],
                    [m[i] for i in idx], [v[i] for i in idx], [],
                    [step] * len(idx), lr=lr, beta1=cfg.beta1,
                    beta2=cfg.beta2, weight_decay=weight_decay, eps=self.eps,
                    amsgrad=False, maximize=False, grad_scale=grad_scale)
        return FusedAdamWState(count_inc, state.mu, state.nu), gnorm


def fused_adamw(cfg: TrainConfig, eps: float = 1e-8) -> FusedAdamW:
    return FusedAdamW(cfg, eps)


# ---------------------------------------------------------------------------
# EMA of the parameters
# ---------------------------------------------------------------------------


class EmaState(NamedTuple):
    ema: dict  # params-like, always float32


class EmaOfParams:
    """Exponential moving average of the post-update params, initialised
    at the initial params, accumulated in float32 (a bf16 average would
    stay frozen at its init for decays near 1)."""

    def __init__(self, decay: float):
        self.decay = decay

    def init(self, params: dict) -> EmaState:
        return EmaState(map_tree(
            lambda p: p.detach().to(torch.float32, copy=True), params))

    @torch.no_grad()
    def step_(self, state: EmaState, params: dict) -> EmaState:
        e = [t for _, t in flatten(state.ema)]
        p = [t.float() for _, t in flatten(params)]
        torch._foreach_mul_(e, self.decay)
        torch._foreach_add_(e, p, alpha=1.0 - self.decay)
        return state


def ema_of_params(decay: float) -> EmaOfParams:
    return EmaOfParams(decay)


class Optimizer:
    """AdamW, then the EMA when cfg.ema_decay > 0. State: the AdamW
    state, or (AdamW state, EmaState)."""

    def __init__(self, cfg: TrainConfig):
        self.adamw = fused_adamw(cfg)
        self.ema = ema_of_params(cfg.ema_decay) if cfg.ema_decay > 0 else None

    def init(self, params: dict):
        state = self.adamw.init(params)
        if self.ema is None:
            return state
        return (state, self.ema.init(params))

    def step_(self, grads: dict, state, params: dict):
        """In-place update; returns (new state, grad global norm)."""
        if self.ema is None:
            return self.adamw.step_(grads, state, params)
        adam, ema = state
        adam, gnorm = self.adamw.step_(grads, adam, params)
        return (adam, self.ema.step_(ema, params)), gnorm


def ema_params(opt_state):
    """The EMA param tree of an optimizer state, or None without EMA."""
    if isinstance(opt_state, tuple) and not isinstance(opt_state,
                                                       FusedAdamWState):
        for part in opt_state:
            if isinstance(part, EmaState):
                return part.ema
    return None


def make_optimizer(cfg: TrainConfig, param_labels=None) -> Optimizer:
    """param_labels (LoRA's trainable/frozen split) is not ported yet."""
    if param_labels is not None:
        raise NotImplementedError("param_labels (LoRA fine-tuning) is not "
                                  "ported yet")
    return Optimizer(cfg)
