"""LoRA adapters over the dense or MoE LM: the reference's
`models/lora.py`.

Adapter params are the reference's plain nested dict,
{"layers": {target: {"a": (L, *stack, fan_in, r), "b": (L, *stack, r,
fan_out)}}}, held as torch tensors (numpy arrays are accepted wherever
a consumer reads them); MoE expert weights (L, E, D, F) get per-expert
adapter stacks, A (L, E, D, r) and B (L, E, r, F). `merge_lora` folds
scale·A@B into a copy of the base weights, so the servers serve a
merged model unchanged; per-request adapters on one base are
`inference/multi_lora.py`'s.

Training (`make_lora_module`): adapter params live beside the frozen
base in one tree, {"base": ..., "lora": ...}: one TrainState, one
checkpoint. The loss merges the adapters into the detached base and
calls the base module's loss. The base's tensors do not require
gradients (`param_labels` marks them "frozen"; the optimizer gives them
no moments, no update and no weight decay), so no base gradient is ever
formed. `export_merged` folds the trained adapters back into plain base
params for serving.

On a mesh (`make_train_step(mesh=)`), `lora_logical_axes` is the
reference's: an adapter pair splits its layer axis like its base (over
pp in a pipeline) and an expert stack over ep, and is whole on every
other axis. The loss merges onto the rank's shard of each base leaf
(`merge_lora(plan=)`): A's rows and B's columns are cut to the slice the
shard holds, so the delta matches the shard that `MeshPlan.gather_layer`
then gathers over fsdp. Where the base splits over tp each tp rank forms
only its slice's part of the adapters' gradient, so A and B enter
through `identity_ad` over tp (the backward sums the parts); fsdp's
parts are summed by the step's gradient sum over the data axes, as for
any leaf fsdp does not split.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.parallel import collectives

# target name -> (stack axis names between the layer axis and fan-in,
# number of trailing output dims). Everything between the stack axes and
# the output dims is fan-in.
_DENSE_TARGETS: dict[str, tuple[tuple[str, ...], int]] = {
    "wq": ((), 2), "wk": ((), 2), "wv": ((), 2),  # (L, D, H, Dh)
    "wo": ((), 1),                                 # (L, H, Dh, D)
    "w_gate": ((), 1), "w_up": ((), 1),            # (L, D, F)
    "w_down": ((), 1),                             # (L, F, D)
}
# the MoE family: the expert weights (L, E, ...) get one adapter pair per
# expert
_MOE_TARGETS: dict[str, tuple[tuple[str, ...], int]] = {
    "wq": ((), 2), "wk": ((), 2), "wv": ((), 2),
    "wo": ((), 1),
    "router": ((), 1),                             # (L, D, E)
    "w_gate": (("experts",), 1),                   # (L, E, D, F)
    "w_up": (("experts",), 1),
    "w_down": (("experts",), 1),                   # (L, E, F, D)
}
_TARGETS = {**_DENSE_TARGETS, **_MOE_TARGETS}  # union, for validation

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo")


def _target_table(base_module=transformer
                  ) -> dict[str, tuple[tuple[str, ...], int]]:
    if base_module is transformer:
        return _DENSE_TARGETS
    from cloud_server_tpu_torch.models import moe
    if base_module is moe:
        return _MOE_TARGETS
    raise NotImplementedError(
        f"LoRA target table not defined for module {base_module!r}")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple[str, ...] = DEFAULT_TARGETS

    def __post_init__(self):
        unknown = set(self.targets) - set(_TARGETS)
        if unknown:
            raise ValueError(f"unknown LoRA targets {sorted(unknown)}; "
                             f"valid: {sorted(_TARGETS)}")
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


_SIDECAR = "lora_config.json"


def save_lora_config(checkpoint_dir: str | os.PathLike,
                     cfg: LoRAConfig) -> None:
    """Persist the adapter hyperparameters next to the checkpoint. alpha
    only enters the math at merge time, so an unrecorded training alpha
    would silently rescale the served model."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(os.fspath(checkpoint_dir), _SIDECAR), "w") as f:
        json.dump(dataclasses.asdict(cfg), f)


def load_lora_config(checkpoint_dir: str | os.PathLike) -> LoRAConfig | None:
    path = os.path.join(os.fspath(checkpoint_dir), _SIDECAR)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    data["targets"] = tuple(data["targets"])
    return LoRAConfig(**data)


def add_lora_args(parser) -> None:
    """The one definition of the --lora-* CLI surface (train +
    generate)."""
    parser.add_argument("--lora-rank", type=int, default=0, metavar="R",
                        help="rank-R LoRA adapters (0 = no LoRA)")
    parser.add_argument("--lora-alpha", type=float, default=16.0)
    parser.add_argument("--lora-targets", default=",".join(DEFAULT_TARGETS),
                        help="comma-separated projection names to adapt")


def lora_config_from_args(args) -> LoRAConfig | None:
    if args.lora_rank <= 0:
        return None
    return LoRAConfig(rank=args.lora_rank, alpha=args.lora_alpha,
                      targets=tuple(args.lora_targets.split(",")))


def _split_dims(name: str, shape: tuple[int, ...], table=None
                ) -> tuple[tuple[int, ...], int, int]:
    """(stack dims, fan_in, fan_out) of a stacked (L, *stack, ...) base
    weight, fan-in/out flattened."""
    stack_axes, n_out = (table or _DENSE_TARGETS)[name]
    n_stack = len(stack_axes)
    stack = tuple(shape[1:1 + n_stack])
    fan_in = math.prod(shape[1 + n_stack:-n_out])
    fan_out = math.prod(shape[-n_out:])
    return stack, fan_in, fan_out


def init_lora_params(model_cfg: ModelConfig, lora_cfg: LoRAConfig,
                     seed: int = 0, *, device=None,
                     base_module=transformer) -> dict:
    """A ~ truncated N(0, 1/fan_in), B = 0 — the adapted delta starts at
    exactly 0. The draws come from a torch.Generator seeded with `seed`
    (the reference's distribution, not its values), one target at a
    time in sorted order, on `device` (CUDA unless named). Stacked
    targets (MoE expert weights) get one pair per stack entry: A (L, E,
    fan_in, r), B (L, E, r, fan_out)."""
    table = _target_table(base_module)
    bad = set(lora_cfg.targets) - set(table)
    if bad:
        raise ValueError(
            f"LoRA targets {sorted(bad)} do not exist for this model "
            f"family (valid here: {sorted(table)})")
    device = resolve_device(device)
    dtype = transformer.torch_dtype(model_cfg.param_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    shapes = base_module.param_shapes(model_cfg)["layers"]
    out: dict = {"layers": {}}
    for name in sorted(lora_cfg.targets):
        n_layers = shapes[name][0]
        stack, fan_in, fan_out = _split_dims(name, shapes[name], table)
        a = torch.empty((n_layers, *stack, fan_in, lora_cfg.rank),
                        dtype=torch.float32, device=device)
        a = transformer._trunc_normal_(a, gen).div_(math.sqrt(fan_in))
        b = torch.zeros((n_layers, *stack, lora_cfg.rank, fan_out),
                        dtype=dtype, device=device)
        out["layers"][name] = {"a": a.to(dtype), "b": b}
    return out


def lora_logical_axes(model_cfg: ModelConfig, lora_cfg: LoRAConfig,
                      base_module=transformer) -> dict:
    """The adapter tree's logical axes: the layer axis and the stack axes
    of the base (experts), fan-in, rank and fan-out unnamed (whole)."""
    table = _target_table(base_module)
    out = {}
    for name in sorted(lora_cfg.targets):
        stack_axes = table[name][0]
        out[name] = {"a": ("layers", *stack_axes, None, None),
                     "b": ("layers", *stack_axes, None, None)}
    return {"layers": out}


def _cut(t: torch.Tensor, dim: int, full: tuple, splits: dict, plan):
    """`t` with its dimension `dim` (the flattened `full` dims) cut to
    the rank's block of each split one (`splits`: {index in full: mesh
    axes})."""
    if not splits:
        return t
    shape = list(t.shape)
    t = t.reshape(*shape[:dim], *full, *shape[dim + 1:])
    for j, axes in splits.items():
        for axis in axes:
            n = t.shape[dim + j] // plan.size(axis)
            t = t.narrow(dim + j, plan.rank(axis) * n, n)
    return t.reshape(*shape[:dim], -1, *shape[dim + 1:])


def _shard_adapters(name: str, w: torch.Tensor, a, b, plan, base_axes,
                    table):
    """(A, B) of target `name` cut to the rank's shard `w` of its base
    leaf: A's fan-in rows and B's fan-out columns where the base splits
    them (entering through `identity_ad` over tp when it splits over
    tp)."""
    logical = base_axes["layers"][name]
    n_stack = len(table[name][0])
    n_out = table[name][1]
    full = []
    for d, axis_name in enumerate(logical):
        k = 1
        for axis in ("dp", "pp", "fsdp", "ep", "sp", "tp"):
            if plan.splits_over(axis_name, axis):
                k *= plan.size(axis)
        full.append(w.shape[d] * k)
    fan_in = range(1 + n_stack, len(logical) - n_out)
    fan_out = range(len(logical) - n_out, len(logical))

    def splits(dims):
        out = {}
        for j, d in enumerate(dims):
            axes = [x for x in ("fsdp", "tp", "sp", "dp")
                    if plan.splits_over(logical[d], x) and plan.size(x) > 1]
            if axes:
                out[j] = axes
        return out

    s_in, s_out = splits(fan_in), splits(fan_out)
    if any("tp" in v for v in (*s_in.values(), *s_out.values())):
        a = collectives.identity_ad(a, plan.group("tp"))
        b = collectives.identity_ad(b, plan.group("tp"))
    a = _cut(a, a.dim() - 2, tuple(full[d] for d in fan_in), s_in, plan)
    b = _cut(b, b.dim() - 1, tuple(full[d] for d in fan_out), s_out, plan)
    return a, b


def merge_lora(base: dict, lora: dict, lora_cfg: LoRAConfig,
               dtype=None, plan=None, base_module=transformer) -> dict:
    """base params + scale·A@B on each target: the delta computed in
    `dtype` (the base weight's by default), cast to the weight's dtype
    and added, as the reference merges. Structure-preserving; the base
    dict is not modified (merged leaves are new tensors, the rest are
    shared). One layer's delta at a time, so a full-width merge needs no
    (L, fan_in, fan_out) temporary. On a mesh (`plan`, a
    `transformer.MeshPlan`) `base` and `lora` are the rank's shards and
    each delta is cut to its base shard's slice."""
    merged_layers = dict(base["layers"])
    if plan is not None:
        table = _target_table(base_module)
        base_axes = base_module.param_logical_axes(plan.cfg)
    for name, ab in lora["layers"].items():
        w = base["layers"][name]
        compute = w.dtype if dtype is None else dtype
        a = torch.as_tensor(ab["a"]).to(device=w.device, dtype=compute)
        b = torch.as_tensor(ab["b"]).to(device=w.device, dtype=compute)
        if plan is not None:
            a, b = _shard_adapters(name, w, a, b, plan, base_axes, table)
        out = torch.empty_like(w)
        for layer in range(w.shape[0]):
            delta = (a[layer] @ b[layer]) * lora_cfg.scale
            out[layer] = w[layer] + delta.reshape(w.shape[1:]).to(w.dtype)
        merged_layers[name] = out
    out = dict(base)
    out["layers"] = merged_layers
    return out


def lora_shapes(model_cfg: ModelConfig, lora_cfg: LoRAConfig,
                base_module=transformer) -> dict:
    """The adapter tree's shapes: {"layers": {target: {"a", "b"}}}."""
    table = _target_table(base_module)
    shapes = base_module.param_shapes(model_cfg)["layers"]
    out = {}
    for name in sorted(lora_cfg.targets):
        stack, fan_in, fan_out = _split_dims(name, shapes[name], table)
        n_layers = shapes[name][0]
        out[name] = {"a": (n_layers, *stack, fan_in, lora_cfg.rank),
                     "b": (n_layers, *stack, lora_cfg.rank, fan_out)}
    return {"layers": out}


def export_merged(params: dict, lora_cfg: LoRAConfig) -> dict:
    """{"base", "lora"} TrainState params -> plain servable base params."""
    return merge_lora(params["base"], params["lora"], lora_cfg)


def make_lora_module(lora_cfg: LoRAConfig, base_module=transformer,
                     base_params: dict | None = None):
    """A loss-function module (the protocol of `models.transformer` and
    `models.moe`: `param_shapes`, `init_params`, `next_token_loss`) that
    trains only adapters, plus `param_labels` (the optimizer's freeze
    mask).

    base_params: pretrained weights to adapt (the fine-tuning case); None
    random-inits the base from the seed."""
    _target_table(base_module)  # raises for unknown module families

    def _labels(tree, label):
        return {k: _labels(v, label) if isinstance(v, dict) else label
                for k, v in tree.items()}

    class module:
        lora_config = lora_cfg

        @staticmethod
        def param_logical_axes(cfg: ModelConfig) -> dict:
            return {"base": base_module.param_logical_axes(cfg),
                    "lora": lora_logical_axes(cfg, lora_cfg, base_module)}

        @staticmethod
        def param_shapes(cfg: ModelConfig) -> dict:
            return {"base": base_module.param_shapes(cfg),
                    "lora": lora_shapes(cfg, lora_cfg, base_module)}

        @staticmethod
        def init_params(cfg: ModelConfig, seed: int = 0, *,
                        device=None) -> dict:
            """The base (`base_params`, or drawn from `seed`) and fresh
            adapters (drawn from seed + 1)."""
            base = (base_params if base_params is not None
                    else base_module.init_params(cfg, seed, device=device))
            return {"base": base,
                    "lora": init_lora_params(cfg, lora_cfg, seed + 1,
                                             device=device,
                                             base_module=base_module)}

        @staticmethod
        def param_labels(cfg: ModelConfig) -> dict:
            """Optimizer labels: base frozen, adapters trained."""
            shapes = module.param_shapes(cfg)
            return {"base": _labels(shapes["base"], "frozen"),
                    "lora": _labels(shapes["lora"], "trainable")}

        @staticmethod
        def next_token_loss(params: dict, batch: dict, cfg: ModelConfig,
                            plan=None, **kwargs):
            frozen = _detached(params["base"])
            merged = merge_lora(frozen, params["lora"], lora_cfg, plan=plan,
                                base_module=base_module)
            if plan is not None:
                kwargs["plan"] = plan
            return base_module.next_token_loss(merged, batch, cfg, **kwargs)

    module.base_module = base_module
    module.base_params = base_params
    return module


def _detached(tree):
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}
