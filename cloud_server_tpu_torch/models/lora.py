"""LoRA adapters over the dense LM: the serving half of the reference's
`models/lora.py`.

Adapter params are the reference's plain nested dict,
{"layers": {target: {"a": (L, fan_in, r), "b": (L, r, fan_out)}}}, held
as torch tensors (numpy arrays are accepted wherever a consumer reads
them). `merge_lora` folds scale·A@B into a copy of the base weights, so
the paged server serves a merged model unchanged; per-request adapters
on one base are `inference/multi_lora.py`'s.

The training half (`make_lora_module`, `lora_logical_axes`,
`export_merged`, `param_labels` and the `--lora-*` CLI) is not ported
yet. MoE targets (per-expert adapters) wait for the MoE model: their
target table raises NotImplementedError.
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

# target name -> (stack axis names between the layer axis and fan-in,
# number of trailing output dims). Everything between the stack axes and
# the output dims is fan-in.
_DENSE_TARGETS: dict[str, tuple[tuple[str, ...], int]] = {
    "wq": ((), 2), "wk": ((), 2), "wv": ((), 2),  # (L, D, H, Dh)
    "wo": ((), 1),                                 # (L, H, Dh, D)
    "w_gate": ((), 1), "w_up": ((), 1),            # (L, D, F)
    "w_down": ((), 1),                             # (L, F, D)
}
# the reference's MoE table: names LoRAConfig accepts; adapters for them
# need the MoE model
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
    raise NotImplementedError(
        f"LoRA target table not defined for module {base_module!r} (MoE "
        "adapters are not ported yet)")


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
    time in sorted order, on `device` (CUDA unless named)."""
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
    shapes = transformer.param_shapes(model_cfg)["layers"]
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


def merge_lora(base: dict, lora: dict, lora_cfg: LoRAConfig,
               dtype=None) -> dict:
    """base params + scale·A@B on each target: the delta computed in
    `dtype` (the base weight's by default), cast to the weight's dtype
    and added, as the reference merges. Structure-preserving; the base
    dict is not modified (merged leaves are new tensors, the rest are
    shared). One layer's delta at a time, so a full-width merge needs no
    (L, fan_in, fan_out) temporary."""
    merged_layers = dict(base["layers"])
    for name, ab in lora["layers"].items():
        w = base["layers"][name]
        compute = w.dtype if dtype is None else dtype
        a = torch.as_tensor(ab["a"]).to(device=w.device, dtype=compute)
        b = torch.as_tensor(ab["b"]).to(device=w.device, dtype=compute)
        out = torch.empty_like(w)
        for layer in range(w.shape[0]):
            delta = (a[layer] @ b[layer]) * lora_cfg.scale
            out[layer] = w[layer] + delta.reshape(w.shape[1:]).to(w.dtype)
        merged_layers[name] = out
    out = dict(base)
    out["layers"] = merged_layers
    return out
