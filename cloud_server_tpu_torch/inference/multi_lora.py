"""Multi-LoRA serving: many adapters live on one base model, selected
PER REQUEST.

A port of the reference's `inference/multi_lora.py`. All registered
adapters stack into one device tensor per target — A: (cap, L, fan_in,
r_cap), B: (cap, L, r_cap, fan_out), f32, plus `scales` (cap,) — with
row 0 the NULL adapter (zeros: its delta is exactly 0) and ranks
zero-padded to the set's `r_cap` (padding contributes nothing to A@B).
Each slot of the continuous batch carries an adapter id; every program
gathers its per-row (a, b, scale) per layer (`layer_lora`) and the model
applies the low-rank delta where a merged weight would land
(`transformer.lora_row_delta`).

Captured programs read the stacks by address, so the set keeps its
tensors in place for as long as it can:

  * an `add` that fits the capacity (a free row, a rank within `r_cap`)
    writes the new adapter's rows into the existing tensors, and
    programs captured before it see it;
  * an `add` that does not fit (the first, a full set, a larger rank)
    restacks into new tensors with geometric headroom (`rebuilds`
    counts these, as the reference's do), and one that brings a target
    no earlier adapter had adds a zero stack for it. Both advance
    `generation`: the server releases the programs that read the old
    generation once the dispatch in flight has committed.

Dense targets only (wq/wk/wv/wo/w_gate/w_up/w_down); adapters may target
different subsets and use different ranks/alphas.
"""

from __future__ import annotations

import numpy as np
import torch

from cloud_server_tpu_torch.config import ModelConfig
from cloud_server_tpu_torch.models.lora import (_DENSE_TARGETS, LoRAConfig,
                                                _split_dims)
from cloud_server_tpu_torch.models.transformer import param_shapes


def _host(x) -> np.ndarray:
    """An adapter leaf (torch tensor or array-like) as an f32 numpy
    array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.array(x, np.float32)  # a private, writable copy


class AdapterSet:
    """Registry + stacked device tensors for per-request LoRA serving.

    `add` returns the adapter id (>= 1; 0 is the null adapter) and
    updates the device tensors — a rare, admission-path operation.
    """

    def __init__(self, model_cfg: ModelConfig, device=None):
        self.model_cfg = model_cfg
        self.device = torch.device("cpu" if device is None else device)
        self._names: list[str] = []
        self._ids: dict[str, int] = {}
        self._raw: list[tuple[dict, LoRAConfig]] = []
        self.stacks: dict | None = None  # {target: {"a", "b"}} on device
        self.scales: torch.Tensor | None = None  # (cap,) f32
        # stacks carry CAPACITY rows (geometric growth) and a rank
        # headroom, so a typical add is one row write of the new adapter
        self._cap = 0     # allocated adapter rows incl. the null row
        self._r_cap = 0   # allocated rank (stacks' r dimension)
        self.rebuilds = 0  # full restacks performed (observability)
        # advances whenever a stack tensor is replaced (programs that
        # read the set must be captured again)
        self.generation = 0

    def __len__(self) -> int:
        return len(self._names)

    @property
    def names(self) -> list[str]:
        return list(self._names)

    def adapter_id(self, name: str) -> int | None:
        return self._ids.get(name)

    def nbytes(self) -> int:
        """Device bytes of the stacks and scales (0 while empty)."""
        if self.stacks is None:
            return 0
        n = sum(t.numel() * t.element_size()
                for ab in self.stacks.values() for t in ab.values())
        return n + self.scales.numel() * self.scales.element_size()

    def add(self, name: str, lora_params: dict, lora_cfg: LoRAConfig
            ) -> int:
        if name in self._ids:
            raise ValueError(f"adapter {name!r} already registered")
        bad = set(lora_cfg.targets) - set(_DENSE_TARGETS)
        if bad:
            raise ValueError(
                f"multi-LoRA serving supports dense targets only; "
                f"{sorted(bad)} are not servable per-request")
        layers = lora_params.get("layers", lora_params)
        missing = set(lora_cfg.targets) - set(layers)
        if missing:
            raise ValueError(f"adapter {name!r} missing params for "
                             f"targets {sorted(missing)}")
        # validate against the MODEL's shapes: a self-consistent but
        # wrong-sized adapter would otherwise register fine and fail at
        # the first dispatch
        shapes = param_shapes(self.model_cfg)["layers"]
        host = {}
        for t in lora_cfg.targets:
            n_layers = shapes[t][0]
            _, fan_in, fan_out = _split_dims(t, shapes[t])
            a = _host(layers[t]["a"])
            b = _host(layers[t]["b"])
            want_a = (n_layers, fan_in, lora_cfg.rank)
            want_b = (n_layers, lora_cfg.rank, fan_out)
            if a.shape != want_a or b.shape != want_b:
                raise ValueError(
                    f"adapter {name!r} target {t!r}: a{a.shape}/"
                    f"b{b.shape} do not match the base model's "
                    f"{want_a}/{want_b}")
            host[t] = {"a": a, "b": b}
        # validation is complete: the fast path mutates in place, the
        # rebuild path builds from a candidate list first, so a failure
        # leaves the registry untouched
        new_id = len(self._raw) + 1
        raw2 = self._raw + [(host, lora_cfg)]
        fits = (self.stacks is not None
                and new_id + 1 <= self._cap
                and lora_cfg.rank <= self._r_cap)
        if fits:
            self._write_row(new_id, host, lora_cfg)
        else:
            self._rebuild(raw2)  # with geometric headroom
        self._names.append(name)
        self._ids[name] = new_id  # id 0 = null adapter
        self._raw = raw2
        return new_id

    def _zero_stack(self, t: str) -> dict[str, torch.Tensor]:
        """Capacity-sized all-zero (= null-adapter) stacks for one
        target, shaped from the base model."""
        shape = param_shapes(self.model_cfg)["layers"][t]
        _, fan_in, fan_out = _split_dims(t, shape)
        return {"a": torch.zeros((self._cap, shape[0], fan_in, self._r_cap),
                                 dtype=torch.float32, device=self.device),
                "b": torch.zeros((self._cap, shape[0], self._r_cap, fan_out),
                                 dtype=torch.float32, device=self.device)}

    def _write_row(self, i: int, layers: dict, cfg: LoRAConfig) -> None:
        """O(one adapter) admission: the new adapter's rows written into
        the device stacks in place (rank columns past its own stay
        zero), so programs captured against these tensors serve it. A
        target nobody used yet gets a fresh zero stack first (earlier
        adapters' rows in it are correctly the null adapter): not a
        restack, but new tensors, so `generation` advances. The stacks
        dict is swapped whole, never mutated under a reader."""
        stacks = dict(self.stacks)
        new_target = False
        for t in cfg.targets:
            if t not in stacks:
                stacks[t] = self._zero_stack(t)
                new_target = True
            ab = stacks[t]
            ab["a"][i, :, :, :cfg.rank].copy_(
                torch.from_numpy(layers[t]["a"]))
            ab["b"][i, :, :cfg.rank, :].copy_(
                torch.from_numpy(layers[t]["b"]))
        self.scales[i] = cfg.scale
        self.stacks = stacks
        if new_target:
            self.generation += 1

    def _rebuild(self, raw) -> None:
        """Full restack into new tensors (first add, capacity exhausted,
        a rank above the allocated headroom, or a target the stacks do
        not hold): capacity doubles so rebuilds amortize to O(1)
        restacked rows per add."""
        self.rebuilds += 1
        r_max = max(cfg.rank for _, cfg in raw)
        targets = sorted({t for _, cfg in raw for t in cfg.targets})
        n = len(raw) + 1
        cap = r_cap = 1
        while cap < max(n, 4):
            cap *= 2
        while r_cap < r_max:
            r_cap *= 2
        stacks: dict[str, dict[str, torch.Tensor]] = {}
        for t in targets:
            # shapes from the first adapter carrying the target
            ref = next(layers[t] for layers, cfg in raw
                       if t in cfg.targets)
            n_layers, fan_in, _ = ref["a"].shape
            fan_out = ref["b"].shape[-1]
            a = np.zeros((cap, n_layers, fan_in, r_cap), np.float32)
            b = np.zeros((cap, n_layers, r_cap, fan_out), np.float32)
            for i, (layers, cfg) in enumerate(raw, start=1):
                if t in cfg.targets:
                    a[i, :, :, :cfg.rank] = layers[t]["a"]
                    b[i, :, :cfg.rank, :] = layers[t]["b"]
            stacks[t] = {"a": torch.from_numpy(a).to(self.device),
                         "b": torch.from_numpy(b).to(self.device)}
        scales = np.zeros((cap,), np.float32)
        scales[0] = 1.0
        scales[1:n] = [cfg.scale for _, cfg in raw]
        self.stacks = stacks
        self.scales = torch.from_numpy(scales).to(self.device)
        self._cap = cap
        self._r_cap = r_cap
        self.generation += 1

    def device_args(self):
        """(stacks, scales) to pass into a dispatch (None when empty)."""
        if not self._raw:
            return None
        return (self.stacks, self.scales)


def layer_lora(adapters, aid: torch.Tensor, layer_idx: int):
    """Per-layer, per-row adapter gather for `transformer.*(lora=...)`.

    adapters: (stacks, scales) from AdapterSet.device_args; aid: (B,)
    int adapter ids. Returns {target: (a (B, fan_in, r),
    b (B, r, fan_out), scale (B,))}."""
    if adapters is None:
        return None
    stacks, scales = adapters
    aid = aid.long()
    s = scales[aid]
    return {t: (ab["a"][aid, layer_idx], ab["b"][aid, layer_idx], s)
            for t, ab in stacks.items()}
