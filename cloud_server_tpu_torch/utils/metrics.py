"""Training metrics: FLOP accounting, step timing, windowed aggregation.

MFU follows the PaLM-style accounting of the reference: matmul
FLOPs/token = 6·N (2·N forward, 4·N backward) plus causal attention
score/value FLOPs; the denominator is the device's peak dense bf16
FLOP/s, looked up from its name.
"""

from __future__ import annotations

import collections
import time
from typing import Any

import torch

from cloud_server_tpu_torch.config import ModelConfig

# Peak dense bf16 FLOP/s per device, by name prefix.
DEVICE_PEAK_FLOPS: dict[str, float] = {
    "NVIDIA H100": 989e12,  # data sheet, SXM, dense bf16
    "cpu": 1e11,  # nominal; keeps MFU finite in CPU runs
}


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def peak_flops_per_device(device, default: float = 989e12) -> float:
    kind = device_name(device).lower()
    for name, peak in DEVICE_PEAK_FLOPS.items():
        if kind.startswith(name.lower()):
            return peak
    return default


def param_count(params: Any) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(params.numel())


def transformer_flops_per_token(cfg: ModelConfig, seq_len: int,
                                n_params: int | None = None,
                                training: bool = True) -> float:
    """Matmul FLOPs per token for one step (fwd+bwd when training).

    6·N_matmul covers every weight matmul (the embedding lookup is a
    gather, so the lm_head is counted explicitly); attention adds
    2·2·S·H·Dh per token forward, halved for causality, tripled for bwd.
    """
    if n_params is None:
        D, L = cfg.embed_dim, cfg.num_layers
        per_layer = (D * cfg.num_heads * cfg.head_dim * 2  # wq, wo
                     + D * cfg.num_kv_heads * cfg.head_dim * 2  # wk, wv
                     + 3 * D * cfg.mlp_dim)  # gate, up, down
        n_params = L * per_layer + D * cfg.vocab_size  # + lm_head/tied
    mult = 3.0 if training else 1.0
    weight = 2.0 * mult * n_params
    attn = (2.0 * mult * 2 * seq_len * cfg.num_heads * cfg.head_dim
            * cfg.num_layers * 0.5)  # 0.5: causal
    return weight + attn


class StepTimer:
    """Wall-clock per-step timing -> tokens/sec and MFU.

    Call `tick(tokens_processed)` after the step's results were read on
    the host (a device result read synchronises; the device runs behind
    the host otherwise). Keeps a sliding window so throughput reflects
    steady state, not the first steps.
    """

    def __init__(self, *, flops_per_token: float | None = None,
                 n_devices: int = 1, peak_flops: float | None = None,
                 device="cpu", window: int = 20):
        self.flops_per_token = flops_per_token
        self.n_devices = n_devices
        self.peak_flops = peak_flops or peak_flops_per_device(device)
        self._times: collections.deque = collections.deque(maxlen=window + 1)
        self._tokens: collections.deque = collections.deque(maxlen=window)
        self._times.append(time.perf_counter())

    def tick(self, tokens: int) -> dict[str, float]:
        self._times.append(time.perf_counter())
        self._tokens.append(tokens)
        dt = self._times[-1] - self._times[0]
        toks = sum(self._tokens)
        out = {"step_time_s": self._times[-1] - self._times[-2],
               "tokens_per_sec": toks / dt if dt > 0 else 0.0}
        if self.flops_per_token:
            out["mfu"] = (out["tokens_per_sec"] * self.flops_per_token
                          / (self.peak_flops * self.n_devices))
        return out


class MetricAggregator:
    """Mean-aggregates scalar metrics between log flushes. Device scalars
    are read on the host only at flush, so steps stay asynchronous."""

    def __init__(self):
        self._sums: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self._pending: list[dict] = []

    def update(self, metrics: dict[str, Any]) -> None:
        self._pending.append(metrics)

    def flush(self) -> dict[str, float]:
        for metrics in self._pending:
            for k, v in metrics.items():
                v = float(v)
                self._sums[k] = self._sums.get(k, 0.0) + v
                self._counts[k] = self._counts.get(k, 0) + 1
        self._pending.clear()
        out = {k: self._sums[k] / self._counts[k] for k in self._sums}
        self._sums.clear()
        self._counts.clear()
        return out
