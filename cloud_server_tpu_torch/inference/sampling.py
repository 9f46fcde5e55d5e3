"""Token sampling: greedy / temperature / top-k / top-p (/ min-p).

Two tiers share one filter chain, as in the reference:

  * Server-global (`InferConfig` scalars): `sample_logits`, drawing from
    one threefry key per call; `sampling_probs` / `sample_from_probs`,
    the same distribution as probabilities (speculation's accept rule).
  * Per-request (`SamplingParams` -> `SamplingRows`, one value per
    slot): `filtered_logits_rows` / `sample_logits_rows`, and
    `sampling_probs_rows`.

Random draws. The per-request path draws exactly as the reference's
`jax.vmap(jax.random.categorical)(keys, filtered)` does: row i's key is
`fold_in(key(seed_i), position_i)` and its token is
argmax(filtered + gumbel(key, (V,))), both from jax.random's threefry2x32
ported bit for bit (`utils/prng.py`, on the logits' device). A seeded
request's tokens are therefore the reference's, token for token, and
depend only on (seed, position), never on the rest of the batch.
The server-global path draws as the reference's
`jax.random.categorical(key, filtered)` does: argmax(filtered +
gumbel(key, (rows, V))), one key for the whole (rows, V) draw. The
server splits its key where the reference's splits (once per dispatch,
then per half and per round), and stages the reference's rows, so its
seeded server-global tokens are the reference's too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from cloud_server_tpu_torch.config import InferConfig
from cloud_server_tpu_torch.utils import prng

NEG_INF = -1e30
MAX_LOGIT_BIAS = 64
_BIAS_PAD = 2 ** 30


# ---------------------------------------------------------------------------
# Server-global path
# ---------------------------------------------------------------------------


def _apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    cutoff = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < cutoff, NEG_INF, logits)


def _apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    keep[..., 0] = True
    cutoff = torch.where(keep, sorted_logits, math.inf).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < cutoff, NEG_INF, logits)


def _filtered_logits(logits: torch.Tensor, cfg: InferConfig) -> torch.Tensor:
    x = logits / cfg.temperature
    if cfg.top_k > 0:
        x = _apply_top_k(x, cfg.top_k)
    if cfg.top_p < 1.0:
        x = _apply_top_p(x, cfg.top_p)
    return x


def sample_logits(logits: torch.Tensor, key: torch.Tensor,
                  cfg: InferConfig) -> torch.Tensor:
    """logits: (B, V) f32 -> (B,) int64 token ids; `key` is one (2,)
    threefry key on the logits' device (`utils/prng.py`)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return prng.categorical(key, _filtered_logits(logits, cfg))


def sampling_probs(logits: torch.Tensor, cfg: InferConfig) -> torch.Tensor:
    """The distribution `sample_logits` draws from: (..., V) f32
    probabilities after temperature / top-k / top-p (one-hot argmax for
    greedy). Speculation's accept rule measures acceptance against it."""
    if cfg.temperature <= 0.0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, dim=-1), logits.shape[-1]).float()
    return torch.softmax(_filtered_logits(logits, cfg), dim=-1)


def sample_from_probs(probs: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Categorical draw from (..., V) probabilities with one key ->
    (...,) int64, as the reference's over log(max(p, 1e-30))."""
    return prng.categorical(key, torch.log(torch.clamp(probs, min=1e-30)))


# ---------------------------------------------------------------------------
# Per-request path (SamplingParams -> SamplingRows)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls (every field optional; `None` and
    the neutral defaults inherit the server's `InferConfig`). The fields
    and their validation are the reference's.

    `stop` holds TOKEN-ID sequences: generation ends with finish_reason
    "stop" when the output's tail equals one of them, and the matched
    tokens are removed from the result."""

    temperature: float | None = None
    top_k: int | None = None
    top_p: float | None = None
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: int | None = None
    stop: tuple[tuple[int, ...], ...] = ()
    ignore_eos: bool = False
    logit_bias: tuple[tuple[int, float], ...] = ()
    min_tokens: int = 0
    regex: str | None = None

    def __post_init__(self):
        if self.temperature is not None and self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k is not None and not -2 ** 31 < self.top_k < 2 ** 31:
            raise ValueError("top_k out of int32 range")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if not 0.0 <= self.min_p < 1.0:
            raise ValueError("min_p must be in [0, 1)")
        if self.repetition_penalty <= 0.0:
            raise ValueError("repetition_penalty must be > 0")
        if self.seed is not None and not 0 <= self.seed < 2 ** 32:
            raise ValueError("seed must be in [0, 2**32)")
        stop = tuple(tuple(int(t) for t in s) for s in self.stop)
        if any(len(s) == 0 for s in stop):
            raise ValueError("empty stop sequence")
        object.__setattr__(self, "stop", stop)
        bias = tuple((int(t), float(b)) for t, b in self.logit_bias)
        if len(bias) > MAX_LOGIT_BIAS:
            raise ValueError(f"at most {MAX_LOGIT_BIAS} logit_bias entries")
        if any(t < 0 or not math.isfinite(b) for t, b in bias):
            raise ValueError("logit_bias needs token ids >= 0 and finite "
                             "biases")
        object.__setattr__(self, "logit_bias", bias)
        if not 0 <= self.min_tokens < 2 ** 31:
            raise ValueError("min_tokens must be a small non-negative int")
        if self.regex is not None and (self.min_tokens > 0
                                       or self.ignore_eos):
            raise ValueError(
                "regex cannot be combined with min_tokens or ignore_eos "
                "(the grammar decides when generation may end)")

    def needs_device_rows(self, cfg: InferConfig) -> bool:
        """True when this request's device-side sampling differs from the
        server defaults (stop/ignore_eos are host-side)."""
        return ((self.temperature is not None
                 and self.temperature != cfg.temperature)
                or (self.top_k is not None and self.top_k != cfg.top_k)
                or (self.top_p is not None and self.top_p != cfg.top_p)
                or self.min_p > 0.0
                or self.needs_penalty_state()
                or self.seed is not None
                or bool(self.logit_bias)
                or self.min_tokens > 0
                or self.regex is not None)

    def needs_penalty_state(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)

    def resolve(self, cfg: InferConfig, default_seed: int) -> tuple:
        ids = [t for t, _ in self.logit_bias]
        vals = [b for _, b in self.logit_bias]
        pad = MAX_LOGIT_BIAS - len(ids)
        return (
            cfg.temperature if self.temperature is None else self.temperature,
            cfg.top_k if self.top_k is None else self.top_k,
            cfg.top_p if self.top_p is None else self.top_p,
            self.min_p, self.repetition_penalty, self.presence_penalty,
            self.frequency_penalty,
            default_seed if self.seed is None else self.seed,
            ids + [_BIAS_PAD] * pad, vals + [0.0] * pad, self.min_tokens)


class SamplingRows(NamedTuple):
    """Per-slot sampling parameters, one row per slot: numpy on the host
    (`make_rows`), tensors on the device (`rows_to`)."""

    temperature: np.ndarray  # (B,) f32; <= 0 means greedy for that row
    top_k: np.ndarray        # (B,) i32; <= 0 disables
    top_p: np.ndarray        # (B,) f32
    min_p: np.ndarray        # (B,) f32
    rep: np.ndarray          # (B,) f32 repetition penalty (1 = off)
    pres: np.ndarray         # (B,) f32 presence penalty
    freq: np.ndarray         # (B,) f32 frequency penalty
    seed: np.ndarray         # (B,) uint32 per-request seed
    bias_ids: np.ndarray     # (B, MAX_LOGIT_BIAS) i32, _BIAS_PAD unused
    bias_vals: np.ndarray    # (B, MAX_LOGIT_BIAS) f32
    min_new: np.ndarray      # (B,) i32 min generated tokens before EOS
    plen: np.ndarray         # (B,) i32 original prompt length


def make_rows(params_list: Sequence[SamplingParams | None],
              cfg: InferConfig, default_seeds: Sequence[int],
              prompt_lens: Sequence[int] | None = None) -> SamplingRows:
    """Host-side builder: one numpy row per request."""
    vals = [(p or SamplingParams()).resolve(cfg, int(s))
            for p, s in zip(params_list, default_seeds)]
    t, k, p, mp, rep, pres, freq, seed, bids, bvals, mn = zip(*vals)
    if prompt_lens is None:
        prompt_lens = [0] * len(vals)
    return SamplingRows(
        temperature=np.asarray(t, np.float32),
        top_k=np.asarray(k, np.int32),
        top_p=np.asarray(p, np.float32),
        min_p=np.asarray(mp, np.float32),
        rep=np.asarray(rep, np.float32),
        pres=np.asarray(pres, np.float32),
        freq=np.asarray(freq, np.float32),
        seed=np.asarray(np.asarray(seed, np.int64) & 0xFFFFFFFF, np.uint32),
        bias_ids=np.asarray(bids, np.int32),
        bias_vals=np.asarray(bvals, np.float32),
        min_new=np.asarray(mn, np.int32),
        plen=np.asarray(prompt_lens, np.int32))


def rows_to(rows: SamplingRows, device) -> SamplingRows:
    """Host rows -> tensors on `device` (seeds widen to int64)."""
    out = []
    for name, a in zip(SamplingRows._fields, rows):
        a = np.asarray(a)
        if name == "seed":
            a = a.astype(np.int64)
        out.append(torch.as_tensor(a, device=device))
    return SamplingRows(*out)


def rows_staged(prefix: str, rows: SamplingRows) -> dict:
    """A host SamplingRows as a captured program's inputs, named
    `prefix + field` (seeds widened to int64)."""
    return {prefix + name: (np.asarray(a, np.int64) if name == "seed"
                            else np.asarray(a))
            for name, a in zip(SamplingRows._fields, rows)}


def rows_in(bufs: dict, prefix: str) -> SamplingRows:
    """The SamplingRows a program reads from its `rows_staged` inputs."""
    return SamplingRows(*(bufs[prefix + name]
                          for name in SamplingRows._fields))


def _expand(row: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return row.reshape(row.shape[0], *([1] * (ref.dim() - 1)))


def penalised_logits(logits, rows: SamplingRows, prompt_mask, out_counts):
    """Repetition penalty over prompt-or-generated tokens, then presence
    and frequency penalties over generated-token counts (vLLM order)."""
    x = logits.float()
    counts = out_counts.float()
    pm = prompt_mask if prompt_mask.dim() == x.dim() else prompt_mask[:, None]
    seen = pm | (out_counts > 0)
    rep = _expand(rows.rep, x)
    x = torch.where(seen, torch.where(x > 0, x / rep, x * rep), x)
    return (x - _expand(rows.pres, x) * (counts > 0).float()
            - _expand(rows.freq, x) * counts)


def filtered_logits_rows(logits, rows: SamplingRows, *, prompt_mask=None,
                         out_counts=None, positions=None, eos_id: int = -1,
                         use_bias: bool = True, allowed_mask=None):
    """Per-row filter chain over (B, ..., V) logits: grammar mask ->
    logit_bias -> penalties -> min_tokens EOS suppression -> temperature
    -> top-k -> top-p -> min-p. `rows` holds tensors on logits' device.

    Returns (filtered logits for categorical draws, post-penalty
    pre-temperature logits — the greedy-row argmax source)."""
    x = logits.float()
    b, v = x.shape[0], x.shape[-1]
    dev = x.device
    if allowed_mask is not None:
        x = torch.where(allowed_mask, x, NEG_INF)
    if use_bias:
        ids = rows.bias_ids.long()
        ok = (ids >= 0) & (ids < v)
        bias = torch.zeros((b, v), dtype=torch.float32, device=dev)
        bias.scatter_add_(1, torch.where(ok, ids, 0),
                          torch.where(ok, rows.bias_vals.float(), 0.0))
        x = x + bias.reshape((b,) + (1,) * (x.dim() - 2) + (v,))
    if prompt_mask is not None:
        x = penalised_logits(x, rows, prompt_mask, out_counts)
    if positions is not None and eos_id >= 0:
        shape = (b,) + (1,) * (positions.dim() - 1)
        gen = positions - rows.plen.reshape(shape)
        suppress = (gen < rows.min_new.reshape(shape))[..., None]
        is_eos = torch.arange(v, device=dev) == eos_id
        x = torch.where(suppress & is_eos, NEG_INF, x)
    raw = x
    xt = x / torch.clamp(_expand(rows.temperature.float(), x), min=1e-6)
    k = _expand(torch.where(rows.top_k <= 0, v, rows.top_k), x)
    xs = torch.sort(xt, dim=-1, descending=True).values
    ps = torch.softmax(xs, dim=-1)
    cum = torch.cumsum(ps, dim=-1)
    rank = torch.arange(v, device=dev)
    keep = (rank < k) & ((cum - ps) < _expand(rows.top_p.float(), x))
    keep[..., 0] = True
    cutoff = torch.where(keep, xs, math.inf).amin(dim=-1, keepdim=True)
    mask = xt >= cutoff
    probs = torch.softmax(xt, dim=-1)
    mask &= probs >= _expand(rows.min_p.float(), x) * ps.amax(
        dim=-1, keepdim=True)
    return torch.where(mask, xt, NEG_INF), raw


def sample_logits_rows(logits, rows: SamplingRows, positions, *,
                       prompt_mask=None, out_counts=None, eos_id: int = -1,
                       use_bias: bool = True, allowed_mask=None):
    """Per-row draw: (B, V) logits -> (B,) int64. `positions` (B,) are
    the absolute sequence positions being sampled (the fold_in counter and
    the min_tokens reference)."""
    positions = torch.as_tensor(positions, device=logits.device)
    filt, raw = filtered_logits_rows(
        logits, rows, prompt_mask=prompt_mask, out_counts=out_counts,
        positions=positions, eos_id=eos_id, use_bias=use_bias,
        allowed_mask=allowed_mask)
    keys = prng.fold_in(prng.key(rows.seed), positions)
    sampled = prng.categorical(keys, filt)
    greedy = torch.argmax(raw, dim=-1)
    return torch.where(rows.temperature <= 0.0, greedy, sampled)


def sampling_probs_rows(logits, rows: SamplingRows, *, prompt_mask=None,
                        out_counts=None, positions=None, eos_id: int = -1,
                        use_bias: bool = True, allowed_mask=None):
    """The per-row distribution `sample_logits_rows` draws from, over
    (B, ..., V) logits (a verify window passes cumulative `out_counts`
    and per-position `positions`, so penalties and min_tokens stay exact
    position by position)."""
    filt, raw = filtered_logits_rows(
        logits, rows, prompt_mask=prompt_mask, out_counts=out_counts,
        positions=positions, eos_id=eos_id, use_bias=use_bias,
        allowed_mask=allowed_mask)
    probs = torch.softmax(filt, dim=-1)
    onehot = torch.nn.functional.one_hot(
        torch.argmax(raw, dim=-1), logits.shape[-1]).to(probs.dtype)
    return torch.where(_expand(rows.temperature <= 0.0, probs), onehot,
                       probs)
