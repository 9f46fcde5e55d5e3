"""Serving layer: the request types and emit rule both servers share,
and `InferenceServer`, slot-based continuous batching over the
contiguous engine.

ONE persistent KV cache of static shape (L, max_slots, max_len, KH, Dh)
lives on the device for the server's lifetime. Each request in flight
owns a slot (a cache row). An admission burst prefills its prompts into
their slots in one batched program and samples their first tokens; one
decode program advances every active slot by `n` tokens (a chunk).
Requests join and leave between programs, and no shape changes.

Programs. Each admission and decode is a captured program of
`inference/graphs.py`, keyed as the reference's jit static arguments
are: an admission by (prompt bucket, padded group rows, prefixed) and
its sampling switches, a decode by (chunk length, per-request rows,
logit bias) and the penalty state's presence. On the card each is one
CUDA graph, replayed with its inputs copied in from pinned staging and
its tokens copied out, then one event; `cuda_graphs=False` launches the
same functions eagerly (a check, not a serving mode). Prompt lengths
are bucketed (powers of two, with max_len last) and the group's rows
padded to a power of two; padding rows name the scratch slot past
`max_slots`, the counterpart of the reference's mode="drop" scatters.

Scheduling state is host-authoritative: each slot's length, last token
and active flag live in numpy and are staged into every decode; the
device keeps the cache and, once a request needs them, the penalty
buffers (prompt presence and generated counts), which programs update
in place. A decode of n steps advances the active slots' host lengths
by n at its launch, so an admission that re-fills a slot while a chunk
is in flight is never overwritten by that chunk's commit; the commit
is identity-guarded by the slots snapshot taken at launch.

The overlap pipeline (`overlap`, on by default): the decode chunk
launched at the end of a step commits at the start of the next, so the
sweep, the admission burst and the epilogue run while the card decodes.
Seeded server-global sampling splits one threefry key per dispatch as
the reference does (`_next_rng`), and a chunk splits it per step, so
the tokens are the reference's. Per-request rows (seeds, penalties,
logit_bias, min_tokens) draw on `fold_in(key(seed), position)`.

Prefix caching (`prefix_tokens`): the shared prefix is prefilled once;
an admission whose prompt extends it builds a cache of prefix + its
remainder bucket, runs only the remainder as a `verify_step`
continuation, and copies the rows into its slots.

The host policy layer of the paged server, each part None unless
configured: QoS admission, SLO tracking, request tracing with tail
retention, fault injection (submit_reject, dispatch, iteration_stall),
the anomaly watchdog with debug bundles, the iteration profile and the
on-demand profiler window. Regex-constrained decoding is the paged
server's and is refused here, as in the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import math
import os
import sys
import threading
import time
import uuid
from typing import Callable, Sequence

import numpy as np
import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import InferConfig, ModelConfig
from cloud_server_tpu_torch.inference import engine, graphs
from cloud_server_tpu_torch.inference.iteration_profile import (
    OVERLAP_PHASES, profile_summary, register_phase_hists, resolve_profiler)
from cloud_server_tpu_torch.inference.request_trace import resolve_recorder
from cloud_server_tpu_torch.inference.sampling import (
    SamplingParams, make_rows, rows_in, rows_staged, sample_logits,
    sample_logits_rows)
from cloud_server_tpu_torch.inference.slo import resolve_slo
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.models.quantization import params_to
from cloud_server_tpu_torch.ops import rope_table
from cloud_server_tpu_torch.utils import prng
from cloud_server_tpu_torch.utils.serving_metrics import ServingMetrics


def _token_logprobs(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log P(tok) under the model's raw (pre-filter) distribution."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    return lsm.gather(1, toks.long()[:, None])[:, 0]


class _StepTracer:
    """On-demand profiling of the next N scheduler iterations into a
    torch.profiler trace (utils.tracing.capture_trace), armed from any
    thread (POST /debug/trace, or the anomaly watchdog) and driven by
    the scheduler's own step(): the window opens at an iteration's
    start and closes at an iteration's end, so a trace shows whole
    dispatches. Trace failures are swallowed with a stderr note: the
    profiler is process-global, and telemetry must never take the
    scheduler (and every request in flight) down with it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: tuple[int, str] | None = None
        self._cm = None
        self._left = 0

    def request(self, n_steps: int, logdir: str | os.PathLike) -> None:
        if n_steps <= 0:
            raise ValueError("trace step count must be positive")
        with self._lock:
            if self._pending is not None or self._cm is not None:
                raise ValueError("a trace capture is already in progress")
            self._pending = (int(n_steps), os.fspath(logdir))

    @property
    def active(self) -> bool:
        return self._pending is not None or self._cm is not None

    def step_start(self) -> None:
        with self._lock:
            if self._pending is None:
                return
            n, logdir = self._pending
            self._pending = None
            from cloud_server_tpu_torch.utils import tracing
            try:
                cm = tracing.capture_trace(logdir)
                cm.__enter__()
            except Exception as exc:  # noqa: BLE001 — see class docstring
                print(f"[server] trace capture failed to start: {exc!r}",
                      file=sys.stderr)
                return
            self._cm, self._left = cm, n

    def step_end(self, settle=None) -> None:
        """Count one iteration of an open window; after the last, close
        it. `settle` (the overlap pipeline's wait on the dispatch still
        in flight) runs first, so the window holds that dispatch's
        kernels; it is called only here, when a window closes, and its
        failure is not swallowed."""
        with self._lock:
            if self._cm is None:
                return
            self._left -= 1
            if self._left > 0:
                return
            cm, self._cm = self._cm, None
            try:
                if settle is not None:
                    settle()
            finally:
                try:
                    cm.__exit__(None, None, None)
                except Exception as exc:  # noqa: BLE001
                    print(f"[server] trace capture failed to stop: "
                          f"{exc!r}", file=sys.stderr)


class QueueFullError(RuntimeError):
    """submit() refused: the pending queue is at its configured bound."""


@dataclasses.dataclass
class Request:
    """A generation request; thread-safe completion via `result()`."""

    prompt: list[int]
    max_new_tokens: int
    stream: Callable[[int], None] | None = None
    sampling: SamplingParams | None = None
    # the seed actually used for this request's rows (its own, or one
    # drawn from the server's host RNG at submit) — stable across
    # preemption and re-admission
    seed_used: int = 0
    # multi-LoRA serving: the registered adapter's name (paged server);
    # None serves the base model
    adapter: str | None = None
    # multi-tenant QoS (inference/qos.py): the resolved tenant name, set
    # at submit; None when the server has no TenantRegistry
    tenant: str | None = None
    # request tracing (inference/request_trace.py): the RequestTrace
    # when head sampling selected the request, else None
    trace: object | None = None
    # tail retention: the provisional trace of a head-unsampled request
    # when the recorder keeps a tail ring, judged at finish
    tail_trace: object | None = None
    # SLO class (inference/slo.py): the tenant's priority class when SLO
    # tracking is configured (None maps to the tracker's "default")
    slo_class: str | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    # log P(token) under the raw distribution, aligned with `tokens`
    logprobs: list[float] = dataclasses.field(default_factory=list)
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    finish_reason: str | None = None  # "eos" | "length" | "stop" | ...
    # host wall clock (perf_counter): TTFT = emit_times[0] - submit_time
    submit_time: float | None = None
    emit_times: list[float] = dataclasses.field(default_factory=list)
    # absolute perf_counter deadline; the scheduler sweep expires it
    deadline: float | None = None
    request_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:12])
    # lifecycle timeline (name, perf_counter) for the serving metrics:
    # submit, admit, first token, preempt-requeue, finish:<reason>.
    # admit_time is the FIRST admission (queue wait survives preemption)
    admit_time: float | None = None
    events: list[tuple[str, float]] = dataclasses.field(
        default_factory=list)
    _cancel: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    _on_cancel: Callable[["Request"], None] | None = None
    # router failover: a request that completes with an "error:" reason
    # is offered to this hook before its waiters unblock; True means the
    # hook took it over (a retry or migration elsewhere completes it)
    _fail_handler: Callable[["Request"], bool] | None = None
    # disaggregated prefill/decode: called once, outside the server's
    # step lock, when the request's chunked prefill completes with
    # decode budget left (the router moves it to a decode replica)
    _handoff: Callable[["Request"], None] | None = None
    # called after `_done` is set (the router mirroring a retry's outcome)
    _on_done: Callable[["Request"], None] | None = None
    # an "error:" caused by the request itself (it can never fit the
    # pool): a router neither retries it nor counts it against a replica
    _request_fault: bool = False

    def record_event(self, name: str, t: float | None = None) -> None:
        self.events.append((name, time.perf_counter() if t is None
                            else t))

    def timeline(self) -> list[tuple[str, float]]:
        """The lifecycle events as (name, perf_counter time) pairs, in
        the order they happened (the span trees' source)."""
        return list(self.events)

    def cancel(self) -> None:
        """Abort this request (idempotent; a no-op once finished)."""
        if self._done.is_set() or self._cancel.is_set():
            return
        self._cancel.set()
        hook = self._on_cancel  # read once: completion clears it
        if hook is not None:
            hook(self)

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def result(self, timeout: float | None = None) -> list[int]:
        if not self._done.wait(timeout):
            raise TimeoutError("generation not finished")
        if self.finish_reason and self.finish_reason.startswith("error"):
            raise RuntimeError(f"generation failed: {self.finish_reason}")
        return self.tokens

    @property
    def done(self) -> bool:
        return self._done.is_set()


def resolve_seed(sampling: SamplingParams | None, host_rng, lock) -> int:
    """The request's own seed, or a fresh draw from the server's host RNG
    (under `lock`), fixed once at submit."""
    if sampling is not None and sampling.seed is not None:
        return int(sampling.seed)
    with lock:
        return int(host_rng.integers(0, 2 ** 32))


def emit_token(req: Request, token: int, logprob: float | None,
               infer_cfg: InferConfig) -> bool:
    """Record one generated token on `req`; True when the request just
    finished (eos / stop sequence / length). Stop sequences are
    token-level and the matched tokens are removed."""
    sp = req.sampling
    if token == infer_cfg.eos_token_id and not (sp and sp.ignore_eos):
        req.finish_reason = "eos"
        return True
    req.tokens.append(token)
    req.emit_times.append(time.perf_counter())
    if logprob is not None:
        req.logprobs.append(float(logprob))
    if sp and sp.stop:
        for s in sp.stop:
            ls = len(s)
            if len(req.tokens) >= ls and req.tokens[-ls:] == list(s):
                del req.tokens[-ls:]
                del req.emit_times[-ls:]
                drop = len(req.logprobs) - len(req.tokens)
                if drop > 0:
                    del req.logprobs[-drop:]
                req.finish_reason = "stop"
                return True
    if req.stream is not None:
        req.stream(token)
    if len(req.tokens) >= req.max_new_tokens:
        req.finish_reason = "length"
        return True
    return False


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt of {n} tokens exceeds largest bucket "
                     f"{buckets[-1]}")


# ---------------------------------------------------------------------------
# The contiguous server's programs (captured per key by inference/graphs.py)
# ---------------------------------------------------------------------------


class _Slots:
    """What the contiguous server's programs read besides their inputs:
    the weights, the slot cache (one scratch row past `max_slots`, the
    target of padding rows), the rope tables, the cached prefix's kv,
    and the penalty buffers (`pm` prompt presence, `oc` generated
    counts; (S+1, V), None until a request needs them). Programs write
    the cache and the penalty buffers in place."""

    def __init__(self, params, cfg, infer_cfg, cache, rope):
        self.params, self.cfg, self.infer_cfg = params, cfg, infer_cfg
        self.cache, self.rope = cache, rope
        self.prefix = None  # (KVCache of the prefix, its tokens)
        self.pm = self.oc = None

    def mutable_state(self) -> list:
        """Per-slot tensors a program updates besides the cache (a
        graph's warm-up run puts them back, see graphs.Program)."""
        return [t for t in (self.pm, self.oc) if t is not None]


def _buffers(cache) -> list:
    """A KVCache's k, v (and int8 scale) buffers."""
    return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)
            if t is not None]


def _prompt_presence(token_rows, true_lens, vocab: int) -> torch.Tensor:
    """(G, Pb) token rows + true lengths -> (G, vocab) bool presence."""
    g, pb = token_rows.shape
    cols = torch.arange(pb, device=token_rows.device)[None, :]
    ids = torch.where(cols < true_lens[:, None], token_rows.long(), vocab)
    out = torch.zeros((g, vocab + 1), dtype=torch.bool,
                      device=token_rows.device)
    return out.scatter_(1, ids, True)[:, :vocab]


def _first_tokens(m: _Slots, bufs: dict, logits, token_rows, lens, *,
                  rows: bool, bias: bool, has_pen: bool):
    """An admission's first-token draw and sampling bookkeeping: the
    group's prompt presence and counts (reset to the first token) land
    in its slots' penalty rows. Returns {"toks", "lps"}."""
    slots = bufs["slots"].long()
    pm_g = (_prompt_presence(token_rows, lens, logits.shape[-1])
            if has_pen else None)
    if rows:
        toks = sample_logits_rows(
            logits, rows_in(bufs, "samp."), lens, prompt_mask=pm_g,
            out_counts=(torch.zeros_like(logits, dtype=torch.int32)
                        if has_pen else None),
            eos_id=m.infer_cfg.eos_token_id, use_bias=bias)
    else:
        toks = sample_logits(logits, bufs["rng"], m.infer_cfg)
    if has_pen:
        m.pm[slots] = pm_g
        oc = torch.zeros_like(m.oc[slots])
        oc[torch.arange(oc.shape[0], device=oc.device), toks] = 1
        m.oc[slots] = oc
    return {"toks": toks, "lps": _token_logprobs(logits, toks)}


def _admit_core(m: _Slots, bufs: dict, *, rows: bool, bias: bool,
                has_pen: bool) -> dict:
    """Prefill G prompts (G, Pb) into their slots' rows [0, Pb) and
    sample their first tokens (the reference's `_admit_batch`)."""
    prompts, lens = bufs["prompts"], bufs["true_lens"].long()
    logits, _ = engine.prefill(m.params, prompts, m.cfg, m.cache, lens,
                               rows=bufs["slots"], rope=m.rope)
    return _first_tokens(m, bufs, logits, prompts, lens, rows=rows,
                         bias=bias, has_pen=has_pen)


def _admit_prefixed_core(m: _Slots, bufs: dict, *, rows: bool, bias: bool,
                         has_pen: bool) -> dict:
    """Admission through the cached prefix (the reference's
    `_admit_batch_prefixed`): a (G, P0 + Rb) cache holds the prefix's
    kv, the remainders (G, Rb) run as a `verify_step` continuation at
    P0, and the rows are copied into the slots."""
    pre, pre_toks = m.prefix
    rem, lens = bufs["remainders"], bufs["true_lens"].long()
    g, rb = rem.shape
    p0 = pre.k.shape[2]
    tmp = engine.init_cache(m.cfg, g, p0 + rb, device=rem.device)
    for dst, src in zip(_buffers(tmp), _buffers(pre)):
        dst[:, :, :p0] = src  # the prefix, broadcast over the rows
    tmp = tmp._replace(length=torch.full((g,), p0, dtype=torch.int64,
                                         device=rem.device))
    logits, tmp = engine.verify_step(m.params, rem, m.cfg, tmp, rope=m.rope)
    last = logits[torch.arange(g, device=rem.device), lens - 1]
    full = torch.cat([pre_toks[None, :].expand(g, p0), rem.long()], dim=1)
    slots = bufs["slots"].long()
    for dst, src in zip(_buffers(m.cache), _buffers(tmp)):
        dst[:, slots, :p0 + rb] = src
    return _first_tokens(m, bufs, last, full, p0 + lens, rows=rows,
                         bias=bias, has_pen=has_pen)


def _decode_core(m: _Slots, bufs: dict, *, n_steps: int, rows: bool,
                 bias: bool, has_pen: bool) -> dict:
    """n_steps decode steps over every slot (the reference's `_decode` /
    `_decode_chunk`): inactive slots are frozen and emit pad. One key
    for one step, split(key, n) for a chunk. Returns {"toks", "lps"},
    each (n_steps, S)."""
    s = bufs["lens"].shape[0]
    active = bufs["active"]
    c = m.cache

    def slot_rows(t):  # without the scratch row
        return None if t is None else t[:, :s]
    cache = engine.KVCache(slot_rows(c.k), slot_rows(c.v),
                           bufs["lens"].long(), slot_rows(c.k_scale),
                           slot_rows(c.v_scale))
    keys = (bufs["rng"][None] if n_steps == 1
            else prng.split(bufs["rng"], n_steps))
    samp = rows_in(bufs, "samp.") if rows else None
    pm = m.pm[:s] if has_pen else None
    oc = m.oc[:s] if has_pen else None
    icfg = m.infer_cfg
    tok, toks, lps = bufs["last"].long(), [], []
    for t in range(n_steps):
        logits, nxt = engine.decode_step(m.params, tok, m.cfg, cache,
                                         rope=m.rope)
        if rows:
            # the sampled token sits at absolute position length + 1
            sampled = sample_logits_rows(
                logits, samp, cache.length + 1, prompt_mask=pm,
                out_counts=oc, eos_id=icfg.eos_token_id, use_bias=bias)
            if has_pen:
                oc.index_put_((torch.arange(s, device=oc.device), sampled),
                              active.to(torch.int32), accumulate=True)
        else:
            sampled = sample_logits(logits, keys[t], icfg)
        lps.append(_token_logprobs(logits, sampled))
        tok = torch.where(active, sampled, icfg.pad_token_id)
        toks.append(tok)
        cache = nxt._replace(length=torch.where(active, nxt.length,
                                                cache.length))
    return {"toks": torch.stack(toks), "lps": torch.stack(lps)}


class InferenceServer:
    """Continuous-batching generation server over the contiguous cache.

    submit() is thread-safe and returns at once; step() runs one
    scheduler iteration (admissions, then one decode chunk for every
    active slot). Run steps by hand, or `serve_forever()` on a thread
    through start()/stop(). `device` defaults to CUDA (device="cpu" runs
    on the CPU); `cuda_graphs=False` launches every program eagerly.
    """

    def __init__(self, params, cfg: ModelConfig, infer_cfg: InferConfig, *,
                 max_slots: int = 8, max_len: int = 1024,
                 prompt_buckets: Sequence[int] | None = None, seed: int = 0,
                 decode_chunk: int = 1, max_pending: int | None = None,
                 prefix_tokens: Sequence[int] | None = None,
                 prefix_remainder_cap: int = 1024,
                 metrics=None, qos=None, tracing=None, slo=None,
                 iteration_profile=None, faults=None, anomaly=None,
                 overlap: bool | None = None, device=None,
                 cuda_graphs: bool = True):
        # these modules import this one's request types
        from cloud_server_tpu_torch.inference.anomaly import resolve_anomaly
        from cloud_server_tpu_torch.inference.faults import (
            resolve_fault_plan)
        from cloud_server_tpu_torch.inference.qos import resolve_registry
        if cfg.decode_attention_impl != "xla":
            # fail at construction, not inside the first decode
            raise ValueError(
                f"decode_attention_impl={cfg.decode_attention_impl!r} is "
                "not supported by the contiguous InferenceServer — the "
                "pallas decode kernel lives in the paged serving stack "
                "(inference.paged_server.PagedInferenceServer); use "
                "'xla' here")
        self.device = resolve_device(device)
        # float32 leaves cast to the compute dtype once; QTensor leaves
        # stay quantized and dequantize at use
        self.params = transformer.cast_params(params_to(params, self.device),
                                              cfg)
        self.cfg = cfg
        self.infer_cfg = infer_cfg
        self.max_slots = max_slots
        self.max_len = max_len
        # decode steps per scheduler iteration (never past any active
        # request's remaining budget)
        self.decode_chunk = max(1, decode_chunk)
        if prompt_buckets is None:
            # powers of two, with max_len itself the last bucket so any
            # prompt the cache can hold is admissible
            prompt_buckets = [b for b in itertools.takewhile(
                lambda b: b < max_len,
                (2 ** i for i in range(4, 31)))] + [max_len]
        self.prompt_buckets = sorted(prompt_buckets)
        if self.prompt_buckets[-1] > max_len:
            raise ValueError(
                f"largest prompt bucket ({self.prompt_buckets[-1]}) exceeds "
                f"max_len ({max_len}); the slot cache could not hold it")
        self._m = _Slots(self.params, cfg, infer_cfg,
                         engine.init_cache(cfg, max_slots + 1, max_len,
                                           device=self.device),
                         rope_table(cfg, max_len, device=self.device))
        self._programs = graphs.ProgramCache(self.device,
                                             capture=cuda_graphs)
        # host-authoritative slot state (staged into every decode)
        self.lengths = np.zeros((max_slots,), np.int64)
        self.last_token = np.zeros((max_slots,), np.int64)
        self.active = np.zeros((max_slots,), bool)
        self.samp_rows = make_rows([None] * max_slots, infer_cfg,
                                   [0] * max_slots)
        # prefix caching: the shared prefix is prefilled once
        self._prefix: list[int] | None = None
        self.prefix_remainder_cap = prefix_remainder_cap
        self.prefix_hits = 0
        self.prefix_misses = 0
        self._warned_prefix_miss = False
        if prefix_tokens:
            pfx = list(prefix_tokens)
            if len(pfx) >= max_len:
                raise ValueError(
                    f"prefix of {len(pfx)} tokens leaves no room within "
                    f"max_len={max_len}")
            toks = torch.tensor([pfx], dtype=torch.int64, device=self.device)
            tmp = engine.init_cache(cfg, 1, len(pfx), device=self.device)
            _, tmp = engine.prefill(self.params, toks, cfg, tmp)
            self._prefix = pfx
            self._m.prefix = (tmp, toks[0])
            rcap = min(max_len - len(pfx), prefix_remainder_cap)
            self._rem_buckets = ([b for b in self.prompt_buckets
                                  if b < rcap] + [rcap])
        self.tokens_emitted = 0  # lifetime emitted tokens
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.metrics.registry.add_collector(self._collect_metrics)
        self.tracer = _StepTracer()  # POST /debug/trace
        # iteration-phase profiler: phases feed only the per-phase
        # histograms (the contiguous server has no flight recorder)
        self._profiler = resolve_profiler(iteration_profile,
                                          infer_cfg.iteration_profile)
        self._phase_hists = ({} if self._profiler is None else
                             register_phase_hists(self.metrics.registry))
        # idle vs dead: an idle scheduler keeps counting idle iterations
        # while last_busy_ts ages; a dead one freezes both
        self.idle_iterations = 0
        self.last_busy_ts = 0.0
        self._iter_busy = False
        self.max_pending = max_pending
        # the host policy layer: each part None unless configured, and
        # every call site guarded
        self.qos = resolve_registry(qos, infer_cfg.qos_config)
        self.trace_recorder = resolve_recorder(
            tracing, infer_cfg.trace_sample_rate,
            capacity=infer_cfg.trace_capacity,
            tail_capacity=infer_cfg.trace_tail_capacity)
        self.slo = resolve_slo(slo, infer_cfg.slo_config)
        if self.slo is not None:
            self.metrics.slo = self.slo
        self._anomaly = resolve_anomaly(anomaly, infer_cfg.anomaly_config)
        if self._anomaly is not None:
            self._anomaly.bind_slo(self.slo)
        self._bundle_on_anomaly = bool(infer_cfg.bundle_on_anomaly)
        self._bundles: collections.deque = collections.deque(maxlen=8)
        self._bundles_captured = 0
        # submit_reject / dispatch / iteration_stall; wedge and
        # alloc_famine are paged-scheduler shapes
        self._faults = resolve_fault_plan(faults, infer_cfg.fault_plan)
        self._draining = False
        self._slots: list[Request | None] = [None] * max_slots
        self._pending: collections.deque[Request] = collections.deque()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self.overlap = bool(infer_cfg.overlap if overlap is None
                            else overlap)
        self._overlap_enabled = self.overlap
        # (launched decode program, _slots snapshot at launch)
        self._inflight: tuple | None = None
        self._iter_overlapped = False
        self._step_lock = threading.Lock()
        # the server-global key, jax.random.key(seed)'s words, split once
        # per dispatch (`_next_rng`)
        self._rng = (0, int(seed) & 0xFFFFFFFF)
        self._host_rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- client API ---------------------------------------------------------

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: int | None = None,
               stream: Callable[[int], None] | None = None,
               sampling: SamplingParams | None = None,
               tenant: str | None = None,
               trace_ctx: tuple | None = None,
               deadline_s: float | None = None,
               fail_handler=None) -> Request:
        if self._stop.is_set():
            raise RuntimeError("server is stopped; not accepting requests")
        if self._faults is not None:
            self._faults.check("submit_reject")
        if deadline_s is not None and not (
                math.isfinite(deadline_s) and deadline_s > 0):
            raise ValueError("deadline_s must be a finite positive "
                             "number of seconds")
        if sampling is not None and sampling.regex is not None:
            raise ValueError(
                "regex-constrained decoding is served by the paged "
                "server (PagedInferenceServer), not the contiguous one")
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        _bucket(len(prompt), self.prompt_buckets)  # raises if too long
        max_new = (self.infer_cfg.max_decode_len if max_new_tokens is None
                   else max_new_tokens)
        max_new = min(max_new, self.max_len - len(prompt))
        if max_new <= 0:
            raise ValueError(
                f"prompt of {len(prompt)} tokens leaves no room to decode "
                f"within max_len={self.max_len}")
        # no registry bounds the tenant set: a caller's string must not
        # mint per-tenant metric series
        tenant = self.qos.resolve(tenant) if self.qos is not None else None
        req = Request(prompt=list(prompt), max_new_tokens=max_new,
                      stream=stream, sampling=sampling, tenant=tenant,
                      seed_used=resolve_seed(sampling, self._host_rng,
                                             self._lock),
                      submit_time=time.perf_counter())
        if deadline_s is None and self.qos is not None:
            deadline_s = self.qos.default_deadline(tenant)
        if deadline_s is not None:
            req.deadline = req.submit_time + float(deadline_s)
        if self.slo is not None:
            req.slo_class = (self.qos.priority_class(tenant)
                             if self.qos is not None else None)
        # the router's failover hook rides in through submit: once
        # queued, a scheduler crash may complete the request
        req._fail_handler = fail_handler
        req._on_cancel = self._handle_cancel
        with self._lock:
            if self._draining:
                raise RuntimeError(
                    "server is draining; not accepting requests")
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                raise QueueFullError(
                    f"pending queue is full ({self.max_pending} "
                    "requests); retry later")
            if self.qos is not None:
                self.qos.gate_submit(tenant, len(prompt))
            # telemetry (and the trace) after every refusal and before
            # the append: once queued, the scheduler may finish it
            if self.trace_recorder is not None:
                tr = self.trace_recorder.begin(req, trace_ctx)
                if tr is not None and tenant is not None:
                    tr.annotate(tenant=tenant)
            req.record_event("submit", req.submit_time)
            self.metrics.observe_submit(req)
            self._pending.append(req)
            self._work.notify()
        return req

    def _handle_cancel(self, req: Request) -> None:
        """A pending request finishes at once; an active slot is reaped
        by the next step's sweep."""
        with self._lock:
            try:
                self._pending.remove(req)
            except ValueError:
                return  # active: the step sweep owns the teardown
            if self.qos is not None:
                self.qos.on_pending_removed(req.tenant)
        req.finish_reason = "cancelled"
        self._complete(req)

    def _complete(self, req: Request) -> None:
        """Terminal bookkeeping for every path that ends a request:
        lifecycle metrics, the watchdog's request feed and the trace's
        finish, then unblock waiters (or hand an "error:" completion to
        its failover hook)."""
        now = self.metrics.observe_finish(req)
        if self._anomaly is not None:
            ttft = (req.emit_times[0] - req.submit_time
                    if req.emit_times and req.submit_time is not None
                    else None)
            itl = (None if len(req.emit_times) < 2 else
                   (req.emit_times[-1] - req.emit_times[0])
                   / (len(req.emit_times) - 1))
            fired = self._anomaly.observe_request(
                now=now, ttft_s=ttft, itl_s=itl,
                finish_reason=req.finish_reason)
            if fired:
                self._on_anomaly(fired)
        if self.trace_recorder is not None and (
                req.trace is not None or req.tail_trace is not None):
            slo_violated = False
            if req.trace is None and self.slo is not None:
                e2e = (None if req.submit_time is None
                       else now - req.submit_time)
                ttft = (req.emit_times[0] - req.submit_time
                        if req.emit_times and req.submit_time is not None
                        else None)
                slo_violated = (
                    (e2e is not None and self.slo.exceeds_target(
                        req.slo_class, "e2e", e2e))
                    or (ttft is not None and self.slo.exceeds_target(
                        req.slo_class, "ttft", ttft)))
            in_anomaly = (self._anomaly is not None
                          and req.trace is None
                          and self._anomaly.active_count(now) > 0)
            self.trace_recorder.finish(req, slo_violated=slo_violated,
                                       in_anomaly=in_anomaly)
        req._on_cancel = None
        h = req._fail_handler
        if (h is not None and req.finish_reason is not None
                and req.finish_reason.startswith("error") and h(req)):
            return
        req._done.set()
        if req._on_done is not None:
            req._on_done(req)

    def _sweep_cancelled(self) -> None:
        """Reap cancelled and deadline-expired slots and expired pending
        requests (the clock is read only when a deadline exists)."""
        now = None
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            if req._cancel.is_set():
                req.finish_reason = "cancelled"
                self._finish(slot, req)
                continue
            if req.deadline is not None:
                if now is None:
                    now = time.perf_counter()
                if now > req.deadline:
                    req.finish_reason = "deadline"
                    self._finish(slot, req)
        with self._lock:
            expired = []
            if any(r.deadline is not None for r in self._pending):
                if now is None:
                    now = time.perf_counter()
                keep = collections.deque()
                for r in self._pending:
                    (expired if r.deadline is not None and now > r.deadline
                     else keep).append(r)
                self._pending = keep
            for r in expired:
                if self.qos is not None:
                    self.qos.on_pending_removed(r.tenant)
        for r in expired:
            r.finish_reason = "deadline"
            self._complete(r)

    def generate(self, prompts: Sequence[Sequence[int]], *,
                 max_new_tokens: int | None = None) -> list[list[int]]:
        """Synchronous convenience: submit all, drive to completion."""
        reqs = [self.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]
        self.run_until_idle()
        return [r.tokens for r in reqs]

    # -- scheduler ----------------------------------------------------------

    def _next_rng(self) -> np.ndarray:
        """The reference's `self._rng, sub = jax.random.split(self._rng)`
        on the host: a fresh key for one dispatch."""
        k0, k1 = self._rng
        self._rng = prng.threefry2x32(k0, k1, 0, 0)
        return np.asarray(prng.threefry2x32(k0, k1, 0, 1), np.int64)

    def _launch(self, body, flags: dict, staged: dict):
        """Launch `body` with static switches `flags` on `staged` inputs
        and a fresh server key; the program is keyed by its body, its
        switches, the penalty state's presence and its input shapes.
        Returns the program (the caller waits on it)."""
        staged["rng"] = self._next_rng()
        flags = dict(flags, has_pen=self._m.pm is not None)
        key = (body.__name__, tuple(sorted(flags.items())),
               tuple((k, np.shape(a)) for k, a in sorted(staged.items())))
        prog = self._programs.get(key, functools.partial(body, **flags),
                                  self._m, staged)
        prog.launch(staged)
        return prog

    def _emit(self, req: Request, token: int,
              logprob: float | None = None) -> bool:
        """Record one generated token; True if the request finished."""
        n0 = len(req.emit_times)
        done = emit_token(req, token, logprob, self.infer_cfg)
        # every token the model computed counts toward throughput, a
        # stop-sequence match's too
        if not (done and req.finish_reason == "eos"):
            self.tokens_emitted += 1
            if self.qos is not None:
                self.qos.charge_generated(req.tenant)
        if len(req.emit_times) > n0:
            self.metrics.observe_emit(req)
        return done

    def _finish(self, slot: int, req: Request) -> None:
        self._slots[slot] = None
        self.active[slot] = False
        self._complete(req)

    def _admit_pending(self) -> None:
        """Admit every admissible pending request in ONE batched prefill
        per kind (plain, then prefixed): the burst's width is the bucket
        of its longest prompt and its rows are padded to a power of
        two."""
        with self._lock:
            if not self._pending:
                return
            free = [i for i, r in enumerate(self._slots) if r is None]
            group: list[tuple[int, Request]] = []
            while self._pending and len(group) < len(free):
                if self.qos is not None:
                    # deficit round-robin over tenants (FIFO within one)
                    idx = self.qos.next_admission_index(self._pending)
                    req = self._pending[idx]
                    del self._pending[idx]
                    self.qos.charge_admission(req.tenant, len(req.prompt))
                    self.qos.on_pending_removed(req.tenant)
                else:
                    req = self._pending.popleft()
                slot = free[len(group)]
                self._slots[slot] = req
                group.append((slot, req))
        if not group:
            return
        self._iter_busy = True
        if self._profiler is not None:
            now = self._profiler.mark("admission")
        else:
            now = time.perf_counter()
        for _, req in group:
            self.metrics.observe_admit(req, now)
        prefixed, plain = [], []
        for gr in group:
            (prefixed if self._use_prefix(gr[1]) else plain).append(gr)
        if plain:
            self._admit_group(plain, [r.prompt for _, r in plain],
                              self.prompt_buckets, _admit_core, "prompts")
        if prefixed:
            p0 = len(self._prefix)
            self._admit_group(prefixed,
                              [r.prompt[p0:] for _, r in prefixed],
                              self._rem_buckets, _admit_prefixed_core,
                              "remainders", p0)

    def _use_prefix(self, req: Request) -> bool:
        """Whether `req` admits through the cached prefix; counts hits
        and misses, and warns once at the first miss (a BPE tokenizer
        merging across the prefix boundary never matches)."""
        pfx = self._prefix
        if pfx is None:
            return False
        ok = (len(req.prompt) > len(pfx)
              # a huge remainder is cheaper through the plain prefill
              and len(req.prompt) - len(pfx) <= self._rem_buckets[-1]
              and req.prompt[:len(pfx)] == pfx)
        if ok:
            self.prefix_hits += 1
        else:
            self.prefix_misses += 1
            if not self._warned_prefix_miss:
                self._warned_prefix_miss = True
                print("[server] request did not match the cached prefix "
                      "(token-level comparison) — with a BPE tokenizer, "
                      "text that merges across the prefix boundary never "
                      "matches; check prefix_hits/prefix_misses",
                      file=sys.stderr)
        return ok

    def _pad_group(self, group, token_rows, buckets):
        """Padded (token rows, true lens, slot ids): width = the bucket of
        the longest entry, rows = the next power of two; padding rows
        target the scratch slot `max_slots`."""
        pb = _bucket(max(len(t) for t in token_rows), buckets)
        gpad = 1
        while gpad < len(group):
            gpad *= 2
        rows = np.full((gpad, pb), self.infer_cfg.pad_token_id, np.int64)
        true_lens = np.ones((gpad,), np.int64)
        slots = np.full((gpad,), self.max_slots, np.int64)
        for i, toks_i in enumerate(token_rows):
            rows[i, :len(toks_i)] = toks_i
            true_lens[i] = len(toks_i)
            slots[i] = group[i][0]
        return rows, true_lens, slots

    def _ensure_penalty_state(self, group) -> None:
        """Materialise the (S+1, V) penalty buffers at the first
        admission that needs them (programs are keyed by their
        presence; slots admitted before carry neutral penalties)."""
        m = self._m
        if m.pm is not None or not any(
                req.sampling is not None
                and req.sampling.needs_penalty_state()
                for _, req in group):
            return
        shape = (self.max_slots + 1, self.cfg.vocab_size)
        m.pm = torch.zeros(shape, dtype=torch.bool, device=self.device)
        m.oc = torch.zeros(shape, dtype=torch.int32, device=self.device)

    def _group_rows(self, group, gpad: int):
        """The burst's SamplingRows padded to `gpad` rows, whether any
        member needs per-request device sampling, and whether any
        carries a logit_bias."""
        params_list = [req.sampling for _, req in group]
        seeds = [req.seed_used for _, req in group]
        plens = [len(req.prompt) for _, req in group]
        pad = gpad - len(group)
        rows = make_rows(params_list + [None] * pad, self.infer_cfg,
                         seeds + [0] * pad, prompt_lens=plens + [0] * pad)
        use = any(sp is not None and sp.needs_device_rows(self.infer_cfg)
                  for sp in params_list)
        bias = any(sp is not None and bool(sp.logit_bias)
                   for sp in params_list)
        return rows, use, bias

    def _rows_mode(self) -> tuple[bool, bool]:
        """(use_rows, use_bias): whether any ACTIVE request needs
        per-request device sampling / logit_bias."""
        live = [r.sampling for r in self._slots
                if r is not None and r.sampling is not None]
        return (any(sp.needs_device_rows(self.infer_cfg) for sp in live),
                any(bool(sp.logit_bias) for sp in live))

    def _admit_group(self, group, token_rows, buckets, body, name,
                     p0: int = 0) -> None:
        """Pad, launch one batched admission, emit the first tokens."""
        rows, true_lens, slots = self._pad_group(group, token_rows, buckets)
        self._ensure_penalty_state(group)
        samp, use_rows, use_bias = self._group_rows(group, rows.shape[0])
        n = len(group)
        for i, (slot, _) in enumerate(group):
            for dst, src in zip(self.samp_rows, samp):
                dst[slot] = src[i]
        prof = self._profiler
        if prof is not None:
            prof.mark("build")
        staged = {name: rows, "true_lens": true_lens, "slots": slots}
        if use_rows:
            staged.update(rows_staged("samp.", samp))
        out = self._launch(body, {"rows": use_rows, "bias": use_bias},
                           staged).wait()
        if prof is not None:
            prof.mark("device")
        idx = slots[:n]
        self.lengths[idx] = p0 + true_lens[:n]
        self.last_token[idx] = out["toks"][:n]
        self.active[idx] = True
        for i, (slot, req) in enumerate(group):
            if self._emit(req, int(out["toks"][i]), float(out["lps"][i])):
                self._finish(slot, req)
        if prof is not None:
            prof.mark("commit")

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def num_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def _chunk_len(self) -> int:
        """Decode steps this iteration: at most decode_chunk and the
        tightest remaining budget among active requests (so no chunk
        decodes past max_new_tokens or the cache), rounded down to a
        power of two."""
        remaining = min(r.max_new_tokens - len(r.tokens)
                        for r in self._slots if r is not None)
        n = min(self.decode_chunk, max(1, remaining))
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def step(self) -> int:
        """One scheduler iteration; returns the number of active slots.
        Thread-safe: concurrent callers serialise on an internal lock."""
        with self._step_lock:
            self.tracer.step_start()
            prof = self._profiler
            try:
                if self._faults is not None:
                    self._faults.maybe_stall()
                if prof is not None:
                    prof.begin()
                self._iter_busy = False
                self._iter_overlapped = False
                n_active = self._step_locked()
                if self._iter_busy:
                    if prof is not None:
                        self._observe_phases(prof)
                    self.last_busy_ts = time.time()
                    if self._anomaly is not None:
                        with self._lock:
                            pending = len(self._pending)
                        fired = self._anomaly.observe_iteration(
                            now=time.perf_counter(), pending=pending)
                        if fired:
                            self._on_anomaly(fired)
                else:
                    self.idle_iterations += 1
                return n_active
            finally:
                self.tracer.step_end(settle=self._settle_inflight)

    def _observe_phases(self, prof) -> None:
        """The step's phases into the rolling histograms; an overlapped
        step's sweep/admission/build ran under the decode in flight and
        fold into the `overlap` series."""
        prof.mark("epilogue")
        hists = self._phase_hists
        phases = prof.phases_ms()
        if self._iter_overlapped:
            hists["overlap"].observe(sum(phases.get(p, 0.0)
                                         for p in OVERLAP_PHASES))
            phases = {p: v for p, v in phases.items()
                      if p not in OVERLAP_PHASES}
        for p, v in phases.items():
            hists[p].observe(v)

    def _settle_inflight(self) -> None:
        """Wait until the decode in flight has run (a profiler window's
        close; never on the serving path)."""
        if self._inflight is not None:
            self._inflight[0].settle()

    def _launch_decode(self):
        """Launch one decode chunk (no wait) over the host slot state and
        advance the active slots' host lengths by its steps. Returns
        the program."""
        n = self._chunk_len()
        use_rows, use_bias = self._rows_mode()
        staged = {"lens": self.lengths.copy(),
                  "last": self.last_token.copy(),
                  "active": self.active.copy()}
        if use_rows:
            staged.update(rows_staged("samp.", self.samp_rows))
        prog = self._launch(_decode_core, {"n_steps": n, "rows": use_rows,
                                           "bias": use_bias}, staged)
        self.lengths[self.active] += n
        return prog

    def _commit_decode_chunk(self, prog, slots, prof) -> None:
        """Wait on a decode chunk (the iteration's one host sync) and
        emit its tokens against `slots`, guarded by identity: a slot
        freed and re-admitted while the chunk was in flight never
        receives the old occupant's tokens."""
        out = prog.wait()
        if prof is not None:
            prof.mark("device")
        chunk, lchunk = out["toks"], out["lps"]
        for slot, req in enumerate(slots):
            if req is not None and self._slots[slot] is req:
                self.last_token[slot] = chunk[-1, slot]
        for t in range(chunk.shape[0]):
            for slot, req in enumerate(slots):
                if req is not None and self._slots[slot] is req \
                        and self._emit(req, int(chunk[t, slot]),
                                       float(lchunk[t, slot])):
                    self._finish(slot, req)
        if prof is not None:
            prof.mark("commit")

    def _step_locked(self) -> int:
        if self._overlap_enabled:
            return self._step_locked_overlap()
        prof = self._profiler
        self._sweep_cancelled()
        if prof is not None:
            prof.mark("sweep")
        self._admit_pending()
        if self.num_active == 0:
            return 0
        self._iter_busy = True
        if self._faults is not None:
            # an injected dispatch failure raises before any device work
            self._faults.check("dispatch")
        if prof is not None:
            prof.mark("admission")
        self._commit_decode_chunk(self._launch_decode(), list(self._slots),
                                  prof)
        return self.num_active

    def _step_locked_overlap(self) -> int:
        """Pipelined iteration: the sweep and the admission burst, then
        the commit of the chunk launched at the end of the previous
        step, then the launch of the next chunk, left in flight. With
        nothing in flight (cold start, after idle) the step commits the
        chunk it launches and then primes the pipeline, so per-step
        emission counts match the sequential loop."""
        prof = self._profiler
        self._sweep_cancelled()
        if prof is not None:
            prof.mark("sweep")
        self._admit_pending()
        if prof is not None:
            prof.mark("admission")
        committed = False
        if self._inflight is not None:
            self._iter_busy = True
            self._iter_overlapped = True
            prog, snap = self._inflight
            self._inflight = None
            self._commit_decode_chunk(prog, snap, prof)
            committed = True
        if self.num_active == 0:
            return 0
        self._iter_busy = True
        if self._faults is not None:
            # analysis: allow[lifecycle-discipline] deliberate raise point,
            # as in the reference: a dispatch fault fails the whole step
            # and _fail_all tears every slot down, so the _iter_busy /
            # _inflight pair is never read torn
            self._faults.check("dispatch")
        if prof is not None:
            prof.mark("admission")
        prog = self._launch_decode()
        if committed:
            self._inflight = (prog, list(self._slots))
            if prof is not None:
                prof.mark("launch")
            return self.num_active
        self._commit_decode_chunk(prog, list(self._slots), prof)
        if self.num_active:
            self._inflight = (self._launch_decode(), list(self._slots))
            if prof is not None:
                prof.mark("launch")
        return self.num_active

    def _fail_all(self, exc: BaseException) -> None:
        """Unblock every active and pending request after a fatal
        scheduler error. The chunk in flight is dropped: its tokens
        belong to the requests failed here."""
        self._inflight = None
        with self._lock:
            pending, self._pending = list(self._pending), collections.deque()
        for slot, req in enumerate(self._slots):
            if req is not None:
                self._slots[slot] = None
                self.active[slot] = False
                req.finish_reason = f"error: {exc!r}"
                self._complete(req)
        for req in pending:
            if self.qos is not None:
                self.qos.on_pending_removed(req.tenant)
            req.finish_reason = f"error: {exc!r}"
            self._complete(req)

    # -- observability ------------------------------------------------------

    def kv_cache_bytes(self) -> int:
        """Device bytes of the slot cache (k, v and int8 scales), the
        scratch row included."""
        return sum(t.numel() * t.element_size()
                   for t in _buffers(self._m.cache))

    def _collect_metrics(self) -> None:
        """Scrape-path mirror of host scheduler state into the registry
        (the reference's families and help texts)."""
        from cloud_server_tpu_torch.inference.anomaly import RULES
        from cloud_server_tpu_torch.inference.faults import SITES
        reg = self.metrics.registry
        reg.gauge("active_slots",
                  "Requests currently decoding").set(self.num_active)
        reg.gauge("pending_requests",
                  "Queued requests awaiting admission").set(
                      self.num_pending)
        reg.counter("tokens_emitted_total",
                    "Lifetime generated tokens").set_total(
                        self.tokens_emitted)
        reg.counter("idle_iterations_total",
                    "step() calls that dispatched nothing").set_total(
                        self.idle_iterations)
        reg.gauge("last_busy_ts",
                  "Unix time of the last busy iteration (0 until the "
                  "first)").set(self.last_busy_ts)
        fstats = (self._faults.stats() if self._faults is not None
                  else None)
        for site in SITES:
            reg.counter("faults_injected_total",
                        "Deliberately injected faults that fired, "
                        "per site (inference/faults.py; zero without "
                        "an armed FaultPlan)",
                        labels={"site": site}).set_total(
                            0 if fstats is None
                            else fstats["fired"][site])
        reg.counter("prefix_hits_total",
                    "Admissions served from the cached prefix"
                    ).set_total(self.prefix_hits)
        reg.counter("prefix_misses_total",
                    "Admissions that missed the cached prefix"
                    ).set_total(self.prefix_misses)
        if self.qos is not None:
            self.qos.mirror_metrics(reg)
        if self.slo is not None:
            self.slo.mirror_metrics(reg)
        astats = (self._anomaly.stats(events=0)
                  if self._anomaly is not None else None)
        for rule in RULES:
            reg.gauge("anomaly_active",
                      "1 while the watchdog rule's anomaly window is "
                      "open (inference/anomaly.py; zero without an "
                      "anomaly config)",
                      labels={"rule": rule}).set(
                          0.0 if astats is None
                          else float(rule in astats["active"]))
            reg.counter("anomalies_total",
                        "Watchdog rule activations (one per anomaly "
                        "window opened, per rule)",
                        labels={"rule": rule}).set_total(
                            0 if astats is None
                            else astats["fired_total"][rule])
        rec = self.trace_recorder
        tstats = (rec.tail_stats() if rec is not None
                  and rec.tail_capacity > 0 else None)
        reg.counter("trace_tail_retained_total",
                    "Head-unsampled finished requests whose span "
                    "trees the tail-retention predicate kept"
                    ).set_total(0 if tstats is None else
                                sum(tstats["retained_total"].values()))
        reg.counter("trace_tail_evicted_total",
                    "Tail-retained trees evicted from the bounded "
                    "tail ring").set_total(
                        0 if tstats is None
                        else tstats["evicted_total"])
        reg.counter("anomaly_bundles_total",
                    "Forensic debug bundles auto-captured on anomaly "
                    "activation (bundle_on_anomaly)").set_total(
                        self._bundles_captured)

    def metrics_snapshot(self) -> dict:
        """Mergeable snapshot of every registered metric."""
        return self.metrics.registry.snapshot()

    def iteration_profile_stats(self) -> dict | None:
        """The /stats `iteration_profile` summary; None with profiling
        disabled."""
        return profile_summary(self.metrics_snapshot())

    @property
    def ready(self) -> bool:
        """False while draining or stopped."""
        return not self._draining and not self._stop.is_set()

    def lookup_trace(self, request_id: str) -> dict | None:
        rec = self.trace_recorder
        return None if rec is None else rec.lookup(request_id)

    def trace_trees(self, n: int | None = None) -> list[dict]:
        rec = self.trace_recorder
        return [] if rec is None else rec.trees(n)

    def slo_report(self) -> dict | None:
        return None if self.slo is None else self.slo.report()

    def fault_stats(self) -> dict | None:
        return None if self._faults is None else self._faults.stats()

    def overlap_stats(self) -> dict:
        """The /stats `overlap` block."""
        return {"enabled": self.overlap, "active": self._overlap_enabled,
                "inflight_depth": 0 if self._inflight is None else 1}

    def request_trace(self, n_steps: int,
                      logdir: str | os.PathLike) -> None:
        """Arm the /debug/trace window over the next `n_steps`
        iterations."""
        self.tracer.request(n_steps, logdir)

    def anomaly_stats(self) -> dict | None:
        return None if self._anomaly is None else self._anomaly.stats()

    def anomaly_events(self, n: int | None = None) -> list[dict]:
        return ([] if self._anomaly is None
                else self._anomaly.events(n))

    def tail_trace_trees(self, n: int | None = None) -> list[dict]:
        rec = self.trace_recorder
        return ([] if rec is None or rec.tail_capacity <= 0
                else rec.tail_trees(n))

    def tail_trace_stats(self) -> dict | None:
        rec = self.trace_recorder
        return (None if rec is None or rec.tail_capacity <= 0
                else rec.tail_stats())

    def _on_anomaly(self, fired) -> None:
        """A rule's activation edge: snapshot a debug bundle
        (`bundle_on_anomaly`) and arm the profiler window when the
        watchdog asks for one; forensics never take the scheduler
        down."""
        if self._bundle_on_anomaly:
            try:
                self._bundles.append(self.debug_bundle(
                    trigger="anomaly:" + ",".join(fired)))
                self._bundles_captured += 1
            except Exception:  # noqa: BLE001 — see docstring
                pass
        wd = self._anomaly
        if wd is not None and wd.capture_iters > 0 and wd.capture_dir:
            try:
                self.tracer.request(wd.capture_iters, wd.capture_dir)
            except ValueError:
                pass  # a capture is already armed or running

    def debug_bundle(self, n: int = 64, *,
                     trigger: str = "manual") -> dict:
        """One forensic artifact (GET /debug/bundle)."""
        return {
            "schema": "cloud_server.debug_bundle/v1",
            "trigger": trigger,
            "ts": time.time(),
            "anomaly": self.anomaly_stats(),
            "metrics": self.metrics_snapshot(),
            "profile": self.iteration_profile_stats(),
            "traces": self.trace_trees(n),
            "tail_traces": self.tail_trace_trees(n),
            "tail_retention": self.tail_trace_stats(),
            "slo": self.slo_report(),
            "faults": self.fault_stats(),
            "overlap": self.overlap_stats(),
        }

    def debug_bundles(self, n: int | None = None) -> list[dict]:
        """The ring of auto-captured bundles (oldest first)."""
        if n is not None and n <= 0:
            return []
        bundles = list(self._bundles)
        return bundles if n is None else bundles[-n:]

    def run_until_idle(self) -> None:
        while self.num_pending or self.num_active:
            self.step()

    # -- background serving -------------------------------------------------

    def serve_forever(self, idle_sleep_s: float = 0.05) -> None:
        while not self._stop.is_set():
            try:
                busy = self.step()
            except Exception as exc:  # noqa: BLE001 — must not hang clients
                import traceback
                traceback.print_exc()
                self._fail_all(exc)
                self._stop.set()
                return
            if busy:
                time.sleep(0)  # let stream consumers run
            if busy == 0 and self.num_pending == 0:
                with self._work:
                    if not self._pending and not self._stop.is_set():
                        self._work.wait(idle_sleep_s)

    def drain(self, timeout: float | None = None, *,
              _resume_on_timeout: bool = True) -> bool:
        """Refuse new submissions and let everything accepted finish.
        True once idle (and stays draining: resume() or stop()); on
        timeout False, accepting again unless `_resume_on_timeout` is
        False (stop(drain=True))."""
        with self._lock:
            self._draining = True
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while self.num_pending or self.num_active:
            if deadline is not None and time.perf_counter() > deadline:
                if _resume_on_timeout:
                    self.resume()
                return False
            if self._thread is None:
                self.step()
            else:
                time.sleep(0.002)
        return True

    def resume(self) -> None:
        """Accept submissions again after a drain."""
        with self._lock:
            self._draining = False

    def stop(self, drain: bool = False,
             timeout: float | None = None) -> None:
        """Stop the scheduler thread, fail whatever is still live, and
        release the captured programs and their memory pool."""
        if drain and not self._stop.is_set():
            self.drain(timeout, _resume_on_timeout=False)
        self._stop.set()
        with self._lock:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self.num_pending or self.num_active:
            self._fail_all(RuntimeError(
                "server stopped before the request completed"))
        with self._step_lock:
            self._inflight = None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._programs.release()

    def start(self) -> "InferenceServer":
        self._stop.clear()
        with self._lock:
            self._draining = False
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True,
                                        name="inference-server")
        self._thread.start()
        return self
