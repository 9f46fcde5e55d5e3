"""Request types and the emit rule shared by the serving stack.

The parts of the reference's `inference/server.py` that the paged
server needs: `QueueFullError`, `Request`, `resolve_seed`, `emit_token`,
`_token_logprobs`, `_bucket` and the on-demand profiler window
`_StepTracer`. The contiguous `InferenceServer` is not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
import uuid
from typing import Callable, Sequence

import torch

from cloud_server_tpu_torch.config import InferConfig
from cloud_server_tpu_torch.inference.sampling import SamplingParams


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
