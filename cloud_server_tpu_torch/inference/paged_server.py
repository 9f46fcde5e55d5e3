"""Paged continuous-batching server: block-table KV, shared prefixes,
chunked prefill, stall-free mixed batching.

A port of the reference's `PagedInferenceServer` with its sequential
mixed scheduler:

  * Memory scales with resident tokens: the pool is `num_pages` pages; a
    slot holds ceil(context / ps) of them.
  * Radix prefix reuse at page granularity (inference/block_allocator.py):
    a request whose token prefix matches cached pages skips prefill for
    them.
  * Chunked prefill under a token budget: while admissions are in
    flight, each iteration runs ONE ragged prefill group (every admitting
    slot the budget selected, each at its own width) followed by the full
    multi-round decode of every live slot, then ONE host sync.
  * Exact staging: a decode dispatch carries one row per live slot, a
    prefill group one row per selected admission at the widest row's
    width. The reference pads both to compile-shape buckets; eager
    PyTorch compiles nothing and the kernel takes ragged widths.
  * On-demand paging: chains grow before each decode dispatch; on pool
    exhaustion the youngest slot is preempted (its pages go to the radix
    cache, its request requeues as a continuation).

Scheduling state is host-authoritative (tables, lengths, active,
last_token in numpy); the device owns the page pools, updated in place
by every dispatch. The reference's `lax.scan` over decode rounds is a
Python loop here; its results stay on the device until the iteration's
one sync.

Write-safety rules (see paged_engine): a slot's chain always covers its
next dispatch's window writes; positions past a row's width write
nothing.

The int8 KV cache (`cfg.kv_cache_dtype == "int8"`) keeps int8 pools
and their f32 scale pools side by side; pages move only by page id, so
a shared radix page carries its scales with it. A `ServingMetrics` is
always on (TTFT, ITL, queue wait, e2e, lifecycle counters), and the
scrape path mirrors occupancy, pool and prefix-cache state into it
(`metrics_snapshot`, the HTTP frontend's `/metrics` and `/stats`).

Not ported yet, and refused with NotImplementedError where a caller asks
for them: the alternating scheduler and the overlap pipeline (`overlap`
is accepted; the sequential loop runs and gives the same tokens),
speculation and draft models, grammar/regex, multi-LoRA, penalties and
logit_bias, min_tokens, QoS, SLO, tracing and trace capture, faults,
brownout, the anomaly watchdog, migration and handoff, the flight
recorder and the iteration profile, `embed`, tensor parallelism and
the full-reservation paging policy (`allocation="reserve"`).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Sequence

import numpy as np
import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import InferConfig, ModelConfig
from cloud_server_tpu_torch.inference import paged_engine
from cloud_server_tpu_torch.inference.block_allocator import BlockAllocator
from cloud_server_tpu_torch.inference.sampling import (
    SamplingParams, SamplingRows, make_rows, rows_to, sample_logits,
    sample_logits_rows)
from cloud_server_tpu_torch.inference.server import (
    QueueFullError, Request, _bucket, _token_logprobs, emit_token,
    resolve_seed)
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import rope_table
from cloud_server_tpu_torch.utils.serving_metrics import ServingMetrics


def _pow2_buckets(lo: int, hi: int) -> list[int]:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    return out + [hi]


# The smallest prefill chunk: when decode alone fills the token budget,
# the oldest admission still advances by this many tokens (the
# reference's smallest remainder bucket).
_MIN_PREFILL_CHUNK = 16


def _take_samp_rows(samp_rows, idx) -> SamplingRows:
    return SamplingRows(*(dst[idx] for dst in samp_rows))


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               "server yet")


@dataclasses.dataclass
class _Slot:
    req: Request
    prompt: list[int]           # admission prompt (original + tokens
    #                             generated before a preemption)
    pages: list[int]            # chain so far, shared prefix first
    shared_len: int
    stop_len: int               # prompt + max_new (absolute positions)
    admit_seq: int = 0          # admission order — preemption picks max


@dataclasses.dataclass
class _AdmitJob:
    """An in-flight chunked admission of ONE slot with token-granular
    progress: `done` advances by whatever width the budget granted."""

    slots: list[int]
    rows: np.ndarray               # (1, rem) remainder tokens
    rem_lens: np.ndarray           # (1,) true remainder length
    base_lens: np.ndarray          # (1,) shared_len
    prompt_lens: np.ndarray        # (1,)
    toks: np.ndarray               # captured first-token candidate
    lps: np.ndarray
    got: np.ndarray                # bool — sample captured yet
    done: int = 0


class PagedInferenceServer:
    """Continuous-batching server over the paged KV cache.

    Client API: submit / generate / step / run_until_idle / start / stop
    / serve_forever. `device` defaults to CUDA; pass device="cpu" to run
    on the CPU.
    """

    def __init__(self, params, cfg: ModelConfig, infer_cfg: InferConfig, *,
                 max_slots: int = 8, max_context: int = 1024,
                 page_size: int = 128, num_pages: int | None = None,
                 prompt_buckets: Sequence[int] | None = None,
                 decode_chunk: int = 8, spec_drafts: int = 0,
                 prefill_chunk: int = 256, seed: int = 0,
                 mesh=None, allocation: str = "ondemand",
                 draft_params=None, draft_cfg: ModelConfig | None = None,
                 tokenizer=None, max_pending: int | None = None,
                 scheduler: str | None = None,
                 mixed_token_budget: int | None = None,
                 metrics=None, flight_recorder_size: int | None = None,
                 qos=None, tracing=None, slo=None, spec_control=None,
                 iteration_profile=None, faults=None, brownout=None,
                 anomaly=None, overlap: bool | None = None, device=None):
        sched = scheduler if scheduler is not None else infer_cfg.scheduler
        refused = {
            "scheduler='alternating'": sched == "alternating",
            "speculative decoding (spec_drafts > 0)": spec_drafts > 0,
            "draft-model speculation": (draft_params is not None
                                        or draft_cfg is not None),
            "tensor-parallel serving (mesh)": mesh is not None,
            f"allocation={allocation!r} (only 'ondemand')":
                allocation != "ondemand",
            "the flight recorder": flight_recorder_size is not None,
            "QoS": qos is not None or bool(infer_cfg.qos_config),
            "request tracing": (tracing is not None
                                or infer_cfg.trace_sample_rate > 0
                                or infer_cfg.trace_tail_capacity > 0),
            "SLO tracking": slo is not None or bool(infer_cfg.slo_config),
            "adaptive speculation control": spec_control is not None,
            "the iteration profile": bool(iteration_profile),
            "fault injection": (faults is not None
                                or bool(infer_cfg.fault_plan)),
            "brownout": (brownout is not None
                         or bool(infer_cfg.brownout_config)),
            "the anomaly watchdog": (anomaly is not None
                                     or bool(infer_cfg.anomaly_config)),
            "MoE models": cfg.num_experts >= 2,
        }
        for what, asked in refused.items():
            if asked:
                raise _not_ported(what)
        if sched != "mixed":
            raise ValueError(f"unknown scheduler: {sched!r}")
        self.device = resolve_device(device)
        self.params = transformer.cast_params(
            _params_on(params, self.device), cfg)
        self.cfg = cfg
        self.infer_cfg = infer_cfg
        # `overlap` is accepted and the sequential loop runs either way:
        # the reference documents identical outputs with it on or off
        del overlap, tokenizer
        self.max_slots = max_slots
        self.page_size = page_size
        self.decode_chunk = max(1, decode_chunk)
        self.window = 1  # kv slack per decode round (no speculation)
        if max_context % page_size:
            raise ValueError(f"{max_context=} must be a multiple of "
                             f"{page_size=}")
        self.max_context = max_context
        self.max_pages_per_slot = max_context // page_size
        if num_pages is None:
            num_pages = max_slots * self.max_pages_per_slot
        self.allocator = BlockAllocator(num_pages, page_size)
        self.prefill_chunk = max(page_size, min(prefill_chunk, max_context))
        if self.prefill_chunk % page_size:
            raise ValueError("prefill_chunk must be a page multiple")
        if prompt_buckets is None:
            prompt_buckets = _pow2_buckets(16, max_context)
        self.prompt_buckets = sorted(prompt_buckets)

        cache = paged_engine.init_paged_cache(
            cfg, num_pages=num_pages, page_size=page_size, batch=max_slots,
            max_pages_per_slot=self.max_pages_per_slot, device=self.device)
        self.k_pool, self.v_pool = cache.k, cache.v
        # the int8 cache's (L, P, KH, ps) f32 scale pools, else None
        self.k_scale_pool, self.v_scale_pool = cache.k_scale, cache.v_scale
        self._rope = rope_table(cfg, max_context, device=self.device)
        # host-authoritative scheduling state
        self.tables = np.full((max_slots, self.max_pages_per_slot),
                              num_pages, np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.active = np.zeros((max_slots,), bool)
        self.last_token = np.zeros((max_slots,), np.int32)
        self.samp_rows = make_rows([None] * max_slots, infer_cfg,
                                   [0] * max_slots)
        self._needs_rows = np.zeros((max_slots,), bool)
        self._host_rng = np.random.default_rng(seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

        self.preemptions = 0
        self.tokens_emitted = 0  # lifetime emitted tokens (metrics)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.metrics.registry.add_collector(self._collect_metrics)
        self._admit_seq = 0
        self._slots: list[_Slot | None] = [None] * max_slots
        self._jobs: list[_AdmitJob] = []
        self._pending: collections.deque[Request] = collections.deque()
        self.max_pending = max_pending
        budget = (mixed_token_budget if mixed_token_budget is not None
                  else infer_cfg.mixed_token_budget)
        if budget is None or budget <= 0:
            budget = max_slots * (self.window * self.decode_chunk
                                  + self.prefill_chunk)
        if budget < self.window:
            raise ValueError(
                f"mixed_token_budget={budget} cannot fit one decode "
                f"window ({self.window} tokens)")
        self.mixed_token_budget = int(budget)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._step_lock = threading.Lock()
        self._draining = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- client API ---------------------------------------------------------

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: int | None = None, stream=None,
               sampling: SamplingParams | None = None,
               adapter: str | None = None, tenant: str | None = None,
               trace_ctx: tuple | None = None,
               deadline_s: float | None = None,
               fail_handler=None, handoff=None,
               _migration=None) -> Request:
        if self._stop.is_set():
            raise RuntimeError("server is stopped; not accepting requests")
        if adapter is not None:
            raise _not_ported("multi-LoRA serving (adapter=)")
        if fail_handler is not None or _migration is not None:
            raise _not_ported("router failover and migration")
        if handoff is not None:
            raise _not_ported("disaggregated prefill/decode handoff")
        if sampling is not None:
            if sampling.needs_penalty_state():
                raise _not_ported("repetition/presence/frequency penalties")
            if sampling.logit_bias:
                raise _not_ported("logit_bias")
            if sampling.regex is not None:
                raise _not_ported("regex-constrained decoding")
            if sampling.min_tokens > 0:
                raise _not_ported("min_tokens")
        if deadline_s is not None and not (
                math.isfinite(deadline_s) and deadline_s > 0):
            raise ValueError("deadline_s must be a finite positive "
                             "number of seconds")
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        _bucket(len(prompt), self.prompt_buckets)  # raises if too long
        max_new = (self.infer_cfg.max_decode_len if max_new_tokens is None
                   else max_new_tokens)
        max_new = min(max_new, self.max_context - len(prompt) - self.window)
        if max_new <= 0:
            raise ValueError(
                f"prompt of {len(prompt)} tokens leaves no room to decode "
                f"within max_context={self.max_context}")
        # without a QoS registry the reference drops the tenant too
        del tenant, trace_ctx
        req = Request(prompt=list(prompt), max_new_tokens=max_new,
                      stream=stream, sampling=sampling,
                      seed_used=resolve_seed(sampling, self._host_rng,
                                             self._lock),
                      submit_time=time.perf_counter())
        if deadline_s is not None:
            req.deadline = req.submit_time + float(deadline_s)
        req._on_cancel = self._handle_cancel
        with self._lock:
            if self._draining:
                raise RuntimeError(
                    "server is draining; not accepting requests")
            if (self.max_pending is not None
                    and len(self._pending) >= self.max_pending):
                raise QueueFullError(
                    f"pending queue is full ({self.max_pending} requests);"
                    " retry later")
            # telemetry before the append: once queued, the scheduler
            # thread may admit (even finish) the request
            req.record_event("submit", req.submit_time)
            self.metrics.observe_submit(req)
            self._pending.append(req)
            self._work.notify()
        return req

    def _handle_cancel(self, req: Request) -> None:
        with self._lock:
            try:
                self._pending.remove(req)
            except ValueError:
                return  # admitted: the step sweep owns the teardown
        req.finish_reason = "cancelled"
        self._complete(req)

    def _complete(self, req: Request) -> None:
        """Terminal bookkeeping for every path that ends a request
        (finish / cancel / fail): lifecycle metrics, then unblock
        waiters."""
        self.metrics.observe_finish(req)
        # a finished request's cancel() is a no-op: drop the bound method,
        # so requests a caller keeps do not keep the server and its pools
        req._on_cancel = None
        req._done.set()

    def generate(self, prompts, *, max_new_tokens=None):
        reqs = [self.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]
        self.run_until_idle()
        return [r.tokens for r in reqs]

    def embed(self, prompts):
        raise _not_ported("embed")

    def request_trace(self, steps: int, logdir: str) -> None:
        raise _not_ported("trace capture (POST /debug/trace)")

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def num_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def ready(self) -> bool:
        """Readiness (vs liveness): False while draining or stopped, so
        load balancers stop routing new work here while in-flight
        requests finish."""
        return not self._draining and not self._stop.is_set()

    def prefix_cache_stats(self):
        return self.allocator.stats()

    def kv_cache_bytes(self) -> int:
        """Device bytes of the page pools (and the int8 cache's scales)."""
        return paged_engine.hbm_bytes(self._cache(self.lengths, self.tables))

    # -- internals ----------------------------------------------------------

    def _cache(self, lengths, tables) -> paged_engine.PagedKVCache:
        """A view of the device pools with host `lengths`/`tables`."""
        return paged_engine.make_cache(self.k_pool, self.v_pool, lengths,
                                       tables, self.k_scale_pool,
                                       self.v_scale_pool)

    def _emit(self, req: Request, token: int, logprob: float) -> bool:
        n0 = len(req.emit_times)
        done = emit_token(req, token, logprob, self.infer_cfg)
        if not (done and req.finish_reason == "eos"):
            self.tokens_emitted += 1  # stop-truncated tokens still count
        if len(req.emit_times) > n0:  # a stop match truncates instead
            self.metrics.observe_emit(req)
        return done

    def _committed(self, slot_id: int) -> list[int]:
        """The slot's committed token stream, truncated to the written-KV
        watermark (the newest sampled token has no KV yet)."""
        slot = self._slots[slot_id]
        since = len(slot.prompt) - len(slot.req.prompt)
        stream = slot.prompt + slot.req.tokens[since:]
        return stream[:int(self.lengths[slot_id])]

    def _release_slot(self, slot_id: int, keyed_tokens: list[int]) -> _Slot:
        slot = self._slots[slot_id]
        self.allocator.release(slot.pages, keyed_tokens)
        self._slots[slot_id] = None
        self.tables[slot_id, :] = self.allocator.num_pages  # sentinel
        self.active[slot_id] = False
        self.lengths[slot_id] = 0
        self._needs_rows[slot_id] = False
        return slot

    def _finish(self, slot_id: int) -> None:
        slot = self._release_slot(slot_id, self._committed(slot_id))
        self._complete(slot.req)

    # -- admission ----------------------------------------------------------

    def _start_admissions(self) -> None:
        """Pop pending requests into slots (pages permitting), one chunked
        admission job each. A request that carries generated tokens is a
        continuation (it was preempted): its admission prompt is prompt +
        tokens, so the prefix walk re-hits the pages it released."""
        staged: list[int] = []
        doomed: list[Request] = []
        with self._lock:
            free = [i for i, s in enumerate(self._slots) if s is None]
            while self._pending and free:
                req = self._pending[0]
                prompt = list(req.prompt) + list(req.tokens)
                remaining = req.max_new_tokens - len(req.tokens)
                shared, shared_len = self.allocator.lookup_prefix(prompt)
                # on-demand paging: the prompt and one window now, the
                # rest grows before each decode dispatch
                total = len(prompt) + self.window
                need = -(-total // self.page_size) - len(shared)
                fresh = self.allocator.alloc(max(0, need))
                if fresh is None:
                    self.allocator.release(shared, prompt[:shared_len])
                    if self.num_active == 0 and not self._jobs:
                        self._pending.popleft()
                        req.finish_reason = (
                            "error: request needs more pages than the "
                            "pool can ever provide")
                        doomed.append(req)
                        continue
                    break
                self._pending.popleft()
                if shared_len:
                    self.allocator.telemetry.record_saved(None, shared_len)
                slot_id = free.pop(0)
                self._admit_seq += 1
                slot = _Slot(req=req, prompt=prompt,
                             pages=shared + fresh, shared_len=shared_len,
                             stop_len=len(prompt) + remaining,
                             admit_seq=self._admit_seq)
                self._slots[slot_id] = slot
                self.tables[slot_id, :] = self.allocator.num_pages
                self.tables[slot_id, :len(slot.pages)] = slot.pages
                self.lengths[slot_id] = shared_len
                self.active[slot_id] = False  # live once admission is done
                row = make_rows([req.sampling], self.infer_cfg,
                                [req.seed_used],
                                prompt_lens=[len(req.prompt)])
                for dst, src in zip(self.samp_rows, row):
                    dst[slot_id] = src[0]
                self._needs_rows[slot_id] = (
                    req.sampling is not None
                    and req.sampling.needs_device_rows(self.infer_cfg))
                staged.append(slot_id)
        for req in doomed:
            self._complete(req)
        now = time.perf_counter()  # one clock read per admission burst
        for slot_id in staged:
            slot = self._slots[slot_id]
            self.metrics.observe_admit(slot.req, now)
            rem_toks = slot.prompt[slot.shared_len:]
            job = _AdmitJob(
                slots=[slot_id],
                rows=np.asarray([rem_toks], np.int32),
                rem_lens=np.asarray([len(rem_toks)], np.int32),
                base_lens=np.asarray([slot.shared_len], np.int32),
                prompt_lens=np.asarray([len(slot.prompt)], np.int32),
                toks=np.zeros((1,), np.int32),
                lps=np.zeros((1,), np.float64),
                got=np.zeros((1,), bool))
            self._jobs.append(job)

    # -- decode -------------------------------------------------------------

    def _preempt_youngest(self, protect: int) -> bool:
        """Free the youngest live slot's pages (content-keyed into the
        radix cache) and requeue its request at the FRONT of the queue as
        a continuation. False when nothing but `protect` is preemptible."""
        candidates = [sid for sid, s in enumerate(self._slots)
                      if s is not None and self.active[sid]
                      and sid != protect]
        if not candidates:
            return False
        sid = max(candidates, key=lambda s: self._slots[s].admit_seq)
        slot = self._release_slot(sid, self._committed(sid))
        self.preemptions += 1
        self.metrics.observe_requeue(slot.req, time.perf_counter())
        with self._lock:
            self._pending.appendleft(slot.req)
        return True

    def _extend_chains(self, n_rounds: int) -> int:
        """On-demand policy: before a decode dispatch of n_rounds, grow
        every live slot's chain to cover its worst-case window writes.
        On exhaustion: partial growth, then preempt youngest-first, then
        bound the dispatch to the rounds every chain covers. Returns the
        dispatchable round count (0 = skip)."""
        n_eff = n_rounds
        for sid in range(self.max_slots):
            slot = self._slots[sid]
            if slot is None or not self.active[sid]:
                continue
            while True:
                need_len = min(
                    int(self.lengths[sid]) + n_rounds * self.window,
                    slot.stop_len + self.window)
                delta = -(-need_len // self.page_size) - len(slot.pages)
                if delta <= 0:
                    break
                grab = min(delta, self.allocator.available)
                fresh = self.allocator.alloc(grab) if grab > 0 else None
                if fresh:
                    start = len(slot.pages)
                    slot.pages.extend(fresh)
                    self.tables[sid, start:len(slot.pages)] = fresh
                    if grab == delta:
                        break
                    continue
                if self._preempt_youngest(protect=sid):
                    continue
                covered = len(slot.pages) * self.page_size
                r_ok = max(0, (covered - int(self.lengths[sid]))
                           // self.window)
                if (r_ok == 0 and not self._jobs
                        and self.num_pending == 0
                        and self.allocator.available == 0
                        and self.num_active == 1):
                    slot = self._release_slot(sid, self._committed(sid))
                    slot.req.finish_reason = (
                        "error: request needs more pages than the pool "
                        "can ever provide")
                    self._complete(slot.req)
                    break
                n_eff = min(n_eff, r_ok)
                break
        return n_eff

    def _chunk_rounds(self) -> int:
        """Rounds for a decode-only dispatch: decode_chunk, bounded by the
        tightest remaining budget, rounded down to a power of two."""
        rem = [s.req.max_new_tokens - len(s.req.tokens)
               for i, s in enumerate(self._slots)
               if s is not None and self.active[i]]
        if not rem:
            return 1
        n = max(1, min(self.decode_chunk, -(-min(rem) // self.window)))
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def _gather_decode_rows(self):
        """Compacted decode sub-batch: exactly one row per live slot."""
        live_ids = np.flatnonzero(self.active)
        return (live_ids, self.lengths[live_ids], self.tables[live_ids],
                self.last_token[live_ids],
                _take_samp_rows(self.samp_rows, live_ids))

    def _sample(self, logits, samp, positions, use_rows: bool):
        if use_rows:
            return sample_logits_rows(logits, rows_to(samp, self.device),
                                      positions, use_bias=False)
        return sample_logits(logits, self._gen, self.infer_cfg)

    def _decode_rounds(self, lengths, tables, last, samp, n_rounds: int,
                       use_rows: bool):
        """n_rounds plain decode steps (W = 1) of the live rows, each
        advancing one token per round. Lengths advance on the host;
        sampled tokens stay on the device. Returns (lengths', last'
        (device), toks (R, B), lps (R, B)) — toks/lps still on the
        device."""
        last_t = torch.as_tensor(last, device=self.device).long()
        at = torch.zeros((len(lengths),), dtype=torch.long)
        toks, lps = [], []
        for _ in range(n_rounds):
            logits, _ = paged_engine.window_forward(
                self.params, last_t[:, None], self.cfg,
                self._cache(lengths, tables), logits_at=at,
                rope=self._rope)
            last_t = self._sample(logits, samp, lengths + 1, use_rows)
            lengths = lengths + 1
            toks.append(last_t)
            lps.append(_token_logprobs(logits, last_t))
        return lengths, last_t, torch.stack(toks), torch.stack(lps)

    def _decode_dispatch(self) -> None:
        n = self._chunk_rounds()
        n_eff = self._extend_chains(n)
        if n_eff <= 0 or not self.active.any():
            return  # transient page famine
        while n > n_eff:
            n //= 2
        n = max(1, n)
        live_ids, lengths, tables, last, samp = self._gather_decode_rows()
        use_rows = bool(self._needs_rows[live_ids].any())
        lens, last_t, toks, lps = self._decode_rounds(
            lengths, tables, last, samp, n, use_rows)
        # the iteration's one host sync
        self._commit_decode_rows(live_ids, toks.cpu().numpy(),
                                 lps.cpu().numpy(), lens,
                                 last_t.cpu().numpy())

    def _commit_decode_rows(self, live_ids, toks, lps, lens, last) -> None:
        """Scatter a compacted decode dispatch's results back to slots
        and emit, round by round."""
        self.lengths[live_ids] = lens
        self.last_token[live_ids] = last
        for r in range(toks.shape[0]):
            for i, sid in enumerate(live_ids):
                slot = self._slots[sid]
                if slot is None or not self.active[sid]:
                    continue
                if self._emit(slot.req, int(toks[r, i]), float(lps[r, i])):
                    self._finish(sid)

    def _complete_admission_chunks(self, sel, ptoks, plps) -> None:
        """Prefill progress on the synced first-token candidates: capture
        samples in range, advance `done`, activate completed admissions."""
        for i, (job, take, d0) in enumerate(sel):
            sid = job.slots[0]
            rl = int(job.rem_lens[0])
            if d0 <= rl - 1 < d0 + take:
                job.toks[0] = ptoks[i]
                job.lps[0] = plps[i]
                job.got[0] = True
            job.done = d0 + take
            if job.done < rl:
                continue
            slot = self._slots[sid]
            assert bool(job.got[0]), "first-token sample never captured"
            self.lengths[sid] = len(slot.prompt)
            self.last_token[sid] = int(job.toks[0])
            if slot.req._cancel.is_set():
                slot = self._release_slot(sid, self._committed(sid))
                slot.req.finish_reason = "cancelled"
                self._complete(slot.req)
            else:
                self.active[sid] = True
                if self._emit(slot.req, int(job.toks[0]),
                              float(job.lps[0])):
                    self._finish(sid)
            self._jobs.remove(job)

    # -- mixed (stall-free) scheduling --------------------------------------

    def _mixed_rounds(self, n_live: int, prefill_demand: int,
                      win: int) -> int:
        """Decode rounds for a mixed iteration: the full steady-state
        count, squeezed to leave the budget one minimal prefill chunk
        when admissions wait, floored at one, a power of two."""
        rem = [s.req.max_new_tokens - len(s.req.tokens)
               for i, s in enumerate(self._slots)
               if s is not None and self.active[i]]
        if not rem or not n_live:
            return 0
        n = max(1, min(self.decode_chunk, -(-min(rem) // win)))
        if prefill_demand > 0:
            fit = (self.mixed_token_budget - _MIN_PREFILL_CHUNK) \
                // (n_live * win)
            n = min(n, max(fit, 1))
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def _select_prefill(self, jobs, n_live: int, win: int, n_rounds: int):
        """Token-budget prefill selection, FIFO: decode rows are funded
        first, each job takes up to `prefill_chunk` tokens of its
        remainder, and when decode alone saturates the budget the oldest
        admission still gets one minimal chunk. [(job, take, offset)]."""
        sel: list[tuple[_AdmitJob, int, int]] = []
        left = self.mixed_token_budget - n_live * win * n_rounds
        for job in jobs:
            if left <= 0:
                break
            take = min(int(job.rem_lens[0]) - job.done, left,
                       self.prefill_chunk)
            if take <= 0:
                continue
            sel.append((job, take, job.done))
            left -= take
        if jobs and not sel:
            job = jobs[0]
            take = min(int(job.rem_lens[0]) - job.done, _MIN_PREFILL_CHUNK)
            sel = [(job, take, job.done)]
        return sel

    def _build_prefill_group(self, sel) -> dict:
        """Host staging of the ragged prefill group: one row per selected
        admission chunk at its own width, staged at the widest row's
        width."""
        g = len(sel)
        w = max(t for _, t, _ in sel)
        chunk = np.full((g, w), self.infer_cfg.pad_token_id, np.int32)
        widths = np.zeros((g,), np.int32)
        g_lens = np.zeros((g,), np.int32)
        g_tables = np.zeros((g, self.max_pages_per_slot), np.int32)
        sample_at = np.zeros((g,), np.int32)
        slot_ids = np.zeros((g,), np.int64)
        prompt_lens = np.zeros((g,), np.int32)
        for i, (job, take, d0) in enumerate(sel):
            sid = job.slots[0]
            rl = int(job.rem_lens[0])
            chunk[i, :take] = job.rows[0, d0:d0 + take]
            widths[i] = take
            g_lens[i] = int(job.base_lens[0]) + d0
            g_tables[i] = self.tables[sid]
            sample_at[i] = min(max(rl - 1 - d0, 0), take - 1)
            slot_ids[i] = sid
            prompt_lens[i] = int(job.prompt_lens[0])
        return {"chunk": chunk, "widths": widths, "g_lens": g_lens,
                "g_tables": g_tables, "sample_at": sample_at,
                "prompt_lens": prompt_lens,
                "samp_g": _take_samp_rows(self.samp_rows, slot_ids),
                "sel_ids": slot_ids}

    def _prefill_group(self, pf: dict, use_rows: bool):
        """The ragged prefill half: one window_forward over the selected
        chunks; first-token candidates at each row's sample position."""
        chunk = torch.as_tensor(pf["chunk"], device=self.device)
        logits, _ = paged_engine.window_forward(
            self.params, chunk, self.cfg,
            self._cache(pf["g_lens"], pf["g_tables"]),
            logits_at=torch.as_tensor(pf["sample_at"]),
            widths=pf["widths"], rope=self._rope)
        toks = self._sample(logits, pf["samp_g"],
                            pf["prompt_lens"].astype(np.int64), use_rows)
        return toks, _token_logprobs(logits, toks)

    def _mixed_dispatch(self) -> None:
        """One token-budget iteration: the ragged prefill group plus the
        multi-round decode of every live slot, then one host sync."""
        demand = sum(int(j.rem_lens[0]) - j.done for j in self._jobs)
        n_live = int(self.active.sum())
        win = 1
        n_rounds = self._mixed_rounds(n_live, demand, win)
        if n_rounds > 0:
            n_eff = self._extend_chains(n_rounds)
            if n_eff <= 0 or not self.active.any():
                n_rounds = 0  # transient page famine: prefill-only
            else:
                while n_rounds > n_eff:
                    n_rounds //= 2
                n_rounds = max(1, n_rounds)
        n_live = int(self.active.sum()) if n_rounds > 0 else 0
        sel = self._select_prefill(self._jobs, n_live, win, n_rounds)
        if not sel and not n_rounds:
            return

        pf = self._build_prefill_group(sel)
        use_rows_p = bool(self._needs_rows[pf["sel_ids"]].any())
        ptoks, plps = self._prefill_group(pf, use_rows_p)

        if n_rounds > 0:
            live_ids, lengths, tables, last, samp = \
                self._gather_decode_rows()
            use_rows_d = bool(self._needs_rows[live_ids].any())
            lens, last_t, toks, lps = self._decode_rounds(
                lengths, tables, last, samp, n_rounds, use_rows_d)
        # the iteration's one host sync
        ptoks, plps = ptoks.cpu().numpy(), plps.cpu().numpy()
        if n_rounds > 0:
            self._commit_decode_rows(live_ids, toks.cpu().numpy(),
                                     lps.cpu().numpy(), lens,
                                     last_t.cpu().numpy())
        self._complete_admission_chunks(sel, ptoks, plps)

    # -- the scheduler loop -------------------------------------------------

    def _sweep_cancelled(self) -> None:
        """Reap cancelled and deadline-expired requests that hold a slot
        (not mid-admission), and expired pending requests."""
        job_slots = {s for job in self._jobs for s in job.slots}
        now = time.perf_counter()
        for sid, slot in enumerate(self._slots):
            if slot is None or sid in job_slots:
                continue
            reason = None
            if slot.req._cancel.is_set():
                reason = "cancelled"
            elif slot.req.deadline is not None and now > slot.req.deadline:
                reason = "deadline"
            if reason is not None:
                slot = self._release_slot(sid, self._committed(sid))
                slot.req.finish_reason = reason
                self._complete(slot.req)
        with self._lock:
            expired = [r for r in self._pending
                       if r.deadline is not None and now > r.deadline]
            for r in expired:
                self._pending.remove(r)
        for r in expired:
            r.finish_reason = "deadline"
            self._complete(r)

    def step(self) -> int:
        """One scheduler iteration: reap cancellations, start admissions,
        then dispatch — the fused mixed iteration while any admission is
        in flight, else a multi-round decode dispatch. Thread-safe."""
        with self._step_lock:
            self._sweep_cancelled()
            self._start_admissions()
            if self._jobs:
                self._mixed_dispatch()
            elif self.active.any():
                self._decode_dispatch()
            return self.num_active

    def run_until_idle(self) -> None:
        while self.num_pending or self.num_active or self._jobs:
            self.step()

    def _fail_all(self, exc: BaseException) -> None:
        with self._step_lock:
            with self._lock:
                pending, self._pending = (list(self._pending),
                                          collections.deque())
            for sid in range(self.max_slots):
                if self._slots[sid] is not None:
                    # key nothing: a failed dispatch may have left these
                    # pages half-written
                    slot = self._release_slot(sid, [])
                    slot.req.finish_reason = f"error: {exc!r}"
                    self._complete(slot.req)
            self._jobs.clear()
        for req in pending:
            req.finish_reason = f"error: {exc!r}"
            self._complete(req)

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
                time.sleep(0)
            if busy == 0 and self.num_pending == 0 and not self._jobs:
                with self._work:
                    if not self._pending and not self._stop.is_set():
                        self._work.wait(idle_sleep_s)

    def start(self) -> "PagedInferenceServer":
        self._stop.clear()
        with self._lock:
            self._draining = False
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True,
                                        name="paged-inference-server")
        self._thread.start()
        return self

    def drain(self, timeout: float | None = None, *,
              _resume_on_timeout: bool = True) -> bool:
        """Graceful drain: refuse new submissions and let everything
        already accepted run to completion. Returns True once idle and
        stays draining (resume() accepts again, stop() shuts down). On
        timeout returns False and accepts again, unless
        `_resume_on_timeout` is False (stop(drain=True), which must not
        accept a request only to fail it)."""
        with self._lock:
            self._draining = True
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while self.num_pending or self.num_active or self._jobs:
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
        if drain and not self._stop.is_set():
            self.drain(timeout, _resume_on_timeout=False)
        self._stop.set()
        with self._lock:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self.num_pending or self.num_active or self._jobs:
            self._fail_all(RuntimeError(
                "server stopped before the request completed"))


    # -- observability ------------------------------------------------------

    def _collect_metrics(self) -> None:
        """Scrape-path mirror of host scheduler and allocator state into
        the registry (never touched on the serving path). The families
        and their help texts are the reference's."""
        reg = self.metrics.registry
        reg.gauge("active_slots",
                  "Requests currently decoding").set(self.num_active)
        reg.gauge("pending_requests",
                  "Queued requests awaiting admission").set(
                      self.num_pending)
        reg.gauge("admission_jobs",
                  "Chunked-prefill admission jobs in flight").set(
                      len(self._jobs))
        reg.counter("tokens_emitted_total",
                    "Lifetime generated tokens").set_total(
                        self.tokens_emitted)
        reg.counter("preemptions_total",
                    "Lifetime on-demand-paging preemptions").set_total(
                        self.preemptions)
        stats = self.allocator.stats()
        reg.gauge("pages_total",
                  "KV page pool size").set(stats.pages_total)
        reg.gauge("pages_free",
                  "Unallocated KV pages").set(stats.pages_free)
        reg.gauge("pages_cached",
                  "Refcount-0 prefix-cached KV pages (evictable)").set(
                      stats.pages_cached)
        reg.gauge("pages_active",
                  "KV pages referenced by live slots").set(
                      stats.pages_active)
        reg.counter("prefix_hit_pages_total",
                    "Admission pages served from the radix prefix cache"
                    ).set_total(stats.prefix_hit_pages)
        reg.counter("prefix_miss_pages_total",
                    "Admission pages that missed the radix prefix cache"
                    ).set_total(stats.prefix_miss_pages)
        reg.counter("prefix_evictions_total",
                    "Prefix-cache pages evicted under memory pressure"
                    ).set_total(stats.evictions)
        reg.counter("prefix_hit_tokens_total",
                    "Token value of prefix-cache page hits (prefill "
                    "work the cache absorbed)").set_total(
                        stats.hits_tokens)
        reg.counter("pages_allocated_total",
                    "Fresh KV pages handed out by the allocator"
                    ).set_total(self.allocator.pages_allocated)
        reg.counter("pages_released_total",
                    "KV pages whose refcount reached zero (cached or "
                    "freed)").set_total(self.allocator.pages_released)

    def metrics_snapshot(self) -> dict:
        """Mergeable snapshot of every registered metric (the /metrics
        and /stats source)."""
        return self.metrics.registry.snapshot()


def _params_on(params, device):
    if isinstance(params, dict):
        return {k: _params_on(v, device) for k, v in params.items()}
    return torch.as_tensor(params).to(device)
