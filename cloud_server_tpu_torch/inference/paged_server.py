"""Paged continuous-batching server: block-table KV, shared prefixes,
chunked prefill, stall-free mixed batching, one program per iteration.

A port of the reference's `PagedInferenceServer`:

  * Memory scales with resident tokens: the pool is `num_pages` pages; a
    slot holds ceil(context / ps) of them.
  * Radix prefix reuse at page granularity (inference/block_allocator.py):
    a request whose token prefix matches cached pages skips prefill for
    them.
  * Two schedulers under admission churn. "mixed" (default): while
    admissions are in flight, each iteration is ONE program — a ragged
    prefill group (every admitting slot the token budget selected, each
    at its own width) followed by the multi-round decode of every live
    slot. "alternating": per-bucket prefill-chunk programs, then a decode
    program, each iteration.
  * Bucketed staging, the reference's compile shapes: decode rows are
    the live slots compacted and padded to a power of two (padding rows
    carry sentinel tables, so they write nothing), or exactly the slots
    when every slot is live; a prefill group is padded to a power of two
    rows and a `_mixed_buckets` width; padding rows sample with neutral
    fills. Each program (its body, static switches — rounds, draft
    count, per-row sampling, bias, grammar, penalty state — and input
    shapes; with the grammar stack's generation when it reads the
    stack) is one captured CUDA graph (inference/graphs.py), replayed
    with its inputs copied in from pinned host staging and its results
    copied out to pinned host buffers, then one event: the iteration's
    one host sync is the wait on that event.
  * The overlap pipeline (mixed scheduler, `overlap` on by default):
    iteration N+1 is planned on the host while the card runs N; a
    steady step then commits N and launches N+1 — one launch and one
    sync per step. Slots reaped while a dispatch is in flight are
    released right after its commit.
  * Page allocation: on demand (the default), chains grow before each
    decode dispatch; on pool exhaustion the youngest slot is preempted
    (its pages go to the radix cache, its request requeues as a
    continuation). `allocation="reserve"` reserves the whole chain
    (prompt + max_new + window slack) at admission instead: no chain
    grows and nothing is preempted.
  * Seeded server-global sampling splits one threefry key as the
    reference splits its own (once per dispatch, then per half and per
    round), so with the reference's staged shapes the draws are its
    token for token.

  * Speculation is the decode loop when `spec_drafts` > 0: per-slot
    n-gram proposals from each slot's token history, or a draft model
    (`draft_params`/`draft_cfg`) decoding against its own pools on the
    same page ids, verified in one W = drafts + 1 window and committed
    with the exact accept rule (inference/speculative.py), under both
    schedulers and the overlap pipeline. Adaptive per-slot draft lengths
    (inference/spec_control.py) are on by default.
  * Per-request sampling rows carry penalties, logit_bias and min_tokens,
    and regex-constrained decoding (inference/grammar.py): each slot's
    DFA state masks its logits, through speculative windows too.

Scheduling state is host-authoritative (tables, lengths, active,
last_token in numpy); the device owns the page pools and the per-slot
state programs carry across iterations (`_Model`: penalty counts, DFA
states, the token history), updated in place by every program. The
reference's `lax.scan` over decode rounds is a Python loop inside the
captured program.

Write-safety rules (see paged_engine): a slot's chain always covers its
next dispatch's window writes; positions past a row's width and rows on
sentinel tables write nothing a kernel reads.

The int8 KV cache (`cfg.kv_cache_dtype == "int8"`) keeps int8 pools
and their f32 scale pools side by side; pages move only by page id, so
a shared radix page carries its scales with it. A `ServingMetrics` is
always on (TTFT, ITL, queue wait, e2e, lifecycle counters), and the
scrape path mirrors occupancy, pool and prefix-cache state into it
(`metrics_snapshot`, the HTTP frontend's `/metrics` and `/stats`). The
flight recorder keeps one record per busy iteration (`flight_window`),
with the iteration profile's phase split (`iteration_profile_stats`,
`/debug/scheduler_trace`).

The host policy layer, each part None (and its call sites skipped)
unless configured: multi-tenant QoS (`qos=`: deficit round-robin
admission, token buckets, priority preemption, class deadlines), SLO
tracking (`slo=`), request tracing with tail retention (`tracing=`),
seeded fault injection (`faults=`) and overload brownout (`brownout=`),
the anomaly watchdog (`anomaly=`) with debug bundles, and the on-demand
profiler window (`request_trace`, POST /debug/trace). It reads host
state the scheduler already owns: no program, launch or sync is added.

Live migration (inference/migration.py) and the disaggregated handoff,
for a router's replicas (inference/router.py): `migrate_export` takes a
live request's snapshot at the commit point (its committed full pages
gathered on the card, copied to pinned host memory, one event waited
on), `migrate_salvage` a host-only one from a failed server's handle,
and `migrate_import` writes the pages into this server's pools in place
(pinned staging, non-blocking copies on the programs' stream, no host
sync) under their radix keys, then re-admits the request as a
continuation. `drain(migrate=...)` evacuates every live request. A
request submitted with `handoff=` calls it when its prefill completes,
the D2H copies of its committed pages already started on a side stream
under the final chunk (`_handoff_prefetch`, `_handoff_copy_out`). Token
exactness rests on the host state alone; the pages save re-prefill.

Multi-LoRA serving (inference/multi_lora.py): `add_adapter` registers an
adapter into stacked device tensors, `submit(adapter=name)` selects it
per request, and every program whose slots carry an adapter gathers
each row's (A, B, scale) per layer (row 0, the null adapter, adds
exactly 0). Such programs are keyed by the stacks' generation: an add
that fits their capacity writes its rows in place and the captured
graphs serve it; one that grows them releases the programs of the old
generation after the dispatch in flight has committed. Radix prefix
chains are namespaced per adapter. `embed` returns mean-pooled,
L2-normalised sequence embeddings of the base model
(`engine.encode`).

MoE models (models/moe.py) serve on the same programs: each
window_forward routes its (B, W) rows per layer, so capacity is
contended over a call's rows as in the reference; adapters on an MoE
base may target attention only.

Tensor-parallel serving (`mesh=`, one process per rank; see the class
docstring): each rank holds its shard of the weights and of the pools'
kv heads, rank 0 schedules and broadcasts every dispatch to the other
ranks (`follow()`), and the programs' forwards sum and gather over the
tp group. Both schedulers, the overlap pipeline, captured graphs,
every sampling mode, the int8 KV cache, n-gram speculation, both
allocation policies, penalties, logit_bias, min_tokens and grammars
serve under it. Not ported yet under it, and refused with
NotImplementedError where a caller asks for it: draft-model
speculation, adapters, int8 weights, MoE models, `embed`, migration
and the handoff, and mesh axes other than tp.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import os
import threading
import sys
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import InferConfig, ModelConfig
from cloud_server_tpu_torch.inference import graphs, paged_engine
from cloud_server_tpu_torch.inference.anomaly import RULES, resolve_anomaly
from cloud_server_tpu_torch.inference.block_allocator import BlockAllocator
from cloud_server_tpu_torch.inference.cache_telemetry import (
    hit_rate, register_cache_hists)
from cloud_server_tpu_torch.inference.faults import (
    SITES, BrownoutShedError, resolve_brownout, resolve_fault_plan)
from cloud_server_tpu_torch.inference.grammar import DEAD as _GDEAD
from cloud_server_tpu_torch.inference.iteration_profile import (
    OVERLAP_PHASES, derive_gap_fields, profile_summary,
    register_phase_hists, resolve_profiler)
from cloud_server_tpu_torch.inference.migration import (
    MIGRATION_VERSION, MigrationLedger, MigrationSnapshot)
from cloud_server_tpu_torch.inference.multi_lora import AdapterSet
from cloud_server_tpu_torch.inference.qos import (PRIORITY_CLASSES,
                                                  resolve_registry)
from cloud_server_tpu_torch.inference.request_trace import resolve_recorder
from cloud_server_tpu_torch.inference.sampling import (
    _BIAS_PAD, SamplingParams, SamplingRows, make_rows, rows_in,
    rows_staged, sample_from_probs, sample_logits, sample_logits_rows,
    sampling_probs, sampling_probs_rows)
from cloud_server_tpu_torch.inference.server import (
    QueueFullError, Request, _bucket, _StepTracer, _token_logprobs,
    emit_token, resolve_seed)
from cloud_server_tpu_torch.inference.slo import resolve_slo
from cloud_server_tpu_torch.inference.spec_control import resolve_controller
from cloud_server_tpu_torch.inference.speculative import (
    _TAG_DRAFT, _accept_drafts, _accept_point_mass, _ngram_drafts,
    _row_pos_keys, sample_from_probs_keyed)
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import rope_table
from cloud_server_tpu_torch.ops.paged_attention import check_tp_heads
from cloud_server_tpu_torch.parallel.distributed import (BroadcastChannel,
                                                         group_timeout_s,
                                                         new_gloo_group)
from cloud_server_tpu_torch.parallel.mesh import axis_size
from cloud_server_tpu_torch.parallel.sharding import shard_params
from cloud_server_tpu_torch.utils import prng
from cloud_server_tpu_torch.utils.serving_metrics import (FlightRecorder,
                                                          ServingMetrics)


def _pow2_buckets(lo: int, hi: int) -> list[int]:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    return out + [hi]


def _pad_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


# Neutral per-field fills for padding rows of a gathered SamplingRows
# (temperature 0 = greedy, rep/top_p 1, bias slots out of the vocab):
# padding samples are discarded, but must stay finite. Fields absent
# here fill with 0.
_SAMP_PAD_FILLS = {"top_p": 1.0, "rep": 1.0, "bias_ids": _BIAS_PAD}


def _gather_samp_rows(samp_rows, idx, n_real) -> SamplingRows:
    """Per-slot SamplingRows rows gathered at `idx` (pre-clipped), with
    rows past n_real overwritten by the neutral pad fills."""
    out = []
    for name, dst in zip(SamplingRows._fields, samp_rows):
        rows = dst[idx].copy()
        rows[n_real:] = _SAMP_PAD_FILLS.get(name, 0)
        out.append(rows)
    return SamplingRows(*out)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to the PyTorch "
                               "server yet")


# ---------------------------------------------------------------------------
# Program bodies (captured per shape key by inference/graphs.py)
# ---------------------------------------------------------------------------


class _Model:
    """What every program reads besides its input buffers: the weights,
    the page pools (and the draft model's, on the same page ids), the
    rope tables, and the per-slot device state that lives across
    programs. Every per-slot tensor carries one scratch row past
    `max_slots` (and `hist` one scratch column past `max_context`):
    padding rows carry the sentinel slot id, so their scatters land
    there, the counterpart of the reference's mode="drop". Programs
    update this state in place, never rebind it, so a replayed graph
    writes where the next program reads.

      hist     (S+1, C+1) int32  committed tokens per slot (n-gram
               speculation only, else None)
      gstate   (S+1,) int32      each slot's grammar DFA state
      pm, oc   (S+1, V) bool / int32  prompt presence and generated
               counts for penalties; None until a request needs them
      grammar  ((Gn, S_max, V) int32 tables, (Gn, S_max) bool accepts)
               of the registered patterns; None until one registers
      lora     (stacks, scales) of the registered adapters
               (`AdapterSet.device_args`); None until one registers

    Under tensor parallelism `params` and the pools are this rank's
    shard and `tp` is the tp process group (else None): the target
    model's forwards sum and gather over it (`paged_engine`), so every
    rank samples the same tokens and keeps the same per-slot state.
    """

    def __init__(self, params, cfg, infer_cfg, pools, rope, *, draft=None,
                 hist=None, gstate=None, tp=None):
        self.params, self.cfg, self.infer_cfg = params, cfg, infer_cfg
        self.k, self.v, self.k_scale, self.v_scale = pools
        self.rope = rope
        self.tp = tp
        # (params, cfg, pools, rope) of the draft model, or None
        self.draft = draft
        self.hist, self.gstate = hist, gstate
        self.pm = self.oc = None
        self.grammar = None
        self.lora = None

    def mutable_state(self) -> list:
        """The per-slot tensors a program updates besides the pools (a
        graph's warm-up run restores them, see graphs.Program)."""
        return [t for t in (self.hist, self.gstate, self.pm, self.oc)
                if t is not None]


def _cache(m: _Model, lengths, tables) -> paged_engine.PagedKVCache:
    return paged_engine.make_cache(m.k, m.v, lengths, tables, m.k_scale,
                                   m.v_scale)


def _draft_cache(m: _Model, lengths, tables) -> paged_engine.PagedKVCache:
    _, _, (k, v, ks, vs), _ = m.draft
    return paged_engine.make_cache(k, v, lengths, tables, ks, vs)


def _grammar_mask(grammar, gid, st, eos_id: int):
    """Next-state rows and the allowed-token mask from DFA states. gid:
    (B,) or (B, 1); st: (B,) or (B, W). DEAD states allow nothing; EOS is
    allowed exactly at accepting states; gid 0 (the identity grammar) is
    live at state 0 whatever state a slot's previous occupant left."""
    tb, ac = grammar
    gid = gid.long()
    ident = gid == 0
    idx = torch.where(ident, 0, st.long().clamp(min=0))
    nrow = tb[gid, idx]
    live_st = (st != _GDEAD) | ident
    amask = (nrow != _GDEAD) & live_st[..., None]
    if eos_id >= 0:
        amask[..., eos_id] = ac[gid, idx] & live_st
    return nrow, amask


def _grammar_step(grammar, gid, st, tok):
    """DFA states after `tok`; DEAD stays DEAD."""
    tb, _ = grammar
    nxt = tb[gid.long(), st.long().clamp(min=0), tok.long()]
    return torch.where(st == _GDEAD, st, nxt)


def _prefill_core(m: _Model, bufs: dict, key, *, ragged: bool, rows: bool,
                  bias: bool, grammar: bool, has_pen: bool,
                  scatter_prompt: bool, lora: bool):
    """One admission window for a (padded) G-row group: `chunk` (G, Wc)
    at positions [g_lens, g_lens + Wc) per row; each row's first-token
    candidate sampled at `sample_at` (per-request rows at position
    `prompt_lens`, else the server-global draw from `key`). `ragged`
    groups (the mixed scheduler) carry per-row `widths` and, when the
    prompts scatter, a `scatter_mask` of the rows at their first chunk;
    padding rows have width 0, sentinel tables and the sentinel slot id.

    Per-slot state, as the reference's `_prefill_core`: with
    `scatter_prompt` each row's admission prompt rebuilds its penalty
    state (positions < orig_lens are prompt presence, the rest are
    tokens generated before a preemption, counted as output) and lands
    in `hist`; rows whose sample is captured in this chunk
    (`count_mask`) count their first token and set their DFA state
    (`grammar`: the first token is sampled under the grammar's mask from
    the resume state `gst0_g`). With `lora` each row applies its slot's
    adapter (`aid_g`). The draft model prefills the same chunk into its
    pools. Returns (toks (G,), lps (G,))."""
    logits, _ = paged_engine.window_forward(
        m.params, bufs["chunk"], m.cfg,
        _cache(m, bufs["g_lens"], bufs["g_tables"]),
        logits_at=bufs["sample_at"],
        widths=bufs["widths"] if ragged else None, rope=m.rope,
        lora=m.lora if lora else None, aid=bufs.get("aid_g"), tp=m.tp)
    slot_ids = bufs["slot_ids"].long()
    count = bufs["count_mask"]
    prompt_lens = bufs["prompt_lens"].long()
    pm = oc = None
    if scatter_prompt:
        prompt_rows = bufs["prompt_rows"].long()
        g, pb = prompt_rows.shape
        sc_ids = slot_ids
        if ragged:
            sc_ids = torch.where(bufs["scatter_mask"], slot_ids,
                                 m.gstate.shape[0] - 1)
        cols = torch.arange(pb, device=slot_ids.device)[None, :]
        if has_pen:
            vsz = m.pm.shape[1]
            orig = bufs["orig_lens"].long()[:, None]
            pm_rows = torch.zeros((g, vsz + 1), dtype=torch.bool,
                                  device=slot_ids.device).scatter_(
                1, torch.where(cols < orig, prompt_rows, vsz), True)
            oc_cols = torch.where((cols >= orig)
                                  & (cols < prompt_lens[:, None]),
                                  prompt_rows, vsz)
            oc_rows = torch.zeros((g, vsz + 1), dtype=torch.int32,
                                  device=slot_ids.device).scatter_add_(
                1, oc_cols, torch.ones_like(oc_cols, dtype=torch.int32))
            m.pm[sc_ids] = pm_rows[:, :vsz]
            m.oc[sc_ids] = oc_rows[:, :vsz]
        if m.hist is not None:
            keep = cols < prompt_lens[:, None]
            if ragged:
                keep &= bufs["scatter_mask"][:, None]
            hcols = torch.where(keep, cols, m.hist.shape[1] - 1)
            m.hist[sc_ids[:, None].expand(g, pb), hcols] = \
                prompt_rows.to(m.hist.dtype)
    if has_pen:
        pm, oc = m.pm[slot_ids], m.oc[slot_ids]
    amask = nrow = None
    if grammar:
        nrow, amask = _grammar_mask(m.grammar, bufs["gid_g"],
                                    bufs["gst0_g"],
                                    m.infer_cfg.eos_token_id)
    if rows:
        toks = sample_logits_rows(
            logits, rows_in(bufs, "samp_g."), prompt_lens, prompt_mask=pm,
            out_counts=oc, eos_id=m.infer_cfg.eos_token_id, use_bias=bias,
            allowed_mask=amask)
    else:
        toks = sample_logits(logits, key, m.infer_cfg)
    if grammar:
        # only rows captured in this chunk: a multi-chunk job revisits
        # rows whose state an earlier chunk already set
        nstate = nrow[torch.arange(toks.shape[0], device=toks.device),
                      toks]
        cap = torch.where(count, slot_ids, m.gstate.shape[0] - 1)
        m.gstate[cap] = nstate.to(m.gstate.dtype)
    if has_pen:
        # the captured first token is the slot's first generated token
        m.oc.index_put_((slot_ids, toks), count.to(torch.int32),
                        accumulate=True)
    if m.draft is not None:
        dparams, dcfg, _, drope = m.draft
        paged_engine.window_forward(
            dparams, bufs["chunk"], dcfg,
            _draft_cache(m, bufs["g_lens"], bufs["g_tables"]),
            widths=bufs["widths"] if ragged else None, rope=drope)
    return toks, _token_logprobs(logits, toks)


def _decode_state(m: _Model, bufs: dict, rows: bool, grammar: bool,
                  has_pen: bool):
    """The decode cores' prologue: the staged rows' views of the
    per-slot state (`d_sids` names each row's slot; padding rows carry
    the sentinel, so they read and write the scratch row)."""
    sids = bufs["d_sids"].long()
    pm = oc = gstate = None
    if rows and has_pen:
        pm, oc = m.pm[sids], m.oc[sids]
    if grammar:
        gstate = m.gstate[sids]
    return sids, pm, oc, gstate


def _decode_plain_core(m: _Model, bufs: dict, key, *, n_rounds: int,
                       rows: bool, bias: bool, grammar: bool,
                       has_pen: bool, lora: bool) -> dict:
    """n_rounds plain decode steps (W = 1) of the staged rows: `live`
    rows advance one token a round, the rest (padding rows, on sentinel
    tables) are frozen. The server-global draw of round r uses
    split(key, n_rounds)[r]; per-request rows sample at position
    lengths + 1 with their penalty counts and grammar masks, advanced
    every round; with `lora` each row applies its slot's adapter
    (`d_aid`). Returns toks (R, B), lps (R, B), counts (R, B) (1 a live
    row), lens (B,), last (B,)."""
    lengths = bufs["d_lens"].long()
    tables = bufs["d_tables"]
    last = bufs["d_last"].long()
    live = bufs["live"]
    sids, pm, oc, gstate = _decode_state(m, bufs, rows, grammar, has_pen)
    samp = rows_in(bufs, "samp_d.") if rows else None
    gid = bufs["d_gid"] if grammar else None
    adapters = m.lora if lora else None
    aid = bufs.get("d_aid")
    keys = prng.split(key, n_rounds)
    at = torch.zeros_like(lengths)
    bi = torch.arange(lengths.shape[0], device=lengths.device)
    pad = m.infer_cfg.pad_token_id
    eos = m.infer_cfg.eos_token_id
    toks, lps = [], []
    for r in range(n_rounds):
        if m.hist is not None:
            # `last` sits at position `lengths`: the history stays an
            # unbroken token sequence for n-gram lookups
            cols = torch.where(live, lengths, m.hist.shape[1] - 1)
            m.hist[sids, cols] = last.to(m.hist.dtype)
        logits, _ = paged_engine.window_forward(
            m.params, last[:, None], m.cfg, _cache(m, lengths, tables),
            logits_at=at, rope=m.rope, lora=adapters, aid=aid, tp=m.tp)
        amask = None
        if grammar:
            nrow, amask = _grammar_mask(m.grammar, gid, gstate, eos)
        if rows:
            tok = sample_logits_rows(logits, samp, lengths + 1,
                                     prompt_mask=pm, out_counts=oc,
                                     eos_id=eos, use_bias=bias,
                                     allowed_mask=amask)
            if oc is not None:
                oc = oc.index_put((bi, tok), live.to(oc.dtype),
                                  accumulate=True)
        else:
            tok = sample_logits(logits, keys[r], m.infer_cfg)
        if grammar:
            # sticky DEAD: a dead row must never resurrect
            gstate = torch.where(live & (gstate != _GDEAD), nrow[bi, tok],
                                 gstate)
        lps.append(_token_logprobs(logits, tok))
        tok = torch.where(live, tok, pad)
        lengths = torch.where(live, lengths + 1, lengths)
        last = torch.where(live, tok, last)
        toks.append(tok)
    if grammar:
        m.gstate[sids] = gstate
    if oc is not None:
        m.oc[sids] = oc
    return {"toks": torch.stack(toks), "lps": torch.stack(lps),
            "counts": torch.stack([live.to(torch.int32)] * n_rounds),
            "lens": lengths, "last": last}


def _spec_core(m: _Model, bufs: dict, key, *, n_rounds: int, n_drafts: int,
               limited: bool, rows: bool, bias: bool, grammar: bool,
               has_pen: bool, lora: bool) -> dict:
    """n_rounds speculative rounds of the staged rows, as the
    reference's `_spec_core`. Each round drafts `n_drafts` tokens per row
    — from the draft model, decoding against its own pools (G+1 steps:
    step j writes the draft kv of its input token at lengths + j), or
    from the row's history (n-gram) — scores the (G+1)-token window in
    one target pass, and commits the accepted prefix plus the
    corrective/bonus token, capped at `d_stop` and (`limited`) at
    `d_limit` + 1 tokens a row.

    Penalties and grammar stay exact through the window: position i's
    target distribution uses the counts and the DFA state after
    drafts[:i], and the draft model's step j uses the same
    construction. Per-request rows draw on position-keyed streams
    (`speculative`), server-global rows on split(key, n_rounds)[r]. With
    `lora` the target's verify pass applies each row's adapter (the
    draft model serves unadapted, as the reference's does).

    Returns toks (R, B, G+1), lps (R, B, G+1), counts (R, B), lens (B,),
    last (B,)."""
    g = n_drafts
    lengths = bufs["d_lens"].long()
    tables = bufs["d_tables"]
    last = bufs["d_last"].long()
    live = bufs["live"]
    stop_len = bufs["d_stop"].long()
    limit = bufs["d_limit"].long() if limited else None
    sids, pm, oc, gstate = _decode_state(m, bufs, rows, grammar, has_pen)
    samp = rows_in(bufs, "samp_d.") if rows else None
    seeds = samp.seed if rows else None
    gid = bufs["d_gid"] if grammar else None
    dev = lengths.device
    b = lengths.shape[0]
    bi = torch.arange(b, device=dev)
    j = torch.arange(g + 1, device=dev)[None, :]
    pad = m.infer_cfg.pad_token_id
    eos = m.infer_cfg.eos_token_id
    vsz = m.cfg.vocab_size
    keys = prng.split(key, n_rounds)
    toks_r, lps_r, counts_r = [], [], []
    for r in range(n_rounds):
        key_acc, key_draft = prng.split(keys[r], 2).unbind(-2)
        can_commit = live & (lengths < stop_len)
        if m.draft is not None:
            dparams, dcfg, _, drope = m.draft
            tok, run_cnt, st_d = last, oc, gstate
            drafts_l, qps = [], []
            for step in range(g + 1):
                key_draft, kd = prng.split(key_draft, 2).unbind(-2)
                dlogits, _ = paged_engine.window_forward(
                    dparams, tok[:, None], dcfg,
                    _draft_cache(m, lengths + step, tables),
                    logits_at=torch.zeros_like(lengths), rope=drope)
                dmask = (_grammar_mask(m.grammar, gid, st_d, eos)[1]
                         if grammar else None)
                pos = lengths + 1 + step
                if rows:
                    qp = sampling_probs_rows(
                        dlogits, samp, prompt_mask=pm, out_counts=run_cnt,
                        positions=pos, eos_id=eos, use_bias=bias,
                        allowed_mask=dmask)
                    nxt = sample_from_probs_keyed(
                        qp, _row_pos_keys(seeds, pos, _TAG_DRAFT))
                else:
                    qp = sampling_probs(dlogits, m.infer_cfg)
                    nxt = sample_from_probs(qp, kd)
                if step < g:
                    if run_cnt is not None:
                        run_cnt = run_cnt.index_put(
                            (bi, nxt), torch.ones_like(nxt, dtype=oc.dtype),
                            accumulate=True)
                    if grammar:
                        st_d = _grammar_step(m.grammar, gid, st_d, nxt)
                tok = nxt
                drafts_l.append(nxt)
                qps.append(qp)
            drafts = torch.stack(drafts_l[:g], dim=1)
            q_probs = torch.stack(qps[:g], dim=1)
        else:
            # `last` is the committed token at position `lengths`: write
            # it before drafting, so bigrams across the prompt/output
            # boundary see the true sequence
            hcol = torch.where(live, lengths, m.hist.shape[1] - 1)
            m.hist[sids, hcol] = last.to(m.hist.dtype)
            hist_rows = m.hist[sids, :-1]
            valid = lengths + 1
            t_prev2 = hist_rows[bi, (valid - 2).clamp(min=0)].long()
            drafts = _ngram_drafts(hist_rows, valid, t_prev2, last, g, pad)
        window = torch.cat([last[:, None], drafts], dim=1)
        vlogits, _ = paged_engine.window_forward(
            m.params, window, m.cfg, _cache(m, lengths, tables),
            all_logits=True, rope=m.rope, lora=m.lora if lora else None,
            aid=bufs.get("d_aid"), tp=m.tp)
        amask_w = None
        if grammar:
            # position i's mask comes from the state after drafts[:i]
            sts = [gstate]
            for jj in range(g):
                sts.append(_grammar_step(m.grammar, gid, sts[-1],
                                         drafts[:, jj]))
            _, amask_w = _grammar_mask(m.grammar, gid[:, None],
                                       torch.stack(sts, dim=1), eos)
        if rows:
            counts_w = None
            if pm is not None:
                # counts at window position i: base + drafts before i
                onehot = torch.nn.functional.one_hot(drafts, vsz).to(
                    oc.dtype)
                cum = torch.cumsum(onehot, dim=1)
                counts_w = oc[:, None, :] + torch.cat(
                    [torch.zeros_like(cum[:, :1]), cum], dim=1)
            p_probs = sampling_probs_rows(
                vlogits, samp, prompt_mask=pm, out_counts=counts_w,
                positions=(lengths + 1)[:, None] + j, eos_id=eos,
                use_bias=bias, allowed_mask=amask_w)
        else:
            p_probs = sampling_probs(vlogits, m.infer_cfg)
        pos0 = lengths + 1 if rows else None
        if m.draft is not None:
            n_acc, x = _accept_drafts(drafts, q_probs, p_probs, key_acc,
                                      seeds=seeds, pos0=pos0)
        else:
            n_acc, x = _accept_point_mass(drafts, p_probs, key_acc,
                                          seeds=seeds, pos0=pos0)
        drafts_x = torch.cat([drafts, x[:, None]], dim=1)
        committed = torch.where(j < n_acc[:, None], drafts_x,
                                torch.where(j == n_acc[:, None],
                                            x[:, None], pad))
        count = torch.where(can_commit, n_acc + 1, 0)
        if limit is not None:
            count = torch.minimum(count, limit + 1)
        count = torch.minimum(count, (stop_len - lengths).clamp(min=0))
        took = j < count[:, None]
        toks = torch.where(took, committed, pad)
        # log P(tok) under the raw target distribution at each position
        lps = torch.log_softmax(vlogits.float(), dim=-1).gather(
            -1, toks.clamp(min=0)[..., None])[..., 0]
        if m.hist is not None:
            # committed[j] sits at position lengths + 1 + j
            hcols = torch.where(took, (lengths + 1)[:, None] + j,
                                m.hist.shape[1] - 1)
            m.hist[sids[:, None].expand_as(hcols), hcols] = \
                toks.to(m.hist.dtype)
        if oc is not None:
            oc = oc.index_put((bi[:, None].expand_as(toks), toks),
                              took.to(oc.dtype), accumulate=True)
        if grammar:
            st = gstate
            for jj in range(g + 1):
                nxt = _grammar_step(m.grammar, gid, st, toks[:, jj])
                st = torch.where(took[:, jj], nxt, st)
            gstate = st
        last_idx = (count - 1).clamp(min=0)
        last = torch.where(count > 0, committed[bi, last_idx], last)
        lengths = lengths + count
        toks_r.append(toks)
        lps_r.append(lps)
        counts_r.append(count)
    if grammar:
        m.gstate[sids] = gstate
    if oc is not None:
        m.oc[sids] = oc
    return {"toks": torch.stack(toks_r), "lps": torch.stack(lps_r),
            "counts": torch.stack(counts_r), "lens": lengths, "last": last}


def _decode_core(m: _Model, bufs: dict, key, *, n_rounds: int,
                 n_drafts: int, limited: bool, rows: bool, bias: bool,
                 grammar: bool, has_pen: bool, lora: bool) -> dict:
    if n_drafts > 0:
        return _spec_core(m, bufs, key, n_rounds=n_rounds,
                          n_drafts=n_drafts, limited=limited, rows=rows,
                          bias=bias, grammar=grammar, has_pen=has_pen,
                          lora=lora)
    return _decode_plain_core(m, bufs, key, n_rounds=n_rounds, rows=rows,
                              bias=bias, grammar=grammar, has_pen=has_pen,
                              lora=lora)


def _mixed_step(m: _Model, bufs: dict, *, n_rounds: int, n_drafts: int,
                limited: bool, scatter_prompt: bool, rows_p: bool,
                bias_p: bool, rows_d: bool, bias_d: bool, grammar: bool,
                has_pen: bool, lora: bool) -> dict:
    """ONE token-budget mixed iteration: the ragged prefill group, then
    (n_rounds > 0) the multi-round decode of the live rows, plain or
    speculative (n_drafts > 0; the draft model's chunk prefill rides in
    the prefill half). The key splits into (prefill, decode) keys, as
    the reference's does."""
    key_p, key_d = prng.split(bufs["rng"], 2)
    ptoks, plps = _prefill_core(m, bufs, key_p, ragged=True, rows=rows_p,
                                bias=bias_p, grammar=grammar,
                                has_pen=has_pen,
                                scatter_prompt=scatter_prompt, lora=lora)
    out = {"ptoks": ptoks, "plps": plps}
    if n_rounds > 0:
        out.update(_decode_core(m, bufs, key_d, n_rounds=n_rounds,
                                n_drafts=n_drafts, limited=limited,
                                rows=rows_d, bias=bias_d, grammar=grammar,
                                has_pen=has_pen, lora=lora))
    return out


def _decode_rounds(m: _Model, bufs: dict, **statics) -> dict:
    return _decode_core(m, bufs, bufs["rng"], **statics)


def _prefill_chunk(m: _Model, bufs: dict, **statics) -> dict:
    """The alternating scheduler's admission program: one uniform-width
    chunk of a bucketed group."""
    toks, lps = _prefill_core(m, bufs, bufs["rng"], ragged=False,
                              **statics)
    return {"ptoks": toks, "plps": lps}


# The program bodies by name: a follower rank of a tensor-parallel
# server launches the body its rank 0 names.
_BODIES = {f.__name__: f for f in (_mixed_step, _decode_rounds,
                                   _prefill_chunk)}

# A tensor-parallel server's rank 0 sends its followers a keepalive (from
# a thread of its own) when it has sent nothing for this long (seconds),
# or for a quarter of the group's timeout if that is shorter, so the
# followers of a server that is not stepping stay inside that timeout.
_TP_KEEPALIVE_S = 5.0


def _followers_left(what: str, why: str) -> RuntimeError:
    return RuntimeError(
        f"{what}: the followers of this tensor-parallel server have left "
        f"({why}); every rank must build a new server")


def _has_qtensor(tree) -> bool:
    from cloud_server_tpu_torch.models.quantization import QTensor
    if isinstance(tree, dict):
        return any(_has_qtensor(v) for v in tree.values())
    return isinstance(tree, QTensor)


def _tp_group(mesh, cfg, params, draft_cfg, device, cuda_graphs):
    """The tp process group of a tensor-parallel server, or None (no
    mesh, or a tp axis of 1). Refuses what is not served under tensor
    parallelism yet (NotImplementedError) and meshes the server cannot
    shard over (ValueError). The mesh's backend is the caller's: the
    server never picks one."""
    if mesh is None:
        return None
    others = {a: axis_size(mesh, a) for a in (mesh.mesh_dim_names or ())
              if a != "tp" and axis_size(mesh, a) > 1}
    if others:
        raise _not_ported(f"paged serving over mesh axes {others} (only "
                          "tp shards the server)")
    ntp = axis_size(mesh, "tp")
    if ntp == 1:
        return None
    check_tp_heads(cfg.num_heads, cfg.num_kv_heads, ntp)
    if draft_cfg is not None:
        raise _not_ported("draft-model speculation under tensor "
                          "parallelism")
    if cfg.num_experts >= 2:
        raise _not_ported("MoE models under tensor parallelism (expert "
                          "parallelism)")
    if _has_qtensor(params):
        raise _not_ported("int8 weight-only params under tensor "
                          "parallelism (quantized_shardings)")
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh is over {mesh.device_type} devices but "
                         f"the server runs on {device}")
    group = mesh.get_group("tp")
    backend = dist.get_backend(group)
    if device.type == "cuda" and cuda_graphs and backend != "nccl":
        raise ValueError(
            f"{backend} collectives cannot be captured in a CUDA graph: "
            "pass cuda_graphs=False, or a mesh over NCCL")
    return group


# ---------------------------------------------------------------------------
# Host-side scheduler
# ---------------------------------------------------------------------------


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
    """An in-flight chunked admission: one bucketed group of slots
    (alternating scheduler) or ONE slot with token-granular progress
    (mixed scheduler: `done` advances by whatever width the budget
    granted that iteration, so chunk_w/n_chunks are unused there)."""

    slots: list[int]
    chunk_w: int
    n_chunks: int
    rows: np.ndarray               # (G, n_chunks*chunk_w) remainder tokens
    rem_lens: np.ndarray           # (G,) true remainder lengths
    base_lens: np.ndarray          # (G,) shared_len per row
    prompt_rows: np.ndarray        # (G, admission bucket) prompts
    prompt_lens: np.ndarray        # (G,)
    toks: np.ndarray               # captured first-token candidates
    lps: np.ndarray
    got: np.ndarray                # bool — sample captured yet
    next_chunk: int = 0
    done: int = 0                  # mixed: remainder tokens prefilled
    # pipelined scheduler: remainder tokens DISPATCHED (committed `done`
    # plus what the in-flight dispatch carries); the planner selects
    # chunks from this cursor so a launch-ahead never re-prefills tokens
    # already in flight. Equal to `done` when nothing is in flight.
    planned: int = 0


@dataclasses.dataclass
class _DecodeRows:
    """The staged decode rows (`_gather_decode_rows`): the live slots
    compacted and padded to a power of two, or the slots themselves when
    every slot is live (`sl` None)."""

    sl: np.ndarray | None           # slot per row, sentinel-padded
    live: np.ndarray                # (rows,) bool
    lens: np.ndarray
    tables: np.ndarray
    last: np.ndarray
    stop: np.ndarray
    samp: SamplingRows
    gid: np.ndarray
    aid: np.ndarray


@dataclasses.dataclass
class _Plan:
    """A planned iteration (pipelined scheduler): everything the launch
    needs, built against the planned frame while the previous dispatch
    runs. `_launch_plan` rewrites only the data-dependent decode inputs
    (d_lens / d_last / d_tables / live_g) from the just-committed
    ledger."""

    kind: str                       # "mixed" | "decode"
    sel: list                       # [(job, take, d0)] — empty for decode
    activating: list                # slot ids whose admission completes
    n_rounds: int
    win: int                        # g_iter + 1
    g_iter: int                     # draft tokens a row this dispatch
    spec_lens: list | None          # per-live-row draft caps (adaptive)
    live_ids: np.ndarray
    rows: _DecodeRows
    owners: list                    # _Slot per live row (identity guard)
    pf: dict | None                 # prefill-half arrays (mixed only)
    flags: dict                     # the program's static switches
    stats: dict
    spans: list                     # trace spans staged for the record


@dataclasses.dataclass
class _Inflight:
    """One launched-but-uncommitted dispatch: the program whose event
    the commit waits on, and the host context the commit needs."""

    kind: str
    program: graphs.Program
    sel: list
    activating: list
    live_ids: np.ndarray
    owners: list
    n_rounds: int
    win: int
    g_iter: int
    spec_lens: list | None
    stats: dict
    spans: list
    t_launch: float


class PagedInferenceServer:
    """Continuous-batching server over the paged KV cache.

    Client API: submit / generate / step / run_until_idle / start / stop
    / serve_forever. `device` defaults to CUDA; pass device="cpu" to run
    on the CPU. `cuda_graphs=False` runs every program eagerly on its
    buffers instead of replaying a captured graph: a check of the graphs
    against eager launches (the counterpart of `jax.disable_jit`), not a
    serving mode.

    Tensor-parallel serving (`mesh`, a `parallel.make_mesh` DeviceMesh
    whose tp axis is > 1; one process per rank, each with its own
    device): every rank constructs the server with the same arguments
    and keeps its shard of the weights (heads, kv heads, MLP columns and
    vocab rows over tp, `parallel.sharding`) and of the page pools (their
    kv-head axis). Rank 0 of the tp group serves: it alone schedules and
    takes requests, and before each program launch it broadcasts the
    dispatch (the body, its switches and the staged inputs, the key
    among them) to the other ranks over a gloo group, together with the
    state changes made outside programs since (the grammar stack, the
    penalty state). The other ranks call `follow()`, which launches the
    same programs on their shard until rank 0 stops; while rank 0 sends
    nothing (idle, or not stepping at all) a thread of its own sends
    them a keepalive, so they stay inside the group's timeout. Once
    rank 0 has released them (`stop()`, or a failure in
    `serve_forever`) it refuses `start()` and `step()` with
    RuntimeError: a tensor-parallel server does not serve again, every
    rank builds a new one. Sampling is replicated: the logits are gathered over the group, so every rank
    draws the same tokens and keeps the same per-slot state. The mesh's
    backend decides the collectives (NCCL on cards, whose collectives
    the CUDA graphs capture; gloo on the CPU, or on cards with
    `cuda_graphs=False`).
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
                 admit_decode_chunk: int | None = 1,
                 scheduler: str | None = None,
                 mixed_token_budget: int | None = None,
                 metrics=None, flight_recorder_size: int | None = None,
                 qos=None, tracing=None, slo=None, spec_control=None,
                 iteration_profile=None, faults=None, brownout=None,
                 anomaly=None, overlap: bool | None = None, device=None,
                 cuda_graphs: bool = True):
        # Page-allocation policy: "ondemand" (default) reserves the
        # prompt and one decode window at admission and grows chains
        # per dispatch, preempting the youngest slot on pool exhaustion;
        # "reserve" reserves prompt + max_new + window slack at
        # admission, so no chain grows and nothing is preempted
        if allocation not in ("ondemand", "reserve"):
            raise ValueError(f"unknown allocation policy: {allocation!r}")
        self.allocation = allocation
        sched = scheduler if scheduler is not None else infer_cfg.scheduler
        if sched not in ("mixed", "alternating"):
            raise ValueError(f"unknown scheduler: {sched!r}")
        if admit_decode_chunk is not None and admit_decode_chunk < 1:
            raise ValueError("admit_decode_chunk must be >= 1 or None")
        if (draft_params is None) != (draft_cfg is None):
            raise ValueError("pass draft_params and draft_cfg together")
        if draft_cfg is not None and spec_drafts <= 0:
            raise ValueError("a draft model needs spec_drafts > 0")
        if draft_cfg is not None and draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size={draft_cfg.vocab_size} != target "
                f"vocab_size={cfg.vocab_size}; speculative verification "
                "compares their token distributions elementwise")
        self.device = resolve_device(device)
        # tensor-parallel serving: this rank's tp group (None without
        # one), its shard of the weights, and of the pools' kv heads
        tp = _tp_group(mesh, cfg, params, draft_cfg, self.device,
                       cuda_graphs)
        ntp = 1 if tp is None else tp.size()
        if tp is not None:
            params = shard_params(params, transformer.param_logical_axes(cfg),
                                  mesh)
        self.params = transformer.cast_params(
            _params_on(params, self.device), cfg)
        self.cfg = cfg
        self.draft_cfg = draft_cfg
        self.tokenizer = tokenizer
        self.infer_cfg = infer_cfg
        self.scheduler = sched
        self._mixed_enabled = sched == "mixed"
        # the pipelined scheduler runs the mixed scheduler only; the
        # alternating scheduler keeps its sequential per-chunk loop
        self.overlap = bool(infer_cfg.overlap if overlap is None
                            else overlap)
        self._overlap_enabled = self.overlap and self._mixed_enabled
        self.admit_decode_chunk = admit_decode_chunk
        self.max_slots = max_slots
        self.page_size = page_size
        self.decode_chunk = max(1, decode_chunk)
        self.spec_drafts = spec_drafts
        self.window = spec_drafts + 1  # kv slack per decode round
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
        # continuations (preempted requests re-admitted with their
        # generated tokens) can outgrow the client-facing buckets
        self._admit_buckets = sorted(set(self.prompt_buckets)
                                     | {max_context})
        # remainders bucket to a pow2 <= prefill_chunk (single-chunk
        # jobs) or a prefill_chunk multiple (multi-chunk jobs)
        self._rem_buckets = _pow2_buckets(16, self.prefill_chunk)
        # dispatch-width buckets of the mixed prefill group
        self._mixed_buckets = sorted(
            set(_pow2_buckets(16, self.prefill_chunk))
            | {_pad_pow2(self.window)})

        cache = paged_engine.init_paged_cache(
            dataclasses.replace(cfg, num_kv_heads=cfg.num_kv_heads // ntp),
            num_pages=num_pages, page_size=page_size, batch=max_slots,
            max_pages_per_slot=self.max_pages_per_slot, device=self.device)
        self.k_pool, self.v_pool = cache.k, cache.v
        # the int8 cache's (L, P, KH, ps) f32 scale pools, else None
        self.k_scale_pool, self.v_scale_pool = cache.k_scale, cache.v_scale
        self._rope = rope_table(cfg, max_context, device=self.device)
        draft = None
        if draft_cfg is not None:
            # the draft model's own pools, in its geometry, on the same
            # page ids (and scratch page) as the target's: one allocator
            # covers both, and a shared prefix page carries both kvs
            dcache = paged_engine.init_paged_cache(
                draft_cfg, num_pages=num_pages, page_size=page_size,
                batch=max_slots, max_pages_per_slot=self.max_pages_per_slot,
                device=self.device)
            draft = (transformer.cast_params(
                _params_on(draft_params, self.device), draft_cfg),
                     draft_cfg,
                     (dcache.k, dcache.v, dcache.k_scale, dcache.v_scale),
                     rope_table(draft_cfg, max_context, device=self.device))
        # n-gram speculation reads each slot's token history; nothing
        # else does, so only such a server keeps it
        ngram = spec_drafts > 0 and draft_cfg is None
        self._model = _Model(
            self.params, cfg, infer_cfg,
            (self.k_pool, self.v_pool, self.k_scale_pool,
             self.v_scale_pool), self._rope, draft=draft,
            hist=(torch.zeros((max_slots + 1, max_context + 1),
                              dtype=torch.int32, device=self.device)
                  if ngram else None),
            gstate=torch.zeros((max_slots + 1,), dtype=torch.int32,
                               device=self.device), tp=tp)
        self._programs = graphs.ProgramCache(self.device,
                                             capture=cuda_graphs)
        # tensor parallelism: the tp group, this rank's place in it, and
        # rank 0's channel of dispatches to the other ranks (its own
        # gloo group: control messages never queue behind the data
        # collectives). State changes outside programs wait in the
        # outbox and ride with the next message; rank 0 times each send.
        self._tp = tp
        self._tp_rank = 0 if tp is None else tp.rank()
        self._channel = (None if tp is None else BroadcastChannel(
            new_gloo_group(dist.get_process_group_ranks(tp))))
        self._tp_outbox: list = []
        self._tp_send_s: collections.deque = collections.deque(maxlen=4096)
        self._tp_last_send = time.perf_counter()
        # why the followers left (stop(), a failure, a failed send): set
        # once, under the send lock; then rank 0 refuses to serve again
        self._tp_closed: str | None = None
        self._tp_left = threading.Event()
        self._tp_keepalive_s = min(_TP_KEEPALIVE_S, group_timeout_s() / 4)
        self._tp_release_error: str | None = None
        self._tp_send_lock = threading.Lock()
        # host-authoritative scheduling state
        self.tables = np.full((max_slots, self.max_pages_per_slot),
                              num_pages, np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.active = np.zeros((max_slots,), bool)
        self.last_token = np.zeros((max_slots,), np.int32)
        self.stop_len = np.zeros((max_slots,), np.int32)
        self.samp_rows = make_rows([None] * max_slots, infer_cfg,
                                   [0] * max_slots)
        self._needs_rows = np.zeros((max_slots,), bool)
        self._has_bias = np.zeros((max_slots,), bool)
        # regex-constrained decoding: the registered patterns, stacked
        # into the (Gn, S_max, V) device table on the scheduler thread
        # (`_sync_grammar_stack`); per slot a grammar id and the DFA
        # state to resume from at (re-)admission
        self._grammar_cache = None
        self._patterns: list[str] = []
        self._pattern_gid: dict[str, int] = {}
        self._grammar_gen = 0      # generation of the device stack
        self._grammar_built = 0    # patterns the device stack holds
        self._gid = np.zeros((max_slots,), np.int32)
        self._gstate0 = np.zeros((max_slots,), np.int32)
        # multi-LoRA serving: the stacked adapter set and per-slot
        # adapter ids (0 = the null adapter, the base model)
        self.adapters = AdapterSet(cfg, device=self.device)
        self._aid = np.zeros((max_slots,), np.int32)
        self.orig_len = np.zeros((max_slots,), np.int32)
        self._host_rng = np.random.default_rng(seed)
        # the server-global key, jax.random.key(seed)'s words, split once
        # per dispatch (`_next_rng`)
        self._rng = (0, int(seed) & 0xFFFFFFFF)

        self.preemptions = 0
        # pages exports took from a handoff prefetch (the rest of the
        # ledger's pages_moved was copied at the export), lifetime
        self.handoff_prefetched_pages = 0
        self.tokens_emitted = 0  # lifetime emitted tokens (metrics)
        # committed tokens per decode round (mean accepted length + 1)
        self.decode_rounds = 0
        self.decode_tokens_committed = 0
        # speculation ledger: tokens drafted on committing rows' behalf
        # (each row's own draft length a round) vs the drafts committed
        self.spec_tokens_drafted = 0
        self.spec_tokens_accepted = 0
        # adaptive draft lengths (inference/spec_control.py), fed by the
        # per-round counts each commit already has; None = fixed length
        self.spec_control = resolve_controller(
            spec_control, infer_cfg.spec_control_config, spec_drafts,
            has_draft_model=draft_cfg is not None)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.metrics.registry.add_collector(self._collect_metrics)
        # flight recorder: one record per busy iteration
        self.flight = FlightRecorder(
            flight_recorder_size if flight_recorder_size is not None
            else infer_cfg.flight_recorder_size)
        self._iter_stats: dict = {}
        self._profiler = resolve_profiler(iteration_profile,
                                          infer_cfg.iteration_profile)
        self._phase_hists = ({} if self._profiler is None else
                             register_phase_hists(self.metrics.registry))
        self._cache_hists = register_cache_hists(self.metrics.registry)
        self.allocator.telemetry.attach_hists(self._cache_hists)
        # idle vs dead: an idle scheduler keeps counting idle iterations
        # while last_busy_ts ages; a dead one freezes both
        self.idle_iterations = 0
        self.last_busy_ts = 0.0
        # the host policy layer (module docstring): each part None
        # unless configured, and every call site guarded, so an
        # unconfigured server runs the code it ran without the layer
        self.tracer = _StepTracer()  # POST /debug/trace
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
        # debug bundles auto-captured on an anomaly's activation edge
        self._bundle_on_anomaly = bool(infer_cfg.bundle_on_anomaly)
        self._bundles: collections.deque = collections.deque(maxlen=8)
        self._bundles_captured = 0
        # lifetime prefix hit/miss pages at the last busy iteration (the
        # watchdog's per-iteration cache deltas)
        self._anomaly_cache_base = (0, 0)
        # iteration spans staged by the dispatch paths, stamped with the
        # iteration's (t0, now) and flight index by _record_iteration
        self._iter_spans: list = []
        self.qos = resolve_registry(qos, infer_cfg.qos_config)
        self._faults = resolve_fault_plan(faults, infer_cfg.fault_plan)
        self._brownout = resolve_brownout(brownout,
                                          infer_cfg.brownout_config)
        if self._brownout is not None and self.qos is None:
            raise ValueError(
                "brownout needs a QoS registry: shed sets are priority "
                "classes, and without tenants nothing can be shed")
        # the migration ledger (its stats, metric families and the
        # flight records' migrated_in/out)
        self._migration = MigrationLedger()
        # _fail_all's bounded _step_lock acquire: teardowns that went
        # ahead against a scheduler that never released it
        self.unserialized_teardowns = 0
        self._teardown_lock_timeout_s = 5.0
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
        self._inflight: _Inflight | None = None
        # a dropped program still in flight, with what it reads; freed
        # once a commit has waited on it (`_sync_grammar_stack`)
        self._retired: list = []
        # deferred sweep reaps: (slot_id, _Slot, reason) marked while a
        # dispatch is in flight; released right after its commit
        self._reaped: list[tuple[int, _Slot, str]] = []
        # perf_counter stamp of the launch made THIS iteration (the
        # flight record's t_launch)
        self._iter_launch_ts: float | None = None
        # disaggregated handoff: requests whose prefill completed with a
        # `handoff=` callback, fired by the scheduler thread after it
        # releases _step_lock (the callback's export needs that lock)
        self._handoff_ready: list[Request] = []
        # request_id -> (page ids, {pool name: pinned host buffer}, the
        # event of their D2H copies): pages `_handoff_prefetch` started
        # copying under the final prefill chunk, taken by the export
        # while they are still a prefix of the slot's chain; dropped at
        # the export or the request's completion
        self._handoff_stash: dict = {}
        # the prefetch's gathers awaiting their copies (request id, page
        # ids, buffer pages, gathered tensors, the event after them)
        self._handoff_gathers: list = []
        # the prefetch's D2H copies run on their own stream, beside the
        # programs (made at the first handoff)
        self._copy_stream = None
        # (event, pinned staging) of imports whose copies may still run
        self._import_holds: list = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if self._channel is not None and self._tp_rank == 0:
            threading.Thread(target=self._tp_keepalive_loop, daemon=True,
                             name="tp-keepalive").start()

    # -- client API ---------------------------------------------------------

    def submit(self, prompt: Sequence[int], *,
               max_new_tokens: int | None = None, stream=None,
               sampling: SamplingParams | None = None,
               adapter: str | None = None, tenant: str | None = None,
               trace_ctx: tuple | None = None,
               deadline_s: float | None = None,
               fail_handler=None, handoff=None,
               _migration=None) -> Request:
        self._refuse_on_follower("submit")
        if handoff is not None:
            self._refuse_tp("the disaggregated handoff")
        if self._stop.is_set():
            raise RuntimeError("server is stopped; not accepting requests")
        if self._faults is not None:
            self._faults.check("submit_reject")
        if (adapter is not None
                and self.adapters.adapter_id(adapter) is None):
            raise ValueError(
                f"unknown adapter {adapter!r}; registered: "
                f"{self.adapters.names}")
        if deadline_s is not None and not (
                math.isfinite(deadline_s) and deadline_s > 0):
            raise ValueError("deadline_s must be a finite positive "
                             "number of seconds")
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        _bucket(len(prompt), self.prompt_buckets)  # raises if too long
        max_new = (self.infer_cfg.max_decode_len if max_new_tokens is None
                   else max_new_tokens)
        # leave room for the last speculative window's writes
        max_new = min(max_new, self.max_context - len(prompt) - self.window)
        if max_new <= 0:
            raise ValueError(
                f"prompt of {len(prompt)} tokens leaves no room to decode "
                f"within max_context={self.max_context}")
        if sampling is not None and sampling.regex is not None:
            if self.infer_cfg.eos_token_id < 0:
                raise ValueError(
                    "regex-constrained decoding needs eos_token_id >= 0 "
                    "(completion is signalled by EOS at an accepting "
                    "state)")
            self._grammar_gid(sampling.regex)  # compile now; 400 here
        if self.qos is not None:
            tenant = self.qos.resolve(tenant)
            if self._brownout is not None and _migration is None:
                # overload brownout: this class's admissions are shed
                # with a jittered Retry-After while the detector grades
                # the server overloaded (a migration continuation is
                # exempt: its delivered tokens are already paid for)
                cls = self.qos.priority_class(tenant)
                if self._brownout.shed(cls):
                    raise BrownoutShedError(
                        f"overloaded: shedding {cls!r} admissions "
                        "(brownout); retry later", tenant=tenant,
                        priority_class=cls,
                        retry_after_s=self._brownout.retry_hint())
        else:
            # no registry bounds the tenant set: a caller's string must
            # not mint per-tenant metric series
            tenant = None
        req = Request(prompt=list(prompt), max_new_tokens=max_new,
                      stream=stream, sampling=sampling, adapter=adapter,
                      tenant=tenant,
                      seed_used=(_migration.seed_used
                                 if _migration is not None else
                                 resolve_seed(sampling, self._host_rng,
                                              self._lock)),
                      submit_time=time.perf_counter())
        if _migration is not None:
            # a migration continuation resumes another server's stream:
            # its generated state is filled in before the request is
            # visible to the scheduler, which admits it as a
            # continuation (admission prompt = prompt + tokens) and
            # decodes from the exact next token. Draws are keyed by
            # (seed, position), so the source's seed is all that crosses.
            req.tokens = list(_migration.tokens)
            req.logprobs = list(_migration.logprobs)
            req.emit_times = list(_migration.emit_times)
        if deadline_s is None and self.qos is not None:
            # the tenant's class default (None when it declares none)
            deadline_s = self.qos.default_deadline(tenant)
        if deadline_s is not None:
            req.deadline = req.submit_time + float(deadline_s)
        if self.slo is not None:
            req.slo_class = (self.qos.priority_class(tenant)
                             if self.qos is not None else None)
        # the router's hooks ride in through submit: once queued, a
        # scheduler failure may complete the request at any moment
        req._fail_handler = fail_handler
        req._handoff = handoff
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
            if self.qos is not None:
                # per-tenant backpressure after the global bound; on
                # success the tenant's pending count advances with the
                # append below. A migration continuation bills no prompt
                # tokens: its source charged them
                self.qos.gate_submit(
                    tenant, len(prompt),
                    charge_tokens=0 if _migration is not None else None)
            # telemetry (and the trace) before the append and after
            # every refusal: once queued, the scheduler thread may admit
            # (even finish) the request
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
        with self._lock:
            try:
                self._pending.remove(req)
            except ValueError:
                return  # admitted: the step sweep owns the teardown
            if self.qos is not None:
                self.qos.on_pending_removed(req.tenant)
        req.finish_reason = "cancelled"
        self._complete(req)

    def _complete(self, req: Request) -> None:
        """Terminal bookkeeping for every path that ends a request
        (finish / cancel / fail): lifecycle metrics, the watchdog's
        request feed and the trace's finish, then unblock waiters."""
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
        # a prefetched handoff that never ran (the request ended here)
        # analysis: allow[lock-discipline] GIL-atomic dict pop, as in the
        # reference: safe from any completing thread, no compound
        # read-modify-write
        self._handoff_stash.pop(req.request_id, None)
        # a finished request's cancel() is a no-op: drop the bound method,
        # so requests a caller keeps do not keep the server and its pools
        req._on_cancel = None
        h = req._fail_handler
        if (h is not None and req.finish_reason is not None
                and req.finish_reason.startswith("error") and h(req)):
            return  # a retry or migration elsewhere completes it
        req._done.set()
        if req._on_done is not None:
            req._on_done(req)

    def generate(self, prompts, *, max_new_tokens=None):
        reqs = [self.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]
        self.run_until_idle()
        return [r.tokens for r in reqs]

    def embed(self, prompts: Sequence[Sequence[int]]) -> np.ndarray:
        """Mean-pooled, L2-normalised sequence embeddings of the base
        model (`engine.encode`): prompts grouped per prompt bucket, each
        group padded to a power of two rows, so repeat calls run the
        same shapes. Runs under the step lock, after the dispatch in
        flight has run: it shares the card with the programs. Returns
        (N, embed_dim) f32."""
        from cloud_server_tpu_torch.inference import engine as _engine
        self._refuse_tp("embed()")
        if not prompts:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        out = np.zeros((len(prompts), self.cfg.embed_dim), np.float32)
        by_bucket: dict[int, list[int]] = {}
        for i, p in enumerate(prompts):
            if len(p) == 0:
                raise ValueError("empty prompt")
            by_bucket.setdefault(_bucket(len(p), self.prompt_buckets),
                                 []).append(i)
        with self._step_lock:
            self._settle_inflight()
            for pb, idxs in by_bucket.items():
                g = _pad_pow2(len(idxs))
                rows = np.full((g, pb), self.infer_cfg.pad_token_id,
                               np.int32)
                lens = np.ones((g,), np.int32)  # padding rows: 1 token
                for r, i in enumerate(idxs):
                    rows[r, :len(prompts[i])] = prompts[i]
                    lens[r] = len(prompts[i])
                vecs = _engine.encode(
                    self.params, torch.from_numpy(rows).to(self.device),
                    torch.from_numpy(lens).to(self.device), cfg=self.cfg)
                # analysis: allow[lock-discipline] deliberate sync under
                # _step_lock, as in the reference: embeddings share the
                # card with decode launches, serializing is the point
                out[idxs] = vecs[:len(idxs)].cpu().numpy()
        return out

    def add_adapter(self, name: str, lora_params: dict, lora_cfg) -> int:
        """Register a LoRA adapter for per-request serving; returns its
        id. Requests select it via submit(..., adapter=name). Runs under
        the step lock (no capture is under way). An add that fits the
        stacks writes its rows in place; one that replaces a stack
        tensor releases the programs keyed to the old generation — the
        dispatch in flight, and the tensors it reads, only after its
        commit has waited on it (`_release_retired`). MLP targets on an
        MoE base (expert-stacked MLP) are a ValueError, as in the
        reference."""
        self._refuse_tp("multi-LoRA adapters (add_adapter)")
        if (self.cfg.num_experts >= 2 and
                {"w_gate", "w_up", "w_down"} & set(lora_cfg.targets)):
            raise ValueError(
                "MLP-targeting adapters cannot be served per-request on "
                "an MoE base (expert-stacked MLP); use attention targets "
                "or merged serving")
        with self._step_lock:
            ad = self.adapters
            gen, held = ad.generation, ad.device_args()
            with self._lock:
                aid = ad.add(name, lora_params, lora_cfg)
            if ad.generation != gen:
                busy = self._inflight.program if self._inflight else None
                kept = self._programs.drop(lambda key: key[4] == gen, busy)
                if kept:  # it reads the old stacks until its commit
                    self._retired += kept + [held]
            self._model.lora = ad.device_args()
            return aid

    @property
    def num_active(self) -> int:
        # analysis: allow[lock-discipline] racy-by-design monitoring
        # read, as in the reference: len-stable list, GIL-atomic element
        # loads; stale by at most one iteration, steers placement only
        return sum(s is not None for s in self._slots)

    @property
    def num_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def pending_prefill_tokens(self) -> int:
        """Prefill tokens this server still owes: the unprefilled
        remainder of every admission in flight plus the whole admission
        prompt of everything queued (a router's load signal). A
        monitoring read: it may lag the running iteration by one."""
        # analysis: allow[lock-discipline] racy-by-design monitoring read
        # of scheduler-thread state, as in the reference: list()
        # snapshots the container; steers placement only
        jobs = list(self._jobs)
        n = sum(max(int(job.rem_lens[0]) - job.done, 0) for job in jobs)
        with self._lock:
            n += sum(len(r.prompt) + len(r.tokens) for r in self._pending)
        return n

    @property
    def ready(self) -> bool:
        """Readiness (vs liveness): False while draining or stopped, so
        load balancers stop routing new work here while in-flight
        requests finish."""
        # analysis: allow[lock-discipline] benign racy read, as in the
        # reference: a stale verdict delays placement by one pick; _lock
        # here would put a contended acquire on every router pick
        return not self._draining and not self._stop.is_set()

    def prefix_cache_stats(self):
        return self.allocator.stats()

    def kv_cache_bytes(self) -> int:
        """Device bytes of the page pools (and the int8 cache's scales)."""
        return paged_engine.hbm_bytes(_cache(self._model, self.lengths,
                                             self.tables))

    # -- internals ----------------------------------------------------------

    def _emit(self, req: Request, token: int, logprob: float) -> bool:
        n0 = len(req.emit_times)
        done = emit_token(req, token, logprob, self.infer_cfg)
        if not (done and req.finish_reason == "eos"):
            self.tokens_emitted += 1  # stop-truncated tokens still count
            if self.qos is not None:
                # the tenant's generated bucket takes the debt
                self.qos.charge_generated(req.tenant)
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
        self.allocator.release(slot.pages, keyed_tokens,
                               namespace=slot.req.adapter or "",
                               tenant=slot.req.tenant)
        self._slots[slot_id] = None
        self.tables[slot_id, :] = self.allocator.num_pages  # sentinel
        self.active[slot_id] = False
        self.lengths[slot_id] = 0
        self._needs_rows[slot_id] = False
        self._has_bias[slot_id] = False
        self._gid[slot_id] = 0
        self._gstate0[slot_id] = 0
        self._aid[slot_id] = 0
        if self.spec_control is not None:
            self.spec_control.on_release(slot_id)
        return slot

    def _finish(self, slot_id: int) -> None:
        slot = self._release_slot(slot_id, self._committed(slot_id))
        self._complete(slot.req)

    # -- grammar and penalty state ------------------------------------------

    def _grammar_gid(self, pattern: str) -> int:
        """Register a pattern (compiled on the caller's thread, so a bad
        regex is the client's ValueError); returns its grammar id. The
        device stack is rebuilt on the scheduler thread before the next
        admission (`_sync_grammar_stack`)."""
        # analysis: allow[lock-discipline] double-checked fast path, as in
        # the reference: a GIL-atomic dict probe; the locked re-check
        # below is authoritative
        gid = self._pattern_gid.get(pattern)
        if gid is not None:
            return gid
        if self.tokenizer is None:
            raise ValueError(
                "regex-constrained requests need a tokenizer: construct "
                "PagedInferenceServer(..., tokenizer=...)")
        from cloud_server_tpu_torch.inference import grammar as _g
        if self._grammar_cache is None:
            self._grammar_cache = _g.GrammarCache(self.tokenizer,
                                                  self.cfg.vocab_size)
        self._grammar_cache.get(pattern)  # compile (raises on bad regex)
        with self._lock:
            if pattern not in self._pattern_gid:
                self._patterns.append(pattern)
                self._pattern_gid[pattern] = len(self._patterns)
            return self._pattern_gid[pattern]

    def _sync_grammar_stack(self) -> None:
        """Scheduler thread: when patterns registered since the last
        build, upload the new (Gn, S_max, V) stack — gid 0 the identity
        grammar (everything allowed, state stays 0), gid i pattern i-1,
        rows past a grammar's states DEAD — and release the programs
        that read the old one: a captured graph keeps the address it
        was captured with. The dispatch in flight (overlap pipeline)
        may be one of them: it and the old stack stay alive until its
        commit has waited on it."""
        with self._lock:
            patterns = list(self._patterns)
        if len(patterns) == self._grammar_built:
            return
        dfas = [self._grammar_cache.get(pat) for pat in patterns]
        s_max = max([d.num_states for d in dfas] + [1])
        v = self.cfg.vocab_size
        tables = np.full((len(dfas) + 1, s_max, v), _GDEAD, np.int32)
        accept = np.zeros((len(dfas) + 1, s_max), bool)
        tables[0] = 0
        accept[0] = True
        for i, d in enumerate(dfas, start=1):
            tables[i, :d.num_states] = d.next_state
            accept[i, :d.num_states] = d.accept
        self._install_grammar(tables, accept)
        self._grammar_built = len(patterns)
        self._tp_queue(("grammar", tables, accept))

    def _install_grammar(self, tables: np.ndarray,
                         accept: np.ndarray) -> None:
        """Upload a grammar stack and release the programs keyed to the
        old one (a follower rank of a tensor-parallel server mirrors rank
        0's with rank 0's arrays)."""
        # the upload first: one that fails (out of device memory) leaves
        # the old stack, its programs and its generation as they were
        grammar = (torch.as_tensor(tables).to(self.device),
                   torch.as_tensor(accept).to(self.device))
        stale = self._grammar_gen
        busy = self._inflight.program if self._inflight else None
        kept = self._programs.drop(lambda key: key[1] == stale, busy)
        if kept:  # it reads the old stack until `_commit_inflight`
            self._retired += kept + [self._model.grammar]
        self._model.grammar = grammar
        self._grammar_gen += 1

    def grammar_stack_bytes(self) -> int:
        """Device bytes of the grammar stack (0 before any pattern)."""
        if self._model.grammar is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in self._model.grammar)

    def _ensure_penalty_state(self) -> None:
        """Materialise the (slots, V) penalty state at the first request
        that needs it; programs are keyed by its presence."""
        m = self._model
        if m.pm is not None:
            return
        shape = (self.max_slots + 1, self.cfg.vocab_size)
        m.pm = torch.zeros(shape, dtype=torch.bool, device=self.device)
        m.oc = torch.zeros(shape, dtype=torch.int32, device=self.device)
        self._tp_queue(("penalty",))

    # -- programs -----------------------------------------------------------

    def _next_rng(self) -> np.ndarray:
        """The reference's `self._rng, sub = jax.random.split(self._rng)`
        on the host: a fresh key for one dispatch."""
        k0, k1 = self._rng
        self._rng = prng.threefry2x32(k0, k1, 0, 0)
        return np.asarray(prng.threefry2x32(k0, k1, 0, 1), np.int64)

    def _launch(self, body, flags: dict, staged: dict) -> graphs.Program:
        """Launch `body` with its static switches `flags` on `staged`
        inputs (with a fresh server key); the caller waits on it. Under
        tensor parallelism the dispatch goes to the follower ranks
        first (`_mirror`), so every rank launches it."""
        staged["rng"] = self._next_rng()
        if self._channel is not None:
            self._mirror(("launch", body.__name__, flags, self._grammar_gen,
                          staged))
        return self._run(body, flags, staged)

    def _run(self, body, flags: dict, staged: dict) -> graphs.Program:
        """Launch `body` on this rank. A program is keyed by its body,
        switches and input shapes, by the grammar stack's generation
        when it reads the stack, and by the adapter stacks' generation
        when it reads them."""
        key = (body.__name__,
               self._grammar_gen if flags.get("grammar") else -1,
               tuple(sorted(flags.items())),
               tuple((k, np.shape(a)) for k, a in sorted(staged.items())),
               self.adapters.generation if flags.get("lora") else -1)
        prog = self._programs.get(key, functools.partial(body, **flags),
                                  self._model, staged)
        prog.launch(staged)
        return prog

    def _decode_staged(self, rows: _DecodeRows, spec_lens, *, spec: bool,
                       use_rows: bool, grammar: bool, lora: bool) -> dict:
        """A decode half's inputs: the rows, with their stop lengths when
        speculating and their draft caps when `spec_lens` (per live row)
        bounds them."""
        sl = rows.sl
        if sl is None:  # rows ARE slots
            sl = np.arange(self.max_slots, dtype=np.int32)
        staged = {"d_lens": np.asarray(rows.lens, np.int32),
                  "d_tables": np.asarray(rows.tables, np.int32),
                  "d_last": np.asarray(rows.last, np.int32),
                  "live": np.asarray(rows.live, bool),
                  "d_sids": np.asarray(sl, np.int32)}
        if spec:
            staged["d_stop"] = np.asarray(rows.stop, np.int32)
        if spec_lens is not None:  # padding rows commit nothing anyway
            lim = np.zeros((len(rows.live),), np.int32)
            lim[:len(spec_lens)] = spec_lens
            staged["d_limit"] = lim
        if use_rows:
            staged.update(rows_staged("samp_d.", rows.samp))
        if grammar:
            staged["d_gid"] = np.asarray(rows.gid, np.int32)
        if lora:
            staged["d_aid"] = np.asarray(rows.aid, np.int32)
        return staged

    def _prefill_staged(self, pf: dict, *, ragged: bool, use_rows: bool,
                        grammar: bool, scatter: bool, lora: bool) -> dict:
        names = ["chunk", "g_lens", "g_tables", "sample_at", "prompt_lens",
                 "slot_ids", "count_mask"]
        if ragged:
            names.append("widths")
        if scatter:
            names += ["prompt_rows", "orig_lens"]
            if ragged:
                names.append("scatter_mask")
        if grammar:
            names += ["gid_g", "gst0_g"]
        if lora:
            names.append("aid_g")
        staged = {k: pf[k] for k in names}
        if use_rows:
            staged.update(rows_staged("samp_g.", pf["samp_g"]))
        return staged

    def _scatters_prompts(self) -> bool:
        """Whether an admission's first chunk writes its prompt into the
        per-slot state (penalty counts, the n-gram history)."""
        return self._model.pm is not None or self._model.hist is not None

    # -- admission ----------------------------------------------------------

    def _rem_bucket(self, rem: int) -> int:
        if rem <= self.prefill_chunk:
            return _bucket(rem, self._rem_buckets)
        return -(-rem // self.prefill_chunk) * self.prefill_chunk

    def _start_admissions(self) -> None:
        """Pop pending requests into slots (pages permitting) and build
        their chunked-prefill jobs: one job per slot (mixed) or one per
        remainder bucket (alternating). A request that carries generated
        tokens is a continuation (it was preempted): its admission prompt
        is prompt + tokens, so the prefix walk re-hits the pages it
        released, and a constrained one resumes its DFA mid-pattern."""
        self._sync_grammar_stack()
        staged: list[int] = []
        doomed: list[Request] = []
        with self._lock:
            free = [i for i, s in enumerate(self._slots) if s is None]
            while self._pending and free:
                # deficit round-robin over tenants picks the request
                # that funds the next slot (FIFO within a tenant; FIFO
                # without QoS)
                idx = (self.qos.next_admission_index(self._pending)
                       if self.qos is not None else 0)
                req = self._pending[idx]
                sp = req.sampling
                if (sp is not None and sp.regex is not None
                        and self._pattern_gid[sp.regex]
                        > self._grammar_built):
                    break  # registered after this iteration's upload
                prompt = list(req.prompt) + list(req.tokens)
                remaining = req.max_new_tokens - len(req.tokens)
                shared, shared_len = self.allocator.lookup_prefix(
                    prompt, namespace=req.adapter or "", tenant=req.tenant)
                if self.allocation == "ondemand":
                    # the prompt and one window now, the rest grows
                    # before each decode dispatch (_extend_chains)
                    total = len(prompt) + self.window
                else:
                    total = len(prompt) + remaining + self.window
                need = -(-total // self.page_size) - len(shared)
                if (self._faults is not None
                        and self._faults.fire("alloc_famine")
                        is not None):
                    # an injected transient famine: release the walk's
                    # references and retry next iteration
                    self.allocator.release(shared, prompt[:shared_len],
                                           namespace=req.adapter or "",
                                           tenant=req.tenant)
                    break
                fresh = self.allocator.alloc(max(0, need),
                                             tenant=req.tenant)
                if fresh is None:
                    self.allocator.release(shared, prompt[:shared_len],
                                           namespace=req.adapter or "",
                                           tenant=req.tenant)
                    if self.num_active == 0 and not self._jobs:
                        del self._pending[idx]
                        if self.qos is not None:
                            self.qos.on_pending_removed(req.tenant)
                        req.finish_reason = (
                            "error: request needs more pages than the "
                            "pool can ever provide")
                        # caused by the request: a router must neither
                        # retry it nor blame the replica
                        req._request_fault = True
                        doomed.append(req)
                        continue
                    break
                del self._pending[idx]
                if self.qos is not None:
                    # the tenant's deficit is spent only now that the
                    # admission holds its pages
                    self.qos.charge_admission(req.tenant, len(prompt))
                    self.qos.on_pending_removed(req.tenant)
                if shared_len:
                    self.allocator.telemetry.record_saved(req.tenant,
                                                          shared_len)
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
                self.stop_len[slot_id] = slot.stop_len
                self.active[slot_id] = False  # live once admission is done
                row = make_rows([sp], self.infer_cfg, [req.seed_used],
                                prompt_lens=[len(req.prompt)])
                for dst, src in zip(self.samp_rows, row):
                    dst[slot_id] = src[0]
                self._needs_rows[slot_id] = (
                    sp is not None and sp.needs_device_rows(self.infer_cfg))
                self._has_bias[slot_id] = sp is not None and bool(
                    sp.logit_bias)
                if sp is not None and sp.regex is not None:
                    # submit() registered the pattern; a continuation
                    # replays its generated tokens through the DFA
                    self._gid[slot_id] = self._pattern_gid[sp.regex]
                    self._gstate0[slot_id] = self._grammar_cache.get(
                        sp.regex).walk(req.tokens)
                else:
                    self._gid[slot_id] = 0
                    self._gstate0[slot_id] = 0
                self._aid[slot_id] = (
                    0 if req.adapter is None
                    else self.adapters.adapter_id(req.adapter))
                if sp is not None and sp.needs_penalty_state():
                    self._ensure_penalty_state()
                self.orig_len[slot_id] = len(req.prompt)
                if self.spec_control is not None:
                    # fresh controller state; a continuation re-prefills
                    # the draft cache, so its staleness clears with it
                    self.spec_control.on_admit(slot_id)
                staged.append(slot_id)
        for req in doomed:
            self._complete(req)
        if not staged:
            return
        now = time.perf_counter()  # one clock read per admission burst
        for slot_id in staged:
            self.metrics.observe_admit(self._slots[slot_id].req, now)
        pad_tok = self.infer_cfg.pad_token_id
        if self._mixed_enabled:
            # one job per slot: progress is token-granular, widths are
            # chosen per iteration by the token budget
            for slot_id in staged:
                slot = self._slots[slot_id]
                rem_toks = slot.prompt[slot.shared_len:]
                rb = self._rem_bucket(len(rem_toks))
                pb = _bucket(len(slot.prompt), self._admit_buckets)
                job = _AdmitJob(
                    slots=[slot_id], chunk_w=rb, n_chunks=1,
                    rows=np.full((1, rb), pad_tok, np.int32),
                    rem_lens=np.asarray([len(rem_toks)], np.int32),
                    base_lens=np.asarray([slot.shared_len], np.int32),
                    prompt_rows=np.full((1, pb), pad_tok, np.int32),
                    prompt_lens=np.asarray([len(slot.prompt)], np.int32),
                    toks=np.zeros((1,), np.int32),
                    lps=np.zeros((1,), np.float64),
                    got=np.zeros((1,), bool))
                job.rows[0, :len(rem_toks)] = rem_toks
                job.prompt_rows[0, :len(slot.prompt)] = slot.prompt
                self._jobs.append(job)
            return
        # group by remainder bucket => uniform chunk schedule per job
        by_bucket: dict[int, list[int]] = {}
        for slot_id in staged:
            slot = self._slots[slot_id]
            rb = self._rem_bucket(len(slot.prompt) - slot.shared_len)
            by_bucket.setdefault(rb, []).append(slot_id)
        for rb, slot_ids in by_bucket.items():
            w = min(rb, self.prefill_chunk)
            n_chunks = -(-rb // w)
            g = len(slot_ids)
            pb = _bucket(max(len(self._slots[s].prompt) for s in slot_ids),
                         self._admit_buckets)
            job = _AdmitJob(
                slots=list(slot_ids), chunk_w=w, n_chunks=n_chunks,
                rows=np.full((g, n_chunks * w), pad_tok, np.int32),
                rem_lens=np.zeros((g,), np.int32),
                base_lens=np.zeros((g,), np.int32),
                prompt_rows=np.full((g, pb), pad_tok, np.int32),
                prompt_lens=np.zeros((g,), np.int32),
                toks=np.zeros((g,), np.int32),
                lps=np.zeros((g,), np.float64),
                got=np.zeros((g,), bool))
            for i, sid in enumerate(slot_ids):
                slot = self._slots[sid]
                rem_toks = slot.prompt[slot.shared_len:]
                job.rows[i, :len(rem_toks)] = rem_toks
                job.rem_lens[i] = len(rem_toks)
                job.base_lens[i] = slot.shared_len
                job.prompt_rows[i, :len(slot.prompt)] = slot.prompt
                job.prompt_lens[i] = len(slot.prompt)
            self._jobs.append(job)

    def _run_one_chunk(self, job: _AdmitJob) -> None:
        """The alternating scheduler's admission program: one chunk of a
        bucketed group, padded to a power of two rows, then its sync."""
        if self._faults is not None:
            self._faults.check("dispatch")
        c = job.next_chunk
        w = job.chunk_w
        g = len(job.slots)
        gp = _pad_pow2(g)

        def pad_rows(a, fill):
            if g == gp:
                return a
            padded = np.full((gp,) + a.shape[1:], fill, a.dtype)
            padded[:g] = a
            return padded

        st = self._iter_stats  # flight recorder: prefill share per iter
        st.setdefault("scheduler", self.scheduler)
        st["prefill_tokens"] = st.get("prefill_tokens", 0) + w * g
        if self.trace_recorder is not None:
            self._stage_spans("prefill_chunk", [
                (sid, {"tokens": w, "chunk": c}) for sid in job.slots])
        sl = np.asarray(job.slots)
        g_tables = np.full((gp, self.max_pages_per_slot),
                           self.allocator.num_pages, np.int32)
        g_tables[:g] = self.tables[sl]
        in_range = ((job.rem_lens - 1) >= c * w) & (
            (job.rem_lens - 1) < (c + 1) * w)
        sl_pad = np.zeros((gp,), np.int64)
        sl_pad[:g] = sl
        pad_tok = self.infer_cfg.pad_token_id
        pf = {
            "chunk": pad_rows(np.ascontiguousarray(
                job.rows[:, c * w:(c + 1) * w]), pad_tok),
            "g_lens": pad_rows(job.base_lens + c * w, 0),
            "g_tables": g_tables,
            "sample_at": pad_rows(
                np.clip(job.rem_lens - 1 - c * w, 0, w - 1), 0),
            "prompt_lens": pad_rows(job.prompt_lens, 0),
            "slot_ids": pad_rows(sl.astype(np.int32), self.max_slots),
            "count_mask": pad_rows(in_range, False),
            "prompt_rows": pad_rows(job.prompt_rows, pad_tok),
            "orig_lens": pad_rows(self.orig_len[sl], 0),
            "gid_g": pad_rows(self._gid[sl], 0),
            "gst0_g": pad_rows(self._gstate0[sl], 0),
            "aid_g": pad_rows(self._aid[sl], 0),
            "samp_g": _gather_samp_rows(self.samp_rows, sl_pad, g)}
        flags = dict(rows=bool(self._needs_rows[sl].any()),
                     bias=bool(self._has_bias[sl].any()),
                     grammar=bool((self._gid[sl] > 0).any()),
                     has_pen=self._model.pm is not None,
                     scatter_prompt=c == 0 and self._scatters_prompts(),
                     lora=bool((self._aid[sl] > 0).any()))
        staged = self._prefill_staged(
            pf, ragged=False, use_rows=flags["rows"],
            grammar=flags["grammar"], scatter=flags["scatter_prompt"],
            lora=flags["lora"])
        prof = self._profiler
        if prof is not None:
            # per-chunk marks accumulate into the iteration's phases
            prof.mark("build")
        # analysis: allow[lock-discipline] THE sanctioned per-iteration
        # host sync; _step_lock serializes the scheduler by design
        out = self._launch(_prefill_chunk, flags, staged).wait()
        if prof is not None:
            prof.mark("device")
        toks, lps = out["ptoks"][:g], out["plps"][:g]
        job.toks = np.where(in_range, toks, job.toks)
        job.lps = np.where(in_range, lps, job.lps)
        job.got |= in_range
        job.next_chunk += 1

        if job.next_chunk >= job.n_chunks:
            # admission complete: activate slots, emit first tokens
            for i, sid in enumerate(job.slots):
                slot = self._slots[sid]
                assert bool(job.got[i]), "first-token sample never captured"
                self.lengths[sid] = len(slot.prompt)
                self.last_token[sid] = int(job.toks[i])
                if slot.req._cancel.is_set():
                    slot = self._release_slot(sid, self._committed(sid))
                    slot.req.finish_reason = "cancelled"
                    self._complete(slot.req)
                    continue
                self.active[sid] = True
                if self._emit(slot.req, int(job.toks[i]),
                              float(job.lps[i])):
                    self._finish(sid)
            self._jobs.remove(job)
        if prof is not None:
            prof.mark("commit")

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
        if self.qos is not None:
            # (lowest priority class, most over fair share, youngest)
            sid = max(candidates,
                      key=lambda s: (*self.qos.victim_rank(
                          self._slots[s].req.tenant),
                          self._slots[s].admit_seq))
        else:
            sid = max(candidates, key=lambda s: self._slots[s].admit_seq)
        slot = self._release_slot(sid, self._committed(sid))
        self.preemptions += 1
        self.metrics.observe_requeue(slot.req, time.perf_counter())
        if self.qos is not None:
            self.qos.on_requeue(slot.req.tenant)
            self._iter_stats.setdefault("preempt_tenants", []).append(
                slot.req.tenant)
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
                    slot.req._request_fault = True
                    self._complete(slot.req)
                    break
                n_eff = min(n_eff, r_ok)
                break
        return n_eff

    def _chunk_rounds(self, active=None) -> int:
        """Rounds of a decode-only dispatch: decode_chunk (shrunk to
        admit_decode_chunk while admission jobs are in flight), bounded
        by the tightest remaining budget, rounded down to a power of
        two. `active` overrides the live mask (the planner's planned
        frame)."""
        if active is None:
            active = self.active
        rem = [s.req.max_new_tokens - len(s.req.tokens)
               for i, s in enumerate(self._slots)
               if s is not None and active[i]]
        if not rem:
            return 1
        chunk = self.decode_chunk
        if self._jobs and self.admit_decode_chunk is not None:
            chunk = self.admit_decode_chunk
        n = max(1, min(chunk, -(-min(rem) // self.window)))
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def _gather_decode_rows(self, active=None):
        """Compacted decode sub-batch: one row per live slot, padded to a
        power of two; rows past the live count carry sentinel tables and
        the sentinel slot id, so their writes drop. A fully live batch
        stages the slots as they are (rows ARE slots, `sl` None).
        `active` overrides the live mask (the planner's planned frame;
        the gathered lengths and last tokens are placeholders there,
        re-read at launch).

        Returns (live_ids, _DecodeRows)."""
        if active is None:
            active = self.active
        live_ids = np.flatnonzero(active)
        if len(live_ids) == self.max_slots:
            return live_ids, _DecodeRows(
                sl=None, live=active.copy(), lens=self.lengths,
                tables=self.tables, last=self.last_token,
                stop=self.stop_len, samp=self.samp_rows, gid=self._gid,
                aid=self._aid)
        bg = _pad_pow2(max(len(live_ids), 1))
        nl = len(live_ids)
        sl = np.full((bg,), self.max_slots, np.int32)
        sl[:nl] = live_ids
        slr = np.clip(sl, 0, self.max_slots - 1)
        live_g = np.zeros((bg,), bool)
        live_g[:nl] = True
        tables = self.tables[slr].copy()
        tables[nl:] = self.allocator.num_pages
        gid = self._gid[slr].copy()
        gid[nl:] = 0
        aid = self._aid[slr].copy()
        aid[nl:] = 0
        return live_ids, _DecodeRows(
            sl=sl, live=live_g, lens=self.lengths[slr].copy(),
            tables=tables, last=self.last_token[slr].copy(),
            stop=self.stop_len[slr].copy(),
            samp=_gather_samp_rows(self.samp_rows, slr, nl), gid=gid,
            aid=aid)

    def _spec_plan(self, live_ids):
        """This dispatch's speculation: (draft count, per-live-row draft
        caps). A fixed-length server plans (spec_drafts, None); with the
        adaptive controller the width is quantized to {0, spec_drafts}
        (each row's cap bounds its commits), and all-zero lengths plan
        plain decode."""
        if self.spec_drafts <= 0 or len(live_ids) == 0:
            return 0, None
        if self.spec_control is None:
            return self.spec_drafts, None
        lens = [self.spec_control.draft_len(int(s)) for s in live_ids]
        if max(lens) <= 0:
            return 0, None
        return self.spec_drafts, lens

    def _drafted_rows(self, g_iter: int, spec_lens, nl: int):
        """Per-live-row drafted-token counts for the speculation ledger
        (None when plain decode ran)."""
        if g_iter <= 0:
            return None
        return spec_lens if spec_lens is not None else [g_iter] * nl

    def _stage_spec_stats(self, g_iter: int, n_live: int,
                          st: dict | None = None) -> None:
        """Flight-recorder speculation fields of this iteration (the
        drafted/accepted tokens land at the commit). `st` overrides the
        destination (a planned iteration's stats)."""
        if self.spec_drafts <= 0:
            return
        if st is None:
            st = self._iter_stats
        st["spec_rows"] = n_live if g_iter > 0 else 0
        st["spec_window"] = g_iter + 1 if g_iter > 0 else 1
        if self.spec_control is not None:
            st["spec_draft_lens"] = self.spec_control.draft_lengths()

    def _decode_flags(self, live, g_iter: int, spec_lens,
                      n_rounds: int) -> dict:
        """A decode program's static switches for the slots `live`."""
        return {"n_rounds": n_rounds, "n_drafts": g_iter,
                "limited": spec_lens is not None,
                "rows": bool((self._needs_rows & live).any()),
                "bias": bool((self._has_bias & live).any()),
                "grammar": bool(((self._gid > 0) & live).any()),
                "has_pen": self._model.pm is not None,
                "lora": bool(((self._aid > 0) & live).any())}

    def _decode_dispatch(self) -> None:
        """A decode-only iteration: one program of n_rounds rounds over
        the compacted live rows, plain or speculative, then its sync."""
        if self._faults is not None:
            self._faults.check("dispatch")
        prof = self._profiler
        n = self._chunk_rounds()
        if self.allocation == "ondemand":
            n_eff = self._extend_chains(n)
            if n_eff <= 0 or not self.active.any():
                return  # transient page famine
            while n > n_eff:  # round counts stay powers of two
                n //= 2
            n = max(1, n)
        if prof is not None:
            prof.mark("admission")
        live_ids, rows = self._gather_decode_rows()
        g_iter, spec_lens = self._spec_plan(live_ids)
        self._iter_stats.update(
            scheduler=self.scheduler, n_live=len(live_ids),
            decode_rounds=n,
            decode_tokens=len(live_ids) * (g_iter + 1) * n,
            decode_rows=int(rows.live.shape[0]),
            compaction_ratio=len(live_ids) / max(int(rows.live.shape[0]),
                                                 1))
        self._stage_spec_stats(g_iter, len(live_ids))
        if self.trace_recorder is not None:
            self._stage_spans("decode_segment",
                              self._decode_span_tags(live_ids, n))
        flags = self._decode_flags(self.active, g_iter, spec_lens, n)
        staged = self._decode_staged(rows, spec_lens, spec=g_iter > 0,
                                     use_rows=flags["rows"],
                                     grammar=flags["grammar"],
                                     lora=flags["lora"])
        if prof is not None:
            prof.mark("build")
        # analysis: allow[lock-discipline] THE sanctioned per-iteration
        # host sync; _step_lock serializes the scheduler by design
        out = self._launch(_decode_rounds, flags, staged).wait()
        if prof is not None:
            prof.mark("device")
        self._commit_decode_out(live_ids, out, g_iter, spec_lens, n)
        if prof is not None:
            prof.mark("commit")

    def _commit_decode_out(self, live_ids, out: dict, g_iter: int,
                           spec_lens, n_rounds: int, owners=None) -> None:
        """A decode program's results to `_commit_decode_rows` (a plain
        round's tokens are windows of one)."""
        toks, lps = out["toks"], out["lps"]
        if g_iter <= 0:
            toks, lps = toks[:, :, None], lps[:, :, None]
            if self.spec_drafts > 0 and self.spec_control is not None:
                # every live slot decoded plainly: draft caches miss
                # these positions, n-gram slots accrue probe credit
                self.spec_control.on_plain_dispatch(
                    [int(s) for s in live_ids], n_rounds)
        self._commit_decode_rows(
            live_ids, toks, lps, out["counts"], out["lens"], out["last"],
            self._drafted_rows(g_iter, spec_lens, len(live_ids)),
            owners=owners)

    def _commit_decode_rows(self, live_ids, toks, lps, counts, lens, last,
                            drafted=None, owners=None) -> None:
        """Scatter a compacted decode dispatch's (R, B, G+1) results back
        to slots and emit round by round, each row its `counts[r]`
        tokens. `owners` (pipelined scheduler): the _Slot each row was
        planned for — a row's slot may have been released and
        re-occupied between launch and commit, so the ledger writes and
        emits are identity-guarded per row. `drafted` (per-live-row draft
        lengths, None when plain decode ran) funds the speculation
        ledger and feeds the adaptive controller: per committed round a
        row drafted its length and accepted count - 1 of them."""
        nl = len(live_ids)
        if owners is None:
            self.lengths[live_ids] = lens[:nl]
            self.last_token[live_ids] = last[:nl]
        else:
            for i in range(nl):
                sid = int(live_ids[i])
                if self._slots[sid] is owners[i] and self.active[sid]:
                    self.lengths[sid] = lens[i]
                    self.last_token[sid] = last[i]
        self.decode_rounds += int(counts.shape[0]) * nl
        self.decode_tokens_committed += int(counts.sum())
        sp_drafted = sp_accepted = 0
        spec_by_tenant: dict = {}
        for r in range(toks.shape[0]):
            for i, sid in enumerate(live_ids):
                slot = self._slots[sid]
                if slot is None or not self.active[sid] \
                        or (owners is not None and slot is not owners[i]):
                    continue
                c = int(counts[r, i])
                if drafted is not None and c > 0:
                    d = int(drafted[i])
                    a = min(max(c - 1, 0), d)
                    sp_drafted += d
                    sp_accepted += a
                    if self.spec_control is not None:
                        self.spec_control.observe(sid, d, a)
                    if self.qos is not None and d > 0:
                        dd, aa = spec_by_tenant.get(slot.req.tenant,
                                                    (0, 0))
                        spec_by_tenant[slot.req.tenant] = (dd + d, aa + a)
                for t in range(c):
                    if self._emit(slot.req, int(toks[r, i, t]),
                                  float(lps[r, i, t])):
                        self._finish(sid)
                        break
        if drafted is not None:
            self.spec_tokens_drafted += sp_drafted
            self.spec_tokens_accepted += sp_accepted
            st = self._iter_stats
            st["spec_tokens_drafted"] = (
                st.get("spec_tokens_drafted", 0) + sp_drafted)
            st["spec_tokens_accepted"] = (
                st.get("spec_tokens_accepted", 0) + sp_accepted)
            for tenant, (dd, aa) in spec_by_tenant.items():
                self.qos.charge_speculation(tenant, dd, aa)

    def _complete_admission_chunks(self, sel, ptoks, plps) -> None:
        """Prefill progress on the synced first-token candidates: capture
        samples in range, advance `done` (and `planned`, to keep it
        ahead), and activate completed admissions — the one completion
        block of the sequential and the pipelined paths."""
        for i, (job, take, d0) in enumerate(sel):
            sid = job.slots[0]
            rl = int(job.rem_lens[0])
            if d0 <= rl - 1 < d0 + take:
                job.toks[0] = ptoks[i]
                job.lps[0] = plps[i]
                job.got[0] = True
            job.done = d0 + take
            job.planned = max(job.planned, job.done)
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
                elif slot.req._handoff is not None:
                    # prefill complete with decode budget left: the
                    # handoff callback fires after _step_lock releases
                    self._handoff_ready.append(slot.req)
            self._jobs.remove(job)

    # -- mixed (stall-free) scheduling --------------------------------------

    def _mixed_rounds(self, n_live: int, prefill_demand: int, win: int,
                      active=None) -> int:
        """Decode rounds for a mixed iteration: the full steady-state
        count at this iteration's window `win` (current draft count + 1,
        a live slot's honest claim on the budget), squeezed to leave the
        budget one minimal prefill chunk when admissions wait, floored at
        one, a power of two."""
        if active is None:
            active = self.active
        rem = [s.req.max_new_tokens - len(s.req.tokens)
               for i, s in enumerate(self._slots)
               if s is not None and active[i]]
        if not rem or not n_live:
            return 0
        n = max(1, min(self.decode_chunk, -(-min(rem) // win)))
        if prefill_demand > 0:
            fit = (self.mixed_token_budget - self._rem_buckets[0]) \
                // (n_live * win)
            n = min(n, max(fit, 1))
        p = 1
        while p * 2 <= n:
            p *= 2
        return p

    def _select_prefill(self, jobs, n_live: int, win: int, n_rounds: int,
                        planned: bool):
        """Token-budget prefill selection in QoS virtual-time order (FIFO
        without QoS), shared by the sequential path (cursor `done`) and
        the planner (cursor `planned`): decode rows are funded first
        (`win` tokens a round each), each job takes up to
        `prefill_chunk` tokens of its remainder, and when decode alone
        saturates the budget the first admission in that order still
        gets one minimal chunk. Returns [(job, take, cursor)]."""

        def cur(j):
            return j.planned if planned else j.done

        if self.qos is not None and jobs:
            order = self.qos.order_jobs(
                [self._slots[j.slots[0]].req.tenant for j in jobs])
            jobs = [jobs[i] for i in order]
        sel: list[tuple[_AdmitJob, int, int]] = []
        left = self.mixed_token_budget - n_live * win * n_rounds
        for job in jobs:
            if left <= 0:
                break
            take = min(int(job.rem_lens[0]) - cur(job), left,
                       self.prefill_chunk)
            if take <= 0:
                continue
            sel.append((job, take, cur(job)))
            left -= take
        if jobs and not sel:
            job = jobs[0]
            take = min(int(job.rem_lens[0]) - cur(job),
                       self._rem_buckets[0])
            sel = [(job, take, cur(job))]
        return sel

    def _build_prefill_group(self, sel) -> dict:
        """Numpy staging of a mixed iteration's ragged prefill half: one
        row per selected admission chunk at its own width, padded to a
        power of two rows and a `_mixed_buckets` width; padding rows have
        width 0, sentinel tables and slot ids, and neutral sampling rows.
        Rows at their first chunk carry their admission prompt
        (`scatter_mask`) for the per-slot state."""
        pad_tok = self.infer_cfg.pad_token_id
        g = len(sel)
        gp = _pad_pow2(max(g, 1))
        w = _bucket(max([t for _, t, _ in sel] + [1]), self._mixed_buckets)
        chunk = np.full((gp, w), pad_tok, np.int32)
        widths = np.zeros((gp,), np.int32)
        g_lens = np.zeros((gp,), np.int32)
        g_tables = np.full((gp, self.max_pages_per_slot),
                           self.allocator.num_pages, np.int32)
        sample_at = np.zeros((gp,), np.int32)
        slot_ids = np.full((gp,), self.max_slots, np.int32)
        prompt_lens = np.zeros((gp,), np.int32)
        orig_lens = np.zeros((gp,), np.int32)
        countm = np.zeros((gp,), bool)
        scatm = np.zeros((gp,), bool)
        scat_plens = [int(job.prompt_lens[0]) for job, _, d0 in sel
                      if d0 == 0]
        pb = (_bucket(max(scat_plens), self._admit_buckets)
              if scat_plens else self._admit_buckets[0])
        prompt_rows = np.full((gp, pb), pad_tok, np.int32)
        for i, (job, take, d0) in enumerate(sel):
            sid = job.slots[0]
            rl = int(job.rem_lens[0])
            pl = int(job.prompt_lens[0])
            chunk[i, :take] = job.rows[0, d0:d0 + take]
            widths[i] = take
            g_lens[i] = int(job.base_lens[0]) + d0
            g_tables[i] = self.tables[sid]
            sample_at[i] = min(max(rl - 1 - d0, 0), take - 1)
            slot_ids[i] = sid
            prompt_lens[i] = pl
            orig_lens[i] = self.orig_len[sid]
            countm[i] = d0 <= rl - 1 < d0 + take
            scatm[i] = d0 == 0
            if d0 == 0:
                prompt_rows[i, :pl] = job.prompt_rows[0, :pl]
        sl_real = np.clip(slot_ids, 0, self.max_slots - 1)
        gid_g = self._gid[sl_real].copy()
        gid_g[g:] = 0
        gst0_g = self._gstate0[sl_real].copy()
        gst0_g[g:] = 0
        aid_g = self._aid[sl_real].copy()
        aid_g[g:] = 0
        sel_mask = np.zeros((self.max_slots,), bool)
        sel_mask[[job.slots[0] for job, _, _ in sel]] = True
        return {"chunk": chunk, "widths": widths, "g_lens": g_lens,
                "g_tables": g_tables, "sample_at": sample_at,
                "prompt_lens": prompt_lens, "slot_ids": slot_ids,
                "count_mask": countm, "scatter_mask": scatm,
                "prompt_rows": prompt_rows, "orig_lens": orig_lens,
                "gid_g": gid_g, "gst0_g": gst0_g, "aid_g": aid_g,
                "samp_g": _gather_samp_rows(self.samp_rows, sl_real, g),
                "sel_mask": sel_mask}

    def _mixed_flags(self, pf: dict, live, g_iter: int, spec_lens,
                     n_rounds: int) -> dict:
        """The mixed program's static switches: its prefill half over
        the selected slots, its decode half over `live`, one grammar
        switch for both."""
        sel = pf["sel_mask"]
        dec = n_rounds > 0
        return {"n_rounds": n_rounds, "n_drafts": g_iter if dec else 0,
                "limited": dec and spec_lens is not None,
                "rows_d": dec and bool((self._needs_rows & live).any()),
                "bias_d": dec and bool((self._has_bias & live).any()),
                "rows_p": bool((self._needs_rows & sel).any()),
                "bias_p": bool((self._has_bias & sel).any()),
                "grammar": bool(((self._gid > 0) & (live | sel)).any()),
                "has_pen": self._model.pm is not None,
                "scatter_prompt": (bool(pf["scatter_mask"].any())
                                   and self._scatters_prompts()),
                "lora": bool(((self._aid > 0) & (live | sel)).any())}

    def _mixed_staged(self, pf: dict, flags: dict, rows: _DecodeRows,
                      spec_lens) -> dict:
        staged = self._prefill_staged(
            pf, ragged=True, use_rows=flags["rows_p"],
            grammar=flags["grammar"], scatter=flags["scatter_prompt"],
            lora=flags["lora"])
        if flags["n_rounds"] > 0:
            staged.update(self._decode_staged(
                rows, spec_lens if flags["limited"] else None,
                spec=flags["n_drafts"] > 0, use_rows=flags["rows_d"],
                grammar=flags["grammar"], lora=flags["lora"]))
        return staged

    def _mixed_dispatch(self) -> None:
        """One token-budget iteration: the multi-round decode of every
        live slot plus as many prefill-chunk tokens as fit under
        `mixed_token_budget`, ONE program, then its sync. Admitting slots
        not selected this iteration are not staged at all."""
        if self._faults is not None:
            # an injected dispatch failure, before any device work
            self._faults.check("dispatch")
        demand = sum(int(j.rem_lens[0]) - j.done for j in self._jobs)
        n_live = int(self.active.sum())
        g0, _ = self._spec_plan(np.flatnonzero(self.active))
        n_rounds = self._mixed_rounds(n_live, demand, g0 + 1)
        if self.allocation == "ondemand" and n_rounds > 0:
            n_eff = self._extend_chains(n_rounds)
            if n_eff <= 0 or not self.active.any():
                n_rounds = 0  # transient page famine: prefill-only
            else:
                while n_rounds > n_eff:
                    n_rounds //= 2
                n_rounds = max(1, n_rounds)
        live = (self.active if n_rounds > 0
                else np.zeros((self.max_slots,), bool))
        n_live = int(live.sum())
        # re-planned: _extend_chains may have preempted a slot
        g_iter, spec_lens = self._spec_plan(np.flatnonzero(self.active))
        win = g_iter + 1
        sel = self._select_prefill(self._jobs, n_live, win, n_rounds,
                                   planned=False)
        prof = self._profiler
        if prof is not None:
            prof.mark("admission")
        if not sel and not n_rounds:
            return
        if self.qos is not None:
            for job, take, _ in sel:
                self.qos.charge_prefill(
                    self._slots[job.slots[0]].req.tenant, take)
        self._iter_stats.update(
            scheduler="mixed", n_live=n_live, decode_rounds=n_rounds,
            decode_tokens=n_live * win * n_rounds,
            prefill_tokens=sum(t for _, t, _ in sel))
        if n_rounds > 0:
            self._stage_spec_stats(g_iter, n_live)
        if self.trace_recorder is not None:
            self._stage_spans("prefill_chunk",
                              self._prefill_span_tags(sel))
        pf = self._build_prefill_group(sel)
        live_ids, rows = self._gather_decode_rows()
        self._iter_stats.update(
            decode_rows=int(rows.live.shape[0]) if n_rounds else 0,
            compaction_ratio=(n_live / max(int(rows.live.shape[0]), 1)
                              if n_rounds else 1.0))
        if self.trace_recorder is not None and n_rounds > 0:
            self._stage_spans("decode_segment",
                              self._decode_span_tags(live_ids, n_rounds))
        flags = self._mixed_flags(pf, live, g_iter, spec_lens, n_rounds)
        staged = self._mixed_staged(pf, flags, rows, spec_lens)
        if prof is not None:
            prof.mark("build")
        # a handoff's committed pages: gathered before the final prefill
        # chunk launches, copied out while it runs
        self._handoff_prefetch(sel)
        prog = self._launch(_mixed_step, flags, staged)
        self._handoff_copy_out()
        # analysis: allow[lock-discipline] THE sanctioned per-iteration
        # host sync: one launch, one wait, under the step lock that
        # serializes the scheduler by design
        out = prog.wait()
        if prof is not None:
            prof.mark("device")
        if n_rounds > 0:
            self._commit_decode_out(live_ids, out, flags["n_drafts"],
                                    spec_lens, n_rounds)
        self._complete_admission_chunks(sel, out["ptoks"], out["plps"])
        if prof is not None:
            prof.mark("commit")

    # -- pipelined scheduling (overlap on) ----------------------------------
    #
    # Each step plans iteration N+1 against the PLANNED frame while the
    # card runs iteration N, waits on N's event and commits it, patches
    # the plan's data-dependent inputs from the just-committed ledger,
    # and launches. The plan functions never release pages or tear down
    # slots: a page freed under an in-flight dispatch could be handed
    # out while the card still writes it.

    def _extend_chains_planned(self, n_rounds: int, planned_len,
                               planned_active) -> int:
        """Planned-frame chain growth for a launch-ahead dispatch: cover
        each planned-live slot's worst-case window writes from its
        planned length (committed length + the in-flight rounds' upper
        bound). Never preempts or fails a request: on famine it takes the
        pages there are and bounds the dispatch to the rounds every chain
        covers (0 drops the decode half; the pipeline drains and the next
        sequential iteration runs the full escalation)."""
        n_eff = n_rounds
        for sid in range(self.max_slots):
            slot = self._slots[sid]
            if slot is None or not planned_active[sid]:
                continue
            need_len = min(int(planned_len[sid]) + n_rounds * self.window,
                           slot.stop_len + self.window)
            delta = -(-need_len // self.page_size) - len(slot.pages)
            if delta > 0:
                grab = min(delta, self.allocator.available)
                fresh = self.allocator.alloc(grab) if grab > 0 else None
                if fresh:
                    start = len(slot.pages)
                    slot.pages.extend(fresh)
                    self.tables[sid, start:len(slot.pages)] = fresh
            covered = len(slot.pages) * self.page_size
            r_ok = max(0, (covered - int(planned_len[sid])) // self.window)
            n_eff = min(n_eff, r_ok)
        return n_eff

    def _plan_iteration(self) -> _Plan | None:
        """Plan, and stage in numpy, the NEXT dispatch against the
        planned frame: the committed ledger plus the in-flight dispatch's
        deterministic effects (job cursors advanced by its takes, slots
        it completes counted live, lengths at their upper bound of
        rounds x window: a speculative dispatch commits between 0 and
        G+1 tokens a row a round). Returns None when there is nothing to
        dispatch (the pipeline drains). Mutates nothing of the committed
        ledger beyond job.planned cursors and chain growth."""
        prof = self._profiler
        infl = self._inflight
        planned_active = self.active.copy()
        planned_len = self.lengths.copy()
        if infl is not None:
            if infl.n_rounds > 0:
                for i, sid_ in enumerate(infl.live_ids):
                    sid = int(sid_)
                    if planned_active[sid] \
                            and self._slots[sid] is infl.owners[i]:
                        planned_len[sid] = min(
                            int(planned_len[sid])
                            + infl.n_rounds * infl.win,
                            int(self.stop_len[sid]) + self.window)
            for sid in infl.activating:
                slot = self._slots[sid]
                if slot is not None:
                    planned_active[sid] = True
                    planned_len[sid] = len(slot.prompt)
        jobs = [j for j in self._jobs if j.planned < int(j.rem_lens[0])]
        if not jobs and not planned_active.any():
            return None
        stats: dict = {}
        spans: list = []
        if jobs:
            # a token-budget mixed iteration (mirrors _mixed_dispatch);
            # the planner never preempts, so one speculation plan holds
            demand = sum(int(j.rem_lens[0]) - j.planned for j in jobs)
            n_live = int(planned_active.sum())
            g_iter, spec_lens = self._spec_plan(
                np.flatnonzero(planned_active))
            win = g_iter + 1
            n_rounds = self._mixed_rounds(n_live, demand, win,
                                          active=planned_active)
            if self.allocation == "ondemand" and n_rounds > 0:
                n_eff = self._extend_chains_planned(
                    n_rounds, planned_len, planned_active)
                if n_eff <= 0:
                    n_rounds = 0
                else:
                    while n_rounds > n_eff:
                        n_rounds //= 2
                    n_rounds = max(1, n_rounds)
            live = (planned_active if n_rounds > 0
                    else np.zeros((self.max_slots,), bool))
            n_live = int(live.sum())
            sel = self._select_prefill(jobs, n_live, win, n_rounds,
                                       planned=True)
            if not sel and not n_rounds:
                return None
            if self.qos is not None:
                for job, take, _ in sel:
                    self.qos.charge_prefill(
                        self._slots[job.slots[0]].req.tenant, take)
            activating: list[int] = []
            for job, take, d0 in sel:
                job.planned = d0 + take
                if job.planned >= int(job.rem_lens[0]):
                    activating.append(job.slots[0])
            stats.update(
                scheduler="mixed", n_live=n_live, decode_rounds=n_rounds,
                decode_tokens=n_live * win * n_rounds,
                prefill_tokens=sum(t for _, t, _ in sel))
            if n_rounds > 0:
                self._stage_spec_stats(g_iter, n_live, st=stats)
            if self.trace_recorder is not None:
                self._stage_spans("prefill_chunk",
                                  self._prefill_span_tags(sel), out=spans)
            if prof is not None:
                prof.mark("admission")
            pf = self._build_prefill_group(sel)
            live_ids, rows = self._gather_decode_rows(live)
            stats.update(
                decode_rows=int(rows.live.shape[0]) if n_rounds else 0,
                compaction_ratio=(n_live / max(int(rows.live.shape[0]), 1)
                                  if n_rounds else 1.0))
            if self.trace_recorder is not None and n_rounds > 0:
                self._stage_spans(
                    "decode_segment",
                    self._decode_span_tags(live_ids, n_rounds), out=spans)
            if n_rounds == 0:
                rows.live = np.zeros_like(rows.live)
            plan = _Plan(
                kind="mixed", sel=sel, activating=activating,
                n_rounds=n_rounds, win=win, g_iter=g_iter,
                spec_lens=spec_lens, live_ids=live_ids, rows=rows,
                owners=[self._slots[int(s)] for s in live_ids], pf=pf,
                flags=self._mixed_flags(pf, live, g_iter, spec_lens,
                                        n_rounds),
                stats=stats, spans=spans)
        else:
            # a pure-decode iteration (mirrors _decode_dispatch)
            n = self._chunk_rounds(active=planned_active)
            if self.allocation == "ondemand":
                n_eff = self._extend_chains_planned(n, planned_len,
                                                    planned_active)
                if n_eff <= 0:
                    return None
                while n > n_eff:
                    n //= 2
                n = max(1, n)
            if prof is not None:
                prof.mark("admission")
            live_ids, rows = self._gather_decode_rows(planned_active)
            g_iter, spec_lens = self._spec_plan(live_ids)
            stats.update(
                scheduler=self.scheduler, n_live=len(live_ids),
                decode_rounds=n,
                decode_tokens=len(live_ids) * (g_iter + 1) * n,
                decode_rows=int(rows.live.shape[0]),
                compaction_ratio=(len(live_ids)
                                  / max(int(rows.live.shape[0]), 1)))
            self._stage_spec_stats(g_iter, len(live_ids), st=stats)
            if self.trace_recorder is not None:
                self._stage_spans("decode_segment",
                                  self._decode_span_tags(live_ids, n),
                                  out=spans)
            flags = self._decode_flags(planned_active, g_iter, spec_lens, n)
            plan = _Plan(
                kind="decode", sel=[], activating=[], n_rounds=n,
                win=g_iter + 1, g_iter=g_iter, spec_lens=spec_lens,
                live_ids=live_ids, rows=rows,
                owners=[self._slots[int(s)] for s in live_ids], pf=None,
                flags=flags, stats=stats, spans=spans)
        if prof is not None:
            prof.mark("build")
        return plan

    def _launch_plan(self, plan: _Plan) -> None:
        """Patch the plan's data-dependent decode inputs from the
        just-committed ledger (a (rows,) re-gather of lengths, last
        tokens and table rows; rows whose slot died at the commit go
        dead), then launch it without waiting: the sync is the next
        step's `_commit_inflight`."""
        prof = self._profiler
        live_ids = plan.live_ids
        nl = len(live_ids)
        rows = plan.rows
        if nl and plan.n_rounds > 0:
            if rows.sl is None:
                # rows ARE slots: the ledger is the patch (dead slots
                # already carry sentinel tables and active=False)
                rows.live = self.active.copy()
                rows.lens = self.lengths
                rows.tables = self.tables
                rows.last = self.last_token
                rows.aid = self._aid
            else:
                for i in range(nl):
                    sid = int(live_ids[i])
                    rows.live[i] = (self._slots[sid] is plan.owners[i]
                                    and self.active[sid])
                    rows.lens[i] = self.lengths[sid]
                    rows.last[i] = self.last_token[sid]
                    rows.tables[i] = self.tables[sid]
            if plan.kind == "decode" and not rows.live[:nl].any():
                # every planned row died at the commit: drain instead of
                # launching an inert program
                return
        if plan.kind == "mixed":
            # the dispatch before this one has been committed, so the
            # plan's cursors are the committed ones
            self._handoff_prefetch(plan.sel)
            prog = self._launch(_mixed_step, plan.flags, self._mixed_staged(
                plan.pf, plan.flags, rows, plan.spec_lens))
        else:
            f = plan.flags
            staged = self._decode_staged(rows, plan.spec_lens,
                                         spec=plan.g_iter > 0,
                                         use_rows=f["rows"],
                                         grammar=f["grammar"],
                                         lora=f["lora"])
            prog = self._launch(_decode_rounds, f, staged)
        self._handoff_copy_out()
        t = (prof.mark("launch") if prof is not None
             else time.perf_counter())
        self._iter_launch_ts = t
        self._inflight = _Inflight(
            kind=plan.kind, program=prog, sel=plan.sel,
            activating=plan.activating, live_ids=live_ids,
            owners=plan.owners, n_rounds=plan.n_rounds, win=plan.win,
            g_iter=plan.g_iter, spec_lens=plan.spec_lens,
            stats=plan.stats, spans=plan.spans, t_launch=t)

    def _commit_inflight(self) -> None:
        """Wait on the in-flight dispatch's event and commit it: the
        serialized part of a pipelined step. The ledger writes, emits,
        speculation feedback, activations and deferred reaps run on the
        synced results, guarded per row by the owners captured at plan
        time."""
        infl, self._inflight = self._inflight, None
        t_wait = time.perf_counter()
        # analysis: allow[lock-discipline] THE sanctioned per-iteration
        # host sync: one launched program, one wait, under the step lock
        # that serializes the scheduler by design
        out = infl.program.wait()
        self._release_retired()
        prof = self._profiler
        if prof is not None:
            prof.mark("device")
        st = infl.stats
        st["overlap"] = True
        st["inflight_depth"] = 1
        # how long the card ran ahead of the host needing its results
        st["overlap_launch_lead_ms"] = (t_wait - infl.t_launch) * 1e3
        # installed before the commit: its speculation fields belong to
        # this record
        self._iter_stats = st
        self._iter_spans = infl.spans
        if infl.n_rounds > 0:
            self._commit_decode_out(infl.live_ids, out, infl.g_iter,
                                    infl.spec_lens, infl.n_rounds,
                                    owners=infl.owners)
        if infl.kind == "mixed":
            self._complete_admission_chunks(infl.sel, out["ptoks"],
                                            out["plps"])
        self._apply_reaps()
        if prof is not None:
            prof.mark("commit")

    def _release_retired(self) -> None:
        """After a wait: every program launched before it has run."""
        for held in self._retired:
            if isinstance(held, graphs.Program):
                held.release()
        self._retired.clear()

    def _overlap_sweep(self) -> None:
        """Sweep for a pipelined step: cancelled or deadline-expired slot
        holders are only MARKED (active=False, queued on `_reaped`) —
        the in-flight dispatch still writes their pages — and released
        by `_apply_reaps` right after the commit. Pending expiry is pure
        host state and runs as in the sequential sweep."""
        job_slots = {s for job in self._jobs for s in job.slots}
        marked = {sid for sid, _, _ in self._reaped}
        now = None
        for sid, slot in enumerate(self._slots):
            if slot is None or sid in job_slots or sid in marked:
                continue
            if slot.req._cancel.is_set():
                self.active[sid] = False
                self._reaped.append((sid, slot, "cancelled"))
                continue
            if slot.req.deadline is not None:
                if now is None:
                    now = time.perf_counter()
                if now > slot.req.deadline:
                    self.active[sid] = False
                    self._reaped.append((sid, slot, "deadline"))
        self._expire_pending(now)

    def _apply_reaps(self) -> None:
        """The deferred half of `_overlap_sweep`, after the commit: the
        marked slots' pages hold committed KV now, so they release
        through the content-keyed path and the requests complete."""
        if not self._reaped:
            return
        reaped, self._reaped = self._reaped, []
        for sid, slot, reason in reaped:
            if self._slots[sid] is not slot:
                continue  # already torn down (failure path)
            s = self._release_slot(sid, self._committed(sid))
            s.req.finish_reason = reason
            self._complete(s.req)

    def _step_overlap(self) -> int:
        """One pipelined iteration. With a dispatch in flight: plan N+1
        while the card runs N, then wait on and commit N, then launch
        N+1 — one launch and one sync per step. With nothing in flight
        (cold start, after a drain or a famine): the sequential
        iteration, then the pipeline is primed by planning and launching
        the next dispatch before returning. A profiler window that
        closes at this step's end first waits on the dispatch still in
        flight, so the trace holds its kernels."""
        with self._step_lock:
            self.tracer.step_start()
            try:
                if self._faults is not None:
                    self._faults.maybe_stall()
                    self._faults.maybe_wedge(self._stop)
                prof = self._profiler
                if prof is not None:
                    prof.begin()
                al = self.allocator
                al.telemetry.iteration = self.flight.iterations + 1
                c0 = (al.pages_allocated, al.pages_released, al.evictions)
                if self._inflight is None:
                    self._sweep_cancelled()
                    if prof is not None:
                        prof.mark("sweep")
                    self._start_admissions()
                    if prof is not None:
                        prof.mark("admission")
                    self._iter_stats = {}
                    p0 = self.preemptions
                    t0 = (prof.t0 if prof is not None
                          else time.perf_counter())
                    if self._jobs:
                        self._mixed_dispatch()
                    elif self.active.any():
                        self._decode_dispatch()
                    if self._jobs or self.active.any():
                        plan = self._plan_iteration()
                        if plan is not None:
                            self._launch_plan(plan)
                    self._record_iteration(t0, p0, c0)
                    if self._iter_stats:
                        self.last_busy_ts = self._iter_stats["ts"]
                    else:
                        self.idle_iterations += 1
                else:
                    self._overlap_sweep()
                    if prof is not None:
                        prof.mark("sweep")
                    self._start_admissions()
                    if prof is not None:
                        prof.mark("admission")
                    p0 = self.preemptions
                    t0 = (prof.t0 if prof is not None
                          else time.perf_counter())
                    if self._faults is not None:
                        # one hit a step (the fill path's site is inside
                        # its sequential dispatch), before the commit
                        self._faults.check("dispatch")
                    plan = self._plan_iteration()
                    self._commit_inflight()
                    if plan is not None:
                        self._launch_plan(plan)
                    self._record_iteration(t0, p0, c0)
                    self.last_busy_ts = self._iter_stats["ts"]
            except BaseException:
                # a failed step closes the window without waiting on the
                # card: the step's own error is the one that surfaces
                self.tracer.step_end()
                raise
            self.tracer.step_end(settle=self._settle_inflight)
            return self.num_active

    def _settle_inflight(self) -> None:
        """Wait until the dispatch in flight has run (a profiler
        window's close; never on the serving path)."""
        if self._inflight is not None:
            # analysis: allow[lock-discipline] the port's own wait: a
            # profiler window closing under the pipeline must hold the
            # dispatch's kernels; off the serving path, and under the step
            # lock so no launch slips in
            self._inflight.program.settle()

    # -- the scheduler loop -------------------------------------------------

    def _sweep_cancelled(self) -> None:
        """Reap cancelled and deadline-expired requests that hold a slot
        (not mid-admission: admission checks the cancel flag at
        activation), and expired pending requests. The clock is read
        only when a live request carries a deadline."""
        job_slots = {s for job in self._jobs for s in job.slots}
        now = None
        for sid, slot in enumerate(self._slots):
            if slot is None or sid in job_slots:
                continue
            if slot.req._cancel.is_set():
                slot = self._release_slot(sid, self._committed(sid))
                slot.req.finish_reason = "cancelled"
                self._complete(slot.req)
                continue
            if slot.req.deadline is not None:
                if now is None:
                    now = time.perf_counter()
                if now > slot.req.deadline:
                    slot = self._release_slot(sid, self._committed(sid))
                    slot.req.finish_reason = "deadline"
                    self._complete(slot.req)
        self._expire_pending(now)

    def _expire_pending(self, now: float | None) -> None:
        """Reap deadline-expired pending requests (pure host-queue state,
        safe with a dispatch in flight)."""
        with self._lock:
            expired = []
            if any(r.deadline is not None for r in self._pending):
                if now is None:
                    now = time.perf_counter()
                keep = collections.deque()
                for r in self._pending:
                    if r.deadline is not None and now > r.deadline:
                        expired.append(r)
                    else:
                        keep.append(r)
                self._pending = keep
            for r in expired:
                if self.qos is not None:
                    self.qos.on_pending_removed(r.tenant)
        for r in expired:
            r.finish_reason = "deadline"
            self._complete(r)

    def step(self) -> int:
        """One scheduler iteration: reap cancellations, start admissions,
        then dispatch — with the mixed scheduler, ONE program while any
        admission is in flight, else a multi-round decode program; with
        the alternating scheduler, each group's prefill-chunk program
        then a decode program. With overlap on (mixed scheduler, the
        default) the iteration is pipelined (`_step_overlap`).
        Thread-safe."""
        self._refuse_on_follower("step")
        self._refuse_after_release("step")
        ret = (self._step_overlap() if self._overlap_enabled
               else self._step_sequential())
        self._drain_handoff_ready()
        return ret

    def _drain_handoff_ready(self) -> None:
        """Fire the handoff callbacks of requests whose prefill completed
        in the last step: on the scheduler thread, after _step_lock is
        released (the callback's export takes it). Each fires at most
        once; a request that finished or was cancelled since is skipped.
        A callback's failure is the router's: the request keeps decoding
        here (the handoff is an optimization)."""
        # analysis: allow[lock-discipline] scheduler-thread-only list, as
        # in the reference: appended inside the step (under _step_lock)
        # and drained here on the SAME thread after the lock drops
        if not self._handoff_ready:
            return
        # analysis: allow[lock-discipline] the same scheduler-thread-only
        # swap as above
        ready, self._handoff_ready = self._handoff_ready, []
        for req in ready:
            h, req._handoff = req._handoff, None
            if h is None or req._done.is_set() or req._cancel.is_set():
                continue
            try:
                h(req)
            except Exception:  # noqa: BLE001 — see docstring
                pass

    def _step_sequential(self) -> int:
        """The sequential iteration (overlap off, or the alternating
        scheduler)."""
        with self._step_lock:
            self.tracer.step_start()
            try:
                if self._faults is not None:
                    # an injected host stall, and the wedge: it blocks
                    # holding _step_lock until stop() (the case of
                    # _fail_all's bounded acquire)
                    self._faults.maybe_stall()
                    self._faults.maybe_wedge(self._stop)
                prof = self._profiler
                if prof is not None:
                    prof.begin()
                al = self.allocator
                al.telemetry.iteration = self.flight.iterations + 1
                c0 = (al.pages_allocated, al.pages_released, al.evictions)
                self._sweep_cancelled()
                if prof is not None:
                    prof.mark("sweep")
                self._start_admissions()
                if prof is not None:
                    prof.mark("admission")
                self._iter_stats = {}
                p0 = self.preemptions
                t0 = prof.t0 if prof is not None else time.perf_counter()
                if self._mixed_enabled and self._jobs:
                    self._mixed_dispatch()
                else:
                    for job in list(self._jobs):
                        self._run_one_chunk(job)
                    if self.active.any():
                        self._decode_dispatch()
                self._record_iteration(t0, p0, c0)
                if self._iter_stats:
                    self.last_busy_ts = self._iter_stats["ts"]
                else:
                    self.idle_iterations += 1
                return self.num_active
            finally:
                self.tracer.step_end()

    def _stage_spans(self, name: str, items,
                     out: list | None = None) -> None:
        """One `name` span per (slot id, tags) of `items` whose request
        is traced, for this iteration's dispatch (stamped by
        _record_iteration). `out` overrides the destination (a planned
        iteration's spans)."""
        if out is None:
            out = self._iter_spans
        for sid, tags in items:
            s = self._slots[sid]
            if s is not None and s.req.trace is not None:
                out.append((s.req, name, {"slot": sid, **tags}))

    @staticmethod
    def _prefill_span_tags(sel) -> list:
        return [(job.slots[0], {"tokens": take, "offset": d0})
                for job, take, d0 in sel]

    @staticmethod
    def _decode_span_tags(live_ids, n_rounds: int) -> list:
        return [(int(sid), {"rounds": n_rounds}) for sid in live_ids]

    def _record_iteration(self, t0: float, p0: int,
                          c0: tuple[int, int, int]) -> None:
        """Flight-recorder epilogue of one busy iteration: the dispatch
        paths filled `_iter_stats` with their token split; this adds the
        budget, occupancy and pool fields and the phase split, and
        appends one record. Idle iterations record nothing. The spans the
        dispatch paths staged are stamped with the same (t0, now) frame
        and the record's flight index, and the brownout detector and the
        anomaly watchdog read this record's fields."""
        spans, self._iter_spans = self._iter_spans, []
        st = self._iter_stats
        if not st:
            return
        st["tokens_scheduled"] = (st.get("decode_tokens", 0)
                                  + st.get("prefill_tokens", 0))
        if st.get("scheduler") == "mixed":
            st["budget_tokens"] = self.mixed_token_budget
            st["budget_utilization"] = (st["tokens_scheduled"]
                                        / self.mixed_token_budget)
        # every preemption requeues its request at the queue front, so
        # this one field is both the preemption and the requeue count
        st["preemptions"] = self.preemptions - p0
        if self.qos is not None:
            # generated share over weighted entitlement (1.0 = fair)
            st["tenant_fair_share"] = {
                k: round(v, 4)
                for k, v in self.qos.fair_shares().items()}
        st["n_jobs"] = len(self._jobs)
        st["pending"] = self.num_pending
        al = self.allocator
        st["pages_allocated"] = al.pages_allocated - c0[0]
        st["pages_released"] = al.pages_released - c0[1]
        st["pages_evicted"] = al.evictions - c0[2]
        free, cached = len(al._free), len(al._evictable)
        st["pool_free"] = free
        st["pool_cached"] = cached
        st["pool_active"] = al.num_pages - free - cached
        frac = (free + cached) / max(al.num_pages, 1)
        st["pool_evictable_frac"] = frac
        self._cache_hists["evictable_frac"].observe(frac)
        mig_in, mig_out = self._migration.drain_flight_deltas()
        if mig_in or mig_out:
            st["migrated_in"] = mig_in
            st["migrated_out"] = mig_out
        prof = self._profiler
        if prof is not None:
            now = prof.mark("epilogue")
            phases = prof.phases_ms()
            st["t_start"] = t0
            st["phases_ms"] = phases
            st["duration_ms"] = (now - t0) * 1e3
            overlapped = bool(st.get("overlap"))
            st.update(derive_gap_fields(phases, st["duration_ms"],
                                        overlapped))
            hists = self._phase_hists
            if overlapped:
                # sweep/admission/build ran under the in-flight program:
                # they fold into the `overlap` series
                hists["overlap"].observe(
                    sum(phases.get(p, 0.0) for p in OVERLAP_PHASES))
                for p, v in phases.items():
                    if p not in OVERLAP_PHASES:
                        hists[p].observe(v)
            else:
                for p, v in phases.items():
                    hists[p].observe(v)
        else:
            now = time.perf_counter()
            st["duration_ms"] = (now - t0) * 1e3
        if self._iter_launch_ts is not None:
            # the launch-ahead made THIS step (the Perfetto inflight
            # track pairs it with the next record's device wait)
            st["t_launch"] = self._iter_launch_ts
            self._iter_launch_ts = None
        if self._brownout is not None:
            # the pending head's age is the queue-growth signal
            with self._lock:
                head = self._pending[0] if self._pending else None
                age = (0.0 if head is None or head.submit_time is None
                       else now - head.submit_time)
            st["brownout_level"] = self._brownout.observe(
                pending_age_s=age,
                budget_utilization=st.get("budget_utilization", 0.0),
                host_gap_frac=st.get("host_gap_frac", 0.0))
        if self._anomaly is not None:
            hb = self._anomaly_cache_base
            cur = (al.prefix_hit_pages, al.prefix_miss_pages)
            self._anomaly_cache_base = cur
            hit_d = cur[0] - hb[0]
            fired = self._anomaly.observe_iteration(
                now=now, host_gap_frac=st.get("host_gap_frac", 0.0),
                pending=st["pending"],
                preempt_delta=st["preemptions"],
                cache_lookup_delta=hit_d + (cur[1] - hb[1]),
                cache_hit_delta=hit_d,
                overload_level=st.get("brownout_level", 0))
            if fired:
                self._on_anomaly(fired)
        st["ts"] = time.time()
        self.flight.record(**st)
        if spans:
            idx = self.flight.iterations
            for req, name, tags in spans:
                req.trace.add_span(name, t0, now, iteration=idx, **tags)

    def run_until_idle(self) -> None:
        # analysis: allow[lock-discipline] idle-polling bool() of a
        # GIL-atomic list, as in the reference; step() below observes
        # the exact state
        while self.num_pending or self.num_active or self._jobs:
            self.step()

    # -- live migration -----------------------------------------------------

    def migrate_export(self, req: Request, *, reason: str = "failover",
                       evacuate: bool = True):
        """Snapshot one live (slot or pending) request for migration to
        another server (inference/migration.py), at the commit point:
        under _step_lock, with the dispatch in flight committed first,
        so the token stream, the KV watermark and the grammar position
        are exact. The chain's committed full pages ride along: gathered
        on the card, copied to pinned host memory, one event waited on
        (the export's one host sync).

        With `evacuate=True` (default) the request leaves this server
        with the snapshot: its slot releases content-keyed (the KV stays
        in the local prefix cache) and nobody completes the handle — the
        caller re-admits the snapshot elsewhere and mirrors the outcome.
        A request mid-admission (chunked prefill still running) raises
        RuntimeError."""
        self._refuse_tp("live migration (migrate_export)")
        led = self._migration
        led.record_export_start()
        try:
            if self._faults is not None:
                self._faults.check("migrate_export")
            with self._step_lock:
                if self._inflight is not None:
                    # its tokens belong to the stream being exported
                    self._commit_inflight()
                snap, sid, committed = self._export_request_locked(
                    req, reason)
                if evacuate:
                    self._evacuate_request_locked(req, sid, committed)
        except BaseException:
            led.record_export_failed()
            raise
        led.record_export_done(len(snap.tokens), snap.n_kv_pages())
        return snap

    def migrate_salvage(self, req: Request, *, reason: str = "failover"):
        """The failure path's export: a host-only snapshot (no pages —
        `_fail_all` released them unkeyed) built from the handle alone.
        The destination re-prefills prompt + tokens and resumes at the
        exact next token; the pages were only ever a prefill saving."""
        self._refuse_tp("live migration (migrate_salvage)")
        led = self._migration
        led.record_export_start()
        try:
            if self._faults is not None:
                self._faults.check("migrate_export")
            snap = self._build_snapshot(req, reason, (), None)
        except BaseException:
            led.record_export_failed()
            raise
        led.record_export_done(len(snap.tokens), 0)
        return snap

    def _build_snapshot(self, req: Request, reason: str, chain_tokens,
                        kv: dict | None):
        now = time.perf_counter()
        tr = req.trace
        return MigrationSnapshot(
            version=MIGRATION_VERSION, request_id=req.request_id,
            reason=reason, prompt=tuple(req.prompt),
            tokens=tuple(req.tokens), logprobs=tuple(req.logprobs),
            emit_times=tuple(req.emit_times), seed_used=req.seed_used,
            sampling=req.sampling, adapter=req.adapter, tenant=req.tenant,
            slo_class=req.slo_class, max_new_tokens=req.max_new_tokens,
            # the remainder: a deadline is a per-host monotonic stamp
            deadline_remaining_s=(None if req.deadline is None
                                  else req.deadline - now),
            trace_ctx=(None if tr is None
                       else (tr.trace_id, tr.root_span_id, True)),
            chain_tokens=tuple(chain_tokens), kv_pages=kv)

    def _pool_items(self) -> list:
        """(snapshot name, pool) of every page pool, the reference's
        names: k, v (and the int8 cache's k_scale, v_scale), then the
        draft model's under "draft/"."""
        m = self._model
        groups = [("", (m.k, m.v, m.k_scale, m.v_scale))]
        if m.draft is not None:
            groups.append(("draft/", m.draft[2]))
        return [(prefix + name, pool) for prefix, pools in groups
                for name, pool in zip(("k", "v", "k_scale", "v_scale"),
                                      pools)
                if pool is not None]

    def _index_on_device(self, ids) -> torch.Tensor:
        idx = torch.as_tensor(list(ids), dtype=torch.long)
        if self.device.type != "cuda":
            return idx
        # pinned, so the copy is asynchronous (a pageable one waits)
        return idx.pin_memory().to(self.device, non_blocking=True)

    def _host_pages(self, n: int) -> dict:
        """Host buffers of `n` pages of every pool, (L, n, ...) each in
        the pool's layout (pinned on CUDA)."""
        pin = self.device.type == "cuda"
        return {name: torch.empty((pool.shape[0], n) + pool.shape[2:],
                                  dtype=pool.dtype, pin_memory=pin)
                for name, pool in self._pool_items()}

    def _gather_pages(self, ids) -> list:
        """Pool pages `ids` of every pool (`_pool_items` order), gathered
        on the programs' stream, after every program that wrote them."""
        idx = self._index_on_device(ids)
        return [pool.index_select(1, idx) for _, pool in self._pool_items()]

    def _pages_out(self, gathered: list, bufs: dict, start: int,
                   stream=None, after=None):
        """Copy `_gather_pages`'s tensors into host buffers `bufs` at
        page `start`: on the current stream, or on a side `stream` that
        first waits on the event `after` (recorded after the gathers).
        Returns the event after the copies (None on the CPU, where they
        are done on return)."""
        names = [name for name, _ in self._pool_items()]
        if self.device.type != "cuda":
            for name, g in zip(names, gathered):
                bufs[name][:, start:start + g.shape[1]] = g
            return None
        cur = torch.cuda.current_stream(self.device)
        stream = cur if stream is None else stream
        if after is not None:
            stream.wait_event(after)
        with torch.cuda.stream(stream):
            for name, g in zip(names, gathered):
                buf, n = bufs[name], g.shape[1]
                if start == 0 and buf.shape[1] == n:
                    buf.copy_(g, non_blocking=True)
                else:  # a page range of each layer is contiguous
                    for layer in range(buf.shape[0]):
                        buf[layer, start:start + n].copy_(
                            g[layer], non_blocking=True)
                if stream is not cur:
                    g.record_stream(stream)
            event = torch.cuda.Event()
            event.record(stream)
        return event

    def _handoff_prefetch(self, sel) -> None:
        """Overlapped export for the disaggregated handoff, before the
        dispatch `sel` belongs to launches: for every selected admission
        that completes its prefill in it and carries a `handoff=`
        callback, gather the full pages earlier chunks wrote (every
        program that wrote them has been waited on). `_handoff_copy_out`
        starts their D2H copies once the dispatch is launched. Allocates
        and releases no page."""
        ps = self.page_size
        for job, take, d0 in sel:
            if d0 + take < int(job.rem_lens[0]):
                continue  # not the final chunk
            slot = self._slots[job.slots[0]]
            if slot is None or slot.req._handoff is None:
                continue
            n_full = (int(job.base_lens[0]) + d0) // ps
            if n_full <= 0 or slot.req.request_id in self._handoff_stash:
                continue
            ids = tuple(slot.pages[:n_full])
            gathered = self._gather_pages(ids)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
            # room for every page the chain can reach: the export copies
            # the rest in beside these
            cap = -(-(slot.stop_len + self.window) // ps)
            self._handoff_gathers.append(
                (slot.req.request_id, ids, cap, gathered, event))

    def _handoff_copy_out(self) -> None:
        """After the final chunk's launch: the prefetch's pinned host
        buffers (their allocation now runs beside the program) and the
        D2H copies on a side stream, under the program. The stash stays
        valid while its page ids are a prefix of the slot's chain."""
        pending, self._handoff_gathers = self._handoff_gathers, []
        for rid, ids, cap, gathered, event in pending:
            if self._copy_stream is None and self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self.device)
            bufs = self._host_pages(cap)
            done = self._pages_out(gathered, bufs, 0,
                                   stream=self._copy_stream, after=event)
            self._handoff_stash[rid] = (ids, bufs, done)

    def _export_request_locked(self, req: Request, reason: str):
        """Find `req` (slot or pending) and snapshot it. The caller holds
        _step_lock with no dispatch in flight. Returns (snapshot,
        slot id or None, committed tokens). The snapshot's `kv_pages`
        are host tensors in the reference's layout, (L, n, KH, Dh, ps)
        ((L, n, KH, ps) for scales), without the scratch page."""
        sid = next((i for i, s in enumerate(self._slots)
                    if s is not None and s.req is req), None)
        if sid is None:
            with self._lock:
                if req not in self._pending:
                    raise RuntimeError(
                        "request is not live on this server (already "
                        "finished, failed, or cancelled)")
            return self._build_snapshot(req, reason, (), None), None, []
        if any(sid in job.slots for job in self._jobs):
            raise RuntimeError(
                "request is mid-admission (chunked prefill in flight); "
                "not exportable until prefill completes")
        committed = self._committed(sid)
        ps = self.page_size
        n_full = len(committed) // ps
        kv = None
        stash = self._handoff_stash.pop(req.request_id, None)
        if n_full:
            page_ids = list(self._slots[sid].pages[:n_full])
            bufs, n_pre = None, 0
            if stash is not None:
                # the handoff prefetch: valid while its pages are still
                # a prefix of the chain (a preemption in between re-keys
                # them; then the whole chain is copied here)
                pre_ids, pre_bufs, pre_event = stash
                cap = next(iter(pre_bufs.values())).shape[1]
                if (list(pre_ids) == page_ids[:len(pre_ids)]
                        and n_full <= cap):
                    bufs, n_pre = pre_bufs, len(pre_ids)
                    if pre_event is not None:
                        # analysis: allow[lock-discipline] the export's
                        # wait on its own prefetch copy (the sanctioned
                        # sync's other half): at the commit point, off
                        # the plan path, under the step lock by design
                        pre_event.synchronize()
            if bufs is None:
                bufs = self._host_pages(n_full)
            self.handoff_prefetched_pages += n_pre
            if n_pre < n_full:
                event = self._pages_out(self._gather_pages(page_ids[n_pre:]),
                                        bufs, n_pre)
                if event is not None:
                    # analysis: allow[lock-discipline] the migration
                    # export's one sanctioned host sync, as in the
                    # reference: at the commit point, off the plan path
                    # (DD5), under the step lock by design
                    event.synchronize()
            kv = {name: buf[:, :n_full] for name, buf in bufs.items()}
        return (self._build_snapshot(req, reason, committed[:n_full * ps],
                                     kv), sid, committed)

    def _evacuate_request_locked(self, req: Request, sid: int | None,
                                 committed: list) -> None:
        """Remove the exported request from this server without
        completing it: the caller owns the handle now. A slot releases
        content-keyed (its KV stays reusable here). The source half of
        the trace closes with a `finish:migrated` event; the destination
        joins the same trace through the snapshot's context."""
        if sid is not None:
            if (self._slots[sid] is None
                    or self._slots[sid].req is not req):
                raise RuntimeError("slot changed under export")
            self._release_slot(sid, committed)
        else:
            with self._lock:
                try:
                    self._pending.remove(req)
                except ValueError:
                    raise RuntimeError(
                        "request left the pending queue during "
                        "export") from None
                if self.qos is not None:
                    self.qos.on_pending_removed(req.tenant)
        req.record_event("finish:migrated", time.perf_counter())
        if self.trace_recorder is not None and (
                req.trace is not None or req.tail_trace is not None):
            if req.trace is None:
                # the source half of a migrated tree always retains, so
                # a merged tree is never half missing
                req.tail_trace.annotate(migrated_out=True)
            self.trace_recorder.finish(req)

    def migrate_import(self, snap, *, stream=None, fail_handler=None,
                       trace_ctx: tuple | None = None,
                       deadline_s: float | None = None) -> Request:
        """Re-admit a migrated request on this server. The snapshot's
        pages are keyed into the pool under their radix chain keys
        (shared prefixes dedupe on arrival) and written into the pools
        in place (`_import_pages`, no host sync); the request then
        enters as a continuation (admission prompt = prompt + tokens),
        whose prefix walk re-hits those pages, and decodes from the
        exact next token. A failed or partial page import degrades to
        re-prefill: a cache miss, never a different token.

        Returns the new handle. Only new tokens are emitted on
        `stream`; the delivered ones are filled in beforehand."""
        self._refuse_tp("live migration (migrate_import)")
        led = self._migration
        led.record_import_start()
        try:
            if self._faults is not None:
                self._faults.check("migrate_import")
            if snap.version != MIGRATION_VERSION:
                raise ValueError(
                    f"migration snapshot version {snap.version} != "
                    f"{MIGRATION_VERSION}")
            if snap.remaining_new_tokens() <= 0:
                raise ValueError(
                    "snapshot has no decode budget left to resume")
            if snap.kv_pages:
                try:
                    self._import_pages(snap)
                except Exception:  # noqa: BLE001 — re-prefill instead
                    pass
            if deadline_s is None:
                deadline_s = snap.deadline_remaining_s
            req = self.submit(
                list(snap.prompt), max_new_tokens=snap.max_new_tokens,
                stream=stream, sampling=snap.sampling, adapter=snap.adapter,
                tenant=snap.tenant,
                trace_ctx=(snap.trace_ctx if trace_ctx is None
                           else trace_ctx),
                deadline_s=deadline_s, fail_handler=fail_handler,
                _migration=snap)
        except BaseException:
            led.record_import_failed()
            raise
        led.record_import_done()
        return req

    def _import_pages(self, snap) -> int:
        """Key the snapshot's pages into the pool and write them in
        place: pinned staging, non-blocking copies and an index_copy_ on
        the programs' stream, so the next program reads them and no host
        sync is made (the pinned staging is kept until an event after
        the copies has passed). Holds _step_lock across keying and
        writing (admissions, the only readers, run inside a step), with
        a bounded acquire: two servers draining into each other would
        otherwise deadlock, and a timeout only skips the transfer.
        Returns the pages written (0 = all deduped or skipped)."""
        n = snap.n_kv_pages()
        items = []
        for name, pool in self._pool_items():
            src = snap.kv_pages.get(name)
            if src is None:
                continue
            if not isinstance(src, torch.Tensor):  # e.g. numpy
                src = torch.tensor(np.asarray(src))
            # checked before any page is keyed: a page keyed but never
            # written would serve stale KV to a later prefix hit
            if (src.dtype != pool.dtype or src.shape[1] != n
                    or src.shape[:1] + src.shape[2:]
                    != pool.shape[:1] + pool.shape[2:]):
                raise ValueError(
                    f"snapshot pages {name!r} {src.dtype} "
                    f"{tuple(src.shape)} do not fit pool "
                    f"{pool.dtype} {tuple(pool.shape)}")
            items.append((pool, src))
        tenant = (self.qos.resolve(snap.tenant)
                  if self.qos is not None else None)
        if not self._step_lock.acquire(timeout=5.0):
            return 0
        try:
            fill = self.allocator.import_chain(list(snap.chain_tokens),
                                               namespace=snap.adapter or "",
                                               tenant=tenant)
            if not fill:
                return 0
            idxs = [i for i, _ in fill]
            dst = self._index_on_device(p for _, p in fill)
            staged: list = []
            for pool, src in items:
                pool.index_copy_(1, dst,
                                 self._pages_to_device(src, idxs, staged))
            if self.device.type == "cuda":
                self._import_holds = [
                    (e, t) for e, t in self._import_holds if not e.query()]
                event = torch.cuda.Event()
                event.record()
                self._import_holds.append((event, staged))
            return len(fill)
        finally:
            self._step_lock.release()

    def _pages_to_device(self, src: torch.Tensor, idxs: list,
                         staged: list) -> torch.Tensor:
        """Pages `idxs` of the host tensor `src` on the device, copied
        without a host sync: layer by layer straight from a pinned
        source when they are one run of pages (an export of this port),
        else gathered into pinned staging first. The pinned sources are
        appended to `staged`."""
        if self.device.type != "cuda":
            return src.index_select(1, torch.as_tensor(idxs))
        a, n = idxs[0], len(idxs)
        if src.is_pinned() and idxs == list(range(a, a + n)):
            out = torch.empty((src.shape[0], n) + tuple(src.shape[2:]),
                              dtype=src.dtype, device=self.device)
            for layer in range(src.shape[0]):
                out[layer].copy_(src[layer, a:a + n], non_blocking=True)
            staged.append(src)
            return out
        pinned = torch.empty((src.shape[0], n) + tuple(src.shape[2:]),
                             dtype=src.dtype, pin_memory=True)
        torch.index_select(src, 1, torch.as_tensor(idxs), out=pinned)
        staged.append(pinned)
        return pinned.to(self.device, non_blocking=True)

    def _evacuate(self, migrate) -> None:
        """drain(migrate=...)'s evacuation, under one _step_lock hold (no
        decode interleaves between a snapshot and its release, so no
        token is generated on two servers): snapshot every live slot and
        pending request and offer each to `migrate(snapshot, request)
        -> bool` (a router's import on a healthy replica). True: moved
        (released here, resumed there); False or an export failure:
        left in place for the normal drain. Requests mid-admission
        finish their prefill here."""
        led = self._migration
        with self._step_lock:
            if self._inflight is not None:
                self._commit_inflight()
            job_slots = {s for job in self._jobs for s in job.slots}
            for sid, slot in enumerate(self._slots):
                if slot is None or sid in job_slots:
                    continue
                req = slot.req
                if req._cancel.is_set() or req._done.is_set():
                    continue
                led.record_export_start()
                try:
                    if self._faults is not None:
                        self._faults.check("migrate_export")
                    snap, sid2, committed = self._export_request_locked(
                        req, "drain")
                except Exception:  # noqa: BLE001 — stays for the drain
                    led.record_export_failed()
                    continue
                if not migrate(snap, req):
                    led.record_export_failed()
                    continue
                self._evacuate_request_locked(req, sid2, committed)
                led.record_export_done(len(snap.tokens),
                                       snap.n_kv_pages())
            with self._lock:
                pend = list(self._pending)
            for req in pend:
                if req._cancel.is_set():
                    continue
                led.record_export_start()
                try:
                    if self._faults is not None:
                        self._faults.check("migrate_export")
                    snap = self._build_snapshot(req, "drain", (), None)
                except Exception:  # noqa: BLE001 — stays for the drain
                    led.record_export_failed()
                    continue
                if not migrate(snap, req):
                    led.record_export_failed()
                    continue
                try:
                    self._evacuate_request_locked(req, None, [])
                except RuntimeError:
                    # cancelled out of the queue mid-offer; the copy
                    # elsewhere completes or cancels on its own
                    led.record_export_failed()
                    continue
                led.record_export_done(len(snap.tokens), 0)

    def _fail_all(self, exc: BaseException) -> None:
        """Fail every pending and admitted request. The step lock is
        taken with a bound: a scheduler wedged inside a step keeps it,
        and failing everyone must unblock the waiters all the same, so
        after the timeout the teardown goes ahead unserialized (and is
        counted). Holding the lock, it first waits (with the same bound)
        on the dispatch in flight: the pools and staging buffers are
        reused in place, so no slot is torn down while the card may
        still write its pages. A wait that times out, or raises (a
        sticky device error raises again at every query), also makes
        the teardown unserialized: it is counted, the wait's error is
        reported on stderr, and every request fails with `exc`."""
        timeout = self._teardown_lock_timeout_s
        got = self._step_lock.acquire(timeout=timeout)
        settled = got
        try:
            if got and self._inflight is not None:
                try:
                    # analysis: allow[lock-discipline] the port's pools
                    # are written in place (the reference's are
                    # functional), so teardown must wait, bounded, on
                    # the dispatch in flight before freeing its pages
                    settled = self._inflight.program.settle(timeout)
                except Exception as err:  # noqa: BLE001 — see docstring
                    # analysis: allow[lock-discipline] one report on
                    # stderr of a failed wait, on the teardown path only
                    print(f"[server] waiting on the dispatch in flight "
                          f"failed: {err!r}", file=sys.stderr)
                    settled = False
            if not settled:
                self.unserialized_teardowns += 1
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
            self._handoff_gathers.clear()
            # drop the launched-but-uncommitted dispatch: its results
            # belong to requests that just failed (its program stays in
            # the cache, released only by stop() after a synchronize)
            self._inflight = None
            self._reaped.clear()
        finally:
            if got:
                self._step_lock.release()
        for req in pending:
            if self.qos is not None:
                self.qos.on_pending_removed(req.tenant)
            req.finish_reason = f"error: {exc!r}"
            self._complete(req)
        if not self._stop.is_set():
            # a failure, not stop(): the followers of a tensor-parallel
            # server raise out of follow() instead of waiting for a
            # dispatch that will not come (stop() releases them itself)
            self._tp_release("fail", repr(exc))

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
                # a pipelined step's sync may return at once: yield so
                # stream writers and result() waiters run
                time.sleep(0)
            # analysis: allow[lock-discipline] idle-polling read on the
            # scheduler's own thread, the only _jobs writer (as in the
            # reference)
            if busy == 0 and self.num_pending == 0 and not self._jobs:
                with self._work:
                    if not self._pending and not self._stop.is_set():
                        self._work.wait(idle_sleep_s)

    def start(self) -> "PagedInferenceServer":
        self._refuse_on_follower("start")
        self._refuse_after_release("start")
        self._stop.clear()
        with self._lock:
            self._draining = False
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True,
                                        name="paged-inference-server")
        self._thread.start()
        return self

    def drain(self, timeout: float | None = None, *, migrate=None,
              _resume_on_timeout: bool = True) -> bool:
        """Graceful drain: refuse new submissions and let everything
        already accepted run to completion. Returns True once idle and
        stays draining (resume() accepts again, stop() shuts down). On
        timeout returns False and accepts again, unless
        `_resume_on_timeout` is False (stop(drain=True), which must not
        accept a request only to fail it). `migrate`, a
        `migrate(snapshot, request) -> bool` callback (a router's drain
        makes one), turns the drain into an evacuation: every live
        request is offered to it first (`_evacuate`), and what it
        declines drains here."""
        if migrate is not None:
            self._refuse_tp("drain(migrate=...)")
        with self._lock:
            self._draining = True
        if migrate is not None:
            self._evacuate(migrate)
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        # analysis: allow[lock-discipline] idle-polling bool() of a
        # GIL-atomic list, as in the reference; drain only needs
        # eventual quiescence
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
        """Stop the scheduler thread, fail whatever is still live, and
        release the captured programs and their memory pool (they are
        captured again if the server serves again; a tensor-parallel
        server releases its followers and does not serve again)."""
        if drain and not self._stop.is_set():
            self.drain(timeout, _resume_on_timeout=False)
        self._stop.set()
        with self._lock:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        # analysis: allow[lock-discipline] post-join read, as in the
        # reference: the scheduler thread is dead (or never ran) here
        if self.num_pending or self.num_active or self._jobs:
            self._fail_all(RuntimeError(
                "server stopped before the request completed"))
        # the followers of a tensor-parallel server return from follow()
        self._tp_release("stop")
        got = self._step_lock.acquire(timeout=self._teardown_lock_timeout_s)
        if not got:
            return  # a scheduler wedged in a step keeps its programs
        try:
            self._inflight = None
            if self.device.type == "cuda":
                # analysis: allow[lock-discipline] the captured graphs'
                # memory is released below: the card must be done with
                # every replay first, and no launch may slip in between
                torch.cuda.synchronize(self.device)
            self._release_retired()
            self._programs.release()
        finally:
            self._step_lock.release()

    # -- tensor parallelism -------------------------------------------------

    def _refuse_tp(self, what: str) -> None:
        if self._tp is not None:
            raise _not_ported(f"{what} under tensor parallelism")

    def _refuse_on_follower(self, what: str) -> None:
        if self._tp_rank != 0:
            raise RuntimeError(
                f"{what}: rank {self._tp_rank} of a tensor-parallel server "
                "follows rank 0 (follow()); only rank 0 serves")

    def _refuse_after_release(self, what: str) -> None:
        """Rank 0: once the followers have left, nothing would mirror
        this rank's dispatches, so it refuses to serve (at once, instead
        of waiting on the group)."""
        with self._tp_send_lock:
            closed = self._tp_closed
        if closed is not None:
            raise _followers_left(what, closed)

    def _tp_queue(self, op: tuple) -> None:
        """Rank 0: queue a state change made outside a program for the
        followers; it rides with the next message."""
        if self._channel is not None and self._tp_rank == 0:
            with self._tp_send_lock:
                self._tp_outbox.append(op)

    def _mirror(self, msg: tuple, closing: str | None = None) -> None:
        """Rank 0: send the followers the state changes queued since the
        last message, then `msg`, as one message (timed). `closing` is
        the release's reason: after it, or after a send that failed, the
        followers are gone and a further message raises RuntimeError."""
        t0 = time.perf_counter()
        failed = None
        with self._tp_send_lock:
            if self._tp_closed is not None:
                raise _followers_left("a dispatch", self._tp_closed)
            ops, self._tp_outbox = self._tp_outbox + [msg], []
            try:
                # analysis: allow[lock-discipline] the dispatch broadcast
                # is a host round trip by design: the followers must have
                # the dispatch before rank 0 launches it (its collectives
                # wait for theirs), and the send lock orders the messages
                self._channel.send(ops)
            except RuntimeError as err:
                failed = err
            self._tp_last_send = time.perf_counter()
            self._tp_send_s.append(self._tp_last_send - t0)
            if failed is not None or closing is not None:
                self._tp_closed = (closing if failed is None else
                                   f"a send to them failed: {failed!r}")
                self._tp_left.set()
        if failed is not None:
            raise failed

    def _tp_keepalive_loop(self) -> None:
        """Rank 0's keepalive thread: a message whenever nothing went to
        the followers for the keepalive period, whether or not rank 0 steps
        (a server before start(), a caller between its own generate
        calls), so waiting followers stay inside the group's timeout.
        Ends when the followers leave."""
        while not self._tp_left.wait(self._tp_keepalive_s / 2):
            with self._tp_send_lock:
                due = (time.perf_counter() - self._tp_last_send
                       > self._tp_keepalive_s)
            if due:
                try:
                    self._mirror(("idle",))
                except RuntimeError:
                    return  # the followers left: rank 0 now refuses

    def _tp_release(self, kind: str, reason: str | None = None) -> None:
        """Rank 0: release the followers once — "stop" returns them from
        follow(), "fail" makes it raise; rank 0 then refuses to serve
        again (`_refuse_after_release`). The release is best effort: a
        send that fails (a follower already gone) is kept for
        `tp_stats`, and a follower left waiting times out on its
        group."""
        if self._channel is None or self._tp_rank != 0:
            return
        with self._tp_send_lock:
            if self._tp_closed is not None:
                return
        try:
            self._mirror((kind, reason), closing=(
                "stop()" if kind == "stop" else f"rank 0 failed: {reason}"))
        except RuntimeError as err:
            self._tp_release_error = repr(err)

    def follow(self) -> None:
        """A follower rank of a tensor-parallel server (tp group rank >
        0): launch every program rank 0 launches, on this rank's shard,
        until rank 0 stops (returns) or fails (raises RuntimeError). A
        message that does not come within the group's timeout (rank 0
        gone) raises too. Each launch is waited on before the next
        message is read, so a follower never runs ahead of rank 0."""
        if self._channel is None or self._tp_rank == 0:
            raise RuntimeError("follow() runs on the ranks other than rank "
                               "0 of a tensor-parallel server's tp group")
        try:
            while True:
                for op in self._channel.recv():
                    if op[0] == "stop":
                        return
                    # as on rank 0, programs and the state they read
                    # change under the step lock
                    with self._step_lock:
                        prog = self._follow_op(op)
                    if prog is not None:
                        prog.settle()
        finally:
            self._stop.set()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            with self._step_lock:
                self._programs.release()

    def _follow_op(self, op: tuple) -> graphs.Program | None:
        """A follower: apply one of rank 0's messages; a dispatch returns
        its launched program."""
        kind = op[0]
        if kind == "launch":
            _, name, flags, gen, staged = op
            if gen != self._grammar_gen:
                raise RuntimeError(f"grammar stack generation {gen} on rank "
                                   f"0, {self._grammar_gen} here")
            return self._run(_BODIES[name], flags, staged)
        if kind == "penalty":
            self._ensure_penalty_state()
        elif kind == "grammar":
            self._install_grammar(op[1], op[2])
        elif kind == "fail":
            raise RuntimeError(f"rank 0 of the tensor-parallel group "
                               f"failed: {op[1]}")
        return None  # "idle": rank 0's keepalive

    def tp_stats(self) -> dict | None:
        """Tensor parallelism: the group's size, this rank, the data
        collectives' backend, and on rank 0 the dispatch messages sent
        and their host time (median and p99, ms). None without tp."""
        if self._tp is None:
            return None
        out = {"tp": self._tp.size(), "rank": self._tp_rank,
               "backend": dist.get_backend(self._tp)}
        if self._tp_rank == 0:
            with self._tp_send_lock:
                ms = sorted(t * 1e3 for t in self._tp_send_s)
            out.update(release_error=self._tp_release_error,
                       messages=len(ms),
                       send_ms_p50=ms[len(ms) // 2] if ms else None,
                       send_ms_p99=(ms[min(len(ms) - 1, int(len(ms) * .99))]
                                    if ms else None))
        return out

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
                      # analysis: allow[lock-discipline] scrape-path len()
                      # of a GIL-atomic list, as in the reference; a gauge
                      # may lag the iteration that is mutating it
                      len(self._jobs))
        reg.counter("tokens_emitted_total",
                    "Lifetime generated tokens").set_total(
                        self.tokens_emitted)
        reg.counter("decode_rounds_total",
                    "Lifetime decode dispatch rounds").set_total(
                        self.decode_rounds)
        reg.counter("decode_tokens_committed_total",
                    "Lifetime tokens committed by decode rounds"
                    ).set_total(self.decode_tokens_committed)
        reg.counter("preemptions_total",
                    "Lifetime on-demand-paging preemptions").set_total(
                        self.preemptions)
        # idle vs dead: an idle scheduler keeps counting while the gauge
        # ages; a dead one freezes both
        reg.counter("idle_iterations_total",
                    "step() calls that dispatched nothing").set_total(
                        self.idle_iterations)
        reg.gauge("last_busy_ts",
                  "Unix time of the last busy iteration (0 until the "
                  "first)").set(self.last_busy_ts)
        reg.counter("spec_tokens_drafted_total",
                    "Draft tokens proposed on committing rows' behalf"
                    ).set_total(self.spec_tokens_drafted)
        reg.counter("spec_tokens_accepted_total",
                    "Draft tokens accepted and committed"
                    ).set_total(self.spec_tokens_accepted)
        rate = (self.spec_control.accept_rate()
                if self.spec_control is not None else
                self.spec_tokens_accepted
                / max(self.spec_tokens_drafted, 1))
        reg.gauge("spec_accept_rate",
                  "Rolling speculative accept rate (accepted/drafted "
                  "per committed round; lifetime ratio without the "
                  "adaptive controller)").set(rate)
        # the policy layer's families register whether or not it is
        # configured (zeros), so a dashboard sees them before an incident
        reg.counter("unserialized_teardown_total",
                    "_fail_all teardowns that proceeded after the "
                    "bounded _step_lock acquire timed out (slot state "
                    "torn down against a wedged scheduler)").set_total(
                        self.unserialized_teardowns)
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
        bstats = (self._brownout.stats() if self._brownout is not None
                  else None)
        reg.gauge("brownout_level",
                  "Current overload brownout level (0 healthy, "
                  "1 shedding best_effort, 2 shedding batch too)").set(
                      0 if bstats is None else bstats["level"])
        for cls in PRIORITY_CLASSES:
            reg.counter("brownout_shed_total",
                        "Admissions refused by overload brownout, per "
                        "priority class (429 with jittered "
                        "Retry-After)",
                        labels={"class": cls}).set_total(
                            0 if bstats is None
                            else bstats["shed_total"].get(cls, 0))
        mstats = self._migration.stats()
        reg.counter("migrations_started_total",
                    "Live-migration operations started (request "
                    "exports + imports; inference/migration.py)"
                    ).set_total(mstats["started"])
        reg.counter("migrations_completed_total",
                    "Live-migration operations completed (the "
                    "request left this replica with its state, or "
                    "resumed here at the exact next token)"
                    ).set_total(mstats["completed"])
        reg.counter("migrations_failed_total",
                    "Live-migration operations that failed — the "
                    "request fell back to fail-fast "
                    "(`retriable: false`) or to the normal drain "
                    "wait").set_total(mstats["failed"])
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
        reg.gauge("cache_namespaces",
                  "Distinct KV namespaces (base model + LoRA "
                  "adapters) that touched the prefix cache").set(
                      stats.namespaces)
        if self.qos is not None:
            # per-tenant cache attribution, labeled only where a
            # registry bounds the tenant set
            tstats = self.allocator.telemetry.tenant_stats()
            for name in set(self.qos.tenants()) | set(tstats):
                led = tstats.get(name, {})
                lbl = {"tenant": name}
                reg.counter(
                    "tenant_prefix_hit_tokens_total",
                    "Prompt tokens served from prefix-cache hits at "
                    "lookup, per tenant", labels=lbl).set_total(
                        led.get("hit_tokens", 0))
                reg.counter(
                    "tenant_prefix_miss_tokens_total",
                    "Prompt tokens the cache could not serve "
                    "(freshly prefilled, tail included), per tenant",
                    labels=lbl).set_total(
                        led.get("miss_tokens", 0))
                reg.counter(
                    "tenant_prefix_evicted_tokens_total",
                    "Token value of the tenant's cached chains "
                    "evicted under memory pressure", labels=lbl
                    ).set_total(
                        led.get("evicted_pages", 0) * self.page_size)
                reg.counter(
                    "tenant_prefix_saved_tokens_total",
                    "Prefill tokens the tenant actually skipped at "
                    "admission (realized savings; diverges from hit "
                    "tokens exactly when page-famine retries wasted "
                    "lookups)", labels=lbl).set_total(
                        led.get("saved_tokens", 0))
                reg.gauge(
                    "tenant_cache_pages_held",
                    "KV pages currently referenced by the tenant's "
                    "slots (shared pages count once per holder)",
                    labels=lbl).set(led.get("pages_held", 0))
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
        """Mergeable snapshot of every registered metric (the /metrics
        and /stats source)."""
        return self.metrics.registry.snapshot()

    def iteration_profile_stats(self) -> dict | None:
        """The /stats `iteration_profile` summary: per-phase
        count/mean/p50/p99 ms and the aggregate host-gap fraction, from
        the per-phase histograms. None with profiling disabled."""
        return profile_summary(self.metrics_snapshot())

    def speculation_stats(self) -> dict:
        """The /stats `speculation` summary, the reference's fields."""
        out = {
            "enabled": self.spec_drafts > 0,
            "source": ("off" if self.spec_drafts <= 0 else
                       "draft_model" if self.draft_cfg is not None
                       else "ngram"),
            "max_drafts": self.spec_drafts,
            "adaptive": self.spec_control is not None,
            "tokens_drafted": self.spec_tokens_drafted,
            "tokens_accepted": self.spec_tokens_accepted,
            "accept_rate": (self.spec_tokens_accepted
                            / max(self.spec_tokens_drafted, 1)),
        }
        if self.spec_control is not None:
            out["rolling_accept_rate"] = self.spec_control.accept_rate()
            out["draft_lens"] = {
                str(k): v
                for k, v in self.spec_control.draft_lengths().items()}
        return out

    def cache_stats(self) -> dict:
        """The /stats `cache` block and GET /debug/cache: pool occupancy,
        lifetime prefix hit/miss/eviction counts with the page hit rate,
        the per-tenant attribution table, the hot-prefix sketch and the
        eviction forensics. Scrape path only (lock-free monitoring
        reads, as `prefix_cache_stats`)."""
        s = self.allocator.stats()
        tel = self.allocator.telemetry
        tstats = tel.tenant_stats()
        # full-page hit/miss from the ledger (the allocator's walk
        # counter records one miss per walk), from the SAME snapshot as
        # the tenants table
        hit_pages = sum(led["hit_pages"] for led in tstats.values())
        miss_pages = sum(led["miss_pages"] for led in tstats.values())
        return {
            "pool": {
                "pages_total": s.pages_total,
                "pages_free": s.pages_free,
                "pages_cached": s.pages_cached,
                "pages_active": s.pages_active,
                "evictable_frac": ((s.pages_free + s.pages_cached)
                                   / max(s.pages_total, 1)),
            },
            "prefix": {
                "hit_pages": hit_pages,
                "miss_pages": miss_pages,
                "hit_tokens": s.hits_tokens,
                "evictions": s.evictions,
                "hit_rate": hit_rate(hit_pages, miss_pages),
            },
            "namespaces": s.namespaces,
            "tenants": tstats,
            "top_prefixes": tel.top_prefixes(),
            "recent_evictions": tel.recent_evictions(64),
            "eviction_matrix": tel.eviction_matrix(),
        }

    def overlap_stats(self) -> dict:
        """The /stats `overlap` block: the knob's resolved state and the
        live pipeline depth. Scrape path only."""
        return {"enabled": self.overlap, "active": self._overlap_enabled,
                # analysis: allow[lock-discipline] racy-by-design
                # monitoring read, as in the reference; stale by at most
                # one iteration
                "inflight_depth": 0 if self._inflight is None else 1}

    def brownout_stats(self) -> dict | None:
        """The /stats `brownout` block; None without brownout."""
        return None if self._brownout is None else self._brownout.stats()

    def fault_stats(self) -> dict | None:
        """Per-site injected-fault hit/fired counts (the /stats `faults`
        block); None without a FaultPlan."""
        return None if self._faults is None else self._faults.stats()

    def migration_stats(self) -> dict:
        """The migration ledger's counts of this server's exports,
        salvages and imports (the /stats `migration` block)."""
        return self._migration.stats()

    def lookup_trace(self, request_id: str) -> dict | None:
        """The span tree of one traced request id (live or retained),
        else None."""
        rec = self.trace_recorder
        return None if rec is None else rec.lookup(request_id)

    def trace_trees(self, n: int | None = None) -> list[dict]:
        """Span trees of the finished ring and the live requests (the
        /traces export)."""
        rec = self.trace_recorder
        return [] if rec is None else rec.trees(n)

    def tail_trace_trees(self, n: int | None = None) -> list[dict]:
        """Span trees of the tail-retained ring; empty without one."""
        rec = self.trace_recorder
        return ([] if rec is None or rec.tail_capacity <= 0
                else rec.tail_trees(n))

    def tail_trace_stats(self) -> dict | None:
        """The /stats `tail_retention` block; None without a tail
        ring."""
        rec = self.trace_recorder
        return (None if rec is None or rec.tail_capacity <= 0
                else rec.tail_stats())

    def slo_report(self) -> dict | None:
        """Per-class SLO attainment and burn rates (GET /slo); None
        without an SLO config."""
        return None if self.slo is None else self.slo.report()

    def anomaly_stats(self) -> dict | None:
        """The /stats `anomaly` block; None without a watchdog."""
        return None if self._anomaly is None else self._anomaly.stats()

    def anomaly_events(self, n: int | None = None) -> list[dict]:
        """Watchdog events (the /traces marker track); empty without a
        watchdog."""
        return [] if self._anomaly is None else self._anomaly.events(n)

    def request_trace(self, n_steps: int,
                      logdir: str | os.PathLike) -> None:
        """Arm POST /debug/trace: the next `n_steps` scheduler
        iterations run inside utils.tracing.capture_trace(logdir)."""
        self.tracer.request(n_steps, logdir)

    def _on_anomaly(self, fired) -> None:
        """A rule's activation edge: snapshot a debug bundle into the
        bounded ring (`bundle_on_anomaly`) and arm the profiler window
        when the watchdog's config asks for one. Forensics never take
        the scheduler down: a bundle that fails, or a window already
        armed, is skipped."""
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
        """One forensic artifact (GET /debug/bundle): metrics, the
        flight window, span trees, cache, brownout, migration, SLO,
        fault and anomaly state as one JSON-ready dict; `n` bounds the
        ring exports."""
        return {
            "schema": "cloud_server.debug_bundle/v1",
            "trigger": trigger,
            "ts": time.time(),
            "anomaly": self.anomaly_stats(),
            "metrics": self.metrics_snapshot(),
            "profile": self.iteration_profile_stats(),
            "flight": self.flight_window(n),
            "traces": self.trace_trees(n),
            "tail_traces": self.tail_trace_trees(n),
            "tail_retention": self.tail_trace_stats(),
            "slo": self.slo_report(),
            "cache": self.cache_stats(),
            "brownout": self.brownout_stats(),
            "migration": self.migration_stats(),
            "faults": self.fault_stats(),
            "overlap": self.overlap_stats(),
        }

    def debug_bundles(self, n: int | None = None) -> list[dict]:
        """The ring of auto-captured bundles (oldest first; `n` bounds
        from the newest end, n <= 0 means none)."""
        if n is not None and n <= 0:
            return []
        bundles = list(self._bundles)
        return bundles if n is None else bundles[-n:]

    def flight_window(self, n: int | None = None) -> list[dict]:
        """The last `n` (default: all retained) flight-recorder records,
        oldest first."""
        return self.flight.window(n)


def _params_on(params, device):
    """The parameter tree on `device` (QTensor leaves move payload and
    scales together)."""
    from cloud_server_tpu_torch.models.quantization import params_to
    return params_to(params, device)
