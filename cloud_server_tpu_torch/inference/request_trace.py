"""Per-request distributed tracing: span trees across the serving fleet.

PR 3's histograms say a deployment's p99 TTFT regressed; they cannot
say where ONE slow request's time went — queue? a preemption gap? a
starved prefill chunk? a slow decode segment on one replica? This
module is the Dapper-style answer (Sigelman et al., 2010): every
sampled request carries a span tree covering its whole lifecycle,
stitched across the router/replica boundary by W3C trace context, and
cross-linked to the scheduler flight recorder by iteration index so a
slow span answers "what else was the scheduler doing right then" in
one hop.

Design rules (the same ones the metrics layer lives by):

  * **Zero new device work.** Every span timestamp is a host moment
    the scheduler already owns — `Request.events`, `emit_times`, and
    the per-iteration `t0`/`now` pair the flight recorder already
    reads. Recording a span is one list append; the tree itself is
    built lazily on the READ path (`/debug/requests/<id>`), never the
    serving path. A copy of the reference's `inference/request_trace.py`;
    the port's tests hold a server tracing at 100% sampling to one
    that does not trace.
  * **Head-based sampling.** The sample decision is made once at
    submit, deterministically from the trace id, so every replica of
    a fleet (and every retry of a client) agrees without
    coordination. An incoming `traceparent` header's sampled flag
    overrides the local rate in either direction (parent-based
    sampling, the W3C convention).
  * **One tree per request, preemption included.** A preempted
    request's tree keeps its identity across requeue/re-admission:
    the gap shows as an explicit `preempt_gap` phase and the phases
    stay contiguous (gap-free) from submit to finish.

Span taxonomy. Phase spans are DERIVED from the lifecycle event trail
(they partition submit → finish with no gaps):

    request                      the root span (whole lifecycle)
      queue                      submit → first admission
      prefill                    admission → (resumed) first token
      decode                     tokens streaming out
      preempt_gap                preempt-requeue → re-admission
      emit                       last token surfaced → finish

The paged scheduler additionally RECORDS iteration-granular spans
(`prefill_chunk`, `decode_segment`), each tagged with the flight
recorder iteration index, slot, and token counts; the router records
`router_pick` (tagged with the replica index) so a fleet-routed
request yields one tree spanning pick → replica execution.

Exports: `GET /debug/requests/<id>` returns one tree as JSON;
`GET /traces` renders the sampled ring in the Chrome trace event
format (load into Perfetto / chrome://tracing); `traceparent` headers
propagate in and out of the HTTP front-end.
"""

from __future__ import annotations

import collections
import threading
import uuid

# The contiguous, gap-free lifecycle phases `request_phases` derives.
PHASES = ("queue", "prefill", "decode", "preempt_gap", "migrate_gap",
          "emit")

TRACEPARENT_HEADER = "traceparent"
_FLAG_SAMPLED = 0x01


def new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 lowercase hex chars (16 bytes)


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]  # 8 bytes


def parse_traceparent(header) -> tuple[str, str, bool] | None:
    """W3C `traceparent` -> (trace_id, parent_span_id, sampled), or
    None for anything malformed (a bad header must degrade to "start a
    fresh trace", never to a 500)."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    ver, tid, pid, flags = parts[0], parts[1], parts[2], parts[3]
    if len(ver) != 2 or len(tid) != 32 or len(pid) != 16 or len(flags) < 2:
        return None
    try:
        int(ver, 16)
        int(tid, 16)
        int(pid, 16)
        fl = int(flags[:2], 16)
    except ValueError:
        return None
    if ver.lower() == "ff" or tid == "0" * 32 or pid == "0" * 16:
        return None  # invalid per spec
    return tid.lower(), pid.lower(), bool(fl & _FLAG_SAMPLED)


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


class RequestTrace:
    """Per-request trace state: identity (trace id, root span id, the
    remote parent span when the request arrived with a `traceparent`)
    plus the explicitly recorded spans (iteration-granular scheduler
    spans, router_pick). Phase spans are NOT stored — they derive from
    the request's own event trail at read time, so the serving path
    pays nothing for them."""

    __slots__ = ("trace_id", "root_span_id", "parent_span_id",
                 "request_id", "tags", "spans")

    def __init__(self, request_id: str, trace_id: str | None = None,
                 parent_span_id: str | None = None):
        self.trace_id = trace_id or new_trace_id()
        self.root_span_id = new_span_id()
        self.parent_span_id = parent_span_id
        self.request_id = request_id
        self.tags: dict = {}
        self.spans: list[dict] = []

    def add_span(self, name: str, start: float, end: float,
                 **tags) -> None:
        """Record one finished span (O(1) append; no clocks are read
        here, callers pass host moments they already had)."""
        self.spans.append({"name": name, "start": start, "end": end,
                           "tags": tags})

    def annotate(self, **tags) -> None:
        """Attach tags to the root span (replica index, tenant)."""
        self.tags.update(tags)


def request_phases(req) -> list[dict]:
    """Contiguous lifecycle phase spans derived from `req.timeline()`
    and `req.emit_times`: queue / prefill / decode / preempt_gap /
    emit, partitioning submit → finish with no gaps (each phase starts
    exactly where the previous one ends). A still-in-flight request's
    last phase has `end: None`.

    Preemption continuity: first_token is only evented once, so the
    prefill → decode boundary after a re-admission is the first emit
    timestamp following that admission (the continuation's resume
    token surfaces at activation)."""
    events = req.timeline()
    emits = list(req.emit_times)
    if not events:
        return []

    def first_emit_in(lo: float, hi: float) -> float | None:
        for e in emits:
            if lo < e <= hi:
                return e
        return None

    phases: list[tuple[str, float, float | None]] = []
    cur: str | None = None
    t_prev = events[0][1]
    for name, t in events:
        if name == "submit":
            cur, t_prev = "queue", t
        elif name == "admit":
            if cur is not None:
                phases.append((cur, t_prev, t))
            cur, t_prev = "prefill", t
        elif name == "first_token":
            if cur == "prefill":
                phases.append(("prefill", t_prev, t))
                cur, t_prev = "decode", t
        elif name == "preempt_requeue":
            if cur == "prefill":
                e = first_emit_in(t_prev, t)
                if e is not None:
                    phases.append(("prefill", t_prev, e))
                    phases.append(("decode", e, t))
                else:
                    phases.append(("prefill", t_prev, t))
            elif cur is not None:
                phases.append((cur, t_prev, t))
            cur, t_prev = "preempt_gap", t
        elif name.startswith("finish:"):
            if cur == "prefill":
                # a re-admitted continuation may finish without a new
                # first_token event: its resume emit is the boundary
                e = first_emit_in(t_prev, t)
                if e is not None:
                    phases.append(("prefill", t_prev, e))
                    cur, t_prev = "decode", e
            if cur == "decode" and emits and t_prev <= emits[-1] <= t:
                phases.append(("decode", t_prev, emits[-1]))
                cur, t_prev = "emit", emits[-1]
            if cur is not None:
                phases.append((cur, t_prev, t))
            cur = None
    if cur is not None:  # in flight: last phase still open
        phases.append((cur, t_prev, None))
    return [{"name": n, "start": a, "end": b} for n, a, b in phases]


class _FinishedTrace:
    """What the ring retains for a COMPLETED request: the trace, the
    (now final) event trail and emit timestamps, and the few scalar
    tags the tree needs — NOT the Request itself, whose prompt /
    token / logprob lists would otherwise keep up to capacity x
    max_context of dead state alive purely for trace export. The
    trace object is shared by reference, so iteration spans stamped
    at the end of the finishing step still land in the tree.
    `trace` overrides which trace the snapshot exports (the tail ring
    passes the provisional `req.tail_trace`)."""

    __slots__ = ("request_id", "trace", "submit_time", "tenant",
                 "finish_reason", "num_tokens", "_events",
                 "emit_times")

    def __init__(self, req, trace=None):
        self.request_id = req.request_id
        self.trace = trace if trace is not None else req.trace
        self.submit_time = req.submit_time
        self.tenant = req.tenant
        self.finish_reason = req.finish_reason
        self.num_tokens = len(req.tokens)
        self._events = req.timeline()
        self.emit_times = req.emit_times  # append-complete at finish

    def timeline(self):
        return list(self._events)


def any_trace(req):
    """The request's head-sampled trace, else its provisional tail
    trace, else None — annotation sites (router failover/handoff
    tagging) must tag whichever tree may eventually be retained."""
    tr = getattr(req, "trace", None)
    return tr if tr is not None else getattr(req, "tail_trace", None)


def continuation_ctx(req) -> tuple[str, str, bool] | None:
    """The (trace_id, parent_span_id, sampled) context a failover /
    handoff continuation submits with so it rejoins the original's
    trace: the head-sampled trace when present (sampled=True, the
    existing contract), else the provisional tail trace with
    sampled=False — the continuation stays head-unsampled but keeps
    the SHARED trace id, so when both halves tail-retain they merge
    into one spanning tree (`merge_handoff_trees` keys on it)."""
    tr = getattr(req, "trace", None)
    if tr is not None:
        return (tr.trace_id, tr.root_span_id, True)
    tr = getattr(req, "tail_trace", None)
    if tr is not None:
        return (tr.trace_id, tr.root_span_id, False)
    return None


def build_tree(req) -> dict | None:
    """The request's span tree as a plain JSON-ready dict (the
    `/debug/requests/<id>` payload) — `req` is a live Request or the
    ring's _FinishedTrace snapshot. None for unsampled requests.
    Recorded scheduler spans nest under the phase whose window
    contains their start; spans that precede submit (router_pick)
    attach directly to the root."""
    tr = getattr(req, "trace", None)
    if tr is None:
        return None
    events = req.timeline()
    start = (req.submit_time if req.submit_time is not None
             else (events[0][1] if events else 0.0))
    end = (events[-1][1]
           if events and events[-1][0].startswith("finish:") else None)
    phases = [dict(p, children=[]) for p in request_phases(req)]

    def owner(ts: float):
        for ph in phases:
            if ts >= ph["start"] and (ph["end"] is None
                                      or ts < ph["end"]):
                return ph
        return None

    loose: list[dict] = []
    for s in sorted(tr.spans, key=lambda s: s["start"]):
        ph = owner(s["start"])
        (ph["children"] if ph is not None else loose).append(dict(s))
    tags = dict(tr.tags)
    if req.tenant is not None:
        tags.setdefault("tenant", req.tenant)
    if req.finish_reason is not None:
        tags["finish_reason"] = req.finish_reason
    n_tok = getattr(req, "num_tokens", None)
    tags["tokens"] = len(req.tokens) if n_tok is None else n_tok
    return {
        "trace_id": tr.trace_id,
        "request_id": req.request_id,
        "root_span_id": tr.root_span_id,
        "parent_span_id": tr.parent_span_id,
        "root": {"name": "request", "start": start, "end": end,
                 "tags": tags, "children": loose + phases},
    }


# Tail-retention reasons, in decision-priority order: the first
# matching clause names the retention (`tail_retained_total{reason=}`
# label values and the docs predicate table key off this tuple).
TAIL_REASONS = ("failed", "deadline", "cancelled", "migrated", "slo",
                "preempt", "anomaly")


class TraceRecorder:
    """Head-sampled per-request trace store: a dict of in-flight
    sampled requests plus a bounded ring of finished ones (oldest
    evicted). Both servers consult it at submit (`begin`) and at
    request completion (`finish`); everything else — lookup, the ring
    export — runs on the read path.

    Tail-based retention (`tail_capacity` > 0): every head-UNSAMPLED
    request still gets a provisional lightweight trace (identity +
    tags only — the schedulers skip iteration-span recording for it,
    so the provisional cost is one small object at submit). At finish
    the provisional tree is RETAINED into a separate bounded tail
    ring iff the request proved anomalous: it failed / deadline-
    expired / was cancelled, was migrated / retried / handed off,
    missed its class SLO target, was preempted >= `tail_preempt_min`
    times, or finished inside an open anomaly window. The decision
    reads only request-terminal state and static config, so every
    replica holding a segment of the same merged tree reaches the
    same verdict (router-merged handoff trees stay whole)."""

    def __init__(self, sample_rate: float = 1.0, capacity: int = 256,
                 tail_capacity: int = 0, tail_preempt_min: int = 2):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError("trace sample_rate must be in [0, 1]")
        if capacity <= 0:
            raise ValueError("trace ring capacity must be positive")
        if tail_capacity < 0:
            raise ValueError("trace tail_capacity must be >= 0")
        if tail_preempt_min <= 0:
            raise ValueError("trace tail_preempt_min must be positive")
        self.sample_rate = float(sample_rate)
        self.capacity = int(capacity)
        self.tail_capacity = int(tail_capacity)
        self.tail_preempt_min = int(tail_preempt_min)
        self._lock = threading.Lock()
        self._live: dict[str, object] = {}          # request_id -> Request
        self._ring: collections.deque = collections.deque()
        self._index: dict[str, object] = {}         # ring members by id
        self._tail_ring: collections.deque = collections.deque()
        self._tail_index: dict[str, object] = {}
        self.sampled_total = 0
        self.evicted_total = 0
        self.tail_retained: dict[str, int] = {r: 0 for r in TAIL_REASONS}
        self.tail_evicted_total = 0

    def should_sample(self, trace_id: str) -> bool:
        """Deterministic head decision from the trace id: every holder
        of the same id (other replicas, the retrying client) reaches
        the same verdict with no coordination."""
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        return int(trace_id[:8], 16) < self.sample_rate * 0x100000000

    def begin(self, req, ctx: tuple[str, str, bool] | None = None):
        """Open a trace for a freshly submitted request. `ctx` is a
        parsed incoming traceparent (trace_id, parent_span_id,
        sampled); its sampled flag is authoritative when present
        (parent-based sampling) — without a context the local head
        rate decides. Sets `req.trace` and returns it (None when the
        request is not sampled)."""
        if ctx is not None:
            trace_id, parent_id, sampled = ctx
        else:
            trace_id, parent_id, sampled = new_trace_id(), None, None
        if sampled is None:
            sampled = self.should_sample(trace_id)
        if not sampled:
            if self.tail_capacity > 0:
                # provisional lightweight tree: identity only; the
                # schedulers see req.trace is None and record no
                # iteration spans, so the hot path pays one object
                req.tail_trace = RequestTrace(req.request_id, trace_id,
                                              parent_id)
            return None
        tr = RequestTrace(req.request_id, trace_id, parent_id)
        req.trace = tr
        with self._lock:
            self._live[req.request_id] = req
            self.sampled_total += 1
        return tr

    def _tail_reason(self, req, tr, slo_violated: bool,
                     in_anomaly: bool) -> str | None:
        """First matching TAIL_REASONS clause, else None (drop). All
        inputs are request-terminal state / static config — the same
        verdict on every replica holding this tree's segments."""
        fr = getattr(req, "finish_reason", None) or ""
        if fr.startswith("error"):
            return "failed"
        if fr in ("deadline", "cancelled", "migrated"):
            return fr
        tags = tr.tags
        if ("handoff_of" in tags or "migrate_of" in tags
                or "retry_of" in tags or "migrated_out" in tags):
            return "migrated"
        if slo_violated:
            return "slo"
        n_pre = 0
        for name, _ts in req.timeline():
            if name == "preempt_requeue":
                n_pre += 1
        if n_pre >= self.tail_preempt_min:
            return "preempt"
        if in_anomaly:
            return "anomaly"
        return None

    def finish(self, req, *, slo_violated: bool = False,
               in_anomaly: bool = False) -> None:
        """Move a completed sampled request from the live set into the
        ring (evicting the oldest past capacity). The ring keeps a
        slim _FinishedTrace snapshot, not the Request — the prompt /
        token / logprob lists are released with the request.

        A head-UNSAMPLED request with a provisional tail trace is
        instead judged by the tail-retention predicate: retained into
        the tail ring (exactly once — a racing duplicate finish is
        dropped) or forgotten. `slo_violated` / `in_anomaly` are the
        caller-supplied clauses the recorder cannot derive itself."""
        if getattr(req, "trace", None) is not None:
            done = _FinishedTrace(req)
            with self._lock:
                self._live.pop(req.request_id, None)
                self._ring.append(done)
                self._index[req.request_id] = done
                while len(self._ring) > self.capacity:
                    old = self._ring.popleft()
                    self._index.pop(old.request_id, None)
                    self.evicted_total += 1
            return
        if self.tail_capacity <= 0:
            return
        tr = getattr(req, "tail_trace", None)
        if tr is None:
            return
        reason = self._tail_reason(req, tr, slo_violated, in_anomaly)
        if reason is None:
            return
        tr.annotate(tail_retained=reason)
        done = _FinishedTrace(req, trace=tr)
        with self._lock:
            if req.request_id in self._tail_index:
                return  # concurrent duplicate finish: retain once
            self._tail_ring.append(done)
            self._tail_index[req.request_id] = done
            self.tail_retained[reason] = (
                self.tail_retained.get(reason, 0) + 1)
            while len(self._tail_ring) > self.tail_capacity:
                old = self._tail_ring.popleft()
                self._tail_index.pop(old.request_id, None)
                self.tail_evicted_total += 1

    def lookup(self, request_id: str) -> dict | None:
        """Span tree for one request id (live, head-retained, or
        tail-retained), else None."""
        with self._lock:
            req = (self._live.get(request_id)
                   or self._index.get(request_id)
                   or self._tail_index.get(request_id))
        return None if req is None else build_tree(req)

    def trees(self, n: int | None = None) -> list[dict]:
        """Span trees of the retained ring plus live requests (oldest
        first; `n` bounds from the newest end — n <= 0 means "no
        trees", never "everything", matching /stats' flight-window
        rule)."""
        if n is not None and n <= 0:
            return []
        with self._lock:
            reqs = list(self._ring) + list(self._live.values())
        trees = [t for t in (build_tree(r) for r in reqs)
                 if t is not None]
        trees.sort(key=lambda t: t["root"]["start"])
        return trees if n is None else trees[-n:]

    def tail_trees(self, n: int | None = None) -> list[dict]:
        """Span trees of the tail-retained ring (oldest first; `n`
        bounds from the newest end, n <= 0 means none — the `trees`
        contract)."""
        if n is not None and n <= 0:
            return []
        with self._lock:
            reqs = list(self._tail_ring)
        trees = [t for t in (build_tree(r) for r in reqs)
                 if t is not None]
        trees.sort(key=lambda t: t["root"]["start"])
        return trees if n is None else trees[-n:]

    def tail_stats(self) -> dict:
        """The /stats tail-retention block (scrape path)."""
        with self._lock:
            return {"capacity": self.tail_capacity,
                    "retained": len(self._tail_ring),
                    "retained_total": dict(self.tail_retained),
                    "evicted_total": self.tail_evicted_total}


def chrome_trace(trees: list[dict],
                 anomalies: list[dict] | None = None) -> dict:
    """Render span trees as Chrome trace event format JSON
    (chrome://tracing / Perfetto `ui.perfetto.dev`): one complete
    ("X") event per span, processes = replicas, threads = requests.
    Timestamps are microseconds on the servers' perf_counter
    timebase — relative durations and alignment are what matter.
    `anomalies` (watchdog event dicts: rule/start/end/details,
    optionally replica) render as marker events on a dedicated
    per-replica "anomalies" track, so an open incident window lines
    up against the request spans it covers."""
    events: list[dict] = []
    for tree in trees:
        root = tree["root"]
        pid = int(root["tags"].get("replica", 0))
        tid = int(tree["request_id"][:8], 16) & 0x7FFFFFFF
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid,
                       "args": {"name": f"req {tree['request_id']}"}})

        def emit(span: dict, name: str | None = None) -> None:
            end = span.get("end")
            start = span["start"]
            args = dict(span.get("tags", {}))
            if end is None:
                end = start
                args["open"] = True
            events.append({
                "ph": "X", "name": name or span["name"],
                "ts": start * 1e6, "dur": max(end - start, 0.0) * 1e6,
                "pid": pid, "tid": tid, "args": args})
            for child in span.get("children", ()):
                emit(child)

        emit(root, name=f"request {tree['request_id']}")

    marker_pids: set[int] = set()
    for ev in anomalies or ():
        pid = int(ev.get("replica", 0))
        if pid not in marker_pids:
            marker_pids.add(pid)
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": 0,
                           "args": {"name": "anomalies"}})
        start = ev["start"]
        end = ev.get("end")
        args = dict(ev.get("details", {}))
        if end is None:
            end = start
            args["open"] = True
        events.append({
            "ph": "X", "name": f"anomaly:{ev['rule']}",
            "ts": start * 1e6, "dur": max(end - start, 0.0) * 1e6,
            "pid": pid, "tid": 0, "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def resolve_recorder(tracing, sample_rate: float = 0.0,
                     capacity: int = 256, tail_capacity: int = 0
                     ) -> TraceRecorder | None:
    """The one constructor both servers use: `tracing` may be a ready
    TraceRecorder, a sampling rate (float in [0, 1]), None (falling
    back to `InferConfig.trace_sample_rate`), or False — tracing
    force-disabled regardless of the config fallback. `capacity` /
    `tail_capacity` size the finished and tail-retained rings
    (`InferConfig.trace_capacity` / `trace_tail_capacity`). Returns
    None (tracing fully disabled, byte-identical pre-trace
    scheduling) when the effective rate is 0 and tail retention is
    off; a zero rate WITH a tail ring still records — that is the
    "1% head sampling, broken requests always inspectable" mode."""
    if tracing is False:
        return None
    if isinstance(tracing, TraceRecorder):
        return tracing
    rate = float(tracing if tracing is not None else (sample_rate or 0.0))
    if rate <= 0.0 and tail_capacity <= 0:
        return None
    return TraceRecorder(sample_rate=rate, capacity=capacity,
                         tail_capacity=tail_capacity)


def merge_handoff_trees(trees: list[dict]) -> list[dict]:
    """Stitch disaggregation handoffs into ONE spanning tree per
    request.  A handed-off request leaves two partial trees sharing a
    trace id: the prefill replica's half (closed by finish:migrated)
    and the decode continuation, whose root carries
    ``handoff_of=<original request id>``.  This grafts each
    continuation's spans onto its original's tree with a bridging
    ``migrate_gap`` phase covering the export -> re-admission seam, so
    the merged tree partitions [submit, finish] with no holes across
    replicas.  Failover trees (``retry_of`` / ``migrate_of``) are left
    untouched — operators rely on seeing those as distinct attempts.
    Order-preserving no-op when nothing was handed off.  Trees are
    mutated in place; callers pass freshly built dicts."""
    by_id = {t["request_id"]: t for t in trees}
    segments = [t for t in trees
                if t["root"]["tags"].get("handoff_of") in by_id]
    if not segments:
        return trees
    consumed: set[int] = set()
    # Oldest-first so a (rare) chained hop grafts onto the tree its
    # predecessor already merged into.
    for seg in sorted(segments, key=lambda t: t["root"]["start"]):
        base = by_id.get(seg["root"]["tags"]["handoff_of"])
        if (base is None or base is seg
                or base["trace_id"] != seg["trace_id"]):
            continue
        b_root, s_root = base["root"], seg["root"]
        if (b_root["end"] is not None
                and s_root["start"] >= b_root["end"]):
            b_root["children"].append({
                "name": "migrate_gap", "start": b_root["end"],
                "end": s_root["start"], "tags": {"reason": "handoff"},
                "children": []})
        b_root["children"].extend(s_root["children"])
        b_root["end"] = s_root["end"]
        tags, s_tags = b_root["tags"], s_root["tags"]
        for k, v in s_tags.items():
            if k not in ("handoff_of", "replica"):
                tags[k] = v
        if "replica" in s_tags:
            tags["decode_replica"] = s_tags["replica"]
        segs = list(tags.get("handoff_segments", ()))
        segs.append(seg["request_id"])
        tags["handoff_segments"] = segs
        consumed.add(id(seg))
        by_id[seg["request_id"]] = base
    return [t for t in trees if id(t) not in consumed]
