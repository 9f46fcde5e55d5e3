"""Iteration-phase profiler: host-gap attribution for the scheduler's
iterations, and its read side (the `/stats` summary and the
scheduler-timeline Chrome-trace export).

A copy of the reference's inference/iteration_profile.py (pure
host-side Python). Phases, one contiguous partition of an iteration,
stamped at boundaries the scheduler already crosses:

    sweep       cancelled-request reaping at the top of step()
    admission   admission, token-budget planning, chain extension and
                preemption policy — the host deciding what to dispatch
    build       host array staging up to the program launch
    device      the launch through the one host sync (the wait on the
                program's event) — the only phase that waits on the card
    commit      token emits and bookkeeping on the synced results
    launch      (overlapped iterations only) the ledger patch and the
                next program's launch after the commit
    epilogue    flight-recorder bookkeeping at the end of the iteration

Sequential iterations: `host_gap_frac` = everything but `device` over
the duration. Overlapped iterations (the pipelined scheduler): sweep,
admission and build run while the card executes the previous
iteration's program, so they fold into `overlap_ms` (and the `overlap`
histogram series), `device` is the residual wait, and `host_gap_frac`
measures only the serialized tail (commit + launch + epilogue). A busy
record's `host_ms + device_wait_ms (+ overlap_ms) == duration_ms`.
A mark is one `perf_counter` read and one dict add; the profiler does
no device work.
"""

from __future__ import annotations

from time import perf_counter

from cloud_server_tpu_torch.utils.serving_metrics import histogram_percentile

# Canonical phase order — the contiguous partition of one iteration.
# `launch` only appears in overlapped iterations (async scheduler).
PHASES = ("sweep", "admission", "build", "device", "commit", "launch",
          "epilogue")

# Phases that run concurrently with the in-flight program when the
# pipelined scheduler has a dispatch outstanding; they fold into the
# `overlap` histogram label and `overlap_ms`.
OVERLAP_PHASES = ("sweep", "admission", "build")

# Histogram label set: the fine-grained phases plus the folded
# `overlap` series overlapped iterations observe instead of their
# sweep/admission/build split (keeping `profile_summary`'s host-gap
# arithmetic honest across sequential and overlapped iterations — the
# fine split of overlapped iterations stays in the flight records).
HIST_PHASES = PHASES + ("overlap",)

# Millisecond bucket ladder for the per-phase histograms, fixed at
# registration so replica snapshots merge bucket for bucket.
PHASE_MS_BUCKETS: tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 5000.0)

# Histogram family (one labeled series per phase): registered by the
# server, walked by `profile_summary`.
PHASE_FAMILY = "iter_phase_ms"
_FULL_FAMILY = f"cloud_server_{PHASE_FAMILY}"

# Flight-record scalars worth carrying into the Perfetto iteration
# track's args (post-mortem context next to the phase bars).
_ITER_ARG_KEYS = ("iteration", "scheduler", "n_live", "decode_rounds",
                  "decode_tokens", "prefill_tokens", "tokens_scheduled",
                  "budget_utilization", "host_ms", "device_wait_ms",
                  "host_gap_frac", "preemptions", "pending", "n_jobs",
                  "overlap", "overlap_ms", "inflight_depth",
                  "overlap_launch_lead_ms")


class IterationProfiler:
    """Host-side phase clock for one scheduler iteration.

    `begin()` opens the iteration; `mark(phase)` attributes the time
    since the previous mark to `phase` (marks accumulate, so a phase
    visited several times in one iteration — `build`/`device` per chunk
    on the alternating scheduler — sums). Both return the time they
    read, so callers reuse it instead of reading the clock again."""

    __slots__ = ("t0", "_last", "_acc")

    def __init__(self):
        self.t0 = 0.0
        self._last = 0.0
        self._acc: dict[str, float] = {}

    def begin(self) -> float:
        t = perf_counter()
        self.t0 = self._last = t
        self._acc = {}
        return t

    def mark(self, phase: str) -> float:
        t = perf_counter()
        acc = self._acc
        acc[phase] = acc.get(phase, 0.0) + (t - self._last)
        self._last = t
        return t

    def phases_ms(self) -> dict[str, float]:
        """Accumulated per-phase milliseconds, canonical order; they
        partition [t0, last mark]."""
        acc = self._acc
        return {p: acc[p] * 1e3 for p in PHASES if p in acc}


def register_phase_hists(registry) -> dict:
    """Register the per-phase histogram family on a server's registry
    (one labeled series per phase); returns the phase -> Histogram dict
    the per-iteration observe path indexes."""
    return {
        p: registry.histogram(
            PHASE_FAMILY,
            "Scheduler iteration time by phase (milliseconds)",
            buckets=PHASE_MS_BUCKETS, labels={"phase": p})
        for p in HIST_PHASES}


def resolve_profiler(profile,
                     cfg_enabled: bool = True) -> IterationProfiler | None:
    """`profile` may be a ready IterationProfiler, True/False, "off", or
    None (falling back to `InferConfig.iteration_profile`). Returns None
    when disabled."""
    if profile is False or profile == "off":
        return None
    if isinstance(profile, IterationProfiler):
        return profile
    if profile is True:
        return IterationProfiler()
    if profile is None:
        return IterationProfiler() if cfg_enabled else None
    raise ValueError(
        "iteration_profile must be True, False, 'off', None, or an "
        f"IterationProfiler; got {profile!r}")


def derive_gap_fields(phases_ms: dict[str, float],
                      duration_ms: float,
                      overlapped: bool = False) -> dict[str, float]:
    """The derived flight-record fields of one iteration's phase split:
    host milliseconds (the serialized host work), the device wait, and
    the host-gap fraction; overlapped iterations move sweep, admission
    and build into `overlap_ms`."""
    device = phases_ms.get("device", 0.0)
    if overlapped:
        overlap = sum(phases_ms.get(p, 0.0) for p in OVERLAP_PHASES)
        host = sum(v for k, v in phases_ms.items()
                   if k != "device" and k not in OVERLAP_PHASES)
        return {"host_ms": host, "device_wait_ms": device,
                "overlap_ms": overlap,
                "host_gap_frac": host / duration_ms if duration_ms > 0
                else 0.0}
    host = sum(v for k, v in phases_ms.items() if k != "device")
    return {"host_ms": host, "device_wait_ms": device,
            "host_gap_frac": host / duration_ms if duration_ms > 0
            else 0.0}


def profile_summary(snapshot: dict) -> dict | None:
    """The `/stats` `iteration_profile` payload from a metrics
    snapshot (one server's, or the router's fleet-merge — the phase
    histograms merged bucket-for-bucket upstream, so these are true
    fleet percentiles): per-phase count/mean/p50/p99 milliseconds
    plus the aggregate `host_gap_frac` recomputed from the merged
    sums (a ratio must never be added across replicas). None when no
    phase histograms are present (profiling disabled, or a backend
    without it)."""
    phases: dict[str, dict] = {}
    host_ms = device_ms = overlap_ms = 0.0
    for key, entry in snapshot.items():
        if not key.startswith(_FULL_FAMILY + "{") \
                or entry.get("type") != "histogram":
            continue
        phase = (entry.get("labels") or {}).get("phase")
        if phase is None:
            continue
        count = entry["count"]
        phases[phase] = {
            "count": count,
            "mean_ms": entry["sum"] / count if count else 0.0,
            "p50_ms": histogram_percentile(entry, 0.50),
            "p99_ms": histogram_percentile(entry, 0.99)}
        if phase == "device":
            device_ms += entry["sum"]
        elif phase == "overlap":
            # host work performed while a dispatch was in flight (the
            # async scheduler's hidden sweep/admission/build): not
            # device-idle time, so not host gap
            overlap_ms += entry["sum"]
        else:
            host_ms += entry["sum"]
    if not phases:
        return None
    total = host_ms + device_ms + overlap_ms
    return {"phases": {p: phases[p] for p in HIST_PHASES if p in phases},
            "host_ms_total": host_ms,
            "device_wait_ms_total": device_ms,
            "overlap_ms_total": overlap_ms,
            "host_gap_frac": host_ms / total if total > 0 else 0.0}


def scheduler_chrome_trace(records: list[dict]) -> dict:
    """Render flight-recorder records as Chrome trace event format
    JSON (chrome://tracing / ui.perfetto.dev): one process per
    replica, one track per phase plus an `iteration` track whose args
    carry the record's scalars. Timestamps are microseconds on the
    servers' perf_counter timebase — the SAME timebase as the
    request-trace export (`GET /traces`), and every event's args
    carry the flight-recorder `iteration` index, which is also the
    tag on every `prefill_chunk`/`decode_segment` span in a request's
    tree: the two exports cross-link in both directions ("why was
    this request's decode_segment slow" ↔ "what was the scheduler
    doing that iteration").

    Phases render laid out consecutively in canonical order inside
    the iteration window; on the alternating scheduler a phase's bar
    is its per-iteration SUM (chunks interleave build/device several
    times), so bar order within an iteration is attribution, not a
    literal interleaving. Records written with profiling disabled
    carry no `t_start`/`phases_ms` and are skipped.

    OVERLAPPED iterations (the async double-buffered scheduler) are
    NOT disjoint in device time: the program committed by iteration
    k+1 was launched inside iteration k's window. Each record that
    launched ahead carries `t_launch`, and the export renders an
    `inflight` track whose slices span from that launch to the END of
    the NEXT record's residual `device` wait — so the device slice
    visibly runs CONCURRENT with (nested under) the next iteration's
    sweep/admission/build bars instead of the export pretending
    iteration bounds partition device time."""
    events: list[dict] = []
    seen_pids: set[int] = set()
    inflight_tid = len(PHASES) + 1
    last_launch: dict[int, tuple[float, int]] = {}  # pid -> (ts, iter)
    for rec in records:
        t0 = rec.get("t_start")
        if t0 is None:
            continue
        pid = int(rec.get("replica", 0))
        if pid not in seen_pids:
            seen_pids.add(pid)
            events.append({"ph": "M", "name": "process_name",
                           "pid": pid,
                           "args": {"name": f"scheduler replica {pid}"}})
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": 0, "args": {"name": "iteration"}})
            for i, p in enumerate(PHASES):
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": i + 1,
                               "args": {"name": p}})
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": inflight_tid,
                           "args": {"name": "inflight"}})
        args = {k: rec[k] for k in _ITER_ARG_KEYS if k in rec}
        events.append({"ph": "X",
                       "name": f"iteration {rec.get('iteration')}",
                       "ts": t0 * 1e6,
                       "dur": rec.get("duration_ms", 0.0) * 1e3,
                       "pid": pid, "tid": 0, "args": args})
        off = t0 * 1e6
        device_end = None
        for i, p in enumerate(PHASES):
            v = (rec.get("phases_ms") or {}).get(p, 0.0)
            if v <= 0:
                continue
            events.append({"ph": "X", "name": p, "ts": off,
                           "dur": v * 1e3, "pid": pid, "tid": i + 1,
                           "args": {"iteration": rec.get("iteration")}})
            off += v * 1e3
            if p == "device":
                device_end = off
        if rec.get("overlap") and pid in last_launch \
                and device_end is not None:
            # the dispatch THIS record committed: launched inside the
            # previous record's window, device-resident until this
            # record's residual sync — one concurrent slice
            ts_launch, it_launch = last_launch.pop(pid)
            events.append({"ph": "X",
                           "name": f"dispatch (committed by iteration "
                                   f"{rec.get('iteration')})",
                           "ts": ts_launch * 1e6,
                           "dur": max(device_end - ts_launch * 1e6, 0.0),
                           "pid": pid, "tid": inflight_tid,
                           "args": {"launched_in_iteration": it_launch,
                                    "iteration": rec.get("iteration")}})
        if rec.get("t_launch") is not None:
            last_launch[pid] = (rec["t_launch"], rec.get("iteration"))
    return {"traceEvents": events, "displayTimeUnit": "ms"}
