"""The iteration profile's read side: the `/stats` summary and the
scheduler-timeline Chrome-trace export.

A copy of what the HTTP frontend imports from the reference's
inference/iteration_profile.py (pure host-side Python). The profiler
itself, which stamps per-phase times on every scheduler iteration, is
not ported yet: the port's server registers no phase histograms and has
no flight recorder, so `profile_summary` returns None for its snapshots
and the frontend answers `/debug/scheduler_trace` with a 404, as the
reference does for a backend without them. Both functions serve any
snapshot or flight records that carry the reference's fields.
"""

from __future__ import annotations

from cloud_server_tpu_torch.utils.serving_metrics import histogram_percentile

# Canonical phase order — the contiguous partition of one iteration.
# `launch` only appears in overlapped iterations (async scheduler).
PHASES = ("sweep", "admission", "build", "device", "commit", "launch",
          "epilogue")

# Histogram label set: the fine-grained phases plus the folded
# `overlap` series overlapped iterations observe instead of their
# sweep/admission/build split (keeping `profile_summary`'s host-gap
# arithmetic honest across sequential and overlapped iterations — the
# fine split of overlapped iterations stays in the flight records).
HIST_PHASES = PHASES + ("overlap",)

# Histogram family (one labeled series per phase) that
# `profile_summary` walks.
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
