"""W3C trace-context headers and the Chrome-trace export of span trees.

A copy of what the HTTP frontend imports from the reference's
inference/request_trace.py (pure host-side Python): `traceparent`
parsing and formatting, and `chrome_trace`. Request tracing on the
server (the recorder, its span trees and tail retention) is not ported
yet: the port's server refuses a tracing configuration, so the frontend
answers `/traces` and `/debug/requests/<id>` as the reference does for
a backend without a recorder.
"""

from __future__ import annotations

TRACEPARENT_HEADER = "traceparent"
_FLAG_SAMPLED = 0x01


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
