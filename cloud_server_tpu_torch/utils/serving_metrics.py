"""Serving metrics: counters, gauges, fixed-bucket histograms, and the
scheduler flight recorder.

A copy of the reference's module (utils/serving_metrics.py there): pure
host-side Python, so the port keeps its own. The serving hot path must
never pay a device sync or a launch for telemetry, so everything here is
plain host-side arithmetic on floats the scheduler already has in hand
(`time.perf_counter()` taken at points where the host blocks anyway).
`observe()` is a bisect + two adds under a small lock; a snapshot is a
deep copy taken on the scrape path, never the serving path.

Naming: every metric carries the `cloud_server_` namespace, and the
port's server registers a subset of the reference's families under the
same names (tests/test_torch_http_server.py checks the subset), so one
dashboard reads either backend.

Snapshots are plain dicts (`{name: {"type", "help", ...}}`) so they
merge across replicas (`merge_snapshots`: histogram buckets add,
counters add, gauges add — occupancy gauges are totals, so summation is
the right fleet semantics) and render to the Prometheus text exposition
(`render_prometheus`) without the registry objects ever crossing a
process or thread boundary. The port's server does not use the flight
recorder yet.
"""

from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import Callable, Iterable, Sequence

NAMESPACE = "cloud_server"

# Per-tenant TTFT histogram family (multi-tenant QoS): one labeled
# series per tenant, observed once per request at first token by
# ServingMetrics.observe_emit when the request carries a tenant (QoS,
# which the port's server does not have yet).
TENANT_TTFT = ("tenant_ttft_seconds",
               "Time from submit to first emitted token, per tenant")

# Shared latency bucket ladder (seconds): sub-ms through minutes, the
# span TTFT/ITL/queue-wait cover between a warm single-chip deployment
# and a cold multi-minute drain. Fixed at registration so merge() across
# replicas is exact (identical edges everywhere).
LATENCY_BUCKETS: tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def _full_name(name: str) -> str:
    return name if name.startswith(f"{NAMESPACE}_") else \
        f"{NAMESPACE}_{name}"


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping — label values may come
    from untrusted client headers (tenant names)."""
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _label_suffix(labels: dict[str, str] | None) -> str:
    """Prometheus label block for a series key ('' when unlabeled).
    Sorted so the same label set always yields the same series key —
    which is what lets `merge_snapshots` add labeled series across
    replicas by plain string key."""
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter. `inc` is the hot-path op; `set_total` exists
    for mirroring an externally-maintained monotonic count (e.g. the
    allocator's lifetime eviction count) into a snapshot collector."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self.labels: dict[str, str] | None = None
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def set_total(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        out = {"type": "counter", "help": self.help, "value": self._value}
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


class Gauge:
    """Point-in-time value (occupancy, queue depth, pool free pages)."""

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text
        self.labels: dict[str, str] | None = None
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        out = {"type": "gauge", "help": self.help, "value": self._value}
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


class Histogram:
    """Fixed-bucket histogram with cheap host-side observe().

    Buckets are UPPER BOUNDS (Prometheus `le` semantics, cumulative at
    render time); counts are kept per-bucket (non-cumulative) plus an
    overflow bucket, so observe() is one bisect and two adds. Edges are
    fixed at construction so snapshots from different replicas merge
    bucket-for-bucket."""

    def __init__(self, name: str, help_text: str,
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("histogram buckets must be a sorted, "
                             "non-empty sequence of upper bounds")
        self.name = name
        self.help = help_text
        self.labels: dict[str, str] | None = None
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +1: +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> dict:
        with self._lock:
            out = {"type": "histogram", "help": self.help,
                   "buckets": list(self.buckets),
                   "counts": list(self._counts),
                   "sum": self._sum, "count": self._count}
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


class MetricsRegistry:
    """Get-or-create registry; the single source of truth for which
    metric names exist at runtime. Collectors are callbacks run at snapshot time so
    externally-owned state (scheduler occupancy, allocator stats) is
    mirrored on the SCRAPE path, not the serving path."""

    def __init__(self):
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}
        self._collectors: list[Callable[[], None]] = []
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help_text: str,
                       labels: dict[str, str] | None, *args):
        name = _full_name(name)
        key = name + _label_suffix(labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help_text, *args)
                if labels:
                    m.labels = {str(k): str(v)
                                for k, v in labels.items()}
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {key} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help_text: str = "",
                labels: dict[str, str] | None = None) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(self, name: str, help_text: str = "",
              labels: dict[str, str] | None = None) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS,
                  labels: dict[str, str] | None = None) -> Histogram:
        return self._get_or_create(Histogram, name, help_text, labels,
                                   buckets)

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def snapshot(self) -> dict[str, dict]:
        for fn in list(self._collectors):
            fn()
        with self._lock:
            return {name: m.snapshot()
                    for name, m in sorted(self._metrics.items())}


def merge_snapshots(snaps: Iterable[dict[str, dict]]) -> dict[str, dict]:
    """Merge registry snapshots (e.g. one per replica) into a
    fleet-wide snapshot: counters and gauges add; histograms add
    bucket-for-bucket (edges must match — they do, by construction:
    every replica registers the same fixed ladders)."""
    out: dict[str, dict] = {}
    for snap in snaps:
        for name, entry in snap.items():
            cur = out.get(name)
            if cur is None:
                out[name] = {k: (list(v) if isinstance(v, list) else
                                 dict(v) if isinstance(v, dict) else v)
                             for k, v in entry.items()}
                continue
            if cur["type"] != entry["type"]:
                raise ValueError(f"metric {name} has conflicting types "
                                 f"across snapshots: {cur['type']} vs "
                                 f"{entry['type']}")
            if entry["type"] == "histogram":
                if cur["buckets"] != entry["buckets"]:
                    raise ValueError(
                        f"histogram {name} has mismatched bucket edges "
                        "across snapshots; merge needs identical ladders")
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], entry["counts"])]
                cur["sum"] += entry["sum"]
                cur["count"] += entry["count"]
            else:
                cur["value"] += entry["value"]
    return dict(sorted(out.items()))


def histogram_percentile(entry: dict, q: float) -> float:
    """Estimate the q-quantile (0..1) of a histogram snapshot entry by
    linear interpolation inside the containing bucket (the Prometheus
    `histogram_quantile` rule). The overflow bucket clamps to the top
    edge. Returns 0.0 for an empty histogram."""
    total = entry["count"]
    if total <= 0:
        return 0.0
    target = q * total
    edges = entry["buckets"]
    seen = 0.0
    for i, c in enumerate(entry["counts"]):
        if seen + c >= target and c > 0:
            lo = 0.0 if i == 0 else edges[i - 1]
            hi = edges[i] if i < len(edges) else edges[-1]
            frac = (target - seen) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        seen += c
    return edges[-1]


def histogram_summary(entry: dict) -> dict:
    """Compact JSON summary for the /stats endpoint: count, mean, and
    interpolated p50/p95/p99."""
    count = entry["count"]
    return {"count": count, "sum": entry["sum"],
            "mean": entry["sum"] / count if count else 0.0,
            "p50": histogram_percentile(entry, 0.50),
            "p95": histogram_percentile(entry, 0.95),
            "p99": histogram_percentile(entry, 0.99)}


def render_prometheus(snapshot: dict[str, dict]) -> str:
    """Prometheus text exposition (version 0.0.4) of a snapshot: every
    metric FAMILY gets exactly one HELP and one TYPE line (labeled
    series — snapshot keys like `name{tenant="a"}` — share their
    family's metadata); histograms render cumulative `_bucket{le=...}`
    series plus `_sum`/`_count`, with the series' own labels folded in
    ahead of `le`."""
    out: list[str] = []
    seen_meta: set[str] = set()
    # group by FAMILY, not raw key: the exposition format wants every
    # series of a family contiguous under one HELP/TYPE, and a plain
    # key sort can interleave (`foo_bar` sorts between `foo` and
    # `foo{...}` because "_" < "{"). Sorting here also makes the output
    # independent of snapshot dict ordering.
    for name, entry in sorted(
            snapshot.items(),
            key=lambda kv: (kv[0].partition("{")[0], kv[0])):
        base, _, label_rest = name.partition("{")
        labels = "{" + label_rest if label_rest else ""
        # labels without the closing brace, for composing with `le`
        inner = label_rest[:-1] + "," if label_rest else ""
        if base not in seen_meta:
            out.append(f"# HELP {base} {entry.get('help', '')}")
            out.append(f"# TYPE {base} {entry['type']}")
            seen_meta.add(base)
        if entry["type"] == "histogram":
            cum = 0
            for edge, c in zip(entry["buckets"], entry["counts"]):
                cum += c
                out.append(
                    f'{base}_bucket{{{inner}le="{edge:g}"}} {cum}')
            cum += entry["counts"][-1]
            out.append(f'{base}_bucket{{{inner}le="+Inf"}} {cum}')
            out.append(f"{base}_sum{labels} {entry['sum']}")
            out.append(f"{base}_count{labels} {entry['count']}")
        else:
            out.append(f"{base}{labels} {entry['value']}")
    return "\n".join(out) + "\n"


# ---------------------------------------------------------------------------
# Request-lifecycle instruments shared by both servers
# ---------------------------------------------------------------------------


class ServingMetrics:
    """The standard serving instrument set, registered once per server.

    All observe_* hooks take timestamps the scheduler already recorded
    on the request (host wall clock at points where the host blocks on
    device output anyway), so instrumentation adds zero device syncs
    and zero launches.

    `slo` (an inference.slo.SLOTracker, attached by a server that
    resolved an SLO config) receives the same latency observations,
    tagged with the request's priority class (`req.slo_class`), at the
    same already-owned host moments; None (the default) keeps every
    hook byte-identical to the pre-SLO build."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 slo=None):
        self.slo = slo
        r = self.registry = registry or MetricsRegistry()
        self.ttft = r.histogram(
            "ttft_seconds", "Time from submit to first emitted token")
        self.itl = r.histogram(
            "itl_seconds", "Inter-token latency between emitted tokens")
        self.queue_wait = r.histogram(
            "queue_wait_seconds",
            "Time from submit to first admission into a slot")
        self.e2e = r.histogram(
            "e2e_seconds", "Time from submit to request completion")
        self.submitted = r.counter(
            "requests_submitted_total", "Requests accepted by submit()")
        self.finished = r.counter(
            "requests_finished_total",
            "Requests completed normally (eos / stop / length)")
        self.cancelled = r.counter(
            "requests_cancelled_total", "Requests cancelled by the client")
        self.failed = r.counter(
            "requests_failed_total",
            "Requests failed by a scheduler/server error")
        self.requeues = r.counter(
            "preempt_requeues_total",
            "Requests requeued after an on-demand-paging preemption")
        self.deadline_expired = r.counter(
            "deadline_expired_total",
            "Requests cancelled by the scheduler sweep because their "
            "deadline passed")

    def observe_submit(self, req) -> None:
        self.submitted.inc()

    def observe_admit(self, req, now: float) -> None:
        req.record_event("admit", now)
        if req.admit_time is None:
            req.admit_time = now
            if req.submit_time is not None:
                self.queue_wait.observe(now - req.submit_time)
                if self.slo is not None:
                    self.slo.observe(req.slo_class, "queue_wait",
                                     now - req.submit_time, now)

    def observe_emit(self, req) -> None:
        """Called after emit_token appended a timestamp (the host moment
        the token surfaced — already taken; nothing re-reads the clock
        here)."""
        times = req.emit_times
        if len(times) == 1:
            req.record_event("first_token", times[0])
            if req.submit_time is not None:
                ttft = times[0] - req.submit_time
                self.ttft.observe(ttft)
                if self.slo is not None:
                    self.slo.observe(req.slo_class, "ttft", ttft,
                                     times[0])
                tenant = getattr(req, "tenant", None)
                if tenant:
                    # once per request (not per token): the per-tenant
                    # latency view QoS isolation is judged by
                    self.registry.histogram(
                        *TENANT_TTFT,
                        labels={"tenant": tenant}).observe(ttft)
        elif len(times) >= 2:
            self.itl.observe(times[-1] - times[-2])
            if self.slo is not None:
                self.slo.observe(req.slo_class, "itl",
                                 times[-1] - times[-2], times[-1])

    def observe_requeue(self, req, now: float) -> None:
        req.record_event("preempt_requeue", now)
        self.requeues.inc()

    def observe_finish(self, req, now: float | None = None) -> float:
        """Terminal-state bookkeeping; returns the finish moment so
        callers (tail retention, the anomaly watchdog) reuse the one
        timestamp instead of re-reading the clock."""
        now = time.perf_counter() if now is None else now
        reason = req.finish_reason or ""
        req.record_event(f"finish:{reason}", now)
        if reason == "cancelled":
            self.cancelled.inc()
        elif reason == "deadline":
            self.deadline_expired.inc()
        elif reason.startswith("error"):
            self.failed.inc()
        else:
            self.finished.inc()
        if req.submit_time is not None:
            self.e2e.observe(now - req.submit_time)
            if self.slo is not None:
                self.slo.observe(req.slo_class, "e2e",
                                 now - req.submit_time, now)
        return now


# ---------------------------------------------------------------------------
# Scheduler flight recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Fixed-size ring buffer of per-iteration scheduler records for
    post-mortem debugging (behaviour only visible iteration by
    iteration, such as decode round counts collapsing while admission
    jobs are in flight).

    A record is a plain dict; the scheduler writes whatever fields the
    iteration produced (token-budget utilization, prefill/decode token
    split, live-slot occupancy, compaction ratio, preemption/requeue
    counts). `record()` is an O(1) deque append on the scheduler
    thread; `window()` copies on the scrape path only."""

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError("flight recorder capacity must be positive")
        self.capacity = capacity
        self._buf: collections.deque[dict] = collections.deque(
            maxlen=capacity)
        self._seq = 0

    def record(self, **fields) -> None:
        self._seq += 1
        fields["iteration"] = self._seq
        self._buf.append(fields)

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def iterations(self) -> int:
        return self._seq

    def window(self, n: int | None = None) -> list[dict]:
        buf = list(self._buf)
        return buf if n is None else buf[-n:]
