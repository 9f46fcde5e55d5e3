"""Per-priority-class serving SLOs: targets, rolling multi-window
attainment, and burn rates.

PR 3's latency histograms answer "what are my percentiles"; an
autoscaler (ROADMAP item 5) and a disaggregated fleet planner (item 3)
need a different shape of signal: "is each QoS class meeting its
latency objective RIGHT NOW, and how fast is it eating its error
budget". That is the Google SRE Workbook's multi-window burn-rate
construction, applied to the serving stack's four request-latency
metrics:

    ttft         submit → first emitted token
    itl          gap between consecutive emitted tokens
    queue_wait   submit → first admission into a slot
    e2e          submit → terminal state

Each configured CLASS (named after the QoS priority classes —
`interactive` / `batch` / `best_effort` — plus `default` for traffic
with no QoS registry) declares per-metric latency targets and one
attainment objective. Every observation is a good/bad event (latency
<= target?) counted into a bucketed ring per (class, metric); reads
sum the ring over each configured window. Definitions:

    attainment  = good / total over the window (None until data)
    burn_rate   = (1 - attainment) / (1 - objective)

Burn rate 1.0 means the class is consuming error budget exactly at
the rate that exhausts it at the objective horizon; a multi-window
alert (e.g. burn > 14 over 5m AND over 1h) is the standard paging
rule, and the fleet autoscaler's input is the same number.

Design rules (shared with `serving_metrics` / `request_trace`):

  * **Zero new device work.** `observe()` is integer arithmetic on a
    preallocated ring, fed timestamps the scheduler already recorded
    (a copy of the reference's `inference/slo.py`; the port's tests
    run a server with SLO tracking enabled against one without).
  * **No configuration, no cost.** With no `slo_config` the tracker
    is None and every call site is guarded — the serving path is
    byte-identical to the pre-SLO build.
  * **Mergeable reports.** `report()` carries raw good/total counts
    per window, so `merge_reports` (used by
    `ReplicatedRouter.slo_report`) sums them exactly and recomputes
    attainment/burn fleet-wide — never an average of ratios.

Config JSON shape (`InferConfig.slo_config`, server `slo=`, CLI
`--slo-config`; a JSON object, a JSON string, or a file path)::

    {"windows_s": [60, 300, 3600],
     "classes": {
       "interactive": {"objective": 0.99, "ttft_s": 0.5, "itl_s": 0.1,
                       "queue_wait_s": 0.25, "e2e_s": 30.0},
       "batch":       {"objective": 0.95, "ttft_s": 5.0, "e2e_s": 120.0},
       "default":     {"objective": 0.99, "e2e_s": 60.0}}}

A request's class is its tenant's QoS priority class when a
TenantRegistry is configured, else `default`; classes observed but
not configured fall back to the `default` entry (absent that, the
observation is dropped — unconfigured traffic costs nothing).
Metrics without a target in a class are not tracked for it.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

DEFAULT_CLASS = "default"
SLO_METRICS = ("ttft", "itl", "queue_wait", "e2e")
DEFAULT_WINDOWS_S = (60.0, 300.0, 3600.0)


@dataclasses.dataclass(frozen=True)
class ClassSLO:
    """One class's latency targets (seconds) + attainment objective.
    None disables that metric for the class."""

    name: str
    objective: float = 0.99
    ttft_s: float | None = None
    itl_s: float | None = None
    queue_wait_s: float | None = None
    e2e_s: float | None = None

    def __post_init__(self) -> None:
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"slo class {self.name!r}: objective must be in (0, 1) "
                "(1.0 leaves no error budget; burn rate would divide "
                "by zero)")
        for m in SLO_METRICS:
            t = getattr(self, m + "_s")
            if t is not None and t <= 0:
                raise ValueError(
                    f"slo class {self.name!r}: {m}_s must be > 0")
        if all(getattr(self, m + "_s") is None for m in SLO_METRICS):
            raise ValueError(
                f"slo class {self.name!r} declares no targets; drop the "
                "entry instead")

    def target(self, metric: str) -> float | None:
        return getattr(self, metric + "_s")


class _RollingCounts:
    """Good/total event counts over bucketed monotonic time: a
    fixed-size ring sized to the longest window, one slot per
    `bucket_s`. `observe` touches exactly one slot (stale slots are
    lazily reused via their absolute-bucket stamp) under a plain lock
    — the scheduler thread and a client-thread cancellation can
    observe the same ring concurrently, the contention shape the
    metrics Histogram locks for; `window` sums the slots whose stamp
    falls inside the asked window — a read-path scan, never a
    serving-path one."""

    def __init__(self, max_window_s: float, bucket_s: float):
        self.bucket_s = float(bucket_s)
        self.n = int(max_window_s / bucket_s) + 1
        self._stamp = [-1] * self.n   # absolute bucket index per slot
        self._good = [0] * self.n
        self._total = [0] * self.n
        self.good_lifetime = 0
        self.total_lifetime = 0
        self._lock = threading.Lock()

    def observe(self, ok: bool, now: float) -> None:
        b = int(now / self.bucket_s)
        i = b % self.n
        with self._lock:
            if self._stamp[i] != b:
                self._stamp[i] = b
                self._good[i] = 0
                self._total[i] = 0
            self._total[i] += 1
            self.total_lifetime += 1
            if ok:
                self._good[i] += 1
                self.good_lifetime += 1

    def window(self, window_s: float, now: float) -> tuple[int, int]:
        """(good, total) over the trailing `window_s` ending at `now`
        (the current partial bucket included)."""
        b = int(now / self.bucket_s)
        lo = b - int(window_s / self.bucket_s)
        good = total = 0
        with self._lock:
            for i in range(self.n):
                if lo < self._stamp[i] <= b:
                    good += self._good[i]
                    total += self._total[i]
        return good, total


def _burn(good: int, total: int, objective: float) -> float:
    if total <= 0:
        return 0.0
    return (1.0 - good / total) / (1.0 - objective)


def _attainment(good: int, total: int) -> float | None:
    return None if total <= 0 else good / total


class SLOTracker:
    """All SLO state for one server: per-(class, metric) rolling
    counts plus the parsed targets. `observe` is the only serving-path
    entry point; `report`/`mirror_metrics` run on the scrape path.

    Thread-safety: each ring guards its counts with a small lock (the
    metrics Histogram discipline — a scheduler-thread emit and a
    client-thread cancellation may observe concurrently), held for a
    handful of int ops only."""

    def __init__(self, config: dict | None = None, *,
                 clock=time.perf_counter):
        config = dict(config or {})
        unknown = set(config) - {"windows_s", "bucket_s", "classes"}
        if unknown:
            raise ValueError(f"unknown slo config keys: {sorted(unknown)}")
        windows = tuple(float(w)
                        for w in config.get("windows_s", DEFAULT_WINDOWS_S))
        if (not windows or sorted(windows) != list(windows)
                or len(set(windows)) != len(windows)
                or windows[0] <= 0):
            raise ValueError(
                "slo windows_s must be a strictly increasing sequence of "
                "positive seconds")
        self.windows = windows
        # bucket granularity: ~60 buckets across the shortest window,
        # floored at 0.25 s (finer would bloat the longest window's
        # ring for no read-out precision anyone alerts on)
        self.bucket_s = float(config.get("bucket_s",
                                         max(windows[0] / 60.0, 0.25)))
        if self.bucket_s <= 0 or self.bucket_s > windows[0]:
            raise ValueError(
                "slo bucket_s must be positive and no larger than the "
                "shortest window")
        classes = dict(config.get("classes", {}))
        if not classes:
            raise ValueError(
                'slo config declares no "classes"; nothing to track')
        self.classes: dict[str, ClassSLO] = {}
        for name, spec in classes.items():
            self.classes[name] = ClassSLO(name=name, **dict(spec))
        self._clock = clock
        self._counts: dict[tuple[str, str], _RollingCounts] = {}
        for name, cls in self.classes.items():
            for m in SLO_METRICS:
                if cls.target(m) is not None:
                    self._counts[(name, m)] = _RollingCounts(
                        windows[-1], self.bucket_s)

    # -- serving path -------------------------------------------------------

    def resolve_class(self, name: str | None) -> str | None:
        """Configured class for an observed class name: exact match,
        else the `default` entry, else None (drop)."""
        if name is not None and name in self.classes:
            return name
        if DEFAULT_CLASS in self.classes:
            return DEFAULT_CLASS
        return None

    def observe(self, cls: str | None, metric: str, value: float,
                now: float) -> None:
        """Count one latency observation (seconds) for `cls` at host
        moment `now` (the same perf_counter timestamp the metrics
        layer observed — no clock is read here)."""
        name = self.resolve_class(cls)
        if name is None:
            return
        rc = self._counts.get((name, metric))
        if rc is None:
            return  # metric untracked for this class
        rc.observe(value <= self.classes[name].target(metric), now)

    def exceeds_target(self, cls: str | None, metric: str,
                       value: float) -> bool:
        """Did `value` miss the class's target for `metric`? False for
        untracked classes/metrics — the tail-retention predicate's SLO
        clause (per-replica deterministic: targets are static config,
        identical fleet-wide by construction)."""
        name = self.resolve_class(cls)
        if name is None:
            return False
        target = self.classes[name].target(metric)
        return target is not None and value > target

    # -- read path ----------------------------------------------------------

    def burn_rates(self, now: float | None = None
                   ) -> dict[str, dict[str, tuple[float, float]]]:
        """{class: {metric: (shortest-window burn, longest-window
        burn)}} — the two numbers a multi-window burn alert compares
        (`anomaly.py`'s `slo_burn` rule samples this instead of the
        full `report()`, which builds the whole mergeable dict)."""
        now = self._clock() if now is None else now
        fast_w, slow_w = self.windows[0], self.windows[-1]
        out: dict[str, dict[str, tuple[float, float]]] = {}
        for (name, metric), rc in self._counts.items():
            obj = self.classes[name].objective
            fast = _burn(*rc.window(fast_w, now), obj)
            slow = (fast if slow_w == fast_w
                    else _burn(*rc.window(slow_w, now), obj))
            out.setdefault(name, {})[metric] = (fast, slow)
        return out

    def report(self, now: float | None = None) -> dict:
        """Attainment + burn rate per class, metric, and window, with
        the raw good/total counts that make reports mergeable
        (`merge_reports`). Window keys are the window length in
        seconds as `%g` strings ("60", "0.5" — JSON-stable and
        non-lossy, so two distinct configured windows can never
        collide into one entry)."""
        now = self._clock() if now is None else now
        classes = {}
        for name, cls in self.classes.items():
            metrics = {}
            for m in SLO_METRICS:
                rc = self._counts.get((name, m))
                if rc is None:
                    continue
                wins = {}
                for w in self.windows:
                    good, total = rc.window(w, now)
                    wins[f"{w:g}"] = {
                        "good": good, "total": total,
                        "attainment": _attainment(good, total),
                        "burn_rate": _burn(good, total, cls.objective)}
                metrics[m] = {
                    "target_s": cls.target(m), "windows": wins,
                    "lifetime": {
                        "good": rc.good_lifetime,
                        "total": rc.total_lifetime,
                        "attainment": _attainment(rc.good_lifetime,
                                                  rc.total_lifetime),
                        "burn_rate": _burn(rc.good_lifetime,
                                           rc.total_lifetime,
                                           cls.objective)}}
            classes[name] = {"objective": cls.objective,
                             "metrics": metrics}
        return {"windows_s": list(self.windows), "classes": classes}

    def mirror_metrics(self, registry, now: float | None = None) -> None:
        """Scrape-path mirror into a `serving_metrics` registry:
        `slo_attainment` / `slo_burn_rate` gauges labeled by class,
        metric, and window. Attainment with no data mirrors as 1.0
        (an idle class is not missing its SLO). Behind a router these
        ratio gauges are recomputed from the fleet-merged report, the
        `tenant_fair_share` rule."""
        rep = self.report(now)
        for cname, centry in rep["classes"].items():
            for metric, m in centry["metrics"].items():
                for w, wentry in m["windows"].items():
                    lbl = {"class": cname, "metric": metric,
                           "window_s": w}
                    att = wentry["attainment"]
                    registry.gauge(
                        "slo_attainment",
                        "Fraction of observations meeting the class "
                        "SLO target over the window",
                        labels=lbl).set(1.0 if att is None else att)
                    registry.gauge(
                        "slo_burn_rate",
                        "Error-budget burn rate over the window "
                        "(1.0 = budget exhausts at the objective "
                        "horizon)",
                        labels=lbl).set(wentry["burn_rate"])


def merge_reports(reports) -> dict | None:
    """Fleet-wide SLO report: per-replica reports' good/total counts
    sum per (class, metric, window); attainment and burn recompute
    from the sums (ratios never average). Objectives/targets come
    from the first report carrying the class — identical everywhere
    by construction (one config serves the fleet)."""
    reports = [r for r in reports if r and r.get("classes")]
    if not reports:
        return None
    out = {"windows_s": list(reports[0]["windows_s"]), "classes": {}}
    for rep in reports:
        if list(rep["windows_s"]) != out["windows_s"]:
            raise ValueError(
                "slo reports have mismatched windows across replicas; "
                "merge needs one shared slo config")
        for cname, centry in rep["classes"].items():
            cur = out["classes"].setdefault(
                cname, {"objective": centry["objective"], "metrics": {}})
            for metric, m in centry["metrics"].items():
                tgt = cur["metrics"].setdefault(
                    metric, {"target_s": m["target_s"], "windows": {},
                             "lifetime": {"good": 0, "total": 0}})
                for w, wentry in m["windows"].items():
                    dst = tgt["windows"].setdefault(
                        w, {"good": 0, "total": 0})
                    dst["good"] += wentry["good"]
                    dst["total"] += wentry["total"]
                tgt["lifetime"]["good"] += m["lifetime"]["good"]
                tgt["lifetime"]["total"] += m["lifetime"]["total"]
    for cname, centry in out["classes"].items():
        obj = centry["objective"]
        for m in centry["metrics"].values():
            for dst in list(m["windows"].values()) + [m["lifetime"]]:
                dst["attainment"] = _attainment(dst["good"], dst["total"])
                dst["burn_rate"] = _burn(dst["good"], dst["total"], obj)
    return out


def resolve_slo(slo, slo_config: str = "") -> SLOTracker | None:
    """The one constructor both servers use: `slo` may be a ready
    SLOTracker, a config dict, a JSON string, a file path, None
    (falling back to `InferConfig.slo_config`), or False — SLO
    tracking force-disabled regardless of the config fallback.
    Returns None (tracking fully disabled, byte-identical pre-SLO
    serving) when nothing is configured."""
    if slo is False:
        return None
    if isinstance(slo, SLOTracker):
        return slo
    spec = slo if slo is not None else (slo_config or None)
    if spec is None or spec == "":
        return None
    if isinstance(spec, str):
        text = spec
        if not text.lstrip().startswith("{"):
            with open(text) as f:  # a path, not inline JSON
                text = f.read()
        spec = json.loads(text)
    if not isinstance(spec, dict):
        raise ValueError("slo config must be a JSON object")
    return SLOTracker(spec)
