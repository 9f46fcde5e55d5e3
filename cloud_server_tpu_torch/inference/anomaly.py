"""Online anomaly watchdog: the stack notices its own incidents.

Every prior observability layer is *pull*-shaped — histograms, burn
rates, span trees, flight records all wait for an operator to scrape
them, and the bounded rings scroll the evidence away while nobody is
looking. This module is the push half: a small rule engine, fed only
from host state the schedulers already own, that latches "something
is wrong" windows, counts them, and lets the servers react (retain
the tail trace, auto-capture a forensic bundle, arm a scheduler
capture) at the moment the anomaly is live rather than after the
fact.

Design rules (the `faults.OverloadDetector` discipline):

  * **Zero new device work, zero new clock reads on the hot path.**
    `observe_iteration` folds signals `_record_iteration` already
    computed; `observe_request` folds latencies `_complete` already
    derived; both take the caller's `now`. The module is stdlib-only
    (a copy of the reference's `inference/anomaly.py`), and its single
    lock is a leaf.
  * **Hysteresis, not flapping.** A rule ACTIVATES the moment its
    condition crosses (after a warm-up so cold EWMAs cannot fire)
    and DEACTIVATES only after `hold_s` of continuous recovery — the
    `OverloadDetector` level-latch shape. Each activation edge
    increments `fired_total[rule]` once and appends one event to a
    bounded ring; the open event's `end` is stamped at deactivation.
  * **No configuration, no cost.** `resolve_anomaly` returns None
    for an empty config; every server call site is guarded, so the
    unconfigured serving path is byte-identical.

Rule catalog (`RULES` is the closed set — metric label values and
the docs table key off it):

    slo_burn        multi-window burn-rate page: some class/metric
                    burns error budget over `fast_burn` in the
                    SHORTEST configured SLO window AND over
                    `slow_burn` in the LONGEST (SRE Workbook rule).
    latency_shift   TTFT or ITL fast-EWMA rose `factor`x above its
                    own slow-EWMA rolling baseline (and above
                    `min_s` absolute).
    cache_collapse  prefix-cache hit-rate fast-EWMA fell below
                    `frac` of its slow-EWMA baseline.
    breaker_flap    overload/breaker level changed >= `flaps` times
                    inside `window_s` (admission flapping open/shut).
    deadline_spike  >= `count` deadline-expired finishes inside
                    `window_s`.
    preempt_spike   >= `count` preemption-requeues inside
                    `window_s`.
    host_gap        per-iteration `host_gap_frac` fast-EWMA rose
                    `factor`x above its slow baseline (and above
                    `min_frac`) — the scheduler is starving the
                    device on host work.
    wedged          requests are pending but no scheduler iteration
                    has been observed for `stall_s` (graded lazily
                    on the read path — a wedged scheduler cannot
                    grade itself).

Config JSON shape (`InferConfig.anomaly_config`, server `anomaly=`,
CLI `--anomaly-config`; a JSON object, a JSON string, or a file
path)::

    {"hold_s": 5.0, "warmup": 32, "check_every": 16,
     "event_capacity": 64, "alpha_fast": 0.3, "alpha_slow": 0.02,
     "capture_iters": 0, "capture_dir": "",
     "disable": ["cache_collapse"],
     "rules": {"deadline_spike": {"count": 5, "window_s": 10.0}}}

`capture_iters`/`capture_dir` arm the existing `POST /debug/trace`
machinery for N iterations on an activation edge (off unless both
set); the `bundle_on_anomaly` knob (InferConfig) makes the servers
snapshot a forensic bundle on the same edge.
"""

from __future__ import annotations

import collections
import threading
import time

from cloud_server_tpu_torch.inference.faults import _resolve_config

# The closed rule set: `anomaly_active{rule=}` / `anomalies_total
# {rule=}` label values, the docs rule-catalog rows, and the /stats
# block all key off this tuple. Adding a rule is a reviewed decision
# that must update all three.
RULES = ("slo_burn", "latency_shift", "cache_collapse",
         "breaker_flap", "deadline_spike", "preempt_spike",
         "host_gap", "wedged")

_RULE_DEFAULTS: dict[str, dict[str, float]] = {
    "slo_burn": {"fast_burn": 14.4, "slow_burn": 6.0},
    "latency_shift": {"factor": 3.0, "min_s": 0.05},
    "cache_collapse": {"frac": 0.5, "min_baseline": 0.2},
    "breaker_flap": {"flaps": 4.0, "window_s": 30.0},
    "deadline_spike": {"count": 3.0, "window_s": 10.0},
    "preempt_spike": {"count": 8.0, "window_s": 10.0},
    "host_gap": {"factor": 2.0, "min_frac": 0.2},
    "wedged": {"stall_s": 10.0},
}


class AnomalyWatchdog:
    """Rule engine over per-iteration and per-finish host signals.

    `observe_iteration` runs once per busy scheduler iteration;
    `observe_request` once per request finish; `active_count` once
    per finish (the tail-retention predicate's "inside an open
    anomaly window" clause). All three run in the scheduler: plain
    float math under one small lock, no clock reads (callers pass
    the perf_counter moment they already had). Everything else —
    `stats`, `events`, `active` — is scrape-path only.

    Both observe methods return a tuple of rules that ACTIVATED on
    this call (empty almost always), so the scheduler can trigger
    auto-capture exactly on the edge without polling."""

    def __init__(self, config: dict | None = None, *,
                 clock=time.perf_counter):
        cfg = dict(config or {})
        self._clock = clock
        self.hold_s = float(cfg.pop("hold_s", 5.0))
        self.warmup = int(cfg.pop("warmup", 32))
        self.check_every = int(cfg.pop("check_every", 16))
        self.event_capacity = int(cfg.pop("event_capacity", 64))
        self.alpha_fast = float(cfg.pop("alpha_fast", 0.3))
        self.alpha_slow = float(cfg.pop("alpha_slow", 0.02))
        self.capture_iters = int(cfg.pop("capture_iters", 0))
        self.capture_dir = str(cfg.pop("capture_dir", ""))
        if self.hold_s < 0:
            raise ValueError("anomaly hold_s must be >= 0")
        if self.check_every <= 0 or self.event_capacity <= 0:
            raise ValueError(
                "anomaly check_every / event_capacity must be positive")
        for name, a in (("alpha_fast", self.alpha_fast),
                        ("alpha_slow", self.alpha_slow)):
            if not 0.0 < a <= 1.0:
                raise ValueError(f"anomaly {name} must be in (0, 1]")
        disabled = cfg.pop("disable", ())
        self._enabled = {r: True for r in RULES}
        for r in disabled:
            if r not in self._enabled:
                raise ValueError(f"unknown anomaly rule to disable: {r!r}")
            self._enabled[r] = False
        self._th: dict[str, dict[str, float]] = {
            r: dict(d) for r, d in _RULE_DEFAULTS.items()}
        for r, spec in dict(cfg.pop("rules", {})).items():
            if r not in self._th:
                raise ValueError(f"unknown anomaly rule: {r!r}")
            for k, v in dict(spec).items():
                if k not in self._th[r]:
                    raise ValueError(
                        f"unknown anomaly threshold {r}.{k}")
                self._th[r][k] = float(v)
        if cfg:
            raise ValueError(f"unknown anomaly config keys: {sorted(cfg)}")

        self._lock = threading.Lock()
        self._slo = None  # bound post-construction (bind_slo)
        # fast/slow EWMA pairs per shifted signal; None until primed
        self._ew: dict[str, list] = {
            s: [None, None] for s in ("ttft", "itl", "cache_hit",
                                      "host_gap")}
        self._n_iter = 0
        self._n_req = 0
        # windowed event timestamps (pruned against each rule's own
        # window on the observe that reads them — bounded by prune)
        self._flap_ts: collections.deque = collections.deque()
        self._deadline_ts: collections.deque = collections.deque()
        self._preempt: collections.deque = collections.deque()  # (ts, n)
        self._preempt_sum = 0
        self._last_level: int | None = None
        self._last_iter_ts: float | None = None
        self._last_pending = 0
        # rule -> open-event dict (also referenced from the ring)
        self._open: dict[str, dict] = {}
        # rule -> last moment its condition held (hysteresis clock)
        self._last_true: dict[str, float] = {}
        self._events: collections.deque = collections.deque(
            maxlen=self.event_capacity)
        self.fired_total: dict[str, int] = {r: 0 for r in RULES}

    def bind_slo(self, tracker) -> None:
        """Attach the server's SLOTracker (or None) so `slo_burn` can
        sample burn rates every `check_every` iterations."""
        self._slo = tracker

    # -- hot path -----------------------------------------------------------

    def _update_rule(self, rule: str, firing: bool, now: float,
                     details: dict, fired: list) -> None:
        """One rule's activate/hold/deactivate step (called with the
        lock held). Activation is immediate; deactivation waits for
        `hold_s` of continuous recovery."""
        if firing:
            self._last_true[rule] = now
            if rule not in self._open:
                ev = {"rule": rule, "start": now, "end": None,
                      "details": details}
                self._open[rule] = ev
                self._events.append(ev)
                self.fired_total[rule] += 1
                fired.append(rule)
        elif rule in self._open:
            if now - self._last_true.get(rule, now) >= self.hold_s:
                self._open.pop(rule)["end"] = now

    def _shift(self, signal: str, value: float) -> tuple[float, float]:
        """Fold `value` into the signal's fast/slow EWMA pair; returns
        the updated (fast, slow)."""
        pair = self._ew[signal]
        if pair[0] is None:
            pair[0] = pair[1] = value
        else:
            pair[0] += self.alpha_fast * (value - pair[0])
            pair[1] += self.alpha_slow * (value - pair[1])
        return pair[0], pair[1]

    def observe_iteration(self, *, now: float, host_gap_frac: float = 0.0,
                          pending: int = 0, preempt_delta: int = 0,
                          cache_lookup_delta: int = 0,
                          cache_hit_delta: int = 0,
                          overload_level: int = 0) -> tuple:
        """Fold one busy iteration's signals; returns the rules that
        activated on this call. All inputs are numbers the scheduler's
        `_record_iteration` already computed for the flight record —
        no measurement of its own, no clock read."""
        burn = None
        # scheduler-thread-only
        # counter read: burn_rates takes the SLO tracker's own leaf
        # lock, so it must be sampled BEFORE this watchdog's lock
        # (no nested acquisition); observe_iteration has exactly one
        # caller thread, so the unlocked read cannot race
        n_iter = self._n_iter
        if (self._slo is not None and self._enabled["slo_burn"]
                and n_iter % self.check_every == 0):
            burn = self._slo.burn_rates(now)
        fired: list = []
        with self._lock:
            self._n_iter += 1
            self._last_iter_ts = now
            self._last_pending = pending
            warm = self._n_iter >= self.warmup

            if self._enabled["wedged"] and "wedged" in self._open:
                # an observed iteration is the proof of un-wedging:
                # close immediately, no hold (the stall IS over)
                self._last_true.pop("wedged", None)
                self._open.pop("wedged")["end"] = now

            if self._enabled["host_gap"]:
                fast, slow = self._shift("host_gap", host_gap_frac)
                th = self._th["host_gap"]
                firing = (warm and fast > th["min_frac"]
                          and fast > th["factor"] * slow)
                self._update_rule("host_gap", firing, now,
                                  {"fast": fast, "slow": slow}, fired)

            if self._enabled["cache_collapse"] and cache_lookup_delta > 0:
                rate = cache_hit_delta / cache_lookup_delta
                fast, slow = self._shift("cache_hit", rate)
                th = self._th["cache_collapse"]
                firing = (warm and slow > th["min_baseline"]
                          and fast < th["frac"] * slow)
                self._update_rule("cache_collapse", firing, now,
                                  {"fast": fast, "slow": slow}, fired)

            if self._enabled["preempt_spike"]:
                th = self._th["preempt_spike"]
                if preempt_delta > 0:
                    self._preempt.append((now, preempt_delta))
                    self._preempt_sum += preempt_delta
                lo = now - th["window_s"]
                while self._preempt and self._preempt[0][0] < lo:
                    self._preempt_sum -= self._preempt.popleft()[1]
                firing = self._preempt_sum >= th["count"]
                self._update_rule("preempt_spike", firing, now,
                                  {"count": self._preempt_sum}, fired)

            if self._enabled["breaker_flap"]:
                th = self._th["breaker_flap"]
                if (self._last_level is not None
                        and overload_level != self._last_level):
                    self._flap_ts.append(now)
                self._last_level = overload_level
                lo = now - th["window_s"]
                while self._flap_ts and self._flap_ts[0] < lo:
                    self._flap_ts.popleft()
                firing = len(self._flap_ts) >= th["flaps"]
                self._update_rule("breaker_flap", firing, now,
                                  {"flaps": len(self._flap_ts)}, fired)

            if burn is not None:
                th = self._th["slo_burn"]
                worst = None
                for cls, metrics in burn.items():
                    for metric, (fast_b, slow_b) in metrics.items():
                        if (fast_b >= th["fast_burn"]
                                and slow_b >= th["slow_burn"]):
                            if worst is None or fast_b > worst[2]:
                                worst = (cls, metric, fast_b, slow_b)
                self._update_rule(
                    "slo_burn", worst is not None, now,
                    {} if worst is None else
                    {"class": worst[0], "metric": worst[1],
                     "fast_burn": worst[2], "slow_burn": worst[3]},
                    fired)
        return tuple(fired)

    def observe_request(self, *, now: float, ttft_s=None, itl_s=None,
                        finish_reason=None) -> tuple:
        """Fold one finished request's latencies and terminal state;
        returns the rules that activated on this call. Called from
        `_complete` with timestamps the request already carries."""
        fired: list = []
        with self._lock:
            self._n_req += 1
            warm = self._n_req >= self.warmup

            if self._enabled["latency_shift"]:
                th = self._th["latency_shift"]
                firing = False
                details: dict = {}
                for name, value in (("ttft", ttft_s), ("itl", itl_s)):
                    if value is None:
                        continue
                    fast, slow = self._shift(name, value)
                    if (warm and fast > th["min_s"]
                            and fast > th["factor"] * slow):
                        firing = True
                        details = {"metric": name, "fast": fast,
                                   "slow": slow}
                self._update_rule("latency_shift", firing, now,
                                  details, fired)

            if self._enabled["deadline_spike"]:
                th = self._th["deadline_spike"]
                if finish_reason == "deadline":
                    self._deadline_ts.append(now)
                lo = now - th["window_s"]
                while self._deadline_ts and self._deadline_ts[0] < lo:
                    self._deadline_ts.popleft()
                firing = len(self._deadline_ts) >= th["count"]
                self._update_rule("deadline_spike", firing, now,
                                  {"count": len(self._deadline_ts)},
                                  fired)
        return tuple(fired)

    def active_count(self, now: float | None = None) -> int:
        """Number of currently-open anomaly windows (the tail
        retention predicate's cheap per-finish read; one lock, no
        clock read when `now` is passed)."""
        with self._lock:
            if now is not None:
                self._check_wedged_locked(now)
            return len(self._open)

    # -- read path ----------------------------------------------------------

    def _check_wedged_locked(self, now: float) -> None:
        """Grade the `wedged` rule lazily: the scheduler cannot
        observe its own stall, so the read path (and the per-finish
        `active_count`) checks whether requests are pending with no
        iteration observed for `stall_s`."""
        if not self._enabled["wedged"]:
            return
        th = self._th["wedged"]
        firing = (self._last_iter_ts is not None
                  and self._last_pending > 0
                  and now - self._last_iter_ts > th["stall_s"])
        dummy: list = []
        self._update_rule("wedged", firing, now,
                          {"stalled_s": (0.0 if self._last_iter_ts is None
                                         else now - self._last_iter_ts),
                           "pending": self._last_pending}, dummy)

    def active(self, now: float | None = None) -> tuple:
        """Names of the currently-open anomaly windows."""
        now = self._clock() if now is None else now
        with self._lock:
            self._check_wedged_locked(now)
            return tuple(sorted(self._open))

    def events(self, n: int | None = None) -> list[dict]:
        """The bounded anomaly-event ring, oldest first (`n` bounds
        from the newest end; n <= 0 means none, the /stats rule)."""
        if n is not None and n <= 0:
            return []
        with self._lock:
            evs = [dict(e, details=dict(e["details"]))
                   for e in self._events]
        return evs if n is None else evs[-n:]

    def stats(self, events: int = 8) -> dict:
        """The /stats `anomaly` block (scrape path)."""
        now = self._clock()
        with self._lock:
            self._check_wedged_locked(now)
            return {
                "active": sorted(self._open),
                "fired_total": dict(self.fired_total),
                "signals": {name: {"fast": pair[0], "slow": pair[1]}
                            for name, pair in self._ew.items()
                            if pair[0] is not None},
                "events": [dict(e, details=dict(e["details"]))
                           for e in list(self._events)[-events:]],
            }


def resolve_anomaly(anomaly, anomaly_config: str = ""
                    ) -> AnomalyWatchdog | None:
    """Same resolution contract as `resolve_fault_plan` (shared
    `_resolve_config` chain): a ready AnomalyWatchdog, a config dict
    / JSON string / file path, None (falling back to
    `InferConfig.anomaly_config`), or False. None means the watchdog
    is fully disabled (no rules, no events, byte-identical serving)."""
    return _resolve_config(anomaly, anomaly_config, AnomalyWatchdog,
                           "anomaly config")


def merge_anomaly_stats(stats_list) -> dict | None:
    """Fleet-wide anomaly view (`ReplicatedRouter.anomaly_stats`):
    `fired_total` counts sum per rule, `active` unions, per-replica
    events are tagged and interleaved by start time (counts sum,
    ratios would recompute — none exist here)."""
    stats_list = [s for s in stats_list if s]
    if not stats_list:
        return None
    out: dict = {"active": set(), "fired_total": {}, "events": []}
    for idx, st in enumerate(stats_list):
        out["active"].update(st.get("active", ()))
        for rule, n in st.get("fired_total", {}).items():
            out["fired_total"][rule] = out["fired_total"].get(rule, 0) + n
        for ev in st.get("events", ()):
            out["events"].append(dict(ev, replica=ev.get("replica", idx)))
    out["active"] = sorted(out["active"])
    out["events"].sort(key=lambda e: e["start"])
    return out
