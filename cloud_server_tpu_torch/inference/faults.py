"""Failure-domain layer: deterministic fault injection and overload
brownout for the serving stack.

A fleet that is supposed to survive replica failures needs two things
this repo historically lacked: a way to MAKE failures happen on demand
(so every recovery path is provable, not aspirational) and a policy for
degrading gracefully when the failure mode is plain overload rather
than a crash. Both live here, stdlib-only, and both follow the QoS/SLO
module rules: pure host-side state consulted at points the schedulers
already own, zero added dispatches or syncs. A copy of the reference's
`inference/faults.py`.

Deterministic fault injection
-----------------------------

`FaultPlan` arms named SITES the servers thread through their hot
paths (each call site guarded by ``if self._faults is not None`` so an
unconfigured server runs the byte-identical pre-fault code):

  * ``submit_reject``    — submit() raises `InjectedFault` (both
                           servers): exercises router failover on
                           submit and client 503 handling.
  * ``dispatch``         — the next dispatch path raises
                           `InjectedFault` before launching device
                           work (paged: `_mixed_dispatch` /
                           `_decode_dispatch` / `_run_one_chunk`;
                           contiguous: `_step_locked`): the scheduler
                           thread crashes exactly the way a poisoned
                           device program would, driving
                           `serve_forever` -> `_fail_all` -> router
                           retry.
  * ``iteration_stall``  — step() sleeps `stall_ms` before the sweep
                           (both servers): simulates a slow host or a
                           long device round, the input the brownout
                           detector and SLO burn rates key on.
  * ``wedge``            — step() blocks (holding `_step_lock`) until
                           the server's stop event is set (paged
                           only): the "scheduler wedged inside a
                           dispatch" shape `_fail_all`'s bounded
                           lock acquire exists for.
  * ``alloc_famine``     — the next admission pretends the page pool
                           is empty (paged only): exercises the
                           famine-retry / preemption paths without
                           shrinking the pool.
  * ``migrate_export``   — the next migration export raises
                           `InjectedFault` before snapshotting (paged
                           only): exercises the non-migratable
                           fallback (the request fails fast with
                           today's `retriable: false` body).
  * ``migrate_import``   — the next migration import raises
                           `InjectedFault` on the destination (paged
                           only): exercises the router's
                           import-failure path (failure stands on the
                           original handle).

Plans are SEEDED: a spec may fire probabilistically (``p < 1``) and
the draw sequence comes from one `random.Random(seed)`, so a given
plan against a given request sequence reproduces exactly. Config is a
JSON object (inline string, dict, or file path) via the server
``faults=`` kwarg / `InferConfig.fault_plan` / CLI ``--fault-plan``::

    {"seed": 0,
     "faults": [
       {"site": "dispatch", "after": 10, "count": 1},
       {"site": "submit_reject", "after": 0, "count": 0, "p": 0.01},
       {"site": "iteration_stall", "stall_ms": 250, "count": 5}]}

``after`` skips the first N hits of the site, ``count`` bounds how
many times the spec fires (<= 0 = unlimited), ``p`` is the per-hit
probability once eligible. Tests can also `plan.arm(site, ...)` at
runtime for exact-moment injection.

Overload brownout
-----------------

`OverloadDetector` watches the per-iteration signals the flight
recorder already owns — pending-queue head age, token-budget
utilization, `host_gap_frac` — as EWMAs, and grades overload into
levels: 0 (healthy), 1 (one signal over threshold), 2 (two or more).
The paged server feeds it from `_record_iteration` (one `observe()`
per busy iteration, plain float math) and consults it at submit:
while the level is high, admissions whose QoS priority class is in
the level's shed set (best_effort at level 1; batch too at level 2)
are refused with `BrownoutShedError` — an HTTP 429 carrying the PR 5
`Retry-After` shape — so interactive traffic keeps its SLO while the
fleet browns out instead of collapsing. The computed retry hint
carries deterministic JITTER (seeded, ``retry_after_s`` base plus up
to ``jitter_frac`` of it) so a synchronized cohort of shed clients
does not thundering-herd the recovering replica. Config (server
``brownout=`` / `InferConfig.brownout_config` / ``--brownout``)::

    {"pending_age_s": 2.0, "budget_utilization": 0.95,
     "host_gap_frac": 0.5, "alpha": 0.3, "hold_s": 2.0,
     "retry_after_s": 1.0, "jitter_frac": 0.5, "seed": 0,
     "shed": {"1": ["best_effort"], "2": ["best_effort", "batch"]}}

Brownout requires a QoS registry (shed sets are priority classes);
without one every request is anonymous and nothing is shed.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time

# imported like qos.py does (the servers import this module lazily, so
# there is no cycle); keeps BrownoutShedError on the HTTP 429 path
from cloud_server_tpu_torch.inference.server import QueueFullError

# The named injection sites the servers thread. Order is documentation
# only; membership is validated at spec construction so a typo'd site
# fails the plan parse, not silently never-fires.
SITES = ("submit_reject", "dispatch", "iteration_stall", "wedge",
         "alloc_famine", "migrate_export", "migrate_import")


class InjectedFault(RuntimeError):
    """A deliberately injected failure (never raised without an armed
    FaultPlan). Subclasses RuntimeError so every layer above treats it
    exactly like a real scheduler/server error — which is the point."""


class BrownoutShedError(QueueFullError):
    """Overload brownout refused this admission: the replica is
    shedding the request's priority class to protect higher classes'
    SLOs. Retryable — the HTTP front-end maps it to a 429 whose
    `Retry-After` header and structured body carry the detector's
    jittered `retry_after_s` (PR 5 shape)."""

    def __init__(self, message: str, *, tenant: str | None,
                 priority_class: str, retry_after_s: float):
        super().__init__(message)
        self.tenant = tenant
        self.priority_class = priority_class
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed fault: fire at `site`, skipping the first `after`
    hits, at most `count` times (<= 0 = unlimited), each eligible hit
    firing with probability `p`. `stall_ms` is the sleep for
    `iteration_stall` (ignored elsewhere)."""

    site: str
    after: int = 0
    count: int = 1
    p: float = 1.0
    stall_ms: float = 0.0

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; one of {SITES}")
        if self.after < 0:
            raise ValueError("fault 'after' must be >= 0")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError("fault 'p' must be in [0, 1]")
        if self.stall_ms < 0:
            raise ValueError("fault 'stall_ms' must be >= 0")


class FaultPlan:
    """A seeded set of armed fault sites. `fire()` (and the `check` /
    `maybe_stall` / `maybe_wedge` conveniences over it) is the only
    hot-path surface: one lock-guarded counter bump plus a few int
    compares per guarded site hit — and call sites only exist behind
    ``if self._faults is not None``, so the unconfigured servers pay
    literally nothing."""

    def __init__(self, spec: dict | None = None):
        spec = dict(spec or {})
        seed = int(spec.pop("seed", 0))
        raw = list(spec.pop("faults", ()))
        if spec:
            raise ValueError(
                f"unknown fault-plan keys: {sorted(spec)}")
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._specs: dict[str, list[list]] = {s: [] for s in SITES}
        # per-site lifetime hit / fired counts (the /stats + test
        # observability surface)
        self.hits: dict[str, int] = {s: 0 for s in SITES}
        self.fired: dict[str, int] = {s: 0 for s in SITES}
        for entry in raw:
            if not isinstance(entry, dict):
                raise ValueError("each fault must be a JSON object")
            self.arm(**entry)

    def arm(self, site: str, *, after: int = 0, count: int = 1,
            p: float = 1.0, stall_ms: float = 0.0) -> FaultSpec:
        """Arm one spec (config entries and tests share this); the
        spec's `after` window counts from the site's CURRENT hit
        count, so a test can arm "the very next dispatch" on a live
        server deterministically."""
        fs = FaultSpec(site=site, after=after, count=count, p=p,
                       stall_ms=stall_ms)
        with self._lock:
            # [spec, first-eligible hit index, times fired]
            self._specs[site].append([fs, self.hits[site] + after, 0])
        return fs

    def fire(self, site: str) -> FaultSpec | None:
        """Count one hit of `site`; return the armed spec that fires
        on this hit (first eligible wins), else None. Deterministic
        given the plan seed and the sequence of fire() calls."""
        with self._lock:
            idx = self.hits[site]
            self.hits[site] = idx + 1
            for rec in self._specs[site]:
                fs, start, used = rec
                if idx < start:
                    continue
                if fs.count > 0 and used >= fs.count:
                    continue
                if fs.p < 1.0 and self._rng.random() >= fs.p:
                    continue
                rec[2] = used + 1
                self.fired[site] += 1
                return fs
        return None

    def check(self, site: str) -> None:
        """fire() and raise `InjectedFault` when armed — the raising
        sites (submit_reject, dispatch)."""
        if self.fire(site) is not None:
            raise InjectedFault(
                f"injected fault at site {site!r}")

    # -- blocking sites (sleeping/waiting is exactly their injected
    # behavior) ---------------------------------------------------------------

    def maybe_stall(self, site: str = "iteration_stall") -> None:
        """Sleep `stall_ms` when the stall site fires (the scheduler
        thread pays it, exactly like a slow host/device round)."""
        fs = self.fire(site)
        if fs is not None and fs.stall_ms > 0:
            time.sleep(fs.stall_ms / 1e3)

    def maybe_wedge(self, stop_event: threading.Event,
                    site: str = "wedge") -> None:
        """Block the calling (scheduler) thread until the server's
        stop event is set, simulating a wedge inside a dispatch. The
        thread still holds `_step_lock` while wedged — which is the
        scenario `_fail_all`'s bounded acquire and the
        `unserialized_teardown` counter exist for."""
        if self.fire(site) is not None:
            stop_event.wait()

    def stats(self) -> dict:
        """Per-site lifetime hit/fired counts (scrape path)."""
        with self._lock:
            return {"hits": dict(self.hits), "fired": dict(self.fired)}


def _resolve_config(value, fallback: str, cls, what: str):
    """The shared resolution chain `faults=` and `brownout=` both
    follow (one copy, so the two contracts cannot drift): a ready
    `cls` instance passes through; False force-disables regardless of
    the config fallback; None falls back to the InferConfig string; a
    dict / inline-JSON string / file path parses; ""/None resolves to
    None (feature fully disabled)."""
    if value is False:
        return None
    if isinstance(value, cls):
        return value
    spec = value if value is not None else (fallback or None)
    if spec is None or spec == "":
        return None
    if isinstance(spec, str):
        text = spec
        if not text.lstrip().startswith("{"):
            with open(text) as f:  # a path, not inline JSON
                text = f.read()
        spec = json.loads(text)
    if not isinstance(spec, dict):
        raise ValueError(f"{what} must be a JSON object")
    return cls(spec)


def resolve_fault_plan(faults, fault_plan_config: str = ""
                       ) -> FaultPlan | None:
    """The one constructor both servers use: `faults` may be a ready
    FaultPlan, a config dict, a JSON string, a file path, None
    (falling back to `InferConfig.fault_plan`), or False — injection
    force-disabled regardless of the config fallback. Returns None
    (no plan: every guarded call site short-circuits, byte-identical
    pre-fault scheduling) when nothing is configured."""
    return _resolve_config(faults, fault_plan_config, FaultPlan,
                           "fault plan")


# ---------------------------------------------------------------------------
# Overload brownout
# ---------------------------------------------------------------------------


# Signals and their default thresholds — all numbers the flight
# recorder already carries per busy iteration, so the detector adds
# zero measurement cost of its own.
_SIGNAL_DEFAULTS = {
    "pending_age_s": 2.0,        # age of the pending-queue head
    "budget_utilization": 0.95,  # mixed token-budget saturation
    "host_gap_frac": 0.5,        # host share of the iteration
}

DEFAULT_SHED: dict[int, tuple[str, ...]] = {
    1: ("best_effort",),
    2: ("best_effort", "batch"),
}


class OverloadDetector:
    """EWMA overload grading over per-iteration scheduler signals.

    `observe()` runs once per busy iteration on the scheduler thread
    (plain float math under a small lock); `level()` / `shed()` run on
    submit threads. Levels: 0 healthy, 1 = one signal EWMA over its
    threshold (shed best_effort), 2 = two or more (shed batch too).
    A risen level HOLDS for `hold_s` after the signals recover
    (hysteresis — admission must not flap open/shut every iteration).

    `retry_hint()` is the Retry-After the shed 429s carry:
    ``retry_after_s * level`` plus a seeded uniform jitter of up to
    ``jitter_frac`` of that base, so shed clients that all woke at the
    same moment re-arrive spread out instead of as a second stampede
    at the recovering replica."""

    def __init__(self, config: dict | None = None, *,
                 clock=time.monotonic):
        cfg = dict(config or {})
        self._clock = clock
        self._thresholds = {}
        for name, default in _SIGNAL_DEFAULTS.items():
            self._thresholds[name] = float(cfg.pop(name, default))
        self.alpha = float(cfg.pop("alpha", 0.3))
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError("brownout alpha must be in (0, 1]")
        self.hold_s = float(cfg.pop("hold_s", 2.0))
        self.retry_after_s = float(cfg.pop("retry_after_s", 1.0))
        self.jitter_frac = float(cfg.pop("jitter_frac", 0.5))
        if self.jitter_frac < 0:
            raise ValueError("brownout jitter_frac must be >= 0")
        self._rng = random.Random(int(cfg.pop("seed", 0)))
        shed = cfg.pop("shed", None)
        if shed is None:
            self._shed = dict(DEFAULT_SHED)
        else:
            self._shed = {int(lvl): tuple(classes)
                          for lvl, classes in dict(shed).items()}
        if cfg:
            raise ValueError(
                f"unknown brownout config keys: {sorted(cfg)}")
        self._lock = threading.Lock()
        self._ewma = {name: 0.0 for name in _SIGNAL_DEFAULTS}
        self._level = 0
        self._level_ts = clock()
        self._observe_ts = self._level_ts
        # per-class lifetime shed counts (scrape-path mirror source)
        self.shed_total: dict[str, int] = {}

    def observe(self, *, pending_age_s: float = 0.0,
                budget_utilization: float = 0.0,
                host_gap_frac: float = 0.0) -> int:
        """Fold one busy iteration's signals in; returns the current
        level. Called by the scheduler once per busy iteration; one
        monotonic clock read (the detector keeps its OWN timebase so
        hysteresis and staleness compare like with like)."""
        now = self._clock()
        a = self.alpha
        with self._lock:
            ew = self._ewma
            ew["pending_age_s"] += a * (pending_age_s
                                        - ew["pending_age_s"])
            ew["budget_utilization"] += a * (budget_utilization
                                             - ew["budget_utilization"])
            ew["host_gap_frac"] += a * (host_gap_frac
                                        - ew["host_gap_frac"])
            crossed = sum(1 for name, th in self._thresholds.items()
                          if ew[name] > th)
            raw = 2 if crossed >= 2 else (1 if crossed else 0)
            self._observe_ts = now
            if raw >= self._level:
                self._level = raw
                self._level_ts = now
            elif now - self._level_ts >= self.hold_s:
                # hysteresis: only step DOWN after hold_s of recovery
                self._level = raw
                self._level_ts = now
            return self._level

    def _effective_locked(self, now: float) -> int:
        """Current level, decayed to 0 when no busy iteration has
        observed for hold_s — an idle scheduler is by definition not
        overloaded, and a latched shed level must never refuse the
        very traffic whose admission would prove recovery."""
        if self._level and now - self._observe_ts > self.hold_s:
            self._level = 0
            self._level_ts = now
        return self._level

    def level(self) -> int:
        with self._lock:
            return self._effective_locked(self._clock())

    def shed(self, priority_class: str | None) -> bool:
        """Should an admission of `priority_class` be refused right
        now? True increments the class's shed counter (the caller
        raises BrownoutShedError next)."""
        with self._lock:
            lvl = self._effective_locked(self._clock())
            classes = self._shed.get(lvl, ())
            if priority_class is None or priority_class not in classes:
                return False
            self.shed_total[priority_class] = (
                self.shed_total.get(priority_class, 0) + 1)
            return True

    def retry_hint(self) -> float:
        """Jittered Retry-After seconds for a shed admission."""
        with self._lock:
            base = self.retry_after_s * max(self._level, 1)
            return base + self._rng.random() * self.jitter_frac * base

    def stats(self) -> dict:
        """The /stats `brownout` block (scrape path)."""
        with self._lock:
            return {"level": self._effective_locked(self._clock()),
                    "signals": dict(self._ewma),
                    "thresholds": dict(self._thresholds),
                    "shed_total": dict(self.shed_total)}


def resolve_brownout(brownout, brownout_config: str = ""
                     ) -> OverloadDetector | None:
    """Same resolution contract as `resolve_fault_plan` (shared
    `_resolve_config` chain): a ready OverloadDetector, a config dict
    / JSON string / file path, None (falling back to
    `InferConfig.brownout_config`), or False. None means brownout
    fully disabled (no detector, no shed checks)."""
    return _resolve_config(brownout, brownout_config, OverloadDetector,
                           "brownout config")
