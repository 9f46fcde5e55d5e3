"""SLO-burn-rate autoscaler: the policy loop over ReplicatedRouter.

Closes the loop the SLO engine left open: ``slo_report()`` already
computes SRE-workbook multi-window burn rates per priority class, and
the router already has runtime fleet mutation
(``add_replica``/``remove_replica``). This module is ONLY the policy
in between:

  * Scale UP when any watched (class, metric) pair burns its error
    budget on BOTH the fast and the slow window (the multi-window
    rule: fast-only is noise, slow-only is already lost) — or when
    pending depth per replica crosses the queue backstop (works with
    no SLO config at all).
  * Scale DOWN only when every watched pair is comfortably under
    budget on both windows AND the queue is near-empty; the victim
    is evacuated with ``remove_replica(migrate=True)`` — scale-down
    loses zero requests (regression-tested).
  * Hysteresis/cooldown: at most one action per ``hold_s`` window
    (anomaly.py's hold_s idiom), so a burst edge cannot flap the
    fleet.
  * Role awareness (disaggregated fleets): ttft/queue_wait burns add
    prefill capacity, itl burns add decode capacity; anything else —
    or a colocated fleet — adds colocated replicas.

The ``cloud_server_autoscaler_*`` metric families are registered
EAGERLY into the router's registry at construction (docs drift
check), so they exist whether or not a scale event ever fires. An
unconfigured deployment never constructs this class — zero added
work.

Replica lifecycle is delegated: ``spawn(role) -> replica | None``
supplies capacity (a warm pool, a fresh construction, a remote
allocation); ``release(replica)`` takes removed replicas (default:
``replica.stop()``). The autoscaler never builds servers itself —
that keeps it free of torch (stdlib only).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import logging

_log = logging.getLogger(__name__)

_ROLE_PREFILL_METRICS = ("ttft", "queue_wait")
_ROLE_DECODE_METRICS = ("itl",)


@dataclass
class AutoscalerConfig:
    """Knobs. Burn thresholds are
    in error-budget-burn units: 1.0 = the budget exhausts exactly at
    the objective horizon."""

    min_replicas: int = 1
    max_replicas: int = 4
    classes: tuple = ("interactive", "default")
    metrics: tuple = ("ttft", "e2e", "itl", "queue_wait")
    up_fast_burn: float = 2.0
    up_slow_burn: float = 1.0
    down_fast_burn: float = 0.5
    down_slow_burn: float = 0.5
    pending_high: float = 8.0
    pending_low: float = 1.0
    hold_s: float = 10.0
    poll_s: float = 1.0
    drain_timeout_s: float = 30.0

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                "need 1 <= min_replicas <= max_replicas "
                f"(got {self.min_replicas}..{self.max_replicas})")
        if self.hold_s < 0 or self.poll_s <= 0:
            raise ValueError("hold_s must be >= 0, poll_s > 0")


@dataclass
class ScaleEvent:
    t: float
    action: str
    role: str
    replicas: int
    reason: str = ""

    def to_json(self) -> dict:
        return {"t": round(self.t, 3), "action": self.action,
                "role": self.role, "replicas": self.replicas,
                "reason": self.reason}


class SLOBurnAutoscaler:
    """One policy loop per router. Drive it with ``step()`` from your
    own loop (benches, tests) or ``start()`` a daemon polling at
    ``poll_s``."""

    def __init__(self, router, spawn, *, release=None,
                 config: AutoscalerConfig | None = None,
                 clock=time.monotonic):
        self.router = router
        self.spawn = spawn
        self.release = release if release is not None else (
            lambda r: r.stop())
        self.cfg = config or AutoscalerConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._last_action_at: float | None = None
        self.events: list[ScaleEvent] = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # eager registration into the ROUTER's registry: the families
        # ride metrics_snapshot()/ /metrics with the rest of the fleet
        # plumbing, and exist before any scale event (docs drift check)
        reg = router._registry
        self._m_up = reg.counter(
            "autoscaler_scale_up_total",
            "Replicas added by the SLO-burn autoscaler")
        self._m_down = reg.counter(
            "autoscaler_scale_down_total",
            "Replicas drained (migrate=True) and removed by the "
            "autoscaler")
        self._m_blocked = reg.counter(
            "autoscaler_scale_blocked_total",
            "Scale decisions that could not act (spawn pool empty, "
            "min/max clamp, drain timeout)")
        self._g_replicas = reg.gauge(
            "autoscaler_replicas",
            "Attached replicas under autoscaler control")
        self._g_burn_fast = reg.gauge(
            "autoscaler_burn_fast",
            "Worst watched fast-window SLO burn rate at the last "
            "evaluation")
        self._g_burn_slow = reg.gauge(
            "autoscaler_burn_slow",
            "Worst watched slow-window SLO burn rate at the last "
            "evaluation")
        self._g_pending = reg.gauge(
            "autoscaler_pending_per_replica",
            "Fleet pending depth per attached replica at the last "
            "evaluation")
        self._g_replicas.set(len(router.attached_indices()))
        # the HTTP frontend's scenario hook: /stats and /autoscaler
        # surface this loop's view when the router carries one
        router.autoscaler = self

    # -- decision (no I/O, no logging, no sleeps) -----------------------

    def _burn_signal(self, report) -> tuple[float, float, str, str]:
        """Worst watched (fast, slow) burn pair and the (class,
        metric) that produced it. (0, 0) when nothing is tracked."""
        worst = (0.0, 0.0, "", "")
        if not report or not report.get("classes"):
            return worst
        wins = report["windows_s"]
        fast_k, slow_k = f"{wins[0]:g}", f"{wins[-1]:g}"
        for cname in self.cfg.classes:
            centry = report["classes"].get(cname)
            if centry is None:
                continue
            for metric in self.cfg.metrics:
                m = centry["metrics"].get(metric)
                if m is None:
                    continue
                fast = m["windows"][fast_k]["burn_rate"]
                slow = m["windows"][slow_k]["burn_rate"]
                # rank by the smaller of the pair: the multi-window
                # rule fires only when BOTH windows burn, so the
                # binding constraint is min(fast, slow)
                if min(fast, slow) > min(worst[0], worst[1]):
                    worst = (fast, slow, cname, metric)
        return worst

    def evaluate(self, now: float) -> tuple[str, str, str]:
        """(action, role, reason) for this instant: pure decision,
        no actuation, no side effects beyond the mirror gauges."""
        cfg = self.cfg
        n = len(self.router.attached_indices())
        pending = self.router.num_pending
        per_replica = pending / max(1, n)
        fast, slow, cname, metric = self._burn_signal(
            self.router.slo_report())
        self._g_replicas.set(n)
        self._g_burn_fast.set(fast)
        self._g_burn_slow.set(slow)
        self._g_pending.set(per_replica)
        if (self._last_action_at is not None
                and now - self._last_action_at < cfg.hold_s):
            return "hold", "colocated", "cooldown"
        burn_up = fast >= cfg.up_fast_burn and slow >= cfg.up_slow_burn
        queue_up = per_replica >= cfg.pending_high
        if (burn_up or queue_up) and n < cfg.max_replicas:
            role = self._role_for(metric if burn_up else "queue_wait")
            reason = (f"burn {cname}/{metric} fast={fast:.2f} "
                      f"slow={slow:.2f}" if burn_up
                      else f"pending/replica={per_replica:.1f}")
            return "up", role, reason
        if (n > cfg.min_replicas
                and fast <= cfg.down_fast_burn
                and slow <= cfg.down_slow_burn
                and per_replica <= cfg.pending_low):
            return ("down", "colocated",
                    f"idle: fast={fast:.2f} slow={slow:.2f} "
                    f"pending/replica={per_replica:.1f}")
        return "hold", "colocated", ""

    def _role_for(self, metric: str) -> str:
        """Which capacity a burn on ``metric`` asks for, on a
        disaggregated fleet; colocated fleets always add colocated."""
        if not getattr(self.router, "_disagg", False):
            return "colocated"
        if metric in _ROLE_PREFILL_METRICS:
            return "prefill"
        if metric in _ROLE_DECODE_METRICS:
            return "decode"
        return "colocated"

    # -- actuation -------------------------------------------------------

    def step(self, now: float | None = None) -> str:
        """One poll: evaluate and act. Returns the action taken
        ("up"/"down"/"hold"/"blocked")."""
        now = self._clock() if now is None else now
        with self._lock:
            action, role, reason = self.evaluate(now)
            if action == "up":
                return self._scale_up(now, role, reason)
            if action == "down":
                return self._scale_down(now, reason)
            return action

    def _record(self, now: float, action: str, role: str,
                reason: str) -> None:
        ev = ScaleEvent(t=now, action=action, role=role,
                        replicas=len(self.router.attached_indices()),
                        reason=reason)
        self.events.append(ev)
        _log.info("autoscaler %s role=%s replicas=%d (%s)",
                  action, role, ev.replicas, reason)

    def _scale_up(self, now: float, role: str, reason: str) -> str:
        replica = self.spawn(role)
        if replica is None:
            self._m_blocked.inc()
            self._record(now, "blocked", role,
                         f"spawn pool empty; wanted up: {reason}")
            return "blocked"
        self.router.add_replica(replica, role=role)
        self._last_action_at = now
        self._m_up.inc()
        self._g_replicas.set(len(self.router.attached_indices()))
        self._record(now, "up", role, reason)
        return "up"

    def _scale_down(self, now: float, reason: str) -> str:
        # victim: the least-loaded attached replica — cheapest
        # evacuation, and the affinity loss is smallest
        idxs = self.router.attached_indices()
        victim = min(
            idxs, key=lambda i: (self.router.replicas[i].num_active
                                 + self.router.replicas[i].num_pending))
        role = self.router.roles[victim]
        replica = self.router.remove_replica(
            victim, migrate=True, timeout=self.cfg.drain_timeout_s)
        if replica is None:
            self._m_blocked.inc()
            self._record(now, "blocked", role,
                         f"drain timeout on replica {victim}")
            return "blocked"
        self._last_action_at = now
        self._m_down.inc()
        self._g_replicas.set(len(self.router.attached_indices()))
        self._record(now, "down", role, reason)
        try:
            self.release(replica)
        except Exception:  # noqa: BLE001 — release is caller policy
            _log.exception("autoscaler release hook failed")
        return "down"

    # -- background loop -------------------------------------------------

    def start(self) -> "SLOBurnAutoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.cfg.poll_s):
                try:
                    self.step()
                except Exception:  # noqa: BLE001 — keep polling
                    _log.exception("autoscaler step failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="slo-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # -- read path -------------------------------------------------------

    def stats(self) -> dict:
        cfg = self.cfg
        return {
            "replicas": len(self.router.attached_indices()),
            "min_replicas": cfg.min_replicas,
            "max_replicas": cfg.max_replicas,
            "hold_s": cfg.hold_s,
            "scale_up_total": int(self._m_up.value),
            "scale_down_total": int(self._m_down.value),
            "blocked_total": int(self._m_blocked.value),
            "burn_fast": self._g_burn_fast.value,
            "burn_slow": self._g_burn_slow.value,
            "pending_per_replica": self._g_pending.value,
            "events": [e.to_json() for e in self.events[-32:]]}
