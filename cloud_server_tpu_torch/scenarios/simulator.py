"""Discrete-event simulator of the mixed scheduler + router.

A host-only model of the serving stack for policy search at scales
a live test cannot reach (100k+ concurrent sessions simulate in
seconds): token-budget iterations, chunked prefill, weighted (DRR-
style) admission across QoS classes, page-pool preemption, a radix
prefix-cache model for shared system prompts, and the router's
least-loaded + tenant-affinity placement.

Calibration: iteration wall time is NOT modeled from first
principles — ``CostModel.fit`` regresses it from the flight
recorder's measured per-iteration records (``duration_ms`` vs
``tokens_scheduled``), so the sim inherits the live stack's real
per-token and fixed costs (on the card, `chip_smoke.py`'s elastic
phase reads the simulated attainment beside the live one).

Latency accounting mirrors serving_metrics: ``queue_wait`` =
submit -> admission, ``ttft`` = submit -> first emitted token,
``itl`` = gap between consecutive emitted tokens, ``e2e`` =
submit -> finish. Observations feed a real ``slo.SLOTracker`` on a
VIRTUAL clock, so sim attainment/burn reports are directly
comparable with a live ``slo_report()``.

Pure host-side policy: stdlib only — no torch, no numpy.
"""

from __future__ import annotations

import heapq
import zlib
from dataclasses import dataclass

from cloud_server_tpu_torch.inference.slo import SLOTracker


@dataclass
class CostModel:
    """Per-iteration wall cost: ``fixed_ms + per_token_ms * tokens``.

    Fit from flight-recorder records so simulated time reflects the
    measured stack, not a guess."""

    fixed_ms: float = 2.0
    per_token_ms: float = 0.05

    def iteration_ms(self, tokens: int) -> float:
        return self.fixed_ms + self.per_token_ms * max(0, tokens)

    @classmethod
    def fit(cls, records, *, default: "CostModel | None" = None
            ) -> "CostModel":
        """Least-squares fit of ``duration_ms`` against
        ``tokens_scheduled`` over busy flight records. Falls back to
        ``default`` when the window has no spread to regress on."""
        pts = [(float(r["tokens_scheduled"]), float(r["duration_ms"]))
               for r in records
               if r.get("tokens_scheduled", 0) > 0
               and r.get("duration_ms") is not None]
        base = default or cls()
        if len(pts) < 2:
            return base
        n = len(pts)
        mx = sum(x for x, _ in pts) / n
        my = sum(y for _, y in pts) / n
        var = sum((x - mx) ** 2 for x, _ in pts)
        if var <= 1e-9:
            # no spread: keep the measured mean as the fixed cost
            return cls(fixed_ms=max(0.0, my), per_token_ms=0.0)
        slope = sum((x - mx) * (y - my) for x, y in pts) / var
        slope = max(0.0, slope)
        fixed = max(0.0, my - slope * mx)
        return cls(fixed_ms=fixed, per_token_ms=slope)


class _SimReq:
    __slots__ = ("event", "cls", "arrival", "admit_t", "prefill_left",
                 "decoded", "first_tok_t", "last_tok_t", "itl_s",
                 "preempted")

    def __init__(self, event, cls: str, arrival: float):
        self.event = event
        self.cls = cls
        self.arrival = arrival
        self.admit_t: float | None = None
        self.prefill_left = len(event.prompt)
        self.decoded = 0
        self.first_tok_t: float | None = None
        self.last_tok_t: float | None = None
        self.itl_s: list[float] = []
        self.preempted = 0

    def pages_needed(self, page_size: int) -> int:
        ctx = len(self.event.prompt) + self.decoded
        return -(-max(1, ctx) // page_size)


class SimReplica:
    """One simulated mixed-scheduler server. Each ``step()`` is one
    scheduler iteration: every decoding slot emits one token, the
    leftover token budget prefills admitted-but-incomplete requests
    in ``prefill_chunk`` quanta, and free slots admit pending work in
    weighted class order (the DRR shape of qos.py's admission)."""

    def __init__(self, *, max_slots: int = 8, budget: int = 256,
                 chunk: int = 64, page_size: int = 16,
                 pages: int | None = None,
                 class_weights: dict[str, float] | None = None):
        self.max_slots = int(max_slots)
        self.budget = int(budget)
        self.chunk = int(chunk)
        self.page_size = int(page_size)
        self.pages = pages  # None = unbounded pool (no preemption)
        self.class_weights = dict(class_weights or {})
        self.t = 0.0                      # this replica's clock
        self.active: list[_SimReq] = []   # admission order
        self.pending: dict[str, list[_SimReq]] = {}
        self._credit: dict[str, float] = {}
        self._seen_prefixes: set = set()  # radix prefix-cache model
        self.preemptions = 0
        self.iterations = 0

    # -- load view (the router model's placement inputs) ----------------

    @property
    def num_active(self) -> int:
        return len(self.active)

    @property
    def num_pending(self) -> int:
        return sum(len(q) for q in self.pending.values())

    @property
    def busy(self) -> bool:
        return bool(self.active or self.num_pending)

    def submit(self, req: _SimReq, now: float) -> None:
        self.t = max(self.t, now)
        self.pending.setdefault(req.cls, []).append(req)

    def _pages_in_use(self) -> int:
        return sum(r.pages_needed(self.page_size) for r in self.active)

    def _admit_order(self) -> list[str]:
        """Weighted class order: classes spend credit proportional to
        their weight before the round resets — heavier classes admit
        first and more often, the DRR admission shape."""
        cands = [c for c, q in self.pending.items() if q]
        if not cands:
            return []
        if all(self._credit.get(c, 0.0) <= 0.0 for c in cands):
            for c in cands:
                self._credit[c] = self.class_weights.get(c, 1.0)
        return sorted(cands, key=lambda c: -self._credit.get(c, 0.0))

    def _admit(self, now: float) -> None:
        while len(self.active) < self.max_slots:
            order = self._admit_order()
            if not order:
                return
            cls = order[0]
            req = self.pending[cls].pop(0)
            self._credit[cls] = self._credit.get(cls, 1.0) - 1.0
            req.admit_t = now if req.admit_t is None else req.admit_t
            e = req.event
            if e.prefix_len > 0:
                key = (e.tenant, e.prefix_len)
                if key in self._seen_prefixes:
                    # shared system prefix already resident: the radix
                    # cache skips recomputing it
                    req.prefill_left = min(
                        req.prefill_left, len(e.prompt) - e.prefix_len)
                else:
                    self._seen_prefixes.add(key)
            self.active.append(req)

    def step(self, cost: CostModel) -> tuple[float, list[_SimReq]]:
        """One iteration. Returns (duration_s, finished requests);
        advances this replica's clock to the iteration end."""
        start = self.t
        self._admit(start)
        decoders = [r for r in self.active if r.prefill_left == 0]
        tokens = len(decoders)
        budget_left = max(0, self.budget - tokens)
        # chunked prefill in admission order within the leftover budget
        for r in self.active:
            if budget_left <= 0:
                break
            if r.prefill_left > 0:
                take = min(self.chunk, r.prefill_left, budget_left)
                r.prefill_left -= take
                tokens += take
                budget_left -= take
        # page-pool pressure: preempt the youngest admission when the
        # pool cannot hold every active context (the live scheduler's
        # _preempt_youngest; the victim re-queues and re-prefills)
        if self.pages is not None:
            # a lone oversized context is allowed to run over the pool
            # (the live server fails it at submit; the sim just serves
            # it) — preemption ping-pong must terminate
            while len(self.active) > 1 and (self._pages_in_use()
                                            > self.pages):
                victim = self.active.pop()
                victim.prefill_left = len(victim.event.prompt)
                victim.decoded = 0
                victim.preempted += 1
                self.preemptions += 1
                self.pending.setdefault(victim.cls, []).insert(0, victim)
        dt = cost.iteration_ms(tokens) / 1e3
        end = start + dt
        finished: list[_SimReq] = []
        for r in decoders:
            if r not in self.active:
                continue  # preempted this iteration
            r.decoded += 1
            if r.first_tok_t is None:
                r.first_tok_t = end
            else:
                r.itl_s.append(end - r.last_tok_t)
            r.last_tok_t = end
            if r.decoded >= r.event.max_new_tokens:
                finished.append(r)
        for r in finished:
            self.active.remove(r)
        self.t = end
        self.iterations += 1
        return dt, finished


def _pct(xs: list[float], p: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


class FleetSim:
    """Runs one scenario event stream over a simulated fleet.

    Placement mirrors ``ReplicatedRouter._pick``: least
    (active + pending) load, ties broken round-robin from the
    tenant's crc32 home offset (affinity concentrates a tenant's
    shared prefix on one replica, exactly like the live router).
    Session turns follow the replay driver's rule: turn k fires
    ``think_s`` after turn k-1 completes."""

    def __init__(self, replicas: list[SimReplica], *,
                 cost: CostModel | None = None,
                 slo: dict | None = None,
                 tenant_class: dict[str, str] | None = None):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = replicas
        self.cost = cost or CostModel()
        self.tenant_class = dict(tenant_class or {})
        self.now = 0.0
        self.tracker = (SLOTracker(slo, clock=lambda: self.now)
                        if slo else None)
        self.finished: list[_SimReq] = []
        self.peak_active = 0

    def _cls(self, tenant: str | None) -> str:
        return self.tenant_class.get(tenant, "default")

    def _place(self, tenant: str | None) -> SimReplica:
        n = len(self.replicas)
        k = (zlib.crc32(tenant.encode()) % n
             if tenant is not None else 0)
        loads = [r.num_active + r.num_pending for r in self.replicas]
        i = min(range(n), key=lambda j: (loads[j], (j - k) % n))
        return self.replicas[i]

    def _observe(self, req: _SimReq, done_t: float) -> None:
        if self.tracker is None:
            return
        obs = self.tracker.observe
        cls = req.cls
        obs(cls, "queue_wait", req.admit_t - req.arrival, done_t)
        obs(cls, "ttft", req.first_tok_t - req.arrival, done_t)
        for gap in req.itl_s:
            obs(cls, "itl", gap, done_t)
        obs(cls, "e2e", done_t - req.arrival, done_t)

    def run(self, events, *, max_sim_s: float = 1e6) -> dict:
        # (due_time, seq, event) heap; turn-k events enter when turn
        # k-1 completes, at completion + think_s
        heap: list = []
        seq = 0
        sessions: dict[int, list] = {}
        for e in sorted(events, key=lambda e: (e.time_s, e.turn)):
            sessions.setdefault(e.session, []).append(e)
        for sid, evs in sessions.items():
            heapq.heappush(heap, (evs[0].time_s, seq, evs[0]))
            seq += 1
            sessions[sid] = evs[1:]
        while heap or any(r.busy for r in self.replicas):
            busy = [r for r in self.replicas if r.busy]
            next_due = heap[0][0] if heap else None
            if busy:
                r = min(busy, key=lambda r: r.t)
                if next_due is not None and next_due <= r.t:
                    _, _, e = heapq.heappop(heap)
                    self.now = max(self.now, next_due)
                    req = _SimReq(e, self._cls(e.tenant), next_due)
                    self._place(e.tenant).submit(req, next_due)
                    continue
                _, finished = r.step(self.cost)
                self.now = max(self.now, r.t)
                self.peak_active = max(
                    self.peak_active,
                    sum(x.num_active for x in self.replicas))
                for req in finished:
                    self.finished.append(req)
                    self._observe(req, r.t)
                    rest = sessions.get(req.event.session)
                    if rest:
                        nxt = rest.pop(0)
                        heapq.heappush(
                            heap, (r.t + nxt.think_s, seq, nxt))
                        seq += 1
            else:
                if next_due is None:
                    break
                _, _, e = heapq.heappop(heap)
                self.now = max(self.now, next_due)
                req = _SimReq(e, self._cls(e.tenant), next_due)
                self._place(e.tenant).submit(req, next_due)
            if self.now > max_sim_s:
                raise RuntimeError(
                    f"simulation exceeded max_sim_s={max_sim_s}")
        return self.report()

    def report(self) -> dict:
        per_class: dict[str, dict] = {}
        for req in self.finished:
            c = per_class.setdefault(
                req.cls, {"count": 0, "ttft_s": [], "itl_s": [],
                          "e2e_s": [], "queue_wait_s": []})
            c["count"] += 1
            c["ttft_s"].append(req.first_tok_t - req.arrival)
            c["itl_s"] += req.itl_s
            c["e2e_s"].append(req.last_tok_t - req.arrival)
            c["queue_wait_s"].append(req.admit_t - req.arrival)
        out_classes = {}
        for cls, c in per_class.items():
            out_classes[cls] = {
                "count": c["count"],
                "ttft_p50_s": _pct(c["ttft_s"], 0.50),
                "ttft_p95_s": _pct(c["ttft_s"], 0.95),
                "itl_p50_s": _pct(c["itl_s"], 0.50),
                "itl_p95_s": _pct(c["itl_s"], 0.95),
                "e2e_p50_s": _pct(c["e2e_s"], 0.50),
                "queue_wait_p50_s": _pct(c["queue_wait_s"], 0.50)}
        return {
            "finished": len(self.finished),
            "sim_duration_s": self.now,
            "iterations": sum(r.iterations for r in self.replicas),
            "preemptions": sum(r.preemptions for r in self.replicas),
            "peak_active": self.peak_active,
            "classes": out_classes,
            "slo": (self.tracker.report(self.now)
                    if self.tracker is not None else None)}
