"""Seeded scenario workload generation.

The generators compose into a ``Scenario`` that emits a DETERMINISTIC
event stream: identical config + seed -> byte-identical events
(``stream_bytes``; the port's copy gives the reference's bytes). Determinism is
the whole point — a regression hunt replays the exact arrival pattern
that broke, a policy search compares schedulers on the same million
requests, and the simulator and the live replay driver consume one
shared stream.

Building blocks:

  * Arrival processes — ``PoissonArrivals`` (memoryless steady load),
    ``MMPPArrivals`` (Markov-modulated Poisson: phases of different
    rate, e.g. diurnal bursts), ``TraceArrivals`` (replayed
    inter-arrival gaps from a recorded trace).
  * ``LengthMixture`` — weighted mixture of point / uniform /
    lognormal components for prompt and output lengths (real traffic
    is a lognormal body with spec-sheet point masses, not one mean).
  * ``SessionShape`` — multi-turn conversations: a geometric turn
    count, exponential think time between turns, and a shared
    per-tenant SYSTEM PREFIX at the head of every prompt, so replays
    exercise the radix prefix cache exactly like production chat
    traffic does.
  * ``TenantMix`` — weighted tenant selection; tenants map onto QoS
    priority classes downstream (qos.py config), so one stream drives
    interactive and batch classes in a controlled ratio.

Everything here is pure host-side policy: stdlib only (``random``,
no numpy, no torch). A copy of the reference's ``scenarios/workload.py``.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Event:
    """One request the replay driver (or simulator) will fire.

    ``time_s`` is the NOMINAL offset from scenario start. For turn 0
    it is the session's arrival time; for later turns it is a nominal
    schedule only — the replay driver fires turn k ``think_s`` after
    turn k-1 actually completed (a user cannot type a follow-up
    before reading the answer), and the simulator applies the same
    rule, so both consume the stream identically."""

    time_s: float
    session: int
    turn: int
    tenant: str | None
    prompt: tuple[int, ...]
    max_new_tokens: int
    think_s: float = 0.0
    prefix_len: int = 0

    def to_json(self) -> dict:
        return {"time_s": round(self.time_s, 6), "session": self.session,
                "turn": self.turn, "tenant": self.tenant,
                "prompt": list(self.prompt),
                "max_new_tokens": self.max_new_tokens,
                "think_s": round(self.think_s, 6),
                "prefix_len": self.prefix_len}


def stream_bytes(events: list[Event]) -> bytes:
    """Canonical serialization of an event stream — the determinism
    contract: identical scenario config + seed must reproduce these
    bytes exactly (floats are rounded in ``to_json`` so the contract
    survives JSON round-trips)."""
    return json.dumps([e.to_json() for e in events], sort_keys=True,
                      separators=(",", ":")).encode()


# -- arrival processes ------------------------------------------------------


class PoissonArrivals:
    """Memoryless arrivals at a constant rate (exponential gaps)."""

    def __init__(self, rate_per_s: float):
        if rate_per_s <= 0:
            raise ValueError("rate_per_s must be > 0")
        self.rate_per_s = float(rate_per_s)

    def times(self, rng: random.Random, duration_s: float) -> list[float]:
        out, t = [], 0.0
        while True:
            t += rng.expovariate(self.rate_per_s)
            if t >= duration_s:
                return out
            out.append(t)


class MMPPArrivals:
    """Markov-modulated Poisson process: the rate cycles through
    ``phases`` of ``(rate_per_s, dwell_s)``. Two phases of low/high
    rate model a diurnal burst; more phases model a full day curve.
    Within a phase arrivals are Poisson at that phase's rate."""

    def __init__(self, phases):
        self.phases = tuple((float(r), float(d)) for r, d in phases)
        if not self.phases or any(r < 0 or d <= 0
                                  for r, d in self.phases):
            raise ValueError(
                "phases must be non-empty (rate_per_s >= 0, dwell_s > 0)"
                " pairs")
        if all(r == 0 for r, _ in self.phases):
            raise ValueError("at least one phase needs rate_per_s > 0")

    def times(self, rng: random.Random, duration_s: float) -> list[float]:
        out, t, k = [], 0.0, 0
        phase_end = self.phases[0][1]
        while t < duration_s:
            rate = self.phases[k % len(self.phases)][0]
            gap = rng.expovariate(rate) if rate > 0 else float("inf")
            if t + gap >= phase_end:
                # no arrival before the phase boundary: jump there and
                # redraw at the NEXT phase's rate — exponential
                # memorylessness makes the restart exact (a gap drawn
                # at the old rate must not stride over a burst phase)
                t = phase_end
                k += 1
                phase_end += self.phases[k % len(self.phases)][1]
                continue
            t += gap
            if t < duration_s:
                out.append(t)
        return out


class TraceArrivals:
    """Replays recorded inter-arrival gaps (seconds), cycling when the
    trace is shorter than the scenario — the path for driving the
    fleet with production arrival patterns instead of a model."""

    def __init__(self, gaps_s):
        self.gaps_s = tuple(float(g) for g in gaps_s)
        if not self.gaps_s or any(g < 0 for g in self.gaps_s):
            raise ValueError("gaps_s must be non-empty, non-negative")
        if sum(self.gaps_s) <= 0:
            raise ValueError("gaps_s must advance time")

    def times(self, rng: random.Random, duration_s: float) -> list[float]:
        out, t, k = [], 0.0, 0
        while True:
            t += self.gaps_s[k % len(self.gaps_s)]
            k += 1
            if t >= duration_s:
                return out
            out.append(t)


# -- value mixtures ---------------------------------------------------------


class LengthMixture:
    """Weighted mixture of length components. Each component is
    ``("point", n)``, ``("uniform", lo, hi)`` or
    ``("lognormal", mu, sigma, cap)`` (mu/sigma in log-token space,
    hard-capped). Samples are always >= 1."""

    def __init__(self, components):
        comps = []
        for w, spec in components:
            if w <= 0:
                raise ValueError("component weight must be > 0")
            kind = spec[0]
            if kind not in ("point", "uniform", "lognormal"):
                raise ValueError(f"unknown length component {kind!r}")
            comps.append((float(w), tuple(spec)))
        if not comps:
            raise ValueError("mixture needs at least one component")
        self.components = tuple(comps)
        self._total_w = sum(w for w, _ in comps)

    @classmethod
    def point(cls, n: int) -> "LengthMixture":
        return cls([(1.0, ("point", int(n)))])

    def sample(self, rng: random.Random) -> int:
        x = rng.random() * self._total_w
        for w, spec in self.components:
            x -= w
            if x <= 0:
                break
        kind = spec[0]
        if kind == "point":
            return max(1, int(spec[1]))
        if kind == "uniform":
            return max(1, rng.randint(int(spec[1]), int(spec[2])))
        mu, sigma, cap = spec[1], spec[2], spec[3]
        return max(1, min(int(cap), int(round(rng.lognormvariate(
            float(mu), float(sigma))))))


class TenantMix:
    """Weighted tenant selection. ``entries`` maps tenant name ->
    weight; tenants map onto QoS priority classes by the serving-side
    qos config, so the mix controls the interactive/batch ratio of
    the stream."""

    def __init__(self, entries: dict[str, float]):
        items = [(str(t), float(w)) for t, w in entries.items() if w > 0]
        if not items:
            raise ValueError("tenant mix needs at least one entry with "
                             "weight > 0")
        self.entries = tuple(sorted(items))  # order-independent config
        self._total_w = sum(w for _, w in self.entries)

    def sample(self, rng: random.Random) -> str:
        x = rng.random() * self._total_w
        for t, w in self.entries:
            x -= w
            if x <= 0:
                return t
        return self.entries[-1][0]


@dataclass(frozen=True)
class SessionShape:
    """Multi-turn conversation shape: geometric turn count (mean
    ``turns_mean``, capped at ``max_turns``), exponential think time
    between turns, and a shared per-tenant system prefix of
    ``prefix_len`` tokens heading every prompt (every session of a
    tenant reuses the SAME prefix tokens — the radix-cache workload)."""

    turns_mean: float = 1.0
    max_turns: int = 8
    think_s_mean: float = 0.0
    prefix_len: int = 0

    def sample_turns(self, rng: random.Random) -> int:
        if self.turns_mean <= 1.0:
            return 1
        # geometric with mean turns_mean: continue w.p. 1 - 1/mean
        p_cont = 1.0 - 1.0 / self.turns_mean
        n = 1
        while n < self.max_turns and rng.random() < p_cont:
            n += 1
        return n

    def sample_think(self, rng: random.Random) -> float:
        if self.think_s_mean <= 0:
            return 0.0
        return rng.expovariate(1.0 / self.think_s_mean)


# -- the scenario -----------------------------------------------------------


@dataclass
class Scenario:
    """One composed workload. ``generate()`` is a pure function of the
    config + seed: a single ``random.Random(seed)`` drives every draw
    in one fixed loop order, so the stream is reproducible down to
    the byte (``stream_bytes``)."""

    arrivals: object
    duration_s: float
    prompt_len: LengthMixture
    output_len: LengthMixture
    tenants: TenantMix | None = None
    session: SessionShape = field(default_factory=SessionShape)
    vocab: int = 32000
    seed: int = 0

    def tenant_prefix(self, tenant: str | None) -> tuple[int, ...]:
        """The shared system-prompt tokens for ``tenant`` — a pure
        function of (scenario seed, tenant), so every session agrees
        and a re-generated scenario reproduces them."""
        n = self.session.prefix_len
        if n <= 0:
            return ()
        prng = random.Random(f"{self.seed}:prefix:{tenant}")
        return tuple(prng.randrange(1, self.vocab) for _ in range(n))

    def generate(self) -> list[Event]:
        rng = random.Random(self.seed)
        starts = self.arrivals.times(rng, self.duration_s)
        prefixes: dict[str | None, tuple[int, ...]] = {}
        events: list[Event] = []
        for sid, t0 in enumerate(starts):
            tenant = (self.tenants.sample(rng)
                      if self.tenants is not None else None)
            prefix = prefixes.get(tenant)
            if prefix is None:
                prefix = prefixes[tenant] = self.tenant_prefix(tenant)
            n_turns = self.session.sample_turns(rng)
            t = t0
            for turn in range(n_turns):
                think = (0.0 if turn == 0
                         else self.session.sample_think(rng))
                t += think
                body_len = max(1, self.prompt_len.sample(rng)
                               - len(prefix))
                body = tuple(rng.randrange(1, self.vocab)
                             for _ in range(body_len))
                events.append(Event(
                    time_s=t, session=sid, turn=turn, tenant=tenant,
                    prompt=prefix + body,
                    max_new_tokens=self.output_len.sample(rng),
                    think_s=think, prefix_len=len(prefix)))
        events.sort(key=lambda e: (e.time_s, e.session, e.turn))
        return events


def diurnal_burst(*, seed: int = 0, duration_s: float = 60.0,
                  low_rps: float = 1.0, high_rps: float = 6.0,
                  phase_s: float | None = None,
                  prompt_len: LengthMixture | None = None,
                  output_len: LengthMixture | None = None,
                  tenants: TenantMix | None = None,
                  session: SessionShape | None = None,
                  vocab: int = 32000) -> Scenario:
    """The canonical autoscaler test scenario: quiet -> burst -> quiet
    (three MMPP phases, burst in the middle third by default). The
    bench's ``slo_autoscale`` section and the autoscaler tests share
    this builder so they argue about the same traffic."""
    ph = duration_s / 3.0 if phase_s is None else float(phase_s)
    return Scenario(
        arrivals=MMPPArrivals([(low_rps, ph), (high_rps, ph),
                               (low_rps, ph)]),
        duration_s=duration_s,
        prompt_len=prompt_len or LengthMixture(
            [(0.7, ("lognormal", 3.0, 0.6, 256)),
             (0.3, ("uniform", 4, 64))]),
        output_len=output_len or LengthMixture(
            [(1.0, ("uniform", 8, 32))]),
        tenants=tenants,
        session=session or SessionShape(),
        vocab=vocab, seed=seed)
