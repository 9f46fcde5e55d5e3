"""Multi-tenant QoS: fair-share admission, priority preemption, and
per-tenant isolation for the serving stack.

Production serving is multi-tenant: many products/users share one
engine, and without a policy layer a single flooding tenant owns the
FIFO queue, the page pool, and the 429 budget of everyone else. This
module is that policy layer — pure host-side state the schedulers
consult at points they already own, so it adds ZERO device dispatches
or syncs (a copy of the reference's `inference/qos.py`; the port's
tests hold a configured server's programs to an unconfigured one's):

  * `TenantConfig` / `TenantRegistry` — per-tenant weight, priority
    class (interactive > batch > best_effort), token-bucket rate
    limits (prompt and generated tokens/s), per-tenant pending bounds,
    and API-key -> tenant mapping. Configured from a JSON object, a
    JSON string, or a file path (`InferConfig.qos_config`, server
    `qos=`, CLI `--qos-config`).
  * Weighted fair-share admission — DEFICIT ROUND-ROBIN over tenants
    when the scheduler picks which pending request gets the next free
    slot (`next_admission_index`), and weighted-fair ordering of the
    in-flight admission jobs that fund each mixed iteration's prefill
    chunks (`order_jobs` / `charge_prefill`). FIFO order is preserved
    WITHIN a tenant; with a single (default) tenant the selection
    degenerates to exactly the old FIFO.
  * Priority-aware preemption — on page-pool exhaustion the victim is
    chosen by (lowest priority class, most over fair share, youngest)
    instead of youngest-only (`priority_rank` + the server's weighted
    usage scan).
  * Differentiated backpressure — a tenant at its own pending bound or
    out of prompt-bucket budget gets `TenantQueueFullError` (HTTP 429
    with a `Retry-After` derived from its token-bucket refill) while
    every other tenant keeps admitting.

With no QoS config (`registry is None`) every server path is the
pre-QoS code byte-for-byte: the schedulers guard every call site with
`if self.qos is not None`, and the mixed-vs-alternating exact-output
tests pin the default behavior.

Work-conservation note: a tenant in generated-token debt is SKIPPED by
admission only while some other tenant is eligible; when every
backlogged tenant is over budget the pick falls back to plain DRR —
rate limits shape contended capacity, they never idle the chip.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time

from cloud_server_tpu_torch.inference.server import QueueFullError

DEFAULT_TENANT = "default"

# Priority classes, best first. Preemption victimizes the HIGHEST rank
# (lowest class) first; admission share is set by weight, not class, so
# best-effort tenants still make progress under interactive floods.
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")

# Half-life of the DECAYED generated-token rate used for preemption's
# "most over fair share" key. Lifetime totals would let days of stale
# history pick victims (an established tenant's millions of old tokens
# outweighing a fresh flood); a ~30 s horizon ranks by what tenants are
# consuming NOW.
RECENT_USAGE_HALFLIFE_S = 30.0


def compute_fair_shares(
        entries: dict[str, tuple[float, float]]) -> dict[str, float]:
    """{name: (weight, generated)} -> {name: share / entitlement}.
    1.0 = the tenant holds exactly its weighted share of all generated
    tokens. THE fair-share definition — the registry's stats/gauges and
    ReplicatedRouter's fleet merge both call this, so the single-server
    and fleet views can never diverge."""
    total_gen = sum(g for _, g in entries.values())
    total_w = sum(w for w, _ in entries.values())
    out = {}
    for name, (w, g) in entries.items():
        share = (g / total_gen) if total_gen else 0.0
        entitlement = w / total_w if total_w else 1.0
        out[name] = share / entitlement if entitlement else 0.0
    return out


class TenantQueueFullError(QueueFullError):
    """Per-tenant backpressure: THIS tenant is over its pending bound
    or out of token-bucket budget; other tenants keep admitting. The
    HTTP front-end maps it to a 429 whose `Retry-After` header and
    structured body carry `retry_after_s` and `tenant`."""

    def __init__(self, message: str, *, tenant: str,
                 retry_after_s: float):
        super().__init__(message)
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """Static per-tenant policy (see docs/serving.md for the JSON
    schema). `weight` sets the fair share; `priority` only orders
    preemption victims; rate/burst pairs of None disable that bucket;
    `max_pending` of None falls back to the server-wide bound."""

    name: str
    weight: float = 1.0
    priority: str = "interactive"
    max_pending: int | None = None
    prompt_tokens_per_s: float | None = None
    prompt_burst: float | None = None
    generated_tokens_per_s: float | None = None
    generated_burst: float | None = None
    api_keys: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0 (a zero "
                "weight would starve the tenant forever; use "
                "priority='best_effort' for a preemption-first class)")
        if self.priority not in PRIORITY_CLASSES:
            raise ValueError(
                f"tenant {self.name!r}: unknown priority "
                f"{self.priority!r}; one of {PRIORITY_CLASSES}")
        if self.max_pending is not None and self.max_pending < 0:
            raise ValueError(
                f"tenant {self.name!r}: max_pending must be >= 0")
        for rate, burst, what in (
                (self.prompt_tokens_per_s, self.prompt_burst, "prompt"),
                (self.generated_tokens_per_s, self.generated_burst,
                 "generated")):
            if rate is not None and rate <= 0:
                raise ValueError(
                    f"tenant {self.name!r}: {what}_tokens_per_s must "
                    "be > 0 (omit it to disable the limit)")
            if burst is not None and rate is None:
                raise ValueError(
                    f"tenant {self.name!r}: {what}_burst without "
                    f"{what}_tokens_per_s")
            if burst is not None and burst <= 0:
                raise ValueError(
                    f"tenant {self.name!r}: {what}_burst must be > 0 "
                    "(a zero burst would reject every request forever)")


class TokenBucket:
    """Classic token bucket with debt. `try_consume` gates work before
    it happens (prompt tokens at submit); `charge` records work after
    the fact and may drive the level negative (generated tokens are
    only known post-emit) — a tenant in debt is deprioritized, never
    retroactively blocked. `retry_after` is the refill time until `n`
    tokens are available: the number the 429 path surfaces."""

    def __init__(self, rate: float, burst: float | None = None, *,
                 clock=time.monotonic):
        if rate <= 0:
            raise ValueError("token bucket rate must be > 0")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else rate)
        self._level = self.burst  # start full: bursts up to burst size
        self._clock = clock
        self._stamp = clock()

    def _refill(self, now: float) -> None:
        dt = now - self._stamp
        if dt > 0:
            self._level = min(self.burst, self._level + dt * self.rate)
            self._stamp = now

    def level(self, now: float | None = None) -> float:
        self._refill(self._clock() if now is None else now)
        return self._level

    def try_consume(self, n: float, now: float | None = None) -> bool:
        self._refill(self._clock() if now is None else now)
        if self._level >= n:
            self._level -= n
            return True
        return False

    def charge(self, n: float, now: float | None = None) -> None:
        self._refill(self._clock() if now is None else now)
        self._level -= n  # may go negative (debt)

    def retry_after(self, n: float = 0.0,
                    now: float | None = None) -> float:
        """Seconds until `n` tokens are available (0.0 when they
        already are). n=0 reports the time to climb out of debt."""
        self._refill(self._clock() if now is None else now)
        need = n - self._level
        return max(0.0, need / self.rate)


class _TenantState:
    """Runtime per-tenant bookkeeping (registry-private)."""

    def __init__(self, cfg: TenantConfig, clock):
        self.cfg = cfg
        self.prompt_bucket = (
            None if cfg.prompt_tokens_per_s is None else
            TokenBucket(cfg.prompt_tokens_per_s, cfg.prompt_burst,
                        clock=clock))
        self.generated_bucket = (
            None if cfg.generated_tokens_per_s is None else
            TokenBucket(cfg.generated_tokens_per_s, cfg.generated_burst,
                        clock=clock))
        # DRR state for slot admission + WFQ virtual time for mixed
        # prefill funding
        self.deficit = 0.0
        self.prefill_vt = 0.0
        # exponentially-decayed generated-token usage (see
        # RECENT_USAGE_HALFLIFE_S) — the preemption victim signal
        self.recent = 0.0
        self.recent_stamp = clock()
        # counters (host-side; mirrored into labeled metrics on the
        # scrape path, never the serving path)
        self.pending = 0
        self.submitted = 0
        self.rejected = 0
        self.generated = 0
        self.preempt_requeues = 0
        self.prefill_tokens = 0
        # speculative decoding: draft tokens proposed on the tenant's
        # rows vs accepted-and-committed. Only COMMITTED tokens are
        # billed to the generated bucket (charge_generated); the
        # difference is the tenant's wasted-speculation ledger
        self.spec_drafted = 0
        self.spec_accepted = 0


class TenantRegistry:
    """All QoS policy state, shared by a server's scheduler, its HTTP
    front-end, and the metrics scrape path. Methods that run inside
    the scheduler iteration are sync- and device-free; the internal
    lock only guards plain
    counter arithmetic, so contention is negligible.

    Config JSON shape::

        {"quantum": 256,
         "default": {"weight": 1.0},
         "tenants": {
           "team-a": {"weight": 3.0, "priority": "interactive",
                      "max_pending": 64,
                      "prompt_tokens_per_s": 2000, "prompt_burst": 8000,
                      "generated_tokens_per_s": 500,
                      "api_keys": ["key-a-1"]},
           "scraper": {"weight": 1.0, "priority": "best_effort"}}}

    Unknown tenants (and requests with no tenant at all) resolve to
    "default", whose policy is the optional "default" entry.
    """

    def __init__(self, config: dict | None = None, *,
                 clock=time.monotonic):
        config = dict(config or {})
        self._clock = clock
        self._lock = threading.Lock()
        self.quantum = float(config.get("quantum", 256))
        if self.quantum <= 0:
            raise ValueError("qos quantum must be > 0")
        # per-priority-class default request deadlines (seconds): a
        # number (every class) or {"interactive": 5, "batch": 60, ...}.
        # Applied at submit when the caller passes no deadline_s; the
        # scheduler sweep cancels expired requests (finish_reason
        # "deadline") and the router stops failover retries past them.
        dl = config.get("deadline_s")
        if dl is None:
            self._class_deadlines: dict[str, float] = {}
        elif isinstance(dl, (int, float)):
            self._class_deadlines = {c: float(dl)
                                     for c in PRIORITY_CLASSES}
        elif isinstance(dl, dict):
            unknown_cls = set(dl) - set(PRIORITY_CLASSES)
            if unknown_cls:
                raise ValueError(
                    f"deadline_s names unknown priority classes: "
                    f"{sorted(unknown_cls)}")
            self._class_deadlines = {c: float(v) for c, v in dl.items()}
        else:
            raise ValueError(
                "deadline_s must be a number or a class->seconds map")
        for c, v in self._class_deadlines.items():
            if v <= 0:
                raise ValueError(
                    f"deadline_s for {c!r} must be > 0 (omit the class "
                    "to leave it unbounded)")
        default = dict(config.get("default", {}))
        default.pop("api_keys", None)  # the fallback tenant has no keys
        self._states: dict[str, _TenantState] = {}
        self._order: list[str] = []  # config order; DRR iterates this
        self._api_keys: dict[str, str] = {}
        self._global_vt = 0.0
        # the tenant set is FROZEN here: configured tenants plus the
        # always-present default. resolve() collapses every other name
        # onto the default, so an untrusted X-Tenant header can neither
        # grow host state / metric cardinality without bound nor
        # multiply a flooder's fair share across spoofed names — and
        # the state dict stays safely iterable from the scrape thread
        # while the scheduler reads it.
        self._register(DEFAULT_TENANT,
                       TenantConfig(name=DEFAULT_TENANT, **default))
        for name, spec in dict(config.get("tenants", {})).items():
            spec = dict(spec)
            keys = tuple(spec.pop("api_keys", ()))
            cfg = TenantConfig(name=name, api_keys=keys, **spec)
            self._register(name, cfg)
            for k in keys:
                if k in self._api_keys:
                    raise ValueError(
                        f"api key registered for both "
                        f"{self._api_keys[k]!r} and {name!r}")
                self._api_keys[k] = name
        unknown = set(config) - {"quantum", "default", "tenants",
                                 "deadline_s"}
        if unknown:
            raise ValueError(f"unknown qos config keys: {sorted(unknown)}")

    def _register(self, name: str, cfg: TenantConfig) -> _TenantState:
        if name in self._states:
            raise ValueError(f"tenant {name!r} declared twice")
        st = _TenantState(cfg, self._clock)
        self._states[name] = st
        self._order.append(name)
        return st

    def _state(self, name: str) -> _TenantState:
        """State for a RESOLVED name — a plain dict read (the tenant
        set never changes after construction)."""
        return self._states[name]

    # -- identity -----------------------------------------------------------

    def resolve(self, tenant: str | None) -> str:
        """Canonical tenant name: configured names pass through;
        anything else — anonymous AND unknown names alike — collapses
        to "default", whose policy is the config's optional "default"
        entry (shared bucket, shared fair share)."""
        if tenant and tenant in self._states:
            return tenant
        return DEFAULT_TENANT

    def tenant_for_api_key(self, key: str) -> str | None:
        return self._api_keys.get(key)

    def priority_rank(self, tenant: str | None) -> int:
        """0 = interactive .. 2 = best_effort; preemption victimizes
        the highest rank first."""
        st = self._state(self.resolve(tenant))
        return PRIORITY_CLASSES.index(st.cfg.priority)

    def priority_class(self, tenant: str | None) -> str:
        """The tenant's priority-class NAME ("interactive" / "batch" /
        "best_effort") — the SLO layer's class mapping (a request's
        SLO class is its tenant's priority class)."""
        return self._state(self.resolve(tenant)).cfg.priority

    def weight(self, tenant: str | None) -> float:
        return self._state(self.resolve(tenant)).cfg.weight

    def default_deadline(self, tenant: str | None) -> float | None:
        """The tenant's class-default request deadline in seconds
        (None = unbounded): submit() applies it when the caller passes
        no explicit deadline_s. Plain dict reads on state frozen at
        construction — submit-path hot."""
        return self._class_deadlines.get(
            self._state(self.resolve(tenant)).cfg.priority)

    def header_trusted(self, tenant: str) -> bool:
        """Whether a bare `X-Tenant: <tenant>` header claim is honored
        without an API key: True for unknown names (they collapse to
        the default tenant anyway) and for configured tenants with no
        api_keys; False for key-protected tenants — their identity
        comes only from `tenant_for_api_key`, so a header alone can
        never ride a protected tenant's weight, priority, or rate
        budget."""
        st = self._states.get(tenant)
        return st is None or not st.cfg.api_keys

    def _decay_recent(self, st: _TenantState, now: float) -> None:
        """Decay `st.recent` to `now` (caller holds the lock)."""
        dt = now - st.recent_stamp
        if dt > 0.0:
            st.recent *= 0.5 ** (dt / RECENT_USAGE_HALFLIFE_S)
            st.recent_stamp = now

    def victim_rank(self, tenant: str | None) -> tuple[int, float]:
        """Preemption ordering key for the tenant's slots: (priority
        rank — best_effort highest, RECENT weighted generated-token
        usage — most over fair share first). Usage is the decayed rate
        (RECENT_USAGE_HALFLIFE_S), not the lifetime total, so an
        established tenant's days-old history never shields a current
        flooder. The server takes the MAX of (victim_rank, admit_seq),
        so the full order is (lowest priority class, most over fair
        share, youngest) per docs/serving.md."""
        st = self._state(self.resolve(tenant))
        now = self._clock()
        with self._lock:
            self._decay_recent(st, now)
            return (PRIORITY_CLASSES.index(st.cfg.priority),
                    st.recent / st.cfg.weight)

    # -- submit gate (differentiated backpressure) --------------------------

    def gate_submit(self, tenant: str | None, prompt_tokens: int,
                    charge_tokens: int | None = None) -> None:
        """Admit-or-429 for one submit, called under the server lock
        AFTER the global checks: per-tenant pending bound, then the
        prompt token bucket. On success the tenant's pending count and
        submit counter advance atomically with the queue append the
        caller performs next. A prompt LARGER than the bucket's burst
        capacity could never be admitted no matter how long the client
        waits, so it raises ValueError (HTTP 400, terminal) instead of
        the retryable 429.

        `charge_tokens` overrides how many tokens the prompt bucket is
        billed (default: the full `prompt_tokens`). A migration
        continuation passes 0: the source replica already billed the
        original prompt, and the salvaged generated tokens were never
        prompt tokens — re-billing either would double-charge the
        tenant fleet-wide for one request. The burst-capacity 400
        keys off the same charge: a continuation's already-paid-for
        prompt must never be refused outright."""
        tenant = self.resolve(tenant)
        st = self._state(tenant)
        charge = prompt_tokens if charge_tokens is None else charge_tokens
        if (st.prompt_bucket is not None
                and charge > st.prompt_bucket.burst):
            raise ValueError(
                f"prompt of {charge} tokens exceeds tenant "
                f"{tenant!r}'s burst capacity "
                f"({st.prompt_bucket.burst:g} tokens); no retry can "
                "ever admit it")
        with self._lock:
            bound = st.cfg.max_pending
            if bound is not None and st.pending >= bound:
                st.rejected += 1
                raise TenantQueueFullError(
                    f"tenant {tenant!r} pending queue is full "
                    f"({bound} requests); retry later",
                    tenant=tenant,
                    retry_after_s=self._retry_hint(st, charge))
            if (st.prompt_bucket is not None
                    and not st.prompt_bucket.try_consume(charge)):
                st.rejected += 1
                raise TenantQueueFullError(
                    f"tenant {tenant!r} is over its prompt-token rate "
                    "limit; retry later", tenant=tenant,
                    retry_after_s=st.prompt_bucket.retry_after(
                        charge))
            st.pending += 1
            st.submitted += 1

    def _retry_hint(self, st: _TenantState, prompt_tokens: int) -> float:
        """Retry-After for a pending-bound 429, derived from the
        tenant's bucket refill state (the best host-side guess at when
        capacity frees); 1.0 s when the tenant has no buckets."""
        hints = []
        if st.prompt_bucket is not None:
            hints.append(st.prompt_bucket.retry_after(prompt_tokens))
        if st.generated_bucket is not None:
            hints.append(st.generated_bucket.retry_after(0.0))
        return max(hints) if hints else 1.0

    # -- pending-queue lifecycle -------------------------------------------

    def on_pending_removed(self, tenant: str | None) -> None:
        """A request left the pending queue (admitted into a slot,
        cancelled while queued, or failed)."""
        st = self._state(self.resolve(tenant))
        with self._lock:
            st.pending = max(0, st.pending - 1)

    def on_requeue(self, tenant: str | None) -> None:
        """A preempted request went back to the queue front."""
        st = self._state(self.resolve(tenant))
        with self._lock:
            st.pending += 1
            st.preempt_requeues += 1

    # -- fair-share admission (hot path) ------------------------------------

    def next_admission_index(self, pending) -> int | None:
        """DRR pick over the pending queue: index of the next request
        to admit, or None when the queue is empty. Preserves FIFO
        within each tenant (each tenant's HEAD request is its only
        candidate); tenants in generated-token debt are skipped while
        any other tenant is eligible (work-conserving fallback
        otherwise). Deficits are NOT consumed here — the caller charges
        `charge_admission` once the admission actually succeeds, so a
        page-famine retry next step is not double-billed.

        Cost: the scan EARLY-EXITS once every tenant with queued work
        has shown its head (per-tenant pending counts are maintained
        at submit / requeue / removal under the same server lock this
        runs under), so a single-tenant flood — the overload shape QoS
        exists for — pays O(1) per pick like the FIFO it replaces. A
        deep scan happens only when some tenant's head really is
        buried behind another's flood, i.e. exactly when fairness
        requires digging it out."""
        with self._lock:
            want = sum(1 for st in self._states.values()
                       if st.pending > 0)
        heads: dict[str, tuple[int, int]] = {}
        for i, req in enumerate(pending):
            t = self.resolve(getattr(req, "tenant", None))
            if t not in heads:
                heads[t] = (i, len(req.prompt) + len(req.tokens))
                if want and len(heads) >= want:
                    break
        if not heads:
            return None
        with self._lock:
            for name, st in self._states.items():
                if name not in heads:
                    st.deficit = 0.0  # classic DRR: idle queues hoard
                    #                   nothing across their idle gap
            pool = [t for t in self._order if t in heads]
            eligible = [t for t in pool if self._in_budget(t)]
            if eligible:
                pool = eligible
            # Closed-form DRR: the round-by-round loop ("top everyone
            # up by quantum*weight until someone's deficit covers its
            # head's cost, first in pool order wins") is computed
            # directly — a preempted 100k-token continuation must not
            # cost cost/quantum lock-held scan passes per pick.
            best = rounds = None
            for t in pool:
                st = self._states[t]
                need = heads[t][1] - st.deficit
                r = (0 if need <= 0 else
                     math.ceil(need / (self.quantum * st.cfg.weight)))
                if rounds is None or r < rounds:  # strict: pool-order
                    best, rounds = t, r  # tie-break, like the loop
            if rounds:
                for t in pool:
                    st = self._states[t]
                    st.deficit += rounds * self.quantum * st.cfg.weight
            return heads[best][0]

    def _in_budget(self, tenant: str) -> bool:
        st = self._states[tenant]
        return (st.generated_bucket is None
                or st.generated_bucket.level() >= 0.0)

    def charge_admission(self, tenant: str | None, cost: int) -> None:
        """Consume the admitted request's DRR deficit (prompt cost)."""
        st = self._state(self.resolve(tenant))
        with self._lock:
            st.deficit -= cost

    def order_jobs(self, tenants: list[str | None]) -> list[int]:
        """Weighted-fair order for the admission jobs funding a mixed
        iteration's prefill chunks: job indices sorted by their
        tenant's prefill virtual time (spent-tokens / weight),
        original (FIFO) order within a tenant. Tenants re-entering
        after an idle gap resume at the current virtual time instead
        of replaying their idle credit."""
        names = [self.resolve(t) for t in tenants]
        involved = set(names)
        with self._lock:
            vts = []
            for name in involved:
                st = self._state(name)
                st.prefill_vt = max(st.prefill_vt, self._global_vt)
                vts.append(st.prefill_vt)
            if vts:
                self._global_vt = max(self._global_vt, min(vts))
            return sorted(range(len(names)),
                          key=lambda i: (self._states[names[i]].prefill_vt,
                                         i))

    def charge_prefill(self, tenant: str | None, tokens: int) -> None:
        st = self._state(self.resolve(tenant))
        with self._lock:
            st.prefill_vt += tokens / st.cfg.weight
            st.prefill_tokens += tokens

    # -- accounting (hot path) ----------------------------------------------

    def charge_generated(self, tenant: str | None, n: int = 1) -> None:
        """Bill `n` generated tokens to the tenant: the generated
        bucket takes the debt (deprioritizing future admissions until
        it refills) and the lifetime counter feeds the scrape-path
        mirrors."""
        st = self._state(self.resolve(tenant))
        now = self._clock()
        with self._lock:
            st.generated += n
            self._decay_recent(st, now)
            st.recent += n
            if st.generated_bucket is not None:
                st.generated_bucket.charge(n, now)

    def charge_speculation(self, tenant: str | None, drafted: int,
                           accepted: int) -> None:
        """Account one dispatch's speculative work for the tenant:
        `drafted` tokens were proposed on its rows, `accepted` of them
        committed. The generated-token BUCKET is untouched — committed
        tokens were already billed one by one via charge_generated —
        this only feeds the wasted-speculation ledger (drafted -
        accepted) the scrape-path mirrors and the fleet merge report."""
        st = self._state(self.resolve(tenant))
        with self._lock:
            st.spec_drafted += drafted
            st.spec_accepted += accepted

    # -- scrape-path views --------------------------------------------------

    def tenants(self) -> list[str]:
        return list(self._order)

    def _fair_shares_locked(self) -> dict[str, float]:
        return compute_fair_shares(
            {name: (st.cfg.weight, float(st.generated))
             for name, st in self._states.items()})

    def fair_shares(self) -> dict[str, float]:
        """{tenant: generated-token share / weighted entitlement} —
        1.0 means exactly the fair share; the compact per-iteration
        gauge the paged server's flight recorder records."""
        with self._lock:
            return self._fair_shares_locked()

    def stats(self) -> dict[str, dict]:
        """Per-tenant counters + fair-share view for the metrics
        mirror and /stats. `fair_share` is the tenant's share of all
        generated tokens divided by its weight share — 1.0 means the
        tenant is getting exactly its weighted entitlement."""
        with self._lock:
            shares = self._fair_shares_locked()
            out = {}
            for name, st in self._states.items():
                out[name] = {
                    "weight": st.cfg.weight,
                    "priority": st.cfg.priority,
                    "pending": st.pending,
                    "submitted": st.submitted,
                    "rejected": st.rejected,
                    "generated": st.generated,
                    "preempt_requeues": st.preempt_requeues,
                    "prefill_tokens": st.prefill_tokens,
                    "spec_drafted": st.spec_drafted,
                    "spec_accepted": st.spec_accepted,
                    "spec_wasted": st.spec_drafted - st.spec_accepted,
                    "fair_share": shares[name],
                }
            return out


    def mirror_metrics(self, registry) -> None:
        """Scrape-path mirror of the per-tenant counters into a
        `utils.serving_metrics.MetricsRegistry` as tenant-labeled
        series (one series per tenant per family; the catalog lives in
        docs/observability.md). Called from the servers' snapshot
        collectors — never from the serving hot path."""
        from cloud_server_tpu_torch.utils.serving_metrics import TENANT_TTFT
        for name, s in self.stats().items():
            lbl = {"tenant": name}
            registry.counter(
                "tenant_requests_submitted_total",
                "Requests accepted by submit(), per tenant",
                labels=lbl).set_total(s["submitted"])
            registry.counter(
                "tenant_requests_rejected_total",
                "Per-tenant 429s (pending bound or rate limit)",
                labels=lbl).set_total(s["rejected"])
            registry.counter(
                "tenant_generated_tokens_total",
                "Lifetime generated tokens, per tenant",
                labels=lbl).set_total(s["generated"])
            registry.counter(
                "tenant_prefill_tokens_total",
                "Prefill tokens funded by mixed iterations, per tenant",
                labels=lbl).set_total(s["prefill_tokens"])
            registry.counter(
                "tenant_preempt_requeues_total",
                "Preempt-requeues charged to the tenant's slots",
                labels=lbl).set_total(s["preempt_requeues"])
            registry.counter(
                "tenant_spec_wasted_tokens_total",
                "Rejected speculative draft work on the tenant's rows "
                "(drafted - accepted; committed tokens are billed to "
                "the generated bucket, this is the waste ledger)",
                labels=lbl).set_total(s["spec_wasted"])
            registry.gauge(
                "tenant_pending_requests",
                "Queued requests awaiting admission, per tenant",
                labels=lbl).set(s["pending"])
            registry.gauge(
                "tenant_fair_share",
                "Generated-token share over weighted entitlement "
                "(1.0 = exactly the tenant's fair share)",
                labels=lbl).set(s["fair_share"])
            # eager get-or-create: the TTFT family (observed by
            # ServingMetrics at first token) exists for every known
            # tenant even before its first request
            registry.histogram(*TENANT_TTFT, labels=lbl)


def resolve_registry(qos, qos_config: str = "") -> TenantRegistry | None:
    """The one constructor both servers use: `qos` may be a ready
    TenantRegistry, a config dict, a JSON string, a file path, None
    (falling back to `InferConfig.qos_config`, itself a JSON string or
    path), or the literal False — QoS force-disabled regardless of the
    config fallback (the bench's control arm and any caller that needs
    "explicitly off" rather than "unset"). Returns None — QoS fully
    disabled, byte-identical legacy scheduling — when nothing is
    configured."""
    if qos is False:
        return None
    if isinstance(qos, TenantRegistry):
        return qos
    spec = qos if qos is not None else (qos_config or None)
    if spec is None or spec == "":
        return None
    if isinstance(spec, str):
        text = spec
        if not text.lstrip().startswith("{"):
            with open(text) as f:  # a path, not inline JSON
                text = f.read()
        spec = json.loads(text)
    if not isinstance(spec, dict):
        raise ValueError("qos config must be a JSON object")
    return TenantRegistry(spec)
