"""Data-parallel serving scale-OUT: a replica router.

N INDEPENDENT replicas — each with its own scheduler and page pools
(on its own card, or several on one card sharing one copy of the
weights) — behind a single submit().
The router is pure host-side policy; replicas never synchronize with
each other, so throughput and availability scale linearly and a
replica failure sheds only its own in-flight work (the same shape as
the reference stacks' multi-replica deployments: router + N engines,
re-built here without any cross-replica NCCL).

Placement: least-loaded (active + pending), round-robin on ties — the
rotation keeps a cold, empty fleet from piling every request on
replica 0. Tenant-tagged submits (multi-tenant QoS, inference/qos.py)
break ties from the TENANT'S OWN stable home offset instead of the
global rotation: on an un-loaded fleet a tenant's requests land on the
same replica first (radix prefix-cache locality for its prompts) while
load imbalance still dominates the pick the moment it appears. QoS
limits are PER REPLICA (each replica owns an independent registry):
token buckets and max_pending bound a tenant on each replica, so its
fleet-wide ceiling is ~N× the configured value — divide rates by the
replica count when a fleet-wide bound is the intent. Fair-share
weights need no scaling (ratios converge per replica).

The router exposes the submit / num_active / num_pending / start /
stop surface the HTTP front-end expects, so
`HttpFrontend(ReplicatedRouter(...))` serves a fleet unchanged.

A copy of the reference's `inference/router.py`. It differs in
`over_devices` (torch devices, CUDA by default, no CPU fallback) and in
`submit`, where a replica's NotImplementedError (an option the port
does not serve) is the client's refusal, not a replica failure.
"""

from __future__ import annotations

import inspect
import itertools
import logging
import queue
import threading
import time
import zlib
from typing import Sequence

import torch

from cloud_server_tpu_torch.inference.request_trace import (any_trace,
                                                      continuation_ctx)
from cloud_server_tpu_torch.inference.server import QueueFullError

_log = logging.getLogger(__name__)

# Per-replica circuit-breaker states. closed = routing normally;
# open = the replica failed `breaker_threshold` times in a row and is
# excluded from placement until `breaker_reset_s` elapses; half_open =
# the reset elapsed and exactly ONE probe submit may route there — its
# outcome decides closed vs re-open.
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

_BREAKER_GAUGE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1,
                  BREAKER_OPEN: 2}

# Replica roles for disaggregated prefill/decode serving. colocated =
# today's behavior (every replica admits and decodes); prefill = new
# admissions chunk-prefill here, then interactive requests hand off;
# decode = handoff destinations, pinned low-latency decode. A fleet is
# DISAGGREGATED only when it has at least one prefill AND one decode
# replica — any other role mix degrades to colocated placement.
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"
ROLE_COLOCATED = "colocated"
_VALID_ROLES = frozenset({ROLE_PREFILL, ROLE_DECODE, ROLE_COLOCATED})


class _Breaker:
    """One replica's circuit-breaker record (mutated under the
    router's lock only)."""

    __slots__ = ("state", "failures", "opened_at", "probing")

    def __init__(self):
        self.state = BREAKER_CLOSED
        self.failures = 0       # consecutive, reset on any success
        self.opened_at = 0.0    # monotonic moment the breaker opened
        self.probing = False    # half_open: a probe submit is in flight


class _DetachedSlot:
    """Tombstone occupying a removed replica's index. The per-replica
    arrays (`replicas`/`roles`/`_inflight`/`_breakers`/...) are
    indexed by position everywhere — submits capture an index, then
    call into it AFTER the router lock is released — so removal must
    never shift indices. A detached slot is permanently unready and
    empty; a racing submit that captured the index before detachment
    gets a RuntimeError from `submit()` and fails over like any other
    server-class refusal. `add_replica` reuses detached indices, so a
    scale-up/scale-down cycle does not grow the arrays without
    bound."""

    ready = False
    num_active = 0
    num_pending = 0
    tokens_emitted = 0

    def submit(self, prompt, **kw):
        raise RuntimeError("replica detached (removed from the fleet)")

    def step(self) -> int:
        return 0

    def start(self):
        return self

    def stop(self, *a, **kw) -> None:
        pass


class ReplicatedRouter:
    """Route requests across independent serving replicas, with
    per-replica circuit breakers and failover retry.

    Failure handling (the fleet's failure-domain contract):

      * A replica whose submit() raises a server error is skipped and
        the submit FAILS OVER to the next healthy replica; the client
        never sees a single-replica crash as long as any replica
        accepts.
      * A request that fails IN FLIGHT (scheduler crash -> _fail_all,
        stop-before-complete) is offered back to the router by the
        replica's completion path (`Request._fail_handler`). If it
        emitted ZERO tokens — the safe-retry rule: nothing was ever
        streamed, so resubmission cannot duplicate output — and its
        deadline has not passed, the router resubmits it to a healthy
        replica (excluding every replica it already failed on) and the
        original Request handle completes with the retry's outcome;
        its trace gains a `router_retry` span in the same trace tree.
      * A request that already STREAMED tokens is MIGRATED instead
        (inference/migration.py): its host state — generated tokens,
        position-keyed RNG seed, grammar progress, deadline
        remainder — is salvaged from the handle and resumed on a
        healthy replica at the exact next token, on the same stream
        (greedy outputs are token-identical to an uninterrupted run;
        seeded sampling is exact because RNG streams are
        position-keyed). The trace gains a `migrate` span in the same
        tree. Only when migration cannot proceed (export fault, no
        healthy replica, past deadline, non-migratable backend) does
        the old fail-fast contract apply and the HTTP front-end marks
        the failure `"retriable": false`.
      * `drain(replica_index)` evacuates a replica for maintenance:
        every active request live-migrates to a healthy replica
        before the drain waits out whatever could not move — replica
        maintenance is a zero-token-loss operation.
      * Every failure trips the failing replica's breaker: after
        `breaker_threshold` consecutive failures it OPENS (excluded
        from placement), after `breaker_reset_s` it half-opens for one
        probe submit, and a probe success closes it again.

    Breaker state is surfaced on /healthz (`breaker_states()`), and
    the retry/failover/migration/breaker counters ride
    `metrics_snapshot()` with the `cloud_server_router_` families
    (docs/observability.md)."""

    def __init__(self, replicas: Sequence, *,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 30.0,
                 roles: Sequence[str] | None = None):
        if not replicas:
            raise ValueError("need at least one replica")
        if breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if breaker_reset_s <= 0:
            raise ValueError("breaker_reset_s must be > 0")
        self.replicas = list(replicas)
        # disaggregated prefill/decode roles (docs/serving.md): None —
        # the default — means every replica is colocated and every
        # placement/handoff path below short-circuits, byte-identical
        # to the role-less router (pinned by the existing exact-output
        # and dispatch-count guard tests).
        if roles is None:
            self.roles = [ROLE_COLOCATED] * len(self.replicas)
        else:
            self.roles = [str(r) for r in roles]
            if len(self.roles) != len(self.replicas):
                raise ValueError(
                    f"roles has {len(self.roles)} entries for "
                    f"{len(self.replicas)} replicas")
            bad = set(self.roles) - _VALID_ROLES
            if bad:
                raise ValueError(
                    f"unknown replica roles {sorted(bad)}; valid: "
                    f"{sorted(_VALID_ROLES)}")
        self._disagg = (ROLE_PREFILL in self.roles
                        and ROLE_DECODE in self.roles)
        if (any(r != ROLE_COLOCATED for r in self.roles)
                and not self._disagg):
            raise ValueError(
                "a role-specialized fleet needs at least one "
                "'prefill' AND one 'decode' replica (got "
                f"{self.roles}); use all-'colocated' (or roles=None) "
                "for a uniform fleet")
        self._rr = itertools.count()
        self._lock = threading.Lock()
        # submits picked but not yet visible in their replica's pending
        # queue: _pick() counts them so concurrent submitters see fresh
        # load instead of racing into the same replica (the lock is NOT
        # held across the replica's submit() — that can block on model
        # work — so the counter is what bridges the window)
        self._inflight = [0] * len(self.replicas)
        # indices whose replica was removed at runtime (remove_replica):
        # tombstoned, never picked, reusable by add_replica; _removing
        # marks an in-progress removal so two removers cannot claim
        # one slot
        self._detached: set[int] = set()
        self._removing: set[int] = set()
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self._breakers = [_Breaker() for _ in self.replicas]
        # router-level metrics: the router owns fleet plumbing no
        # replica can see (failovers, retries, breaker trips), so it
        # keeps its own registry and merges it into metrics_snapshot()
        from cloud_server_tpu_torch.utils.serving_metrics import (
            MetricsRegistry)
        reg = self._registry = MetricsRegistry()
        self._m_failovers = reg.counter(
            "router_submit_failovers_total",
            "submit() calls re-routed after a replica refused with a "
            "server error")
        self._m_retries = reg.counter(
            "router_retries_total",
            "In-flight requests resubmitted to another replica after "
            "failing with zero tokens emitted")
        self._m_retry_success = reg.counter(
            "router_retry_success_total",
            "Failover retries whose resubmission completed normally")
        self._m_migrations = reg.counter(
            "router_migrations_total",
            "Mid-stream failures and drain evacuations handed to "
            "live migration (state salvaged, resumption dispatched)")
        self._m_migration_success = reg.counter(
            "router_migration_success_total",
            "Live migrations whose resumed request completed "
            "normally on the destination replica")
        self._migration_ms = reg.histogram(
            "migration_ms",
            "Live-migration handoff latency (failure or drain offer "
            "through destination re-admission), ms",
            buckets=(1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                     500.0, 1000.0, 2500.0, 5000.0))
        self._m_breaker_open = reg.counter(
            "router_breaker_open_total",
            "Circuit-breaker open transitions (closed/half_open -> "
            "open), fleet lifetime")
        self._m_drainless = reg.counter(
            "router_drainless_stops_total",
            "stop(drain=...) calls that fell back to a drain-less "
            "replica stop() (replica without drain support)")
        # disaggregation handoff counters (zeros unless a role-
        # specialized fleet runs): attempts, continuations admitted on
        # a decode replica, and the admission-to-admission latency.
        # Registered EAGERLY so the families exist for the docs drift
        # check whether or not a handoff ever runs.
        self._m_handoffs = reg.counter(
            "router_handoffs_total",
            "Disaggregation handoffs attempted (prefill-complete "
            "requests offered to a decode replica)")
        self._m_handoff_success = reg.counter(
            "router_handoff_success_total",
            "Disaggregation handoffs whose continuation was admitted "
            "on a decode replica")
        self._handoff_ms = reg.histogram(
            "router_handoff_ms",
            "Disaggregation handoff latency (prefill completion "
            "through destination re-admission), ms",
            buckets=(1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                     500.0, 1000.0, 2500.0, 5000.0))
        for i in range(len(self.replicas)):
            reg.gauge("router_breaker_state",
                      "Per-replica breaker state (0 closed, 1 "
                      "half_open, 2 open)",
                      labels={"replica": str(i)})
            # the fleet's role map as a labeled constant gauge, so
            # per-role splits of any replica-tagged series are
            # readable from one scrape
            reg.gauge("router_replica_role",
                      "Replica role assignment (constant 1; the role "
                      "rides the labels)",
                      labels={"replica": str(i),
                              "role": self.roles[i]}).set(1)
        reg.add_collector(self._collect_router_metrics)
        # can each replica's submit() carry the failover hook?
        # (our servers take `fail_handler=`; third-party backends
        # without it — or without **kwargs — keep the old no-failover
        # behavior instead of TypeError-ing every submit)
        self._accepts_hook = [self._submit_takes_hook(r)
                              for r in self.replicas]
        self._accepts_handoff = [self._submit_takes_hook(r, "handoff")
                                 for r in self.replicas]
        # disaggregation handoff plumbing: a prefill replica fires the
        # submit-time handoff callback (outside its step lock) when a
        # request's chunked prefill completes; the callback enqueues
        # here and ONE daemon worker migrates request-by-request — a
        # flood of simultaneous completions must not mint a thread
        # each. Colocated fleets never start the worker.
        self._handoff_q: "queue.SimpleQueue | None" = None
        self._handoff_thread: threading.Thread | None = None
        if self._disagg:
            self._handoff_q = queue.SimpleQueue()
            self._handoff_thread = threading.Thread(
                target=self._handoff_worker, daemon=True,
                name="router-handoff")
            self._handoff_thread.start()

    @staticmethod
    def _submit_takes_hook(replica, kwarg: str = "fail_handler") -> bool:
        try:
            params = inspect.signature(replica.submit).parameters
        except (TypeError, ValueError):
            return False
        return (kwarg in params
                or any(p.kind == p.VAR_KEYWORD
                       for p in params.values()))

    @classmethod
    def over_devices(cls, params, cfg, infer_cfg, *, devices=None,
                     server_cls=None, **srv_kw) -> "ReplicatedRouter":
        """One replica per device, each with `params` moved there with
        `.to(d)` (a copy per device; on the device the tensors already
        live on, they are shared, as JAX's `device_put` shares them).
        `devices` (torch devices or names) defaults to every visible
        CUDA device; with none visible this raises, it never falls back
        to the CPU."""
        from cloud_server_tpu_torch.inference.paged_server import (
            PagedInferenceServer)
        server_cls = server_cls or PagedInferenceServer
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is visible: pass devices= to place "
                    "the replicas")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        replicas = []
        for d in map(torch.device, devices):
            local = {g: {n: t.to(d) for n, t in leaves.items()}
                     for g, leaves in params.items()}
            replicas.append(server_cls(local, cfg, infer_cfg, device=d,
                                       **srv_kw))
        return cls(replicas)

    # -- placement ----------------------------------------------------------

    def _breaker_admits_locked(self, i: int, now: float) -> bool:
        """May placement route to replica `i` right now? (caller holds
        the router lock). Lazily transitions open -> half_open when
        the reset window elapsed; half_open admits only while no probe
        is in flight."""
        b = self._breakers[i]
        if b.state == BREAKER_CLOSED:
            return True
        if b.state == BREAKER_OPEN:
            if now - b.opened_at < self.breaker_reset_s:
                return False
            b.state = BREAKER_HALF_OPEN
            b.probing = False
        return not b.probing

    @staticmethod
    def _prefill_load(replica) -> int:
        """Placement load for a PREFILL pick: queued prompt work, not
        occupied decode slots. Our servers expose the exact figure
        (pending prefill tokens); a backend without it degrades to the
        generic request count."""
        n = getattr(replica, "pending_prefill_tokens", None)
        return (replica.num_active + replica.num_pending
                if n is None else int(n))

    def _role_candidates(self, cands: list[int],
                         role: str | None) -> list[int]:
        """Narrow a candidate set to replicas of `role` — but NEVER to
        empty: when no replica of the wanted role is healthy (open
        breakers, drains), placement falls back to whatever is, so a
        role-specialized fleet degrades to colocated behavior instead
        of refusing work."""
        if role is None or not self._disagg:
            return cands
        pref = [j for j in cands if self.roles[j] == role]
        return pref or cands

    def _plan_roles(self, tenant: str | None) -> tuple[str | None, bool]:
        """The disaggregation placement plan for one submit:
        (admission role preference, arm the prefill->decode handoff?).
        Every request ADMITS toward prefill capacity (admission cost
        IS prefill); only interactive-class tenants hand off to a
        decode replica afterward — batch/best_effort decode where
        they prefilled, soaking prefill-replica slack instead of
        polluting the low-latency decode pool."""
        # analysis: allow[lock-discipline] GIL-atomic bool: topology
        # flips only inside add/remove_replica under _lock; a stale
        # read routes one request with the old topology, which the
        # failover/handoff paths tolerate by design
        if not self._disagg:
            return None, False
        cls = "interactive"
        try:
            q = self.qos
            if q is not None:
                cls = q.priority_class(q.resolve(tenant))
        except Exception:  # noqa: BLE001 — unknown tenant/backends
            pass
        return ROLE_PREFILL, cls == "interactive"

    def _pick(self, *, tenant: str | None = None,
              count_inflight: bool = False,
              exclude: frozenset | set = frozenset(),
              strict: bool = False,
              role: str | None = None) -> int | None:
        n = len(self.replicas)
        if role == ROLE_PREFILL and self._disagg:
            # prefill picks balance by queued PROMPT tokens: decode
            # occupancy (num_active) says nothing about how long a new
            # prompt waits for chunk-prefill budget
            loads = [self._prefill_load(r) + inf
                     for r, inf in zip(self.replicas, self._inflight)]
        else:
            loads = [r.num_active + r.num_pending + inf
                     for r, inf in zip(self.replicas, self._inflight)]
        if tenant is None:
            k = next(self._rr) % n
        else:
            # tenant-affinity tie-break: a stable per-tenant home
            # offset (crc32, not hash() — PYTHONHASHSEED-independent)
            # so an idle fleet serves a tenant from one replica (its
            # prompts hit that replica's radix prefix cache) while
            # least-loaded still wins under any load skew
            k = zlib.crc32(tenant.encode()) % n
        # readiness- and breaker-aware placement: a draining (or
        # stopped) replica advertises ready=False, an open breaker
        # excludes a repeatedly-failing one, and `exclude` carries a
        # failover's already-failed set. Fallback chain (non-strict):
        # healthy -> merely ready -> anything not excluded -> all, so
        # a wholly-unready fleet surfaces the replica's own refusal
        # instead of an index error. Strict mode (failover retries)
        # returns None rather than re-picking an excluded replica —
        # resubmitting to the replica that just failed the request
        # would retry into the same failure.
        now = time.monotonic()
        # a detached (removed) slot is out of EVERY tier, including
        # the last-resort fallback: there is no replica behind it
        alive = [j for j in range(n) if j not in self._detached]
        ready = [j for j in alive
                 if j not in exclude
                 and getattr(self.replicas[j], "ready", True)]
        cands = ([j for j in ready
                  if self._breaker_admits_locked(j, now)] or ready)
        if not cands:
            if strict:
                return None
            cands = ([j for j in alive if j not in exclude] or alive)
        # role preference narrows AFTER health (a healthy off-role
        # replica beats a broken on-role one — see _role_candidates)
        cands = self._role_candidates(cands, role)
        # least loaded; ties resolve round-robin from k
        i = min(cands, key=lambda j: (loads[j], (j - k) % n))
        b = self._breakers[i]
        if b.state == BREAKER_HALF_OPEN and count_inflight:
            # this pick is the probe (submit paths only — monitoring
            # picks like embed() never resolve a probe, so they must
            # not claim one)
            b.probing = True
        if count_inflight:
            self._inflight[i] += 1
        return i

    def _release_probe(self, i: int) -> None:
        """A probe submit resolved WITHOUT a breaker verdict (client-
        class refusal: queue full, bad request): free the half-open
        slot so the next submit can probe — otherwise the breaker
        wedges with `probing` latched forever."""
        with self._lock:
            b = self._breakers[i]
            if b.state == BREAKER_HALF_OPEN:
                b.probing = False

    def _record_breaker_failure(self, i: int) -> None:
        """One failure event on replica `i` (submit refusal or an
        in-flight request failure): consecutive count up; at the
        threshold — or on a failed half-open probe — the breaker
        OPENS and placement stops routing there until the reset."""
        with self._lock:
            b = self._breakers[i]
            b.failures += 1
            if b.state == BREAKER_HALF_OPEN or (
                    b.state == BREAKER_CLOSED
                    and b.failures >= self.breaker_threshold):
                b.state = BREAKER_OPEN
                b.opened_at = time.monotonic()
                b.probing = False
                self._m_breaker_open.inc()

    def _record_breaker_success(self, i: int) -> None:
        with self._lock:
            b = self._breakers[i]
            b.failures = 0
            b.state = BREAKER_CLOSED
            b.probing = False

    def _make_fail_hook(self, replica: int, prompt, kw: dict,
                        excluded: frozenset, orig):
        """The Request._fail_handler a submit carries INTO the
        replica: context rides in the closure (no post-submit
        attribute installation — a scheduler crash in that window
        would otherwise complete the request past the hook). `orig`
        is None on the first hop (the failing request IS the
        original client handle)."""
        def hook(req) -> bool:
            return self._on_request_failed(
                req, replica, prompt, kw, excluded,
                orig if orig is not None else req)
        return hook

    def submit(self, prompt, **kw):
        t0 = time.perf_counter()
        excluded: set[int] = set()
        role, arm_handoff = self._plan_roles(kw.get("tenant"))
        while True:
            with self._lock:
                i = self._pick(tenant=kw.get("tenant"),
                               count_inflight=True, exclude=excluded,
                               role=role)
            # analysis: allow[lock-discipline] GIL-atomic list index:
            # capability slots are written once at attach under _lock
            # and i came from _pick — a read racing an attach at worst
            # skips the hook for that one request
            hkw = ({"fail_handler": self._make_fail_hook(
                        i, prompt, dict(kw), frozenset(excluded),
                        None)}
                   if self._accepts_hook[i] else {})
            if (arm_handoff and self.roles[i] == ROLE_PREFILL
                    # analysis: allow[lock-discipline] GIL-atomic
                    # capability slot, see hkw above
                    and self._accepts_handoff[i]
                    and hasattr(self.replicas[i], "migrate_export")):
                # prefill landed on a prefill replica: ride the
                # handoff hook IN through submit (same no-install-
                # window rule as the failover hook) so the replica
                # pings us the moment chunked prefill completes
                hkw["handoff"] = self._make_handoff_hook(i, dict(kw))
            try:
                req = self.replicas[i].submit(prompt, **hkw, **kw)
            except (QueueFullError, NotImplementedError):
                # backpressure (global bound, tenant 429, brownout
                # shed): a CLIENT-class refusal, not a replica
                # failure — no breaker event, no failover (the 429's
                # Retry-After is the contract). An option the port
                # does not serve (NotImplementedError, a RuntimeError)
                # is refused alike: every replica would refuse it
                with self._lock:
                    self._inflight[i] -= 1
                self._release_probe(i)
                raise
            except RuntimeError as exc:
                # server-class refusal (stopped, crashed, injected):
                # trip the breaker — unless the replica is merely
                # unready (draining), which is expected — and FAIL
                # OVER to the next replica
                with self._lock:
                    self._inflight[i] -= 1
                if getattr(self.replicas[i], "ready", True):
                    self._record_breaker_failure(i)
                else:
                    self._release_probe(i)
                excluded.add(i)
                if len(excluded) >= len(self.replicas):
                    raise
                self._m_failovers.inc()
                continue
            except BaseException:
                with self._lock:
                    self._inflight[i] -= 1
                self._release_probe(i)
                raise
            self._record_breaker_success(i)
            tr = getattr(req, "trace", None)
            if tr is not None:
                # the fleet half of the request's ONE span tree: the
                # routing decision as an explicit span (pick through
                # replica-submit return) + the replica tag every
                # replica-side span inherits via the root
                tr.annotate(replica=i)
                tr.add_span("router_pick", t0, time.perf_counter(),
                            replica=i)
            # the request is now in the replica's pending queue — its
            # load is visible/settled again (its failover hook rode
            # IN through submit, so there is no install window a
            # crash could slip past)
            with self._lock:
                self._inflight[i] -= 1
            return req

    # -- failover retry ------------------------------------------------------

    def _on_request_failed(self, req, replica: int, prompt, kw: dict,
                           excluded: frozenset, orig) -> bool:
        """Body of the closure _make_fail_hook plants as
        Request._fail_handler: a router-submitted request completed
        with an "error:" finish_reason on its replica. Runs on the
        FAILING replica's thread (possibly inside _fail_all, holding
        its step lock), so this only classifies and hands off; the
        resubmission happens on a fresh daemon thread. True = the
        router took ownership and a retry will complete the request;
        False = the failure stands (the replica unblocks waiters)."""
        if getattr(req, "_request_fault", False):
            # REQUEST-caused error (e.g. it can never fit the page
            # pool): it would fail identically on every replica — no
            # retry, and no breaker event against a healthy replica
            return False
        self._record_breaker_failure(replica)
        excluded = set(excluded) | {replica}
        # the SAFE-RETRY rule, upgraded by live migration: a request
        # that streamed NOTHING resubmits plainly (at-most-once token
        # delivery — nothing to duplicate); one that already streamed
        # is MIGRATED — host state salvaged from the handle, resumed
        # on a healthy replica at the exact next token. Only when the
        # migration cannot even start (checks below, export fault,
        # non-migratable backend) does the failure stand and the HTTP
        # layer mark it retriable: false.
        mid_stream = bool(req.tokens or orig.tokens)
        if orig._cancel.is_set():
            return False
        if (orig.deadline is not None
                and time.perf_counter() > orig.deadline):
            return False  # past deadline: retrying cannot help
        if len(excluded) >= len(self.replicas):
            return False
        with self._lock:
            now = time.monotonic()
            if not any(j not in excluded
                       and getattr(r, "ready", True)
                       and self._breaker_admits_locked(j, now)
                       for j, r in enumerate(self.replicas)):
                return False  # nowhere healthy to retry
        if mid_stream:
            salvage = getattr(self.replicas[replica],
                              "migrate_salvage", None)
            if salvage is None:
                return False  # backend without migration: fail fast
            # whichever handle carries MORE of the stream is the
            # truth (req is the failing hop's request — on hop > 1 it
            # holds the full pre-filled stream; orig only mirrors at
            # success)
            src = req if len(req.tokens) >= len(orig.tokens) else orig
            try:
                snap = salvage(src, reason="failover")
            except Exception:  # noqa: BLE001 — injected or real
                return False  # export failed: the old contract stands
            self._m_migrations.inc()
            threading.Thread(
                target=self._migrate_submit,
                args=(orig, snap, replica, excluded, kw),
                daemon=True, name="router-migrate").start()
            return True
        self._m_retries.inc()
        threading.Thread(
            target=self._retry_submit,
            args=(orig, replica, excluded, prompt, kw),
            daemon=True, name="router-retry").start()
        return True

    def _retry_submit(self, orig, from_replica: int, excluded: set,
                      prompt, kw) -> None:
        """Resubmit a zero-token failed request to a healthy replica
        (retry worker thread). The ORIGINAL Request stays the client's
        handle: the retry submits with the same stream callback,
        sampling, and tenant, joins the same trace (gaining a
        `router_retry` span), and on completion mirrors its outcome
        onto the original before unblocking its waiters."""
        t_fail = time.perf_counter()
        kw = dict(kw)
        if orig.deadline is not None:
            remaining = orig.deadline - time.perf_counter()
            if remaining <= 0:
                orig._done.set()  # expired while handing off
                return
            kw["deadline_s"] = remaining
        ctx = continuation_ctx(orig)
        if ctx is not None:
            # the retry joins the ORIGINAL trace (same trace id,
            # parented at the original root), so the hop is one story
            # — tail-provisional traces too, with sampled=False so
            # the continuation stays on the tail-retention path
            kw["trace_ctx"] = ctx
        while True:
            with self._lock:
                i = self._pick(tenant=kw.get("tenant"),
                               count_inflight=True, exclude=excluded,
                               strict=True)
            if i is None:
                break  # nothing healthy left: the failure stands
            # analysis: allow[lock-discipline] GIL-atomic capability
            # slot (written once at attach under _lock), as in submit
            hkw = ({"fail_handler": self._make_fail_hook(
                        i, prompt, dict(kw), frozenset(excluded),
                        orig)}
                   if self._accepts_hook[i] else {})
            try:
                new = self.replicas[i].submit(prompt, **hkw, **kw)
            except Exception as exc:  # noqa: BLE001 — any refusal: next
                with self._lock:
                    self._inflight[i] -= 1
                if (isinstance(exc, RuntimeError)
                        and not isinstance(exc, QueueFullError)
                        and getattr(self.replicas[i], "ready", True)):
                    self._record_breaker_failure(i)
                else:
                    self._release_probe(i)
                excluded.add(i)
                if len(excluded) >= len(self.replicas):
                    break
                continue
            with self._lock:
                self._inflight[i] -= 1
            self._record_breaker_success(i)
            if not hasattr(new, "_fail_handler"):
                # a backend without the Request completion surface
                # cannot report the retry's outcome back — the
                # original failure stands (and the resubmitted work,
                # if any, runs unobserved)
                orig._done.set()
                return
            # error completions already route through the fail hook
            # that rode IN with the submit; _on_done handles success
            # mirroring. The only window left is a NORMAL completion
            # before _on_done lands — closed by the idempotent
            # re-check below.
            new._router_orig = orig
            new._on_done = self._mirror_retry
            # cancel propagation: cancelling the original handle now
            # cancels the retry (the original's own replica is gone).
            # GENERATION-guarded under the router lock: a slow hop-N
            # thread must not overwrite the link a later hop already
            # installed — cancel() would then hit the dead earlier
            # retry while the live one decodes on, orphaned. The
            # excluded set grows strictly per hop, so its size is the
            # hop's generation.
            with self._lock:
                gen = len(excluded)
                if gen >= getattr(orig, "_router_cancel_gen", -1):
                    orig._router_cancel_gen = gen
                    orig._on_cancel = lambda _r, _n=new: _n.cancel()
            if orig._cancel.is_set():
                new.cancel()
            tr = any_trace(new)
            if tr is not None:
                tr.annotate(replica=i, retry_of=orig.request_id)
                tr.add_span("router_retry", t_fail,
                            time.perf_counter(),
                            from_replica=from_replica, replica=i,
                            attempt=len(excluded))
            if new.done:
                self._mirror_retry(new)
            return
        # could not resubmit anywhere: the original failure stands
        orig._done.set()

    def _migrate_submit(self, orig, snap, from_replica: int,
                        excluded: set, kw) -> None:
        """Resume a salvaged mid-stream request on a healthy replica
        (migration worker thread; `_retry_submit`'s shape, but the
        re-admission goes through `migrate_import` so the destination
        resumes at the exact next token). The ORIGINAL Request stays
        the client's handle: the continuation emits only NEW tokens
        through the same stream callback, joins the same trace
        (gaining a `migrate` span), and on completion mirrors its
        outcome onto the original before unblocking its waiters."""
        t_fail = time.perf_counter()
        deadline_s = None
        if orig.deadline is not None:
            remaining = orig.deadline - time.perf_counter()
            if remaining <= 0:
                orig._done.set()  # expired while handing off
                return
            deadline_s = remaining
        trace_ctx = continuation_ctx(orig)
        while True:
            with self._lock:
                i = self._pick(tenant=kw.get("tenant"),
                               count_inflight=True, exclude=excluded,
                               strict=True)
            if i is None:
                break  # nothing healthy left: the failure stands
            imp = getattr(self.replicas[i], "migrate_import", None)
            if imp is None:
                # non-migratable backend: skip it for THIS request
                # without a breaker event (it did nothing wrong)
                with self._lock:
                    self._inflight[i] -= 1
                self._release_probe(i)
                excluded.add(i)
                if len(excluded) >= len(self.replicas):
                    break
                continue
            # analysis: allow[lock-discipline] GIL-atomic capability
            # slot (written once at attach under _lock), as in submit
            hook = (self._make_fail_hook(
                        i, list(snap.prompt), dict(kw),
                        frozenset(excluded), orig)
                    if self._accepts_hook[i] else None)
            try:
                new = imp(snap, stream=kw.get("stream"),
                          fail_handler=hook, trace_ctx=trace_ctx,
                          deadline_s=deadline_s)
            except Exception as exc:  # noqa: BLE001 — any refusal: next
                with self._lock:
                    self._inflight[i] -= 1
                if (isinstance(exc, RuntimeError)
                        and not isinstance(exc, QueueFullError)
                        and getattr(self.replicas[i], "ready", True)):
                    self._record_breaker_failure(i)
                else:
                    self._release_probe(i)
                excluded.add(i)
                if len(excluded) >= len(self.replicas):
                    break
                continue
            with self._lock:
                self._inflight[i] -= 1
            self._record_breaker_success(i)
            # same mirroring/cancel-chain contract as _retry_submit
            # (see the comments there); _router_migrated routes the
            # success onto the migration counter instead of retry's
            new._router_orig = orig
            new._router_migrated = True
            new._on_done = self._mirror_retry
            with self._lock:
                gen = len(excluded)
                if gen >= getattr(orig, "_router_cancel_gen", -1):
                    orig._router_cancel_gen = gen
                    orig._on_cancel = lambda _r, _n=new: _n.cancel()
            if orig._cancel.is_set():
                new.cancel()
            tr = any_trace(new)
            if tr is not None:
                tr.annotate(replica=i, migrate_of=orig.request_id)
                tr.add_span("migrate", t_fail, time.perf_counter(),
                            from_replica=from_replica, replica=i,
                            attempt=len(excluded),
                            reason=snap.reason,
                            tokens_salvaged=len(snap.tokens),
                            kv_pages=snap.n_kv_pages())
            self._migration_ms.observe(
                (time.perf_counter() - t_fail) * 1e3)
            if new.done:
                self._mirror_retry(new)
            return
        # could not resume anywhere: the original failure stands
        orig._done.set()

    # -- disaggregation handoff ---------------------------------------------

    def _make_handoff_hook(self, replica: int, kw: dict):
        """The submit-time handoff callback a prefill replica fires
        (outside its step lock) the moment a request's chunked
        prefill completes and its first token streams. The hook only
        ENQUEUES — the scheduler thread must never block on another
        replica's admission path."""
        def hook(req) -> None:
            # analysis: allow[lock-discipline] GIL-atomic reference
            # snapshot: the queue is created once on the disagg
            # transition under _lock and never replaced
            q = self._handoff_q
            if q is not None:
                q.put((req, replica, kw))
        return hook

    def _handoff_worker(self) -> None:
        """Daemon loop draining the handoff queue one request at a
        time. A handoff is an OPTIMIZATION: any exception leaves the
        request decoding where it prefilled (or, after a successful
        export, the loop inside _handoff_one owns re-admission)."""
        # analysis: allow[lock-discipline] GIL-atomic reference
        # snapshot: the worker thread starts under _lock strictly
        # after the queue exists, and the queue is never replaced
        q = self._handoff_q
        while True:
            item = q.get()
            if item is None:
                return  # stop() sentinel
            try:
                self._handoff_one(*item)
            except Exception:  # noqa: BLE001 — keep draining
                pass

    def _handoff_one(self, orig, src_i: int, kw: dict) -> None:
        """Move one prefill-complete request to a decode replica:
        export the committed KV + host state from the prefill replica
        (the final-chunk device->host copies were already started by
        the scheduler's handoff prefetch, so the export's sanctioned
        sync mostly finds them resident) and re-admit through
        `migrate_import`. Until the export commits, the request keeps
        decoding on the prefill replica — a missing/unhealthy decode
        pool costs nothing. AFTER the export the request has left the
        source, so the import loop must land it somewhere: decode
        replicas first, any healthy replica next, the source itself
        last (its pages are still hot in the local prefix cache)."""
        if orig.done or orig._cancel.is_set():
            return
        excluded: set[int] = {src_i}
        with self._lock:
            now = time.monotonic()
            has_dest = any(
                j != src_i and self.roles[j] == ROLE_DECODE
                and getattr(r, "ready", True)
                and self._breaker_admits_locked(j, now)
                and getattr(r, "migrate_import", None) is not None
                for j, r in enumerate(self.replicas))
        if not has_dest:
            return  # no decode capacity: decode where it prefilled
        t0 = time.perf_counter()
        try:
            snap = self.replicas[src_i].migrate_export(
                orig, reason="handoff")
        except Exception:  # noqa: BLE001 — finished/cancelled/mid-
            return  # admission: the request stays local, no handoff
        self._m_handoffs.inc()
        deadline_s = None
        if orig.deadline is not None:
            remaining = orig.deadline - time.perf_counter()
            if remaining <= 0:
                orig.finish_reason = "error:deadline"
                orig._done.set()
                return
            deadline_s = remaining
        trace_ctx = continuation_ctx(orig)
        last_resort = False
        while True:
            with self._lock:
                i = self._pick(tenant=kw.get("tenant"),
                               count_inflight=True, exclude=excluded,
                               strict=True, role=ROLE_DECODE)
            if i is None:
                # nothing else healthy: land it back where it came
                # from before giving up entirely
                if last_resort:
                    break
                last_resort = True
                with self._lock:
                    self._inflight[src_i] += 1
                i = src_i
            imp = getattr(self.replicas[i], "migrate_import", None)
            if imp is None:
                with self._lock:
                    self._inflight[i] -= 1
                self._release_probe(i)
                excluded.add(i)
                continue
            # analysis: allow[lock-discipline] GIL-atomic capability
            # slot (written once at attach under _lock), as in submit
            hook = (self._make_fail_hook(
                        i, list(snap.prompt), dict(kw),
                        frozenset(excluded), orig)
                    if self._accepts_hook[i] else None)
            try:
                new = imp(snap, stream=kw.get("stream"),
                          fail_handler=hook, trace_ctx=trace_ctx,
                          deadline_s=deadline_s)
            except Exception as exc:  # noqa: BLE001 — any refusal: next
                with self._lock:
                    self._inflight[i] -= 1
                if (isinstance(exc, RuntimeError)
                        and not isinstance(exc, QueueFullError)
                        and getattr(self.replicas[i], "ready", True)):
                    self._record_breaker_failure(i)
                else:
                    self._release_probe(i)
                excluded.add(i)
                continue
            with self._lock:
                self._inflight[i] -= 1
            self._record_breaker_success(i)
            # same mirroring/cancel-chain contract as _migrate_submit;
            # _router_handoff keeps the completion off the failover-
            # migration success counter (handoff success is counted
            # HERE, at admission — the handoff "won" the moment the
            # continuation is decoding on the destination)
            new._router_orig = orig
            new._router_migrated = True
            new._router_handoff = True
            new._on_done = self._mirror_retry
            with self._lock:
                gen = len(excluded)
                if gen >= getattr(orig, "_router_cancel_gen", -1):
                    orig._router_cancel_gen = gen
                    orig._on_cancel = lambda _r, _n=new: _n.cancel()
            if orig._cancel.is_set():
                new.cancel()
            tr = any_trace(new)
            if tr is not None:
                tr.annotate(replica=i, handoff_of=orig.request_id)
                tr.add_span("handoff", t0, time.perf_counter(),
                            from_replica=src_i, replica=i,
                            tokens_salvaged=len(snap.tokens),
                            kv_pages=snap.n_kv_pages())
            if i != src_i:
                self._m_handoff_success.inc()
            self._handoff_ms.observe(
                (time.perf_counter() - t0) * 1e3)
            if new.done:
                self._mirror_retry(new)
            return
        # exported but nowhere to land (source included): the request
        # cannot continue — fail the handle so waiters unblock
        orig.finish_reason = orig.finish_reason or "error:handoff"
        orig._done.set()

    def _mirror_retry(self, new) -> None:
        """Request._on_done of a retry: copy the outcome onto the
        original handle and unblock its waiters (tokens already
        streamed through the shared stream callback). Idempotent
        UNDER THE ROUTER LOCK — both the replica's _on_done callback
        and the retry thread's done re-check may race here, and the
        success counter must move exactly once."""
        orig = getattr(new, "_router_orig", None)
        if orig is None:
            return
        with self._lock:
            if getattr(orig, "_router_mirrored", False):
                return
            orig._router_mirrored = True
        orig.tokens = new.tokens
        orig.logprobs = new.logprobs
        orig.emit_times = new.emit_times
        orig.finish_reason = new.finish_reason
        if (new.finish_reason is not None
                and not new.finish_reason.startswith("error")):
            if getattr(new, "_router_handoff", False):
                # disaggregation handoff: success already counted at
                # import admission (router_handoff_success_total) —
                # this completion is not a failover migration
                pass
            elif getattr(new, "_router_migrated", False):
                self._m_migration_success.inc()
            else:
                self._m_retry_success.inc()
        orig._done.set()
        # `orig` may ITSELF be a router continuation holding the true
        # client handle (a handed-off request drained or failed over
        # again chains through the replica's request object) —
        # propagate so the original submit's waiters unblock too.
        # Idempotency per link bounds the recursion.
        self._mirror_retry(orig)

    def generate(self, prompts, *, max_new_tokens=None):
        reqs = [self.submit(p, max_new_tokens=max_new_tokens)
                for p in prompts]
        self.run_until_idle()
        return [r.tokens for r in reqs]

    # -- aggregate surface (HTTP front-end compatible) ----------------------

    def embed(self, prompts):
        """Embeddings via the least-loaded replica (same weights
        everywhere, so any replica's answer is THE answer)."""
        with self._lock:
            i = self._pick()
        fn = getattr(self.replicas[i], "embed", None)
        if fn is None:
            raise ValueError(
                "this serving backend does not support embeddings")
        return fn(prompts)

    @property
    def adapters(self):
        """The adapter registry (replica 0's — add_adapter keeps every
        replica's registry identical, so ids/names agree fleet-wide)."""
        return getattr(self.replicas[0], "adapters", None)

    def add_adapter(self, name: str, lora_params, lora_cfg) -> int:
        """Register a LoRA adapter on EVERY replica (requests routed
        anywhere must find it). Returns the (fleet-wide) adapter id."""
        ids = {r.add_adapter(name, lora_params, lora_cfg)
               for r in self.replicas}
        if len(ids) != 1:  # registries diverged (out-of-band adds)
            raise RuntimeError(
                f"adapter {name!r} got inconsistent ids across "
                f"replicas: {sorted(ids)}; register adapters through "
                "the router only")
        return ids.pop()

    @property
    def num_active(self) -> int:
        return sum(r.num_active for r in self.replicas)

    @property
    def num_pending(self) -> int:
        return sum(r.num_pending for r in self.replicas)

    @property
    def ready(self) -> bool:
        """Fleet readiness: True while ANY replica accepts new work
        (a draining replica only removes itself from placement)."""
        return any(getattr(r, "ready", True) for r in self.replicas)

    def breaker_states(self) -> list[dict]:
        """Per-replica breaker view (the /healthz `replicas` block):
        state, consecutive failures, and the replica's own readiness.
        Reading surfaces any lazy open -> half_open transition, so
        the report never shows an open breaker whose reset already
        elapsed."""
        with self._lock:
            now = time.monotonic()
            out = []
            for i, b in enumerate(self._breakers):
                if i in self._detached:
                    continue
                self._breaker_admits_locked(i, now)
                out.append({
                    "replica": i, "role": self.roles[i],
                    "state": b.state,
                    "consecutive_failures": b.failures,
                    "ready": bool(getattr(self.replicas[i], "ready",
                                          True))})
            return out

    def replica_roles(self) -> list[str]:
        """The fleet's role map, by replica index (all "colocated"
        unless the constructor configured a disaggregated fleet)."""
        return list(self.roles)

    def _collect_router_metrics(self) -> None:
        """Scrape-path mirror of breaker state into the router's own
        registry (labeled per replica — a bounded set)."""
        for st in self.breaker_states():
            self._registry.gauge(
                "router_breaker_state",
                "Per-replica breaker state (0 closed, 1 half_open, "
                "2 open)",
                labels={"replica": str(st["replica"])}).set(
                    _BREAKER_GAUGE[st["state"]])

    @property
    def tokens_emitted(self) -> int:
        return sum(r.tokens_emitted for r in self.replicas)

    def metrics_snapshot(self) -> dict:
        """FLEET-wide metrics: every replica's registry snapshot merged
        (histogram buckets add bucket-for-bucket — identical fixed
        ladders by construction — so a dp deployment's /metrics reports
        true fleet percentiles, not replica-0's). The additive gauge
        merge is wrong for RATIO gauges: `tenant_fair_share` (1.0 =
        exactly fair) would read ~N for N fair replicas, so it is
        recomputed from the fleet-merged generated totals
        (tenant_stats), the same rule that function documents.

        The iteration-phase histograms (`iter_phase_ms`, labeled by
        phase) merge bucket-for-bucket like every other histogram —
        identical ms ladders by construction — and the derived
        `host_gap_frac` is deliberately NOT a registered gauge: the
        /stats summary recomputes it from the merged phase sums
        (iteration_profile.profile_summary), so the ratio can never
        be added across replicas by accident."""
        from cloud_server_tpu_torch.utils.serving_metrics import (
            merge_snapshots)
        merged = merge_snapshots(
            [r.metrics_snapshot() for r in self.replicas
             if hasattr(r, "metrics_snapshot")]
            # + the router's own families (failover/retry/breaker
            # counters and per-replica breaker-state gauges): fleet
            # plumbing no replica can observe
            + [self._registry.snapshot()])
        tstats = self.tenant_stats()
        for key, entry in merged.items():
            if not key.startswith("cloud_server_tenant_fair_share{"):
                continue
            t = (entry.get("labels") or {}).get("tenant")
            if t in tstats:
                entry["value"] = tstats[t]["fair_share"]
        # spec_accept_rate is a RATIO gauge too: recompute from the
        # fleet-merged drafted/accepted totals, never by adding the
        # per-replica rates
        if "cloud_server_spec_accept_rate" in merged:
            sstats = self.speculation_stats()
            merged["cloud_server_spec_accept_rate"]["value"] = (
                sstats.get("accept_rate", 0.0))
        # same rule for the SLO ratio gauges: attainment/burn recompute
        # from the fleet-merged good/total counts, never by adding the
        # per-replica ratios (two 0.99-attaining replicas must read
        # 0.99, not 1.98)
        srep = self.slo_report()
        if srep is not None:
            for key, entry in merged.items():
                if not (key.startswith("cloud_server_slo_attainment{")
                        or key.startswith("cloud_server_slo_burn_rate{")):
                    continue
                lbl = entry.get("labels") or {}
                went = (srep["classes"]
                        .get(lbl.get("class"), {})
                        .get("metrics", {})
                        .get(lbl.get("metric"), {})
                        .get("windows", {})
                        .get(lbl.get("window_s")))
                if went is None:
                    continue
                if "attainment{" in key:
                    att = went["attainment"]
                    entry["value"] = 1.0 if att is None else att
                else:
                    entry["value"] = went["burn_rate"]
        return merged

    @property
    def qos(self):
        """The TenantRegistry view the HTTP front-end resolves API
        keys against (replica 0's — every replica parses the same
        config, so the key map agrees fleet-wide)."""
        return getattr(self.replicas[0], "qos", None)

    def tenant_stats(self) -> dict:
        """FLEET-wide per-tenant stats: every replica's
        TenantRegistry.stats() merged — counters sum, weight/priority
        come from the shared config, and fair_share is recomputed from
        the merged generated totals (a per-replica ratio would not
        average meaningfully)."""
        merged: dict[str, dict] = {}
        for r in self.replicas:
            reg = getattr(r, "qos", None)
            if reg is None:
                continue
            for name, s in reg.stats().items():
                cur = merged.setdefault(name, {
                    "weight": s["weight"], "priority": s["priority"],
                    "pending": 0, "submitted": 0, "rejected": 0,
                    "generated": 0, "preempt_requeues": 0,
                    "prefill_tokens": 0, "spec_drafted": 0,
                    "spec_accepted": 0, "spec_wasted": 0})
                for k in ("pending", "submitted", "rejected",
                          "generated", "preempt_requeues",
                          "prefill_tokens", "spec_drafted",
                          "spec_accepted", "spec_wasted"):
                    cur[k] += s[k]
        from cloud_server_tpu_torch.inference.qos import compute_fair_shares
        shares = compute_fair_shares(
            {name: (s["weight"], float(s["generated"]))
             for name, s in merged.items()})
        for name, s in merged.items():
            s["fair_share"] = shares[name]
        return merged

    def speculation_stats(self) -> dict:
        """FLEET-wide speculation summary (the /stats `speculation`
        source behind the router): drafted/accepted counts sum across
        replicas and `accept_rate` recomputes from the merged totals
        (a per-replica ratio would not average meaningfully —
        exactly the `tenant_fair_share` rule). Per-replica live
        `draft_lens` views are dropped (slot ids are replica-local)."""
        merged: dict = {}
        for r in self.replicas:
            fn = getattr(r, "speculation_stats", None)
            if fn is None:
                continue
            s = fn()
            if not merged:
                merged = {
                    "enabled": s["enabled"], "source": s["source"],
                    "max_drafts": s["max_drafts"],
                    "adaptive": s["adaptive"],
                    "tokens_drafted": 0, "tokens_accepted": 0}
            elif s["enabled"] and not merged["enabled"]:
                # heterogeneous fleet: config metadata must come from a
                # replica that actually speculates, not whichever
                # answered first — otherwise /stats could report
                # source "off" alongside nonzero drafted counts
                merged.update(source=s["source"],
                              max_drafts=s["max_drafts"],
                              adaptive=s["adaptive"])
            merged["enabled"] = merged["enabled"] or s["enabled"]
            merged["tokens_drafted"] += s["tokens_drafted"]
            merged["tokens_accepted"] += s["tokens_accepted"]
        if merged:
            merged["accept_rate"] = (merged["tokens_accepted"]
                                     / max(merged["tokens_drafted"], 1))
        return merged

    def cache_stats(self) -> dict:
        """FLEET-wide KV-cache/memory view (the /debug/cache and
        /stats `cache` source behind the router): pool, prefix, and
        per-tenant COUNTS sum across replicas; `hit_rate` and
        `evictable_frac` recompute from the merged totals (never
        added — the `tenant_fair_share` ratio rule); the hot-prefix
        sketches merge per chain digest (hits sum, so the same system
        prompt hot on two replicas ranks twice as hot fleet-wide —
        the artifact ROADMAP item 3(a)'s prefix-aware `_pick` scores
        against); forensics rings concatenate tagged by replica.
        Returns {} when no replica exposes cache stats."""
        from cloud_server_tpu_torch.inference.cache_telemetry import (
            merge_cache_stats)
        stats = []
        for r in self.replicas:
            fn = getattr(r, "cache_stats", None)
            if fn is not None:
                stats.append(fn())
        return merge_cache_stats(stats)

    def lookup_trace(self, request_id: str) -> dict | None:
        """Span tree for one sampled request, wherever it ran: the
        first replica that knows the id answers, tagged with its
        replica index (router-submitted requests already carry it from
        the router_pick span).  In a role-specialized fleet a
        handed-off request's prefill and decode halves merge into the
        ONE spanning tree; looking up either the original or the
        continuation id returns that merged tree."""
        tree = None
        for i, r in enumerate(self.replicas):
            fn = getattr(r, "lookup_trace", None)
            tree = fn(request_id) if fn is not None else None
            if tree is not None:
                tree["root"]["tags"].setdefault("replica", i)
                break
        # analysis: allow[lock-discipline] racy-by-design monitoring
        # read of a GIL-atomic bool (flips under _lock)
        if tree is None or not self._disagg:
            return tree
        for t in self.trace_trees():
            tags = t["root"]["tags"]
            if (t["request_id"] == request_id
                    or request_id in tags.get("handoff_segments", ())):
                return t
        return tree

    def trace_trees(self, n: int | None = None) -> list[dict]:
        """FLEET-wide sampled span trees (the /traces source), each
        tagged with its replica index and ordered by root start
        (n <= 0 means "no trees", the recorder's own rule).  Handoff
        continuations merge into their original's tree
        (request_trace.merge_handoff_trees) so a disaggregated request
        reads as one gap-free tree spanning both replicas."""
        if n is not None and n <= 0:
            return []
        out = []
        for i, r in enumerate(self.replicas):
            fn = getattr(r, "trace_trees", None)
            if fn is None:
                continue
            for tree in fn(n):
                tree["root"]["tags"].setdefault("replica", i)
                out.append(tree)
        # analysis: allow[lock-discipline] racy-by-design monitoring
        # read of a GIL-atomic bool (flips under _lock)
        if self._disagg:
            from cloud_server_tpu_torch.inference.request_trace import (
                merge_handoff_trees)
            out = merge_handoff_trees(out)
        out.sort(key=lambda t: t["root"]["start"])
        return out if n is None else out[-n:]

    def slo_report(self) -> dict | None:
        """FLEET-wide SLO attainment + burn rates: every replica's
        report merged by summing good/total counts per (class, metric,
        window) and recomputing the ratios — the control signal the
        future autoscaler consumes. None when no replica tracks
        SLOs."""
        from cloud_server_tpu_torch.inference.slo import merge_reports
        return merge_reports(
            r.slo_report() for r in self.replicas
            if hasattr(r, "slo_report"))

    def flight_window(self, n: int | None = None) -> list[dict]:
        """Recent flight-recorder records across the fleet, each tagged
        with its replica index, ordered by wall-clock timestamp."""
        out = []
        for i, r in enumerate(self.replicas):
            fn = getattr(r, "flight_window", None)
            if fn is not None:
                out += [{"replica": i, "role": self.roles[i], **rec}
                        for rec in fn(n)]
        out.sort(key=lambda rec: rec.get("ts", 0.0))
        return out

    def anomaly_stats(self) -> dict | None:
        """FLEET-wide watchdog view (anomaly.merge_anomaly_stats):
        per-rule fire counts sum, active windows union, event rings
        interleaved by start time with each event tagged by its TRUE
        replica index (pre-tagged here — the merge helper's own
        enumeration only covers replicas that HAVE a watchdog). None
        when no replica has one."""
        from cloud_server_tpu_torch.inference.anomaly import (
            merge_anomaly_stats)
        stats = []
        for i, r in enumerate(self.replicas):
            fn = getattr(r, "anomaly_stats", None)
            s = fn() if fn is not None else None
            if s is not None:
                s = dict(s)
                s["events"] = [dict(ev, replica=ev.get("replica", i))
                               for ev in s.get("events", ())]
                stats.append(s)
        return merge_anomaly_stats(stats)

    def anomaly_events(self, n: int | None = None) -> list[dict]:
        """Fleet anomaly events for the /traces marker track, each
        tagged with its replica, ordered by window start."""
        out = []
        for i, r in enumerate(self.replicas):
            fn = getattr(r, "anomaly_events", None)
            if fn is not None:
                out += [dict(ev, replica=ev.get("replica", i))
                        for ev in fn(n)]
        out.sort(key=lambda e: e["start"])
        return out if n is None or n <= 0 else out[-n:]

    def tail_trace_trees(self, n: int | None = None) -> list[dict]:
        """FLEET-wide tail-retained span trees, replica-tagged and
        handoff-merged exactly like trace_trees — the retention
        predicate is replica-deterministic (both halves of a handoff
        always retain), so a disaggregated anomalous request reads as
        ONE gap-free tree here."""
        if n is not None and n <= 0:
            return []
        out = []
        for i, r in enumerate(self.replicas):
            fn = getattr(r, "tail_trace_trees", None)
            if fn is None:
                continue
            for tree in fn(n):
                tree["root"]["tags"].setdefault("replica", i)
                out.append(tree)
        # analysis: allow[lock-discipline] racy-by-design monitoring
        # read of a GIL-atomic bool (flips under _lock)
        if self._disagg:
            from cloud_server_tpu_torch.inference.request_trace import (
                merge_handoff_trees)
            out = merge_handoff_trees(out)
        out.sort(key=lambda t: t["root"]["start"])
        return out if n is None else out[-n:]

    def tail_trace_stats(self) -> dict | None:
        """Fleet tail-retention accounting: capacities and counts sum
        across replicas (per-reason retained_total merges per key).
        None when no replica retains tail traces."""
        merged: dict | None = None
        for r in self.replicas:
            fn = getattr(r, "tail_trace_stats", None)
            s = fn() if fn is not None else None
            if s is None:
                continue
            if merged is None:
                merged = {"capacity": 0, "retained": 0,
                          "retained_total": {}, "evicted_total": 0}
            merged["capacity"] += s["capacity"]
            merged["retained"] += s["retained"]
            merged["evicted_total"] += s["evicted_total"]
            for k, v in s["retained_total"].items():
                merged["retained_total"][k] = (
                    merged["retained_total"].get(k, 0) + v)
        return merged

    def debug_bundle(self, n: int = 64, *,
                     trigger: str = "manual") -> dict:
        """FLEET-wide forensic bundle (the GET /debug/bundle payload
        behind the router): the same schema as a single replica's,
        assembled from the router's own merged views — counts summed,
        trees replica-tagged and handoff-merged, plus the
        router-only breaker/role blocks."""
        return {
            "schema": "cloud_server.debug_bundle/v1",
            "trigger": trigger,
            "ts": time.time(),
            "anomaly": self.anomaly_stats(),
            "metrics": self.metrics_snapshot(),
            "flight": self.flight_window(n),
            "traces": self.trace_trees(n),
            "tail_traces": self.tail_trace_trees(n),
            "tail_retention": self.tail_trace_stats(),
            "slo": self.slo_report(),
            "cache": self.cache_stats(),
            "migration": self.migration_stats(),
            "breakers": self.breaker_states(),
            "roles": self.replica_roles(),
        }

    def debug_bundles(self, n: int | None = None) -> list[dict]:
        """Auto-captured bundles across the fleet, each tagged with
        the replica whose watchdog snapshotted it, oldest first."""
        out = []
        for i, r in enumerate(self.replicas):
            fn = getattr(r, "debug_bundles", None)
            if fn is not None:
                out += [dict(b, replica=i) for b in fn(n)]
        out.sort(key=lambda b: b.get("ts", 0.0))
        return out if n is None or n <= 0 else out[-n:]

    def step(self) -> int:
        busy = 0
        for i, r in enumerate(self.replicas):
            try:
                busy += r.step()
            except Exception as exc:  # noqa: BLE001 — replica crash
                # a synchronously-driven replica whose scheduler throws
                # gets the same teardown serve_forever would give it:
                # stop accepting, fail its in-flight work (the failover
                # hooks retry zero-token requests on healthy replicas),
                # and trip its breaker — the other replicas keep
                # stepping instead of the whole fleet dying with it
                self._record_breaker_failure(i)
                stop_ev = getattr(r, "_stop", None)
                fail = getattr(r, "_fail_all", None)
                if stop_ev is None or fail is None:
                    raise
                stop_ev.set()
                fail(exc)
        return busy

    def run_until_idle(self) -> None:
        while any(r.num_pending or r.num_active
                  or getattr(r, "_jobs", ())
                  for r in self.replicas):
            self.step()

    def start(self) -> "ReplicatedRouter":
        for r in self.replicas:
            r.start()
        return self

    # -- runtime fleet mutation ---------------------------------------------

    def attached_indices(self) -> list[int]:
        """Indices currently backed by a live replica (detached
        tombstones excluded) — the autoscaler's fleet-size view."""
        with self._lock:
            return [i for i in range(len(self.replicas))
                    if i not in self._detached]

    def _set_role_gauge_locked(self, i: int, old_role: str | None,
                               new_role: str | None) -> None:
        """Move the constant role gauge to the slot's current role
        (labeled series persist once created, so the stale label must
        be zeroed, not abandoned at 1)."""
        help_text = ("Replica role assignment (constant 1; the role "
                     "rides the labels)")
        if old_role is not None and old_role != new_role:
            self._registry.gauge(
                "router_replica_role", help_text,
                labels={"replica": str(i), "role": old_role}).set(0)
        if new_role is not None:
            self._registry.gauge(
                "router_replica_role", help_text,
                labels={"replica": str(i), "role": new_role}).set(1)

    def _recompute_disagg_locked(self) -> None:
        attached_roles = {self.roles[i]
                          for i in range(len(self.replicas))
                          if i not in self._detached}
        was = self._disagg
        self._disagg = (ROLE_PREFILL in attached_roles
                        and ROLE_DECODE in attached_roles)
        if self._disagg and not was and self._handoff_thread is None:
            # the fleet just became disaggregated at runtime: start
            # the handoff worker the constructor would have started
            self._handoff_q = queue.SimpleQueue()
            self._handoff_thread = threading.Thread(
                target=self._handoff_worker, daemon=True,
                name="router-handoff")
            self._handoff_thread.start()
        # a fleet that DEGRADED out of disaggregation (one side
        # removed) keeps its worker parked on the queue — harmless,
        # and re-adding the role reuses it

    def add_replica(self, replica, *, role: str = ROLE_COLOCATED) -> int:
        """Attach a replica to the serving fleet AT RUNTIME (the
        autoscaler's scale-up actuator; equally an operator handing a
        warm standby to a live router). Returns the replica's index.

        Registration matches the constructor: fresh breaker, role +
        breaker-state gauges, failover/handoff capability probes.
        Detached indices (prior `remove_replica`) are reused before
        the arrays grow. A quiesced replica (a drained one coming
        back from a warm pool) is `resume()`d so it accepts work the
        moment placement can see it.

        Roles: unlike the constructor — which validates the INITIAL
        fleet shape — incremental adds accept any valid role;
        disaggregated routing switches on automatically once the
        attached fleet has both a 'prefill' and a 'decode' replica."""
        if role not in _VALID_ROLES:
            raise ValueError(f"unknown replica role {role!r}; valid: "
                             f"{sorted(_VALID_ROLES)}")
        # capability probes (inspect.signature) stay outside the lock
        takes_hook = self._submit_takes_hook(replica)
        takes_handoff = self._submit_takes_hook(replica, "handoff")
        if (not getattr(replica, "ready", True)
                and hasattr(replica, "resume")):
            replica.resume()
        with self._lock:
            if self._detached:
                i = min(self._detached)
                self._detached.discard(i)
                old_role = self.roles[i]
                self.replicas[i] = replica
                self.roles[i] = role
                self._inflight[i] = 0
                self._breakers[i] = _Breaker()
                self._accepts_hook[i] = takes_hook
                self._accepts_handoff[i] = takes_handoff
            else:
                i = len(self.replicas)
                old_role = None
                self.replicas.append(replica)
                self.roles.append(role)
                self._inflight.append(0)
                self._breakers.append(_Breaker())
                self._accepts_hook.append(takes_hook)
                self._accepts_handoff.append(takes_handoff)
                self._registry.gauge(
                    "router_breaker_state",
                    "Per-replica breaker state (0 closed, 1 "
                    "half_open, 2 open)",
                    labels={"replica": str(i)}).set(0)
            self._set_role_gauge_locked(i, old_role, role)
            self._recompute_disagg_locked()
        _log.info("replica %d attached (role=%s, fleet size %d)",
                  i, role, len(self.attached_indices()))
        return i

    def _quiesce_for_removal(self, replica_index: int, *,
                             timeout: float | None,
                             migrate: bool) -> bool:
        """remove_replica's drain step. Replicas with drain support
        get the full evacuating drain; a backend without drain() is
        removable only once idle (polled up to `timeout` — it cannot
        quiesce itself, so a busy one refuses removal instead of
        cutting off its in-flight work)."""
        src = self.replicas[replica_index]
        if callable(getattr(src, "drain", None)):
            return self.drain(replica_index, timeout=timeout,
                              migrate=migrate)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while src.num_active or src.num_pending:
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.002)
        return True

    def remove_replica(self, replica_index: int, *,
                       timeout: float | None = None,
                       migrate: bool = True):
        """Detach a replica AT RUNTIME (the autoscaler's scale-down
        actuator): drain it first — with `migrate=True` (default)
        every in-flight request is EVACUATED to a healthy replica at
        its exact next token, zero requests lost — then tombstone its
        index and hand the (quiesced, still-running) replica object
        back to the caller, who owns its lifecycle from here (stop it,
        or park it in a warm pool for a later `add_replica`).

        Returns None — with the replica still attached and serving —
        when the drain timed out; the caller retries or escalates.
        Concurrent `submit()`s are safe throughout: during the drain
        the replica is unready (placement skips it), and a submit that
        captured the index before detachment fails over on the
        tombstone's refusal."""
        with self._lock:
            n_attached = (len(self.replicas) - len(self._detached)
                          - len(self._removing))
            if (replica_index in self._detached
                    or replica_index in self._removing
                    or not 0 <= replica_index < len(self.replicas)):
                raise ValueError(
                    f"replica {replica_index} is not attached")
            if n_attached <= 1:
                raise ValueError(
                    "cannot remove the last attached replica; "
                    "stop() the router instead")
            # claim the index: a concurrent remove_replica of the same
            # slot (two autoscaler loops, an operator racing one) must
            # see "not attached", not drain a replica twice
            self._removing.add(replica_index)
        try:
            if not self._quiesce_for_removal(replica_index,
                                             timeout=timeout,
                                             migrate=migrate):
                # timed out: the replica resumed accepting (drain's
                # timeout contract) and STAYS attached
                _log.warning(
                    "remove_replica(%d): drain timed out; replica "
                    "stays attached", replica_index)
                return None
            with self._lock:
                replica = self.replicas[replica_index]
                old_role = self.roles[replica_index]
                self.replicas[replica_index] = _DetachedSlot()
                self.roles[replica_index] = ROLE_COLOCATED
                self._inflight[replica_index] = 0
                self._breakers[replica_index] = _Breaker()
                self._detached.add(replica_index)
                self._accepts_hook[replica_index] = False
                self._accepts_handoff[replica_index] = False
                self._set_role_gauge_locked(replica_index, old_role,
                                            None)
                self._recompute_disagg_locked()
        finally:
            with self._lock:
                self._removing.discard(replica_index)
        _log.info("replica %d detached (was role=%s, fleet size %d)",
                  replica_index, old_role,
                  len(self.attached_indices()))
        return replica

    def drain(self, replica_index: int, *,
              timeout: float | None = None,
              migrate: bool = True) -> bool:
        """Drain ONE replica for maintenance. With `migrate=True`
        (default) every active request is first EVACUATED: exported
        at the replica's commit point and resumed on a healthy
        replica at the exact next token, on the same stream — a
        zero-token-loss operation. Whatever cannot move (export
        fault, no healthy destination, non-migratable state) is
        waited out by the normal drain. Returns the replica drain's
        verdict (True = idle/quiesced; resume() it to serve again)."""
        src = self.replicas[replica_index]

        def _migrate_cb(snap, req) -> bool:
            t0 = time.perf_counter()
            excluded = {replica_index}
            kw = {"tenant": snap.tenant,
                  "stream": getattr(req, "stream", None)}
            while True:
                with self._lock:
                    i = self._pick(tenant=snap.tenant,
                                   count_inflight=True,
                                   exclude=excluded, strict=True)
                if i is None:
                    return False
                imp = getattr(self.replicas[i], "migrate_import", None)
                if imp is None:
                    with self._lock:
                        self._inflight[i] -= 1
                    self._release_probe(i)
                    excluded.add(i)
                    if len(excluded) >= len(self.replicas):
                        return False
                    continue
                self._m_migrations.inc()
                # analysis: allow[lock-discipline] GIL-atomic capability
                # slot (written once at attach under _lock), as in submit
                hook = (self._make_fail_hook(
                            i, list(snap.prompt), dict(kw),
                            frozenset(excluded), req)
                        if self._accepts_hook[i] else None)
                try:
                    new = imp(snap, stream=kw["stream"],
                              fail_handler=hook,
                              trace_ctx=continuation_ctx(req))
                except Exception as exc:  # noqa: BLE001 — next replica
                    with self._lock:
                        self._inflight[i] -= 1
                    if (isinstance(exc, RuntimeError)
                            and not isinstance(exc, QueueFullError)
                            and getattr(self.replicas[i], "ready",
                                        True)):
                        self._record_breaker_failure(i)
                    else:
                        self._release_probe(i)
                    excluded.add(i)
                    if len(excluded) >= len(self.replicas):
                        return False
                    continue
                with self._lock:
                    self._inflight[i] -= 1
                self._record_breaker_success(i)
                # same mirroring/cancel-chain contract as
                # _migrate_submit: the evacuated request handle stays
                # the client's, the destination's outcome mirrors back
                new._router_orig = req
                new._router_migrated = True
                new._on_done = self._mirror_retry
                with self._lock:
                    gen = len(excluded)
                    if gen >= getattr(req, "_router_cancel_gen", -1):
                        req._router_cancel_gen = gen
                        req._on_cancel = lambda _r, _n=new: _n.cancel()
                if req._cancel.is_set():
                    new.cancel()
                tr = any_trace(new)
                if tr is not None:
                    tr.annotate(replica=i, migrate_of=req.request_id)
                    tr.add_span("migrate", t0, time.perf_counter(),
                                from_replica=replica_index, replica=i,
                                reason="drain",
                                tokens_salvaged=len(snap.tokens),
                                kv_pages=snap.n_kv_pages())
                self._migration_ms.observe(
                    (time.perf_counter() - t0) * 1e3)
                if new.done:
                    self._mirror_retry(new)
                return True

        if migrate:
            try:
                return src.drain(timeout, migrate=_migrate_cb)
            except TypeError:
                # replica without migration support: fall through to
                # the plain wait-it-out drain below, VISIBLY
                _log.warning(
                    "replica %d drain() does not accept migrate=; "
                    "draining without evacuation", replica_index)
        return src.drain(timeout)

    def migration_stats(self) -> dict:
        """FLEET-wide live-migration counters (the /stats `migration`
        source behind the router): every replica's ledger sums
        (export + import halves), and `success_rate` — resumptions
        admitted per export attempted — recomputes from the merged
        totals (the `tenant_fair_share` ratio rule: ratios never
        add)."""
        keys = ("out_started", "out_completed", "out_failed",
                "in_started", "in_completed", "in_failed", "started",
                "completed", "failed", "tokens_salvaged",
                "pages_moved")
        merged = {k: 0 for k in keys}
        for r in self.replicas:
            fn = getattr(r, "migration_stats", None)
            if fn is None:
                continue
            s = fn()
            for k in keys:
                merged[k] += s.get(k, 0)
        merged["success_rate"] = (merged["in_completed"]
                                  / max(merged["out_started"], 1))
        return merged

    def stop(self, drain: bool = False,
             timeout: float | None = None) -> None:
        # analysis: allow[lock-discipline] teardown read of a
        # GIL-atomic write-once reference (never cleared)
        if self._handoff_q is not None:
            # analysis: allow[lock-discipline] teardown, write-once
            # reference; unblocks the handoff worker
            self._handoff_q.put(None)
        for i, r in enumerate(self.replicas):
            try:
                r.stop(drain=drain, timeout=timeout)
            except TypeError:
                # replica without drain support: retry drain-less —
                # but VISIBLY (counted + logged), because the drain
                # the caller asked for did not happen on this replica
                # and its in-flight work is about to be cut off
                self._m_drainless.inc()
                _log.warning(
                    "replica %d stop() does not accept drain/timeout; "
                    "stopping without drain (requested drain=%s "
                    "timeout=%s)", i, drain, timeout)
                r.stop()
