"""KV-cache & memory observability: per-tenant prefix-cache
attribution, eviction forensics, and the bounded hot-prefix sketch.

The paged KV pool and its radix prefix cache
(`inference/block_allocator.py`) are the serving stack's scarcest
resource, and until this module they were nearly blind: the allocator
kept flat lifetime counters with no notion of WHO hit, who missed, or
whose churn evicted whose system prompt. This module is the
measurement layer ROADMAP item 3 (fleet-scale prefix cache) scores its
policies against:

  * **Per-tenant attribution** (`record_walk` / `record_alloc` /
    `record_release` / `record_saved`): the allocator calls in at the
    host moments it already owns — one call per prefix walk, one per
    alloc/release — so every tenant accumulates pages held, prefix
    pages/tokens hit and missed, and realized saved tokens.
    `hit_tokens` counts at LOOKUP time (optimistic — a page-famine
    retry next step walks and counts again); `saved_tokens` is
    recorded by the scheduler only once the admission actually
    succeeded, so the two diverge exactly when lookups were wasted.
  * **Eviction forensics** (`record_evict`): when the allocator's
    `_evict_one` reclaims a keyed page it reports the VICTIM (the
    tenant whose request produced the page) and the FORCER (the tenant
    whose `alloc` drained the free list) — per-tenant
    suffered/caused counters, a bounded victim×forcer matrix, and a
    ring of recent evictions (chain digest, depth, idle age) that
    answers "whose churn evicted whose system prompt" post-mortem.
  * **Hot-prefix sketch**: a bounded counter table over chain digests
    (the deepest hit node per walk). The hot path pays one dict
    update; top-K selection and the occasional compaction (drop the
    cold half when the table overflows `capacity`) are amortized /
    read-path work. `top_prefixes()` is the artifact item 3(a)'s
    prefix-aware router `_pick` will score candidate replicas with,
    and `merge_top_prefixes` / `merge_cache_stats` are the fleet
    merge: counts sum per digest, hit-rate ratios recompute from the
    merged totals (the `tenant_fair_share` rule — ratios never add).

Concurrency: mutators run on the scheduler thread (under the server's
locks); readers run on the scrape thread. The internal `_lock` guards
only plain dict/deque arithmetic, so contention is negligible — the
same discipline as `qos.TenantRegistry`. `iteration` is a plain int
the scheduler stamps once per step (GIL-atomic write, racy-by-design
monitoring read: a stale value skews a sketch recency tag by one
iteration at most).

Stdlib-only by contract: device work, numpy buffers, blocking syncs,
wall-clock reads, and host I/O never creep into the record path. This
is a verbatim copy of the reference package's module of the same name
(the port imports nothing of the reference).
"""

from __future__ import annotations

import collections
import threading

# Matches qos.DEFAULT_TENANT (not imported: qos pulls the server import
# chain, and the two constants are pinned equal by a test instead).
DEFAULT_TENANT = "default"

# Sketch bounds: TOP_K is the export size, CAPACITY the tracked-chain
# bound. When the table crosses CAPACITY it compacts to the hottest
# CAPACITY // 2 entries — a space-saving-style bounded counter, so a
# long-tail chain can undercount but a genuinely hot chain cannot be
# displaced by one-hit wonders.
SKETCH_TOP_K = 32
SKETCH_CAPACITY = 512
FORENSICS_RING = 256

# Fixed histogram ladders (identical on every replica, so fleet merges
# are exact bucket-for-bucket — the serving_metrics rule).
CHAIN_DEPTH_BUCKETS: tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256)
PAGE_AGE_BUCKETS: tuple[float, ...] = (
    1, 4, 16, 64, 256, 1024, 4096, 16384, 65536)
EVICTABLE_FRAC_BUCKETS: tuple[float, ...] = (
    0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

# Histogram families (name, help) — registered eagerly by the paged
# server (`register_cache_hists`) so the docs drift check sees them
# before any traffic.
CHAIN_DEPTH_HIST = (
    "cache_chain_depth_pages",
    "Prefix-cache pages hit per admission walk (0 = cold miss)")
PAGE_AGE_HIST = (
    "cache_page_age_at_eviction_iters",
    "Scheduler iterations a page sat evictable before being reclaimed "
    "(near-zero = the cache is thrashing)")
EVICTABLE_FRAC_HIST = (
    "pool_evictable_frac",
    "Per-busy-iteration reclaimable pool fraction "
    "((free + cached) / total) — the HBM-pressure watermark")


def register_cache_hists(registry) -> dict:
    """Eager registration of the cache/memory histogram families in a
    `utils.serving_metrics.MetricsRegistry`; returns {short_key: hist}
    for the observe paths (a dict lookup per observation, never a
    registry get-or-create)."""
    return {
        "chain_depth": registry.histogram(
            *CHAIN_DEPTH_HIST, buckets=CHAIN_DEPTH_BUCKETS),
        "page_age": registry.histogram(
            *PAGE_AGE_HIST, buckets=PAGE_AGE_BUCKETS),
        "evictable_frac": registry.histogram(
            *EVICTABLE_FRAC_HIST, buckets=EVICTABLE_FRAC_BUCKETS),
    }


class _TenantCacheStats:
    """Per-tenant cache ledger (telemetry-private)."""

    __slots__ = ("lookups", "hit_pages", "miss_pages", "hit_tokens",
                 "miss_tokens", "saved_tokens", "pages_held",
                 "evicted_pages", "evictions_caused")

    def __init__(self):
        self.lookups = 0
        self.hit_pages = 0
        self.miss_pages = 0
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.saved_tokens = 0
        self.pages_held = 0
        self.evicted_pages = 0
        self.evictions_caused = 0

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class CacheTelemetry:
    """The allocator's attribution + forensics + sketch sidecar.

    One instance per `BlockAllocator` (constructed by it when the
    caller passes none). The allocator calls the record_* hooks at the
    walk/alloc/release/evict moments it already owns; the paged server
    stamps `iteration` once per step and attaches the registry
    histograms (`attach_hists`) so depth/age observations land in
    mergeable fixed-ladder families. Everything is plain host
    arithmetic — zero dispatches, zero syncs (hot-path lint + the
    dispatch-count regression clone enforce this).
    """

    def __init__(self, page_size: int, *, top_k: int = SKETCH_TOP_K,
                 capacity: int = SKETCH_CAPACITY,
                 ring: int = FORENSICS_RING):
        if top_k <= 0 or capacity < 2 * top_k:
            raise ValueError(
                f"sketch needs top_k > 0 and capacity >= 2 * top_k "
                f"(got {top_k=}, {capacity=})")
        self.page_size = page_size
        self.top_k = top_k
        self.capacity = capacity
        # scheduler-stamped flight-recorder iteration index (plain int:
        # GIL-atomic write on the scheduler thread, monitoring reads
        # may lag by one iteration — recency tags only)
        self.iteration = 0
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantCacheStats] = {}
        # chain digest -> [hits, depth_pages, last_hit_iteration]
        self._chains: dict[bytes, list] = {}
        self._evictions = collections.deque(maxlen=ring)
        self._evict_matrix: dict[tuple[str, str], int] = {}
        self.hists: dict = {}  # attach_hists; empty = skip observes

    def attach_hists(self, hists: dict) -> None:
        """Wire the registry histograms (`register_cache_hists`) into
        the observe paths; without them observations are skipped
        (library/standalone allocator use)."""
        self.hists = dict(hists)

    def _tenant(self, tenant: str | None) -> _TenantCacheStats:
        """Ledger for a RESOLVED tenant name (callers pass names the
        QoS registry already collapsed; None — no QoS — lands on the
        default ledger, mirroring `qos.resolve`). Caller holds _lock."""
        name = tenant or DEFAULT_TENANT
        st = self._tenants.get(name)
        if st is None:
            st = self._tenants[name] = _TenantCacheStats()
        return st

    # -- record hooks (allocator/scheduler hot path) ------------------------

    def record_walk(self, tenant: str | None, hit_pages: int,
                    miss_pages: int, prefilled_tokens: int,
                    chain_digest: bytes | None) -> None:
        """One prefix walk: `hit_pages` served from cache, `miss_pages`
        full prompt pages that will be freshly written,
        `prefilled_tokens` the un-shared prompt remainder (tail
        included). `chain_digest` names the deepest hit node (None on
        a cold miss) and feeds the hot-prefix sketch."""
        ps = self.page_size
        with self._lock:
            st = self._tenant(tenant)
            st.lookups += 1
            st.hit_pages += hit_pages
            st.hit_tokens += hit_pages * ps
            st.miss_pages += miss_pages
            st.miss_tokens += prefilled_tokens
            if chain_digest is not None:
                entry = self._chains.get(chain_digest)
                if entry is None:
                    self._chains[chain_digest] = [
                        1, hit_pages, self.iteration]
                    if len(self._chains) > self.capacity:
                        self._compact()
                else:
                    entry[0] += 1
                    # the digest names the whole chain, so depth is a
                    # constant of the key; keep the max for safety
                    if hit_pages > entry[1]:
                        entry[1] = hit_pages
                    entry[2] = self.iteration
        h = self.hists.get("chain_depth")
        if h is not None:
            h.observe(hit_pages)

    def _compact(self) -> None:
        """Drop the cold half once the chain table overflows (caller
        holds _lock). Amortized: runs once per capacity/2 NEW chains."""
        keep = sorted(self._chains.items(),
                      key=lambda kv: (kv[1][0], kv[1][2]),
                      reverse=True)[:self.capacity // 2]
        self._chains = dict(keep)

    def record_alloc(self, tenant: str | None, n: int) -> None:
        with self._lock:
            self._tenant(tenant).pages_held += n

    def record_release(self, tenant: str | None, n: int) -> None:
        with self._lock:
            st = self._tenant(tenant)
            st.pages_held = max(0, st.pages_held - n)

    def record_saved(self, tenant: str | None, tokens: int) -> None:
        """Realized prefill savings: called by the scheduler once an
        admission SUCCEEDED with `tokens` of its prompt served from
        cache (lookup-time hit_tokens counts optimistically; this one
        only counts wins that turned into skipped prefill work)."""
        with self._lock:
            self._tenant(tenant).saved_tokens += tokens

    def record_evict(self, victim: str | None, forcer: str | None,
                     age_iterations: int, depth: int,
                     chain_digest: bytes | None) -> None:
        """One keyed-page eviction: `victim` produced the page,
        `forcer`'s alloc reclaimed it, `age_iterations` is how long it
        sat evictable, `depth` its position in its chain."""
        vic = victim or DEFAULT_TENANT
        frc = forcer or DEFAULT_TENANT
        with self._lock:
            self._tenant(vic).evicted_pages += 1
            self._tenant(frc).evictions_caused += 1
            key = (vic, frc)
            self._evict_matrix[key] = self._evict_matrix.get(key, 0) + 1
            self._evictions.append({
                "iteration": self.iteration,
                "victim": vic,
                "forcer": frc,
                "age_iterations": age_iterations,
                "depth": depth,
                "key": (chain_digest.hex()
                        if chain_digest is not None else None),
            })
        h = self.hists.get("page_age")
        if h is not None:
            h.observe(age_iterations)

    # -- scrape-path views --------------------------------------------------

    def tenant_stats(self) -> dict[str, dict]:
        """{tenant: ledger dict} — counts only; ratios are the
        consumer's job (so fleet merges stay exact)."""
        with self._lock:
            return {name: st.as_dict()
                    for name, st in self._tenants.items()}

    def top_prefixes(self, k: int | None = None) -> list[dict]:
        """The hottest `k` (default top_k) prefix chains, hottest
        first: {"key": digest hex, "depth": pages, "hits": count,
        "last_hit_iteration": flight index}."""
        k = self.top_k if k is None else k
        with self._lock:
            items = sorted(self._chains.items(),
                           key=lambda kv: (kv[1][0], kv[1][2]),
                           reverse=True)[:max(k, 0)]
        return [{"key": dig.hex(), "depth": e[1], "hits": e[0],
                 "last_hit_iteration": e[2]} for dig, e in items]

    def recent_evictions(self, n: int | None = None) -> list[dict]:
        """The last `n` (default: full ring) eviction-forensics
        records, oldest first."""
        with self._lock:
            out = list(self._evictions)
        return out if n is None else out[-max(n, 0):]

    def eviction_matrix(self) -> dict[str, dict[str, int]]:
        """{victim: {forcer: pages}} — who evicted whom, lifetime."""
        with self._lock:
            items = list(self._evict_matrix.items())
        out: dict[str, dict[str, int]] = {}
        for (vic, frc), n in items:
            out.setdefault(vic, {})[frc] = n
        return out


# ---------------------------------------------------------------------------
# fleet merge (ReplicatedRouter.cache_stats)
# ---------------------------------------------------------------------------


def merge_top_prefixes(sketches, k: int = SKETCH_TOP_K) -> list[dict]:
    """Merge per-replica `top_prefixes` exports into the fleet top-K:
    hits SUM per chain digest (the same prompt hot on two replicas is
    twice as hot fleet-wide), depth is a constant of the digest (max
    kept for safety), recency is the max last-hit index. Exact for
    every chain that made each replica's export."""
    merged: dict[str, dict] = {}
    for sketch in sketches:
        for e in sketch:
            cur = merged.get(e["key"])
            if cur is None:
                merged[e["key"]] = dict(e)
            else:
                cur["hits"] += e["hits"]
                cur["depth"] = max(cur["depth"], e["depth"])
                cur["last_hit_iteration"] = max(
                    cur["last_hit_iteration"], e["last_hit_iteration"])
    return sorted(merged.values(),
                  key=lambda e: (e["hits"], e["last_hit_iteration"]),
                  reverse=True)[:max(k, 0)]


def hit_rate(hit_pages: int, miss_pages: int) -> float:
    """THE hit-rate definition (hit / walked full pages) — single
    server and fleet merge both call this, so the two views can never
    diverge (the `compute_fair_shares` pattern)."""
    total = hit_pages + miss_pages
    return hit_pages / total if total else 0.0


def merge_cache_stats(stats: list[dict],
                      k: int = SKETCH_TOP_K) -> dict:
    """Merge per-replica `cache_stats()` payloads into the fleet view:
    pool/prefix/tenant COUNTS sum, `hit_rate` recomputes from the
    merged totals (never added — two 0.5-hit-rate replicas read 0.5),
    sketches merge via `merge_top_prefixes`, forensics rings
    concatenate with a replica tag, matrices add cellwise. Returns {}
    for an empty fleet."""
    stats = [s for s in stats if s]
    if not stats:
        return {}
    pool: dict[str, float] = {}
    prefix: dict[str, float] = {}
    tenants: dict[str, dict] = {}
    matrix: dict[str, dict[str, int]] = {}
    evictions: list[dict] = []
    namespaces = 0
    for i, s in enumerate(stats):
        for f, v in s.get("pool", {}).items():
            pool[f] = pool.get(f, 0) + v
        for f, v in s.get("prefix", {}).items():
            if f != "hit_rate":
                prefix[f] = prefix.get(f, 0) + v
        namespaces = max(namespaces, s.get("namespaces", 0))
        for name, led in s.get("tenants", {}).items():
            cur = tenants.setdefault(name, dict.fromkeys(led, 0))
            for f, v in led.items():
                cur[f] = cur.get(f, 0) + v
        for vic, row in s.get("eviction_matrix", {}).items():
            out_row = matrix.setdefault(vic, {})
            for frc, n in row.items():
                out_row[frc] = out_row.get(frc, 0) + n
        evictions += [{"replica": i, **rec}
                      for rec in s.get("recent_evictions", [])]
    prefix["hit_rate"] = hit_rate(int(prefix.get("hit_pages", 0)),
                                  int(prefix.get("miss_pages", 0)))
    # derived fraction over the merged pool, not averaged fractions
    total = pool.get("pages_total", 0)
    pool["evictable_frac"] = (
        (pool.get("pages_free", 0) + pool.get("pages_cached", 0))
        / total if total else 0.0)
    return {
        "pool": pool,
        "prefix": prefix,
        "namespaces": namespaces,
        "tenants": tenants,
        "top_prefixes": merge_top_prefixes(
            [s.get("top_prefixes", []) for s in stats], k),
        "recent_evictions": evictions,
        "eviction_matrix": matrix,
        "per_replica": [
            {"replica": i,
             "pool": dict(s.get("pool", {})),
             "hit_rate": s.get("prefix", {}).get("hit_rate", 0.0)}
            for i, s in enumerate(stats)],
    }
