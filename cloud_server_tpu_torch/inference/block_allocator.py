"""Host-side page allocator: refcounts, prefix sharing, LRU reuse.

Pure-Python bookkeeping for the device page pool
(`paged_engine.PagedKVCache`). The device never allocates — the
scheduler either reserves a request's whole chain at admission
(allocation="reserve") or grows chains just-in-time before each decode
dispatch, preempting the youngest slot on exhaustion
(allocation="ondemand" — see paged_server). Either way every write the
device issues lands in a page the host put in the table first.

Sharing model (radix-style, page granularity): a FULL page of kv is
identified by the token chain that produced it — the cache key is
(parent_chain_hash, page_tokens), where parent_chain_hash is a running
hash over every preceding page's key (vLLM-style block hashing). Keys
are pure CONTENT: they never reference physical page ids, so reusing an
evicted page's id can never alias an old chain (the ABA hazard of
id-based keys). Walking a prompt page-by-page either extends a chain of
hits
(each hit bumps a refcount and costs zero prefill FLOPs) or misses and
switches to fresh private pages. On release, a request's full private
pages are KEYED into the cache (refcount 0, LRU-ordered) rather than
freed — a later request with the same token prefix (same system prompt,
same few-shot header, a multi-turn follow-up replaying the conversation)
reuses them, generated tokens included. The free list refills by evicting
least-recently-used refcount-0 cached pages on demand.

Page lifecycle:

    free --alloc--> active-private --release(full)--> cached
      ^                 |release(partial)               |   ^
      |                 v                        lookup |   | release
      +--evict-- cached <----- active-shared <----------+---+

A page is EVICTABLE iff refcount 0; keyed pages stay discoverable while
actively shared, so any number of in-flight slots can share one page.

Immutability invariant (what makes sharing safe): keyed pages are always
FULL pages strictly before every sharing slot's first private position,
and the engine only writes at positions >= lengths >= that boundary. An
evicted page has refcount 0 — no slot's table points at it.

Eviction orphans: evicting a parent page leaves cached children
unreachable for now (lookup walks front-to-back and stops at the first
miss — attention needs contiguous prefix KV). They age out via LRU, or
become reachable again if another request re-materializes the same
parent content (keys are content-only, so the chain re-links).
Correctness is unaffected either way — a miss is just a miss.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib

from cloud_server_tpu_torch.inference.cache_telemetry import CacheTelemetry

# Root digest for every chain. Chain hashing uses blake2b-128 over
# (parent_digest, page_tokens) rather than Python's builtin hash():
# the builtin's int-tuple hash is 64-bit, non-cryptographic, and
# deterministic across processes — an attacker who can choose token ids
# could construct two prompt chains whose keys collide and read another
# request's cached KV (the exact design vLLM patched in
# CVE-2025-25183). The token tuple itself also rides in the key, so a
# wrong hit additionally requires identical page content.
_ROOT = b"\x00" * 16


def _chain_digest(parent: bytes, page_tokens: tuple[int, ...]) -> bytes:
    h = hashlib.blake2b(parent, digest_size=16)
    h.update(",".join(map(str, page_tokens)).encode())
    return h.digest()


def _root_for(namespace: str) -> bytes:
    """Chain root for a KV namespace. Different adapters produce
    DIFFERENT kv for identical tokens, so their chains must never
    collide — the namespace (adapter name; "" = base model) salts the
    root digest, partitioning the cache."""
    if not namespace:
        return _ROOT
    h = hashlib.blake2b(_ROOT, digest_size=16)
    h.update(b"ns:" + namespace.encode())
    return h.digest()


@dataclasses.dataclass
class AllocatorStats:
    """Point-in-time allocator snapshot. Occupancy fields partition
    the pool (`pages_total == pages_free + pages_cached +
    pages_active`); the rest are LIFETIME counters. `prefix_hit_pages`
    counts every page served from the cache across all walks;
    `prefix_miss_pages` counts one page per walk that BROKE at a miss
    (the walk stops at the first miss, so un-walked pages are not
    misses here — per-tenant miss accounting in
    `cache_telemetry.CacheTelemetry` counts the full un-shared
    remainder instead). `hits_tokens` is the token value of the hit
    pages (hit pages x page_size — prefill work the cache absorbed);
    `namespaces` counts the distinct KV namespaces (base model +
    per-request LoRA adapters) that ever touched the cache."""

    pages_total: int
    pages_free: int
    pages_cached: int   # refcount-0 keyed pages (evictable)
    pages_active: int   # referenced by >= 1 slot
    prefix_hit_pages: int = 0
    prefix_miss_pages: int = 0
    evictions: int = 0
    hits_tokens: int = 0
    namespaces: int = 0


class BlockAllocator:
    """Allocator for a pool of `num_pages` device pages of `page_size`
    tokens. Not thread-safe — callers hold the scheduler lock."""

    def __init__(self, num_pages: int, page_size: int,
                 telemetry: CacheTelemetry | None = None):
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: collections.deque[int] = collections.deque(
            range(num_pages))
        self._ref = [0] * num_pages
        # key -> page for every keyed page (active or not); _evictable
        # holds ONLY refcount-0 keyed pages, in insertion order — python
        # dicts iterate oldest-first, giving an O(1) LRU (pages re-insert
        # on every release, so insertion order IS recency order)
        self._cache: dict[tuple[bytes, tuple[int, ...]], int] = {}
        self._key_of: dict[int, tuple[bytes, tuple[int, ...]]] = {}
        self._evictable: dict[int, None] = {}
        self.prefix_hit_pages = 0
        self.prefix_miss_pages = 0
        self.evictions = 0
        # lifetime flow counters (the flight recorder deltas these per
        # iteration): fresh pages handed out, pages whose refcount hit 0
        self.pages_allocated = 0
        self.pages_released = 0
        self._namespaces: set[str] = set()
        # per-page attribution sidecar state (plain fixed-size lists —
        # O(1) per event): the tenant whose alloc produced the page, and
        # for KEYED pages the chain position / digest / the iteration it
        # last became evictable (eviction forensics reads all four)
        self._owner: list[str | None] = [None] * num_pages
        self._depth = [0] * num_pages
        self._digest: list[bytes | None] = [None] * num_pages
        self._idle_since = [0] * num_pages
        # attribution / forensics / hot-prefix-sketch ledger
        # (inference/cache_telemetry.py): always present — the record
        # hooks are plain dict arithmetic — so library users get the
        # same observability the paged server surfaces
        self.telemetry = (telemetry if telemetry is not None
                          else CacheTelemetry(page_size))

    # -- capacity -----------------------------------------------------------

    @property
    def available(self) -> int:
        """Pages obtainable right now (free + evictable cached)."""
        return len(self._free) + len(self._evictable)

    def stats(self) -> AllocatorStats:
        active = self.num_pages - len(self._free) - len(self._evictable)
        return AllocatorStats(
            pages_total=self.num_pages, pages_free=len(self._free),
            pages_cached=len(self._evictable), pages_active=active,
            prefix_hit_pages=self.prefix_hit_pages,
            prefix_miss_pages=self.prefix_miss_pages,
            evictions=self.evictions,
            hits_tokens=self.prefix_hit_pages * self.page_size,
            namespaces=len(self._namespaces))

    # -- allocate / share ---------------------------------------------------

    def _evict_one(self, forcer: str | None = None) -> None:
        """Reclaim the LRU refcount-0 keyed page. `forcer` is the
        tenant whose alloc drained the free list — eviction forensics
        pairs it with the page's producing tenant (who suffered)."""
        page = next(iter(self._evictable))  # oldest refcount-0 page
        del self._evictable[page]
        del self._cache[self._key_of.pop(page)]
        self._free.append(page)
        self.evictions += 1
        self.telemetry.record_evict(
            self._owner[page], forcer,
            self.telemetry.iteration - self._idle_since[page],
            self._depth[page], self._digest[page])
        self._owner[page] = None
        self._digest[page] = None
        self._depth[page] = 0

    def alloc(self, n: int,
              tenant: str | None = None) -> list[int] | None:
        """n fresh private pages (refcount 1), evicting cached pages as
        needed; None (and no side effects) if capacity is short.
        `tenant` attributes the pages (and any evictions this alloc
        forces) for the cache-telemetry ledger."""
        if self.available < n:
            return None
        while len(self._free) < n:
            self._evict_one(forcer=tenant)
        pages = [self._free.popleft() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
            self._owner[p] = tenant
        self.pages_allocated += n
        if n:
            self.telemetry.record_alloc(tenant, n)
        return pages

    def lookup_prefix(self, prompt: list[int], namespace: str = "",
                      tenant: str | None = None) -> tuple[list[int], int]:
        """Walk the prompt's full pages through the prefix cache.

        Returns (shared_pages, shared_len_tokens). Each hit page's
        refcount is bumped — the caller owns one reference per returned
        page and must release() them. At least one prompt token is always
        left un-shared so admission has a position to produce first-token
        logits from. `namespace` partitions chains whose KV differs for
        identical tokens (per-request LoRA adapters); `tenant`
        attributes the walk's hits/misses (and the hot-prefix-sketch
        update) to the requesting tenant's ledger.
        """
        ps = self.page_size
        self._namespaces.add(namespace)
        shared: list[int] = []
        parent = _root_for(namespace)
        limit = (len(prompt) - 1) // ps  # full pages, leaving >= 1 token
        for i in range(limit):
            key = (parent, tuple(prompt[i * ps:(i + 1) * ps]))
            page = self._cache.get(key)
            if page is None:
                self.prefix_miss_pages += 1
                break
            self.prefix_hit_pages += 1
            self._ref[page] += 1
            self._evictable.pop(page, None)  # active again
            shared.append(page)
            parent = _chain_digest(*key)
        hits = len(shared)
        self.telemetry.record_walk(
            tenant, hits, limit - hits, len(prompt) - hits * ps,
            parent if hits else None)
        if hits:
            self.telemetry.record_alloc(tenant, hits)  # refs held
        return shared, hits * ps

    def import_chain(self, tokens: list[int], namespace: str = "",
                     tenant: str | None = None) -> list[tuple[int, int]]:
        """Key a migrated chain's full pages into the cache so a
        continuation admission re-hits them.

        Walks the chain keys for every full page of `tokens` (the
        migration snapshot's committed stream). A key already cached
        DEDUPES — the destination holds identical content, nothing to
        transfer for that position. A miss claims a page (evicting LRU
        cached pages like alloc) and keys it; the caller must scatter
        the snapshot's KV into every returned page BEFORE any lookup
        can hit it (the scheduler holds its step lock across
        import + scatter, and admissions only run inside the step).

        Returns [(chain_index, page_id)] for the pages this call
        created — the positions whose device KV the caller must fill.
        Capacity shortage stops the walk early: a partial import is a
        valid (shorter) cached prefix, just a smaller prefill saving.
        Created pages land at refcount 0, cached and evictable —
        exactly the state a released chain leaves behind.
        """
        ps = self.page_size
        self._namespaces.add(namespace)
        parent = _root_for(namespace)
        fill: list[tuple[int, int]] = []
        created: list[int] = []
        for i in range(len(tokens) // ps):
            key = (parent, tuple(tokens[i * ps:(i + 1) * ps]))
            page = self._cache.get(key)
            if page is not None:
                parent = _chain_digest(*key)
                continue
            if self.available < 1:
                break
            if not self._free:
                self._evict_one(forcer=tenant)
            page = self._free.popleft()
            # refcount 1 for the duration of the walk: eviction only
            # touches refcount-0 pages, so later iterations of THIS
            # import can never reclaim an earlier created page
            self._ref[page] = 1
            self._owner[page] = tenant
            self.pages_allocated += 1
            self._cache[key] = page
            self._key_of[page] = key
            parent = _chain_digest(*key)
            self._depth[page] = i + 1
            self._digest[page] = parent
            created.append(page)
            fill.append((i, page))
        if created:
            self.telemetry.record_alloc(tenant, len(created))
            for page in created:
                self._ref[page] = 0
                self.pages_released += 1
                self._evictable[page] = None
                self._idle_since[page] = self.telemetry.iteration
            self.telemetry.record_release(tenant, len(created))
        return fill

    # -- release ------------------------------------------------------------

    def release(self, pages: list[int], tokens: list[int],
                namespace: str = "",
                tenant: str | None = None) -> None:
        """Drop one reference per chain page. Pages reaching refcount 0
        become cached (if they are full pages covered by `tokens` — the
        slot's committed prompt + generated ids) or return to the free
        list (the partial tail). `namespace` must match the lookup's;
        `tenant` the lookup/alloc's (the ledger drops the refs it
        counted there)."""
        ps = self.page_size
        self._namespaces.add(namespace)
        parent = _root_for(namespace)
        for i, page in enumerate(pages):
            self._ref[page] -= 1
            full = (i + 1) * ps <= len(tokens)
            if full:
                key = (parent, tuple(tokens[i * ps:(i + 1) * ps]))
                if page not in self._key_of and key not in self._cache:
                    # (a duplicate-content page under another id stays
                    # unkeyed; it frees below when unreferenced)
                    self._cache[key] = page
                    self._key_of[page] = key
                # content digest: the chain continues regardless of which
                # physical page is canonical for this position
                parent = _chain_digest(*key)
                if page in self._key_of:
                    # forensics sidecar for the KEYED page: chain
                    # position + digest (stamped once — the digest is a
                    # constant of the content) so an eviction needs no
                    # re-hash
                    self._depth[page] = i + 1
                    self._digest[page] = parent
            if self._ref[page] <= 0:
                self._ref[page] = 0
                self.pages_released += 1
                if page in self._key_of:
                    self._evictable[page] = None
                    # LRU idle clock: age-at-eviction counts from the
                    # moment the page LAST became evictable
                    self._idle_since[page] = self.telemetry.iteration
                else:
                    self._free.append(page)
                    self._owner[page] = None
        if pages:
            self.telemetry.record_release(tenant, len(pages))
