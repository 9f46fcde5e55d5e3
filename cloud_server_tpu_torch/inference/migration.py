"""Live request migration: checkpoint/restore for mid-stream failover
and zero-loss drains.

A migration moves ONE in-flight request from a failing (or draining)
replica to a healthy one without losing or duplicating a single
delivered token.  The snapshot is taken at the scheduler's sanctioned
commit point — the only moment the host's view of the request (tokens,
KV watermark, grammar walker, RNG position) is exact — and carries:

  * the generated-token stream (plus logprobs/emit timestamps so the
    mirrored handle is indistinguishable from an uninterrupted one),
  * the request's KV pages for every COMMITTED full page, gathered
    with the export's one sanctioned host copy (off the plan path),
  * the sampling RNG position.  PR 9's streams are position-keyed
    (``fold_in(seed, position)``), so "RNG state" is just
    ``seed_used`` — the destination re-derives every future stream
    from the seed and the token index, no generator state crosses,
  * grammar progress, implicitly: the destination re-walks the
    generated tokens through its own compiled walker (the walk is
    deterministic, so the resumed ``gstate`` is exact),
  * identity and budget: tenant, adapter, QoS/SLO class, and the
    deadline REMAINDER (absolute deadlines are per-host monotonic
    clocks and must not cross machines),
  * trace context, so the destination's spans join the source's tree
    — one gap-free trace across replicas.

Import is deliberately thin: the destination scatters the pages back
into its pool under the radix chain keys (shared prefixes dedupe on
arrival — an imported page whose key is already cached is dropped,
not duplicated) and then re-admits the request through the NORMAL
continuation-admission path.  Token exactness therefore never depends
on the KV transfer: the pages are a prefill-cost optimization, and a
partially-imported (or evicted-on-arrival) chain is just a cache miss.

This module is host policy: stdlib-only, the ledger's lock is
leaf-level, and its record hooks ride the scheduler hot path. A copy of
the reference's `inference/migration.py`: the port's paged server
records its exports, salvages and imports in the ledger
(`migrate_export`, `migrate_salvage`, `migrate_import`), which backs
its stats and the bundle's `migration` block.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

# Snapshot wire-format version: bump when fields change incompatibly.
# import paths reject snapshots from a different major version rather
# than resuming a request from misread state.
MIGRATION_VERSION = 1


@dataclasses.dataclass(frozen=True)
class MigrationSnapshot:
    """Everything needed to resume one request on another replica.

    Built by ``PagedInferenceServer.migrate_export`` (live, with KV)
    or ``migrate_salvage`` (crash path, host state only — the dead
    scheduler already released its pages).  Arrays in ``kv_pages``
    are opaque to this module (host buffers produced by the export's
    sanctioned sync); everything else is plain Python data.
    """

    version: int
    request_id: str
    reason: str                       # "failover" | "drain" | ...
    prompt: tuple
    tokens: tuple                     # generated so far (delivered)
    logprobs: tuple
    emit_times: tuple
    seed_used: Any                    # RNG position key: seed only
    sampling: Any                     # SamplingParams (carries grammar
                                      # regex; walker state re-derived
                                      # by walking `tokens`)
    adapter: Any
    tenant: Any
    slo_class: Any
    max_new_tokens: int
    deadline_remaining_s: float | None
    trace_ctx: tuple | None           # (trace_id, root_span_id, True)
    chain_tokens: tuple               # committed stream covered by
                                      # the exported full pages
    kv_pages: dict | None             # pool name -> host array of the
                                      # chain's full pages, or None
                                      # (crash-path salvage)

    def remaining_new_tokens(self) -> int:
        """Decode budget left after the tokens already generated."""
        return max(0, int(self.max_new_tokens) - len(self.tokens))

    def full_prompt(self) -> tuple:
        """Continuation prompt: original prompt + generated stream."""
        return tuple(self.prompt) + tuple(self.tokens)

    def n_kv_pages(self) -> int:
        """Full pages carried by the snapshot (0 for salvage)."""
        if not self.kv_pages:
            return 0
        for arr in self.kv_pages.values():
            return int(arr.shape[1])
        return 0


class MigrationLedger:
    """Lock-guarded migration counters for one server.

    Record hooks are int adds under a leaf lock — they run from the
    export/import paths (which hold the scheduler's ``_step_lock``)
    and must never block or allocate.  ``stats()`` is the read side
    surfaced on ``/stats`` and merged fleet-wide by the router.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.out_started = 0
        self.out_completed = 0
        self.out_failed = 0
        self.in_started = 0
        self.in_completed = 0
        self.in_failed = 0
        self.tokens_salvaged = 0
        self.pages_moved = 0
        # per-iteration deltas consumed by the flight recorder
        # (migrated_in/out counts on the iteration record)
        self._flight_in = 0
        self._flight_out = 0

    def record_export_start(self) -> None:
        with self._lock:
            self.out_started += 1

    def record_export_done(self, n_tokens: int, n_pages: int) -> None:
        with self._lock:
            self.out_completed += 1
            self.tokens_salvaged += int(n_tokens)
            self.pages_moved += int(n_pages)
            self._flight_out += 1

    def record_export_failed(self) -> None:
        with self._lock:
            self.out_failed += 1

    def record_import_start(self) -> None:
        with self._lock:
            self.in_started += 1

    def record_import_done(self) -> None:
        with self._lock:
            self.in_completed += 1
            self._flight_in += 1

    def record_import_failed(self) -> None:
        with self._lock:
            self.in_failed += 1

    def drain_flight_deltas(self) -> tuple:
        """(migrated_in, migrated_out) since the last call — consumed
        once per iteration by the flight recorder."""
        with self._lock:
            out = (self._flight_in, self._flight_out)
            self._flight_in = 0
            self._flight_out = 0
            return out

    def stats(self) -> dict:
        with self._lock:
            started = self.out_started + self.in_started
            completed = self.out_completed + self.in_completed
            failed = self.out_failed + self.in_failed
            return {
                "out_started": self.out_started,
                "out_completed": self.out_completed,
                "out_failed": self.out_failed,
                "in_started": self.in_started,
                "in_completed": self.in_completed,
                "in_failed": self.in_failed,
                "started": started,
                "completed": completed,
                "failed": failed,
                "tokens_salvaged": self.tokens_salvaged,
                "pages_moved": self.pages_moved,
            }
