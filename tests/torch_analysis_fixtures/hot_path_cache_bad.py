"""Fixture: cache-telemetry record paths the lint must FLAG — the
tempting-but-wrong implementations (wall-clock eviction stamps, a
numpy buffer per walk, a device sync to "snapshot the pool honestly",
logging/IO per eviction) that the real cache_telemetry.py deliberately
avoids with plain dict arithmetic on scheduler-stamped iteration
indices."""

import time


class BadCacheTelemetry:
    def record_evict_wall_clock(self, ledger, victim):
        # wall clock for an eviction timestamp: NTP steps would
        # corrupt age math, and wall-clock reads are banned outright
        ledger[victim] = time.time()

    def record_walk_numpy(self, hits, misses):
        import numpy as np
        return np.asarray([hits, misses])

    def record_walk_synced(self, pool, ledger, tenant, hits):
        # "honest pool occupancy" via a blocking sync: the telemetry
        # would CREATE the stall it exists to surface
        pool.cpu()
        ledger[tenant] = hits
        return ledger

    def record_evict_logged(self, logger, victim, forcer):
        logger.info((victim, forcer))

    def record_evict_io(self, path, rec):
        with open(path, "a") as f:
            f.write(str(rec))

    def record_walk_fine(self, ledger, tenant, hits, iteration):
        # the shape the real telemetry uses: dict arithmetic on a
        # scheduler-stamped iteration index — must NOT fire
        cur = ledger.get(tenant, 0)
        ledger[tenant] = cur + hits
        return iteration
