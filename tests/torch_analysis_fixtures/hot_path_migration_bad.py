"""Fixture: migration-ledger hot paths the lint must FLAG — the
tempting-but-wrong implementations (logging per export, a wall-clock
stamp on the flight-delta drain, numpy counter buffers, snapshot IO
from inside a record hook, a blocking sync to "confirm" the export's
pages landed, a sleep to pace imports) that the real migration.py
deliberately avoids: every record hook is an int add under a leaf
lock, because they run while the SOURCE or DESTINATION scheduler's
step lock is held and drain_flight_deltas rides every busy iteration
of _record_iteration."""

import time


class BadMigrationLedger:
    def record_export_done_logged(self, logger, n_tokens):
        # the export path holds the source's _step_lock: a log write
        # here stalls that replica's whole scheduler
        logger.info(n_tokens)

    def record_import_done_io(self, path, request_id):
        # persisting the snapshot belongs to the caller, off-lock
        with open(path, "a") as f:
            f.write(request_id)

    def drain_flight_wall_clock(self, record):
        # drain_flight_deltas runs once per busy iteration; the
        # schedulers keep one monotonic timebase (NTP steps would
        # corrupt the iteration record)
        record["ts"] = time.time()
        return record

    def stats_numpy(self, counters):
        import numpy as np
        return np.asarray(counters)

    def record_export_synced(self, kv_pages):
        # "confirming" the gathered pages landed re-syncs under the
        # step lock — the export already paid its ONE sanctioned sync
        return kv_pages.numpy()

    def record_import_sleepy(self, backoff_s):
        # pacing belongs to the router's migrate worker, never the
        # ledger hook the destination calls under its step lock
        time.sleep(backoff_s)

    def record_export_done_fine(self, n_tokens, n_pages):
        # the real shape: int adds on the ledger — must NOT fire
        self.out_completed += 1
        self.tokens_salvaged += int(n_tokens)
        self.pages_moved += int(n_pages)
