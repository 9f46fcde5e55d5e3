"""Fixture: anomaly-watchdog hot paths the lint must FLAG — the
tempting-but-wrong implementations (a wall-clock stamp per observed
iteration, a numpy signal window per fold, logging the fired rule from
the scheduler thread, writing the forensic bundle to disk inline, a
blocking sync to grade a latency signal, sleeping out the hysteresis
hold) that the real anomaly.py deliberately avoids: observe_* fold
caller-passed floats into plain dicts/deques under a leaf lock, and
every export (stats/events/bundles) lives on the scrape path."""

import time


class BadWatchdog:
    def observe_wall_clock(self, signals):
        # wall clock for the hold/window math: NTP steps would flap
        # every windowed rule; the watchdog takes caller-passed
        # monotonic stamps and reads no clock of its own
        signals["ts"] = time.time()
        return signals

    def observe_numpy(self, ttft, itl, gap):
        import numpy as np
        return np.asarray([ttft, itl, gap])

    def fire_logged(self, logger, rule):
        logger.warning(rule)
        return rule

    def bundle_io(self, path, bundle):
        # the bundle belongs in the bounded in-memory ring; disk IO
        # on the activation edge stalls the scheduler iteration
        with open(path, "w") as f:
            f.write(str(bundle))

    def shift_synced(self, device_latency):
        # grading a latency shift via a blocking sync would CREATE
        # the host stall the host_gap rule exists to catch
        return device_latency.tolist()

    def hold_sleeps(self, hold_s):
        # hysteresis is a timestamp compare, never a wait
        time.sleep(hold_s)

    def update_fine(self, rule, firing, now, open_windows, last_true):
        # the real shape: dict/float work under the leaf lock — must
        # NOT fire
        if firing:
            last_true[rule] = now
            if rule not in open_windows:
                open_windows[rule] = {"rule": rule, "start": now,
                                      "end": None}
        return len(open_windows)
