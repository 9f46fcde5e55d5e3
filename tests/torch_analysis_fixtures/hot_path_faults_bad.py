"""Fixture: failure-domain hot paths the lint must FLAG — the
tempting-but-wrong implementations (a sleep INSIDE fire() instead of
the dedicated blocking helpers, wall-clock overload stamps, a numpy
signal buffer per observe, logging per shed, config IO per level
read) that the real faults.py deliberately avoids: fire()/shed() are
lock-guarded int/float compares, and the only blocking lives in the
unrostered maybe_stall/maybe_wedge whose job IS to block."""

import time


class BadFaultPlan:
    def fire_sleeps(self, stall_ms):
        # the stall belongs in maybe_stall (unrostered, deliberate);
        # fire() runs on EVERY guarded site hit of every iteration
        time.sleep(stall_ms / 1e3)
        return None

    def fire_logged(self, logger, site):
        logger.info(site)
        return None

    def check_io(self, path, site):
        with open(path, "a") as f:
            f.write(site)


class BadOverloadDetector:
    def observe_wall_clock(self, signals):
        # wall clock for hysteresis math: NTP steps would flap the
        # shed level; the detector keeps one monotonic timebase
        signals["ts"] = time.time()
        return signals

    def observe_numpy(self, pending_age, utilization, gap):
        import numpy as np
        return np.asarray([pending_age, utilization, gap])

    def level_synced(self, device_signal):
        # grading overload via a blocking sync would CREATE the host
        # stall the detector exists to measure
        return device_signal.item()

    def shed_fine(self, level, shed_map, priority_class):
        # the real shape: dict lookup + membership test — must NOT fire
        return priority_class in shed_map.get(level, ())
