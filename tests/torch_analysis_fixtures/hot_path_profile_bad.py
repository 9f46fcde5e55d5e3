"""Fixture: iteration-profiler record paths the lint must FLAG — the
tempting-but-wrong implementations (wall-clock phase stamps, numpy
buffers per mark, a device sync to "time the device phase honestly",
logging/IO per iteration) that the real iteration_profile.py
deliberately avoids with perf_counter marks and plain dict adds."""

import time


class BadProfiler:
    def mark_wall_clock(self, acc, phase):
        # wall clock for a phase boundary: non-monotonic under NTP
        # slew, and banned on the hot path outright
        acc[phase] = time.time()

    def mark_numpy(self, phase, start, end):
        import numpy as np
        return np.asarray([start, end])

    def mark_synced(self, state, acc, phase, now):
        # "honest device timing" via a blocking sync: the profiler
        # would CREATE the stall it claims to measure
        state.synchronize()
        acc[phase] = now
        return acc

    def finish_logged(self, logger, acc):
        logger.info(acc)

    def finish_io(self, path, acc):
        with open(path, "a") as f:
            f.write(str(acc))

    def mark_fine(self, acc, phase, prev, now):
        # the shape the real profiler uses: monotonic timestamps and
        # one dict add — must NOT fire
        acc[phase] = acc.get(phase, 0.0) + (now - prev)
        return now
