"""Fixture: a span-record / SLO-observe path the lint must FLAG —
the tempting-but-wrong implementations (reading the wall clock inside
the recorder, materializing numpy buffers per observation, logging
per span) that the real request_trace.py / slo.py deliberately avoid
by taking timestamps the scheduler already owns."""

import time


class BadRecorder:
    def add_span_wall_clock(self, spans, name):
        # stamps its own wall-clock time instead of an owned moment
        spans.append((name, time.time()))

    def add_span_numpy(self, name, start, end):
        import numpy as np
        return np.asarray([start, end])

    def add_span_logged(self, logger, name):
        logger.info(name)


class BadSLO:
    def observe_io(self, path, ok):
        with open(path, "a") as f:
            f.write("x")
        return ok

    def observe_sleepy(self, ok):
        time.sleep(0.001)
        return ok

    def observe_fine(self, ring, ok, now):
        # the shape the real modules use: pure arithmetic on passed-in
        # timestamps — must NOT fire
        ring[int(now) % len(ring)] += 1 if ok else 0
        return ring
