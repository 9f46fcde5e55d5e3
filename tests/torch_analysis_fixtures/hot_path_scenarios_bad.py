"""Fixture: scenario-harness hot paths the lint must FLAG — the
tempting-but-wrong implementations (a tick that reads its own clock,
a tick that sleeps until the next event is due, firing lag computed
through a numpy buffer, logging every rejection from the firing path,
an autoscaler evaluation that prints its decision) that the real
replay.py/autoscaler.py deliberately avoid: tick(now)/evaluate(now)
take caller-passed time and fold plain floats/dicts; logging and
actuation live on the _scale_up/_scale_down and run() paths."""

import time


class BadDriver:
    def tick_reads_clock(self, sessions):
        # the caller owns time: tests pass virtual time, run() passes
        # scaled wall time — a wall-clock read here both skews the
        # replay and steps with NTP
        now = time.time()
        return [e for e in sessions if e <= now]

    def tick_sleeps(self, due, now):
        # tick is non-blocking by contract; waiting out the gap stalls
        # the interleaved scheduler step() pump
        time.sleep(due - now)

    def fire_numpy_lag(self, due_times, now):
        import numpy as np
        return np.asarray(due_times) - now

    def fire_logged(self, logger, event):
        logger.info("fired %s", event)
        return event

    def evaluate_prints(self, action, reason):
        print(action, reason)
        return action

    def tick_fine(self, sessions, now, fired):
        # the real shape: plain list/float work on caller-passed time
        # — must NOT fire
        for events in sessions:
            while events and events[-1] <= now:
                fired.append(events.pop())
        return len(fired)
