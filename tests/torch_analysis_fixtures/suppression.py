"""Fixture: suppression-pragma semantics.

Two identical lock-discipline violations; ONE carries a reasoned
``allow[lock-discipline]`` pragma (and must be suppressed), the other
must survive. A third pragma has no reason and must itself become a
``pragma`` finding. A fourth violation sits on a continuation line of
a multi-line statement whose pragma is anchored on the statement's
FIRST line — the regression for full-lexical-extent coverage (the
finding reports at the sub-expression's line, lines below the
pragma).
"""

import threading
import time


class Suppressed:
    def __init__(self):
        self._lock = threading.Lock()
        self._state = 0

    def poke(self):
        with self._lock:
            self._state += 1

    def allowed_sleep(self):
        with self._lock:
            # analysis: allow[lock-discipline] test fixture: proves a
            # reasoned pragma silences exactly this finding
            time.sleep(0.001)

    def unallowed_sleep(self):
        with self._lock:
            time.sleep(0.001)

    def reasonless(self):
        # analysis: allow[lock-discipline]
        return self._state

    def allowed_multiline(self):
        with self._lock:
            waits = [  # analysis: allow[lock-discipline] regression: the finding lands on the sleep's own line, below this pragma — statement-extent coverage must still suppress it
                time.sleep(0.001),
                time.sleep(0.002),
            ]
            return waits
