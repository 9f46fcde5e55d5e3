"""Fixture: disciplined locking — the ``lock-discipline`` checker
must stay silent on every shape the real serving stack uses."""

import threading
import time


class GoodServer:
    def __init__(self):
        self._lock = threading.Lock()
        self._step_lock = threading.Lock()
        self._pending = []
        self._stats = {}
        self._work = threading.Condition(self._lock)

    def submit(self, req):
        with self._lock:
            self._pending.append(req)

    def peek(self):
        with self._lock:
            return len(self._pending)

    # the _locked-suffix convention: a private helper whose every call
    # site holds the lock inherits it (must-held propagation)
    def _drain_locked(self):
        out, self._pending = list(self._pending), []
        return out

    def take_all(self):
        with self._lock:
            return self._drain_locked()

    # correct nesting order: _step_lock outermost, _lock inside
    def step(self):
        with self._step_lock:
            self._stats = {}
            with self._lock:
                batch = self._drain_locked()
            self._stats["n"] = len(batch)
            return batch

    # blocking work OUTSIDE any lock region is fine: the program's
    # wait() after the lock drops
    def idle(self, prog):
        time.sleep(0.001)
        prog.wait()
        return self.peek()

    # a Condition built over _lock aliases it, and its wait() releases
    # the lock: host-only, not a device sync
    def park(self):
        with self._lock:
            self._work.wait(0.01)
            return len(self._pending)

    # the bounded-acquire teardown idiom: a path that must not hang
    # behind a wedged holder takes the lock with a timeout and
    # proceeds either way — the rest of the block counts as held
    def fail_all(self):
        got = self._step_lock.acquire(timeout=5.0)
        try:
            self._stats = {}
            with self._lock:
                self._pending.clear()
        finally:
            if got:
                self._step_lock.release()
