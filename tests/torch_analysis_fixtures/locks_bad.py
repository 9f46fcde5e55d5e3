"""Fixture: every lock-discipline violation class, one per method.

NOT imported — parsed by tests/test_torch_analysis.py to prove the
port's ``lock-discipline`` checker actually fires on each rule
(LD1..LD4), in the port's idiom: a captured program's wait(), an
event's synchronize(), a tensor's cpu().
"""

import queue
import threading
import time


class BadServer:
    def __init__(self):
        self._lock = threading.Lock()
        self._step_lock = threading.Lock()
        self._pending = []
        self._draining = False
        self._split = 0
        self._queue = queue.Queue()
        self._prog = None
        self._event = None

    # LD1 setup: _pending and _draining are written under _lock here,
    # so they are inferred as _lock-guarded shared state
    def submit(self, req):
        with self._lock:
            if self._draining:
                raise RuntimeError("draining")
            self._pending.append(req)

    def drain(self):
        with self._lock:
            self._draining = True

    # LD1: unlocked READ of a guarded attribute from a public method
    def peek_unlocked(self):
        return len(self._pending)

    # LD1: unlocked WRITE of a guarded attribute
    def reset_unlocked(self):
        self._draining = False

    # LD2: _split is written under _lock here and under _step_lock in
    # step() below — no common guard, the two writers can race
    def bump_split(self):
        with self._lock:
            self._split += 1

    def step(self):
        with self._step_lock:
            self._split = 0

    # LD3: blocking calls while a lock is held
    def sleepy_hold(self):
        with self._lock:
            time.sleep(0.1)

    def sync_hold(self):
        with self._step_lock:
            return self._prog.wait()

    def event_hold(self):
        with self._step_lock:
            self._event.synchronize()

    def copy_hold(self, t):
        with self._lock:
            return t.cpu()

    def io_hold(self):
        with self._lock:
            print("held")

    def queue_hold(self):
        with self._lock:
            return self._queue.get()

    # LD4: acquiring _step_lock while holding _lock violates the
    # declared _step_lock -> _lock order
    def backwards(self):
        with self._lock:
            with self._step_lock:
                return list(self._pending)

    # LD4: the one-liner form of the same inversion — items acquire
    # left to right, so this is the identical ABBA hazard
    def backwards_oneliner(self):
        with self._lock, self._step_lock:
            return list(self._pending)

    # LD4: self-deadlock through a helper — locked() calls a method
    # that re-acquires the same (non-reentrant) lock
    def locked_entry(self):
        with self._lock:
            return self._relock()

    def _relock(self):
        with self._lock:
            return True
