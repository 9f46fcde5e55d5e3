"""Fixture: every lifecycle-discipline violation, one per method.

NOT imported — parsed by tests/test_torch_analysis.py to prove the
``lifecycle-discipline`` checker actually fires on each rule
(LC1..LC4). The test injects fixture-local rosters
(owner/marker/complete/transfer) via ``check_source`` keyword
arguments, mirroring how the real rosters key on the audited modules.
"""

import threading

import torch


class BadFinish:
    # a CORRECT _complete, so the class's completing closure exists
    # and only the LC1 violations below fire
    def _complete(self, req):
        self.metrics.observe_finish(req)
        if req.finish_reason.startswith("error:") and (
                self._fail_handler is not None):
            if self._fail_handler(req):
                return
        req._done.set()
        if req._on_done is not None:
            req._on_done(req)

    # LC1: terminal finish_reason assigned, then the function falls
    # off the end without ever reaching _complete — the waiter hangs
    def drop_on_floor(self, req):
        req.finish_reason = "error:dropped"

    # LC1: the early-exit path skips completion (the fall-through
    # path is fine — this is the path-sensitivity the rule needs)
    def early_exit_leaks(self, req, ok):
        req.finish_reason = "stop"
        if not ok:
            return
        self._complete(req)

    # LC1: completed twice with no rebind between — the second call
    # double-counts telemetry and double-offers the fail handler
    def double_complete(self, req):
        req.finish_reason = "stop"
        self._complete(req)
        self._complete(req)

    # LC1: _done.set() outside _complete (and outside the audited
    # COMPLETION_OWNER_FUNCS) — the fail-handler contract only
    # holds if _complete is the single place the event fires
    def rogue_done_set(self, req):
        req._done.set()

    # LC1: reading _on_done to invoke it outside _complete
    def rogue_callback(self, req):
        cb = req._on_done
        if cb is not None:
            cb(req)


class BadOrder:
    # LC2: _done.set() fires before the telemetry observation and the
    # fail-handler offer — a handler that takes over the request
    # would find the waiter already released
    def _complete(self, req):
        req._done.set()
        self.metrics.observe_finish(req)
        if self._fail_handler is not None:
            self._fail_handler(req)
        if req._on_done is not None:
            req._on_done(req)


class BadMissing:
    # LC2: no _fail_handler offer at all — error-terminal requests
    # would silently skip failover
    def _complete(self, req):
        self.metrics.observe_finish(req)
        req._done.set()
        if req._on_done is not None:
            req._on_done(req)


class BadPages:
    # LC3: the n > 4 path returns while `fresh` still owns its pages
    def leak_on_return(self, n):
        fresh = self.allocator.alloc(n, tenant=None)
        if fresh is None:
            return False
        if n > 4:
            return True
        self.allocator.release(fresh, [], namespace="", tenant=None)
        return True

    # LC3: the raise edge leaks — the exception propagates with the
    # pages neither released nor transferred
    def leak_on_raise(self, n):
        fresh = self.allocator.alloc(n, tenant=None)
        if fresh is None:
            raise RuntimeError("admission failed")
        if not self.validate(fresh):
            raise RuntimeError("bad chain")
        self.allocator.release(fresh, [], namespace="", tenant=None)

    # LC3: the allocation's result is discarded outright — the pages
    # can never be released
    def drops_result(self):
        self.allocator.alloc(2, tenant=None)

    # LC3: rebound while still owning pages
    def rebinds_while_live(self, n):
        fresh = self.allocator.alloc(n, tenant=None)
        fresh = []
        return fresh


class BadTear:
    def __init__(self):
        self._lock = threading.Lock()
        self._head = 0
        self._tail = 0

    # guard setup: _head/_tail written under _lock here, so the lock
    # pass infers them as _lock-guarded shared state
    def reset(self):
        with self._lock:
            self._head = 0
            self._tail = 0

    # LC4: a may-raise call between the two guarded writes, with no
    # try/finally — an exception leaves _head updated but _tail stale
    # for the next lock holder
    def risky_between(self, spec):
        with self._lock:
            self._head = spec.head
            probe = open("/dev/null")
            self._tail = spec.tail
            probe.close()

    # LC4: a host->device staging copy between the writes (may run
    # out of device memory) is the same tear
    def staging_between(self, spec):
        with self._lock:
            self._head = spec.head
            rows = torch.as_tensor(spec.rows)
            self._tail = spec.tail
            return rows

    # LC4: a program's wait() between the writes is the same tear
    def wait_between(self, spec, prog):
        with self._lock:
            self._head = spec.head
            out = prog.wait()
            self._tail = spec.tail
            return out

    # LC4: an explicit raise between the writes is the same tear
    def raise_between(self, spec):
        with self._lock:
            self._head = spec.head
            if spec.tail < 0:
                raise ValueError("bad tail")
            self._tail = spec.tail
