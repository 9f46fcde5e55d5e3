"""Fixture: compliant twins of every lifecycle_bad.py violation.

NOT imported — parsed by tests/test_torch_analysis.py to prove the
``lifecycle-discipline`` checker stays QUIET on code that honors the
contracts (the other half of the fixture round-trip). The test
injects the same fixture-local rosters it uses for lifecycle_bad.py.
"""

import threading

import torch


class SlotRecord:
    # stand-in for the real _Slot: TAKES OWNERSHIP of the page list
    # handed to it (released later through the slot teardown path) —
    # the injected OWNERSHIP_TRANSFER_FUNCS entry
    def __init__(self, req, pages):
        self.req = req
        self.pages = pages


class GoodLifecycle:
    # the documented terminal order: telemetry -> fail-handler offer
    # -> _done.set() -> _on_done callback (LC2-clean)
    def _complete(self, req):
        self.metrics.observe_finish(req)
        if req.finish_reason.startswith("error:") and (
                self._fail_handler is not None):
            if self._fail_handler(req):
                return
        req._done.set()
        if req._on_done is not None:
            req._on_done(req)

    def _finish(self, slot, req):
        self._slots[slot] = None
        self._complete(req)

    # direct completion on the assigning path
    def cancel(self, req):
        req.finish_reason = "cancelled"
        self._complete(req)

    # transitive completion through the class-local call graph
    # (_finish -> _complete), the propagation the lock pass uses too
    def deadline(self, slot, req):
        req.finish_reason = "deadline"
        self._finish(slot, req)

    # deferred completion: the handle escapes into a container and
    # the drain site (audited on its own) owns the obligation
    def defer(self, req, doomed):
        req.finish_reason = "error:admission"
        doomed.append(req)

    # path-sensitive: only the assigning branch must complete
    def branchy(self, req, ok):
        if not ok:
            req.finish_reason = "error:rejected"
            self._complete(req)
            return
        self.step(req)

    # sanctioned terminal marker (injected TERMINAL_MARKER_FUNCS):
    # assigns the reason, the CALLER completes on the True return
    def emit(self, req, tok):
        if tok == 0:
            req.finish_reason = "eos"
            return True
        return False


class GoodOwner:
    # sanctioned completion owner (injected COMPLETION_OWNER_FUNCS):
    # completes the ORIGINAL handle it took ownership of
    def retry(self, orig, new):
        orig.finish_reason = new.finish_reason
        orig._done.set()


class GoodPages:
    # registered into an owned chain on the live branch; the None
    # branch owns nothing (the refinement LC3 needs)
    def balanced(self, slot, n):
        fresh = self.allocator.alloc(n, tenant=None)
        if fresh is None:
            return False
        slot.pages.extend(fresh)
        return True

    # ownership transferred to an audited callable (injected
    # OWNERSHIP_TRANSFER_FUNCS) via the pages= keyword
    def handoff(self, req, n):
        fresh = self.allocator.alloc(n, tenant=None)
        if not fresh:
            return None
        return SlotRecord(req=req, pages=fresh)

    # returning the fill hands ownership to the caller; reading the
    # list (len, comprehensions) is not a move
    def import_and_count(self, snap):
        fill = self.allocator.import_chain(
            list(snap.chain_tokens), namespace="", tenant=None)
        if not fill:
            return 0
        self.scatter([p for _, p in fill])
        return len(fill)

    # released on every edge: try/finally covers the staging call
    def release_via_finally(self, n):
        fresh = self.allocator.alloc(n, tenant=None)
        if fresh is None:
            return
        try:
            self.stage(fresh)
        finally:
            self.allocator.release(fresh, [], namespace="",
                                   tenant=None)


class GoodTear:
    def __init__(self):
        self._lock = threading.Lock()
        self._head = 0
        self._tail = 0

    def reset(self):
        with self._lock:
            self._head = 0
            self._tail = 0

    # adjacent guarded writes with the risky work outside the lock
    def writes_then_risky(self, spec):
        with self._lock:
            self._head = spec.head
            self._tail = spec.tail
        probe = open("/dev/null")
        probe.close()

    # the staging first, then the writes back to back (the port's
    # grammar-stack upload): a failed upload tears nothing
    def staged_then_writes(self, spec):
        with self._lock:
            rows = torch.as_tensor(spec.rows).to(spec.device)
            self._head = spec.head
            self._tail = spec.tail
            return rows

    # risky call between the writes, but try/finally protects the
    # region — the finally restores the pair on the exception edge
    def protected(self, spec):
        with self._lock:
            prev = self._head
            try:
                self._head = spec.head
                probe = open("/dev/null")
                self._tail = spec.tail
                probe.close()
            finally:
                self._head = prev
