"""Replay driver: fires a scenario event stream at a live target.

The target is anything with ``submit(prompt, **kw)`` — a
``PagedInferenceServer``, a ``ReplicatedRouter`` — or an ``HttpTarget``
wrapping the HTTP frontend, so the same stream can drive one replica,
a fleet, or the full wire path.

Timing contract (shared with the simulator so both consume a stream
identically): a turn-0 event fires when the scenario clock reaches its
``time_s``; a turn-k event fires ``think_s`` after turn k-1 actually
completed. ``tick(now)`` is the non-blocking serving-path entry point
(it runs interleaved with scheduler steps, so it never blocks); ``run()`` is the wall-clock convenience loop around
it.

A replay never *loses* requests silently: every fired handle is kept,
``result()`` classifies completed vs failed (error finish reasons) vs
rejected (backpressure refusals at submit), and the scenario-harness
metric families (``cloud_server_scenario_*``) are registered eagerly
for the docs drift check.

Pure host-side policy: stdlib only — no torch, no numpy.
"""

from __future__ import annotations

import threading
import time
import urllib.request

from cloud_server_tpu_torch.utils.serving_metrics import MetricsRegistry


class _HttpHandle:
    """Request-handle shim over one non-streaming HTTP completion:
    exposes the ``done`` / ``finish_reason`` surface the driver's
    bookkeeping reads on real Request handles."""

    def __init__(self):
        self._done = threading.Event()
        self.finish_reason: str = ""
        self.text: str = ""

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)


class HttpTarget:
    """Fires events against the HTTP frontend (``/v1/completions``,
    non-streaming; tenant identity rides the X-Tenant header exactly
    as documented in http_server.py). Each submit runs on its own
    daemon thread so the driver's tick loop never blocks on the
    wire."""

    def __init__(self, base_url: str, *, timeout_s: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)

    def submit(self, prompt, *, max_new_tokens: int | None = None,
               tenant: str | None = None, **kw) -> _HttpHandle:
        import json as _json
        h = _HttpHandle()
        body = {"prompt": list(prompt), "stream": False}
        if max_new_tokens is not None:
            body["max_tokens"] = int(max_new_tokens)
        headers = {"Content-Type": "application/json"}
        if tenant is not None:
            headers["X-Tenant"] = tenant
        req = urllib.request.Request(
            self.base_url + "/v1/completions",
            data=_json.dumps(body).encode(), headers=headers)

        def worker():
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as resp:
                    out = _json.loads(resp.read())
                choice = (out.get("choices") or [{}])[0]
                h.finish_reason = choice.get("finish_reason", "stop")
                h.text = choice.get("text", "")
            except Exception as exc:  # noqa: BLE001 — recorded, surfaced
                h.finish_reason = f"error: {exc!r}"[:160]
            finally:
                h._done.set()

        threading.Thread(target=worker, daemon=True,
                         name="scenario-http").start()
        return h


class _Session:
    __slots__ = ("events", "prev", "prev_done_at")

    def __init__(self):
        self.events = []          # reversed: pop() yields next turn
        self.prev = None          # previous turn's live handle
        self.prev_done_at = None  # scenario time its completion was seen


class ReplayDriver:
    """Drives one event stream against one target.

    ``tick(now)`` fires every event that is due at scenario time
    ``now`` and returns how many fired; it never sleeps, logs, or
    reads a clock (the caller owns time — a test passes virtual time,
    ``run()`` passes scaled wall time), so it can interleave with
    synchronous ``step()`` pumping."""

    def __init__(self, target, events, *, submit_kw: dict | None = None,
                 registry: MetricsRegistry | None = None):
        self.target = target
        self.submit_kw = dict(submit_kw or {})
        self._sessions: dict[int, _Session] = {}
        for e in sorted(events, key=lambda e: (e.time_s, e.turn),
                        reverse=True):
            self._sessions.setdefault(e.session, _Session()).events \
                .append(e)
        self.handles: list[tuple[object, object]] = []  # (event, handle)
        self.rejected: list[tuple[object, str]] = []
        # scenario-harness metric families — registered EAGERLY so
        # they exist for the docs drift check before any event fires
        reg = self._registry = registry or MetricsRegistry()
        self._m_fired = reg.counter(
            "scenario_events_fired_total",
            "Scenario events submitted to the replay target")
        self._m_rejected = reg.counter(
            "scenario_events_rejected_total",
            "Scenario events refused at submit (backpressure/429 "
            "class) — counted, never retried by the driver")
        self._m_sessions = reg.counter(
            "scenario_sessions_total",
            "Distinct sessions in the replayed event stream")
        self._m_sessions.set_total(len(self._sessions))
        self._lag_ms = reg.histogram(
            "scenario_replay_lag_ms",
            "Firing lag behind the scenario schedule (tick time minus "
            "nominal due time), ms",
            buckets=(1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                     1000.0, 2500.0, 5000.0))

    # -- serving path -----------------------------------------------------

    def tick(self, now: float) -> int:
        """Fire everything due at scenario time ``now``."""
        fired = 0
        for sess in self._sessions.values():
            while sess.events:
                e = sess.events[-1]
                if e.turn > 0:
                    prev = sess.prev
                    if prev is None or not prev.done:
                        break
                    if sess.prev_done_at is None:
                        sess.prev_done_at = now
                    due = sess.prev_done_at + e.think_s
                else:
                    due = e.time_s
                if now < due:
                    break
                sess.events.pop()
                sess.prev_done_at = None
                sess.prev = self._fire(e, now - due)
                fired += 1
        return fired

    def _fire(self, e, lag_s: float):
        kw = dict(self.submit_kw)
        kw["max_new_tokens"] = e.max_new_tokens
        if e.tenant is not None:
            kw["tenant"] = e.tenant
        try:
            h = self.target.submit(list(e.prompt), **kw)
        except Exception as exc:  # noqa: BLE001 — refusal, not a loss
            self._m_rejected.inc()
            self.rejected.append((e, repr(exc)[:160]))
            return None
        self._m_fired.inc()
        self._lag_ms.observe(max(0.0, lag_s) * 1e3)
        self.handles.append((e, h))
        return h

    # -- read path -------------------------------------------------------

    @property
    def exhausted(self) -> bool:
        """Every event fired (or rejected)."""
        return all(not s.events for s in self._sessions.values())

    @property
    def done(self) -> bool:
        return self.exhausted and all(h.done for _, h in self.handles)

    def run(self, *, speed: float = 1.0, poll_s: float = 0.002,
            step=None, timeout_s: float | None = None) -> dict:
        """Wall-clock replay: scenario time advances at ``speed``x
        real time. With ``step`` (a callable) the target is pumped
        synchronously between ticks; without it the target is assumed
        to run its own scheduler threads."""
        t0 = time.monotonic()
        deadline = None if timeout_s is None else t0 + timeout_s
        while not self.done:
            now = time.monotonic()
            if deadline is not None and now > deadline:
                break
            self.tick((now - t0) * speed)
            if step is not None:
                step()
            else:
                time.sleep(poll_s)
        return self.result()

    def result(self) -> dict:
        failed = [(e, h.finish_reason) for e, h in self.handles
                  if h.done and str(getattr(h, "finish_reason", "")
                                    or "").startswith("error")]
        completed = (sum(1 for _, h in self.handles if h.done)
                     - len(failed))
        return {"fired": len(self.handles),
                "completed": completed,
                "failed": len(failed),
                "failures": [(e.session, e.turn, r)
                             for e, r in failed][:16],
                "rejected": len(self.rejected),
                "outstanding": sum(1 for _, h in self.handles
                                   if not h.done)}

    def metrics_snapshot(self) -> dict:
        return self._registry.snapshot()
