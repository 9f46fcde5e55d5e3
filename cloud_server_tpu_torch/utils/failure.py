"""Failure detection: NaN guard, preemption handler, watchdog.

Host-side train-loop hooks, copied from the reference package:

* `NaNGuard` — checks the loss for NaN/inf on a cadence (cadenced
  because reading a device scalar synchronises the host with the
  device). On divergence it raises `TrainingDiverged`.

* `PreemptionHandler` — converts SIGTERM (the preemption notice cloud
  schedulers send) into a `KeyboardInterrupt` raised at the next step
  boundary.

* `Watchdog` — a heartbeat monitor thread for hang detection. If `beat()`
  is not called within `timeout_s`, it dumps every thread's stack to
  stderr and invokes `on_hang` (default: `os._exit(code)`). It only arms
  at the *first* beat, so a long first step cannot trigger it.
"""

from __future__ import annotations

import faulthandler
import math
import os
import signal
import sys
import threading
import time
from typing import Callable

class TrainingDiverged(RuntimeError):
    """Loss became NaN/inf and stayed that way past the guard's patience."""


class NaNGuard:
    """Train-loop hook: raise `TrainingDiverged` on non-finite loss.

    check_interval: only inspect every k-th step (each inspection pulls a
    scalar from device, which blocks the async dispatch pipeline).
    patience: number of *consecutive checked* non-finite losses tolerated
    before raising — transient inf (e.g. one bad batch under bf16) can
    recover; a persistent NaN cannot.
    """

    def __init__(self, check_interval: int = 10, patience: int = 0,
                 metric: str = "loss"):
        self.check_interval = max(1, check_interval)
        self.patience = patience
        self.metric = metric
        self._bad_streak = 0

    def __call__(self, step: int, state, metrics: dict):
        if step % self.check_interval:
            return None
        value = float(metrics[self.metric])
        if math.isfinite(value):
            self._bad_streak = 0
            return None
        self._bad_streak += 1
        if self._bad_streak > self.patience:
            raise TrainingDiverged(
                f"{self.metric}={value} at step {step} "
                f"({self._bad_streak} consecutive bad checks)")
        return None


class PreemptionHandler:
    """Preemption signal -> KeyboardInterrupt at the next step boundary.

    Installs handlers for `signals` (default: SIGTERM only — SIGINT keeps
    Python's immediate Ctrl-C behaviour unless explicitly listed). Use as
    a context manager around the train loop; the inner hook only reads a
    flag, so the signal can arrive at any point (including inside a device
    call) and the interrupt still lands at a state-consistent boundary.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous: dict = {}
        self.requested = False

    def _handle(self, signum, frame):
        self.requested = True

    def __enter__(self) -> "PreemptionHandler":
        for s in self._signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()

    def __call__(self, step: int, state, metrics: dict):
        """The train-loop hook."""
        if self.requested:
            raise KeyboardInterrupt(f"preemption requested (step {step})")
        return None


def _default_on_hang(timeout_s: float) -> None:
    print(f"[watchdog] no heartbeat for {timeout_s:.0f}s — dumping stacks "
          "and exiting", file=sys.stderr, flush=True)
    faulthandler.dump_traceback(file=sys.stderr)
    os._exit(42)


class Watchdog:
    """Heartbeat hang-detector.

    The protected code calls `beat()` periodically (e.g. via the train-loop
    hook interface: a Watchdog instance is itself a valid hook). A daemon
    thread checks the last heartbeat; silence past `timeout_s` triggers
    `on_hang(timeout_s)`. The monitor is disarmed until the first `beat()`
    (entering the context manager does not beat), so startup work of
    unknown length — first-step compilation in particular — can't fire it.
    """

    def __init__(self, timeout_s: float = 600.0,
                 on_hang: Callable[[float], None] | None = None,
                 poll_s: float | None = None):
        self.timeout_s = timeout_s
        self._on_hang = on_hang or _default_on_hang
        self._poll_s = poll_s if poll_s is not None else min(
            10.0, timeout_s / 4)
        self._stop = threading.Event()
        self._last_t: float | None = None
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self.fired = False

    def beat(self) -> None:
        with self._lock:
            self._last_t = time.monotonic()

    # hook interface
    def __call__(self, step: int, state, metrics: dict):
        self.beat()
        return None

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                last = self._last_t
            if last is not None and time.monotonic() - last > self.timeout_s:
                self.fired = True
                self._on_hang(self.timeout_s)
                return

    def __enter__(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="cloud-server-watchdog")
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
