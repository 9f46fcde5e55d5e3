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

* `CollectiveWatchdog` — a `Watchdog` for a rank of a mesh: its timeout
  grows by `per_axis_s` for each mesh axis of more than one rank, and
  its hang report names those axes.

* `FaultInjector` — fires "preempt", "nan_loss" or "crash" at exact
  steps, to drill the hooks above and the loop's checkpointing.
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


class CollectiveWatchdog:
    """Mesh-aware deadlock watchdog (see `Watchdog` for the mechanism).

    The classic distributed hang is a wedged collective: one rank on a
    mesh axis stops issuing its all_reduce/send/all_gather and every
    other rank on that axis blocks forever. This wrapper (a) extends the
    timeout by `per_axis_s` for each comm-active mesh axis (axes of size
    > 1 — each adds a blocking dependency chain, e.g. pp stage handoffs on
    top of sp ring hops), and (b) names those axes in the hang report so
    the operator knows which collectives to suspect before reading stacks.

    `mesh` is the rank's `torch.distributed` DeviceMesh (its axis names
    and sizes). Constructed like `Watchdog(...)` plus the mesh; use it
    anywhere a Watchdog is accepted (it is one, via delegation to an
    inner instance).
    """

    def __init__(self, mesh, timeout_s: float = 600.0,
                 per_axis_s: float = 60.0,
                 on_hang: Callable[[float], None] | None = None,
                 poll_s: float | None = None):
        axis_sizes = dict(zip(mesh.mesh_dim_names or (),
                              (int(n) for n in mesh.shape)))
        self.comm_axes = {a: s for a, s in axis_sizes.items() if s > 1}
        self._user_on_hang = on_hang or _default_on_hang
        self._inner = Watchdog(
            timeout_s=timeout_s + per_axis_s * len(self.comm_axes),
            on_hang=self._report, poll_s=poll_s)

    def _report(self, timeout_s: float) -> None:
        print(
            f"[watchdog] possible collective deadlock: no heartbeat for "
            f"{timeout_s:.0f}s with comm-active mesh axes "
            f"{self.comm_axes or '{} (single-device)'} — a wedged "
            "psum/ppermute/all_gather on any of these axes blocks every "
            "participant on it", file=sys.stderr, flush=True)
        self._user_on_hang(timeout_s)

    # Watchdog surface, delegated
    @property
    def timeout_s(self) -> float:
        return self._inner.timeout_s

    @property
    def fired(self) -> bool:
        return self._inner.fired

    def beat(self) -> None:
        self._inner.beat()

    def __call__(self, step: int, state, metrics: dict):
        return self._inner(step, state, metrics)

    def __enter__(self) -> "CollectiveWatchdog":
        self._inner.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._inner.__exit__(*exc)


class FaultInjector:
    """Deterministic fault injection for resilience drills and tests.

    A train-loop hook (`training.loop.train_loop(hooks=...)`) that fires
    configured faults at exact steps, so the recovery machinery (NaNGuard,
    the loop's emergency checkpoint, checkpoint resume) can be exercised
    on demand instead of waiting for real hardware flakiness. Faults:

      * "preempt"  — simulate a preemption at the step boundary (raises
                     KeyboardInterrupt, the control flow a SIGTERM
                     produces through PreemptionHandler), which the loop
                     turns into an emergency checkpoint.
      * "nan_loss" — overwrite metrics[metric] with NaN so the NaNGuard
                     path (patience, divergence abort) is driven end to
                     end. Mutates the metrics dict only — model state is
                     untouched, mirroring a transient bad batch.
      * "crash"    — raise RuntimeError, the generic unrecoverable error
                     (the loop saves nothing).

    Faults are (step, kind) pairs; each fires once. The injector is a
    plain hook — put it BEFORE the guards it is meant to trigger in the
    loop's hook list.
    """

    KINDS = ("preempt", "nan_loss", "crash")

    def __init__(self, faults: dict[int, str], metric: str = "loss"):
        for step, kind in faults.items():
            if kind not in self.KINDS:
                raise ValueError(f"unknown fault kind {kind!r} at step "
                                 f"{step}; expected one of {self.KINDS}")
        self._faults = dict(faults)
        self.metric = metric
        self.fired: list[tuple[int, str]] = []

    def __call__(self, step: int, state, metrics: dict):
        kind = self._faults.pop(step, None)
        if kind is None:
            return None
        self.fired.append((step, kind))
        if kind == "preempt":
            raise KeyboardInterrupt(f"injected preemption (step {step})")
        if kind == "nan_loss":
            import torch
            metrics[self.metric] = torch.tensor(float("nan"))
            return None
        raise RuntimeError(f"injected crash (step {step})")
