"""Profiling hooks around torch.profiler.

The port of the reference's `utils/tracing.py` (there on
jax.profiler). `annotate` names a host-side region so it shows on the
trace timeline (`torch.profiler.record_function`); `capture_trace`
wraps a window of work in a `torch.profiler.profile` window, CPU
activity and, when a CUDA device is present, the card's kernels and
copies, and writes the trace into `logdir` through
`torch.profiler.tensorboard_trace_handler` (a `*.pt.trace.json` that
TensorBoard's profile plugin and Perfetto open); `StepProfiler` is the
same window over a range of training steps.

`start_profiler_server` is refused: PyTorch has no in-process profiler
server, and its on-demand path (`dynolog`) needs a daemon beside the
process. A live server is traced with POST /debug/trace instead.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity


def _activities() -> list:
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _profile(logdir: str | os.PathLike) -> torch.profiler.profile:
    return torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(
            os.fspath(logdir)))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def capture_trace(logdir: str | os.PathLike) -> Iterator[None]:
    """Capture a host (+ device) trace of the enclosed block into
    `logdir` (view with TensorBoard's profile plugin or Perfetto)."""
    prof = _profile(logdir)
    prof.start()
    try:
        yield
    finally:
        prof.stop()


def start_profiler_server(port: int = 9999):
    """The reference's on-demand remote capture (`--profiler-port`)."""
    raise NotImplementedError(
        f"a profiler server (port {port}) is not ported to the PyTorch "
        "package: torch.profiler has no in-process server and its "
        "on-demand capture needs the dynolog daemon; trace a live server "
        "with POST /debug/trace")


class StepProfiler:
    """Trace a half-open step window [start, stop) of a training loop:
    profiles steady-state steps while skipping warm-up."""

    def __init__(self, logdir: str | os.PathLike, *, start_step: int,
                 num_steps: int = 3):
        self.logdir = os.fspath(logdir)
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof: torch.profiler.profile | None = None

    def step(self, step: int) -> None:
        if step == self.start_step and self._prof is None:
            self._prof = _profile(self.logdir)
            self._prof.start()
        elif step >= self.stop_step and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.stop()
