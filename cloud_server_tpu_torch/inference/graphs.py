"""Captured programs: one CUDA graph per shape key, one replay per
scheduler dispatch.

The counterpart of the reference's jitted `_mixed_step`,
`_decode_rounds`, `_spec_rounds` and `_prefill_chunk`, whose compile
cache is keyed by their static arguments and shapes. Here a `Program`
owns, for one key (the server's: body, static switches, input shapes,
and the grammar stack's generation for a program that reads it), static
input buffers on the device, pinned host staging for them, and the
pinned host buffers its results land in. A launch is:

  1. the staged numpy arrays written into the pinned staging;
  2. one non-blocking host-to-device copy per input;
  3. on CUDA, a replay of the program's graph (captured at its first
     launch: one eager warm-up run on a side stream, then the capture,
     in `capture_error_mode="thread_local"` because the HTTP frontend
     runs the scheduler on its own thread); on the CPU, the same
     function on the same buffers;
  4. one non-blocking device-to-host copy per result, then one event.

`wait()` is the iteration's one host sync: it waits on that event and
returns the results as numpy. `settle()` waits on it without taking the
results, off the serving path: a profiler window closing on the
dispatch in flight, and `_fail_all` before it tears slots down. Every
program of a `ProgramCache` shares one graph memory pool (graphs run
one at a time, in stream order, and every result is copied out right
after its replay, so a later replay may reuse an earlier graph's freed
intermediates). `release()` drops the graphs, their buffers and the
pool; so does a `drop` that leaves no captured graph behind.

There is no fallback: a capture or replay that fails raises. A cache
made with `capture=False` runs the same function eagerly on the same
buffers on the card: a switch for checking graphs against eager
launches (the counterpart of `jax.disable_jit`), not a mode to serve
in.

Kernel counters see replays: while a graph captures, the paged and
flash attention wrappers' calls launch nothing, so the capture counts
them into its own tallies (`ops.paged_attention.recording` and
`ops.flash_attention.recording`, this thread's calls only), keeps them,
and adds them on every replay (`add_counts`).

Several servers may share a device (a router's replicas, each with its
own scheduler thread): the warm-up and capture streams are shared per
device, so a warm-up and its capture hold the device's capture lock
from the warm-up through `capture_end`. Replays and eager launches take
no lock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from cloud_server_tpu_torch.ops import flash_attention as _fa
from cloud_server_tpu_torch.ops import paged_attention as _pa

# Program launches and waits, lifetime (tests read them: a steady
# pipelined step makes one of each).
launches = 0
syncs = 0


# One warm-up and one capture stream per device for every program:
# cuBLAS keeps a workspace for each stream it has run on, so a stream per
# capture would hold one more workspace per program for good. The
# streams of a device are used under its capture lock.
_streams: dict = {}
_capture_locks: dict = {}
_streams_lock = threading.Lock()


def _card(device) -> int:
    """The card's index ("cuda" and "cuda:0" name one card)."""
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _stream(device, use: str) -> torch.cuda.Stream:
    key = (_card(device), use)
    with _streams_lock:
        stream = _streams.get(key)
        if stream is None:
            stream = _streams[key] = torch.cuda.Stream(device)
        return stream


def _capture_lock(device) -> threading.Lock:
    with _streams_lock:
        return _capture_locks.setdefault(_card(device), threading.Lock())


class Program:
    """One shape key's static buffers, and its graph once captured.

    `fn(ctx, bufs) -> {name: tensor}` reads only the input buffers
    `bufs`, the tensors it reaches through `ctx` (weights, page pools),
    and constants; it writes the pools in place and returns its
    results."""

    def __init__(self, fn: Callable, ctx, inputs: dict, device,
                 capture: bool, pool):
        self.fn, self.ctx, self.device = fn, ctx, device
        cuda = device.type == "cuda"
        self._cuda, self._capture, self._pool = cuda, capture and cuda, pool
        self.dev_in = {k: torch.zeros(shape, dtype=dtype, device=device)
                       for k, (shape, dtype) in inputs.items()}
        self._host_in = {k: torch.zeros(shape, dtype=dtype, pin_memory=cuda)
                         for k, (shape, dtype) in inputs.items()}
        self.graph: torch.cuda.CUDAGraph | None = None
        self._dev_out: dict | None = None
        self._host_out: dict | None = None
        self.replay_counts: dict = {}  # paged attention's, per replay
        self.replay_flash: dict = {}   # flash attention's, per replay
        self.capture_s = 0.0  # host seconds of the warm-up and capture
        self._in_done = torch.cuda.Event() if cuda else None
        self._done = torch.cuda.Event() if cuda else None

    def _capture_graph(self) -> None:
        """Warm the program up on a side stream (real launches), then
        capture it. The warm-up's writes to the pools repeat at the
        replay with the same values; the per-slot state it updates
        (`ctx.mutable_state()`: counts, DFA states, token history) is
        put back as it was, so the replay applies each update once.
        `torch.cuda.graph` would also synchronise the card and empty the
        allocator's device and pinned-host caches before every capture;
        a server captures a dozen programs or more, so the capture is
        begun and ended here directly."""
        t0 = time.perf_counter()
        with _capture_lock(self.device):
            cur = torch.cuda.current_stream(self.device)
            side = _stream(self.device, "warm-up")
            side.wait_stream(cur)
            state = getattr(self.ctx, "mutable_state", list)()
            with torch.cuda.stream(side):
                saved = [t.clone() for t in state]
                self.fn(self.ctx, self.dev_in)
                for t, s in zip(state, saved):
                    t.copy_(s)
                del saved
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            cap = _stream(self.device, "capture")
            cap.wait_stream(cur)
            with _pa.recording() as recorded, _fa.recording() as flash, \
                    torch.cuda.stream(cap):
                graph.capture_begin(self._pool,
                                    capture_error_mode="thread_local")
                try:
                    out = self.fn(self.ctx, self.dev_in)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # an invalidated capture; `fn`'s error stands
                    raise
                graph.capture_end()
        self.graph, self._dev_out = graph, out
        self.replay_counts, self.replay_flash = recorded, flash
        self.capture_s = time.perf_counter() - t0

    def launch(self, staged: dict) -> None:
        """Stage `staged` ({input name: numpy array}, every input) and
        launch the program asynchronously."""
        global launches
        launches += 1
        if self._cuda and self._in_done is not None:
            # analysis: allow[dispatch-discipline] the last launch's input
            # copies read the staging: they ran before its program, and
            # the commit has waited on that program, so this never
            # waits on device work
            self._in_done.synchronize()
        for k, host in self._host_in.items():
            # analysis: allow[dispatch-discipline] numpy view of a pinned
            # host buffer: no device memory, no copy
            host.numpy()[...] = staged[k]
            self.dev_in[k].copy_(host, non_blocking=True)
        if not self._cuda:
            self._host_out = self.fn(self.ctx, self.dev_in)
            return
        self._in_done.record()
        if self._capture:
            if self.graph is None:
                self._capture_graph()
            self.graph.replay()
            _pa.add_counts(self.replay_counts)
            _fa.add_counts(self.replay_flash)
        else:
            self._dev_out = self.fn(self.ctx, self.dev_in)
        if self._host_out is None:
            self._host_out = {
                k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in self._dev_out.items()}
        for k, host in self._host_out.items():
            host.copy_(self._dev_out[k], non_blocking=True)
        self._done.record()

    def wait(self) -> dict:
        """The one host sync: the launched program's results as numpy."""
        global syncs
        syncs += 1
        if self._cuda:
            self._done.synchronize()
        # analysis: allow[dispatch-discipline] numpy views of the pinned
        # host results, after the sync above
        return {k: v.numpy().copy() for k, v in self._host_out.items()}

    def settle(self, timeout: float | None = None) -> bool:
        """Wait until the last launch has finished on the card, without
        taking its results (not an iteration's sync): True once it has,
        False when `timeout` seconds pass first."""
        if not self._cuda:
            return True
        if timeout is None:
            self._done.synchronize()
            return True
        deadline = time.perf_counter() + timeout
        while not self._done.query():
            if time.perf_counter() > deadline:
                return False
            time.sleep(0.001)
        return True

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self._dev_out = self._host_out = None
        self.dev_in = self._host_in = {}


class ProgramCache:
    """The programs of one server, by shape key, sharing one graph
    memory pool. Programs are made (and on CUDA captured) lazily at their
    first launch."""

    def __init__(self, device, capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture
        self._programs: dict = {}
        self._pool = None
        self.dropped = 0   # programs released by `drop`, lifetime
        self.dropped_in_flight = 0  # of those, kept until their wait

    def __len__(self) -> int:
        return len(self._programs)

    def keys(self) -> list:
        return list(self._programs)

    def capture_seconds(self) -> float:
        """Host seconds spent warming up and capturing the programs."""
        return sum(p.capture_s for p in self._programs.values())

    def get(self, key, fn: Callable, ctx, staged: dict) -> Program:
        """The program of shape `key`, made at its first use with input
        buffers shaped like `staged` ({name: numpy array})."""
        prog = self._programs.get(key)
        if prog is None:
            if (self._pool is None and self.capture
                    and self.device.type == "cuda"):
                self._pool = torch.cuda.graph_pool_handle()
            inputs = {k: (np.shape(a), torch.from_numpy(np.asarray(a)).dtype)
                      for k, a in staged.items()}
            prog = Program(fn, ctx, inputs, self.device, self.capture,
                           self._pool)
            self._programs[key] = prog
        return prog

    def drop(self, stale: Callable, busy: Program | None = None) -> list:
        """Release the programs whose key `stale(key)` names (they read
        a tensor that has been replaced); the next launch of such a shape
        makes, and on CUDA captures, the program again. `busy`, a program
        launched but not yet waited on, is taken out unreleased and
        returned: the caller releases it after its wait."""
        gone = [k for k in self._programs if stale(k)]
        kept = []
        for k in gone:
            prog = self._programs.pop(k)
            if prog is busy:
                kept.append(prog)
            else:
                prog.release()
        self.dropped += len(gone)
        self.dropped_in_flight += len(kept)
        if not any(p.graph is not None for p in self._programs.values()):
            # no captured graph of this cache is left in the pool (a kept
            # program's goes with its release): the next capture takes a
            # fresh pool, as the allocator refuses to hand out one whose
            # graphs have all been reset
            self._pool = None
        return kept

    def release(self) -> None:
        """Drop every graph, its buffers and the shared pool (they are
        made again at the next launch)."""
        for prog in self._programs.values():
            prog.release()
        self._programs.clear()
        self._pool = None

