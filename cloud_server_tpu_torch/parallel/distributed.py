"""Multi-process runtime: initialization, hybrid meshes, coordination
helpers, and a bounded launcher of ranks.

The port runs one process per rank over `torch.distributed` (SPMD):
collectives are NCCL on cards (`torchrun` starts the ranks, one card
each) or gloo on the CPU. What this module adds is the process plumbing
around that, the reference's vocabulary:

* `initialize()` — one idempotent entry point over
  `init_process_group`, with the backend, the init method and a finite
  timeout, so a collective that a dead rank never joins raises instead
  of hanging.
* `make_hybrid_mesh(ici, dcn)` — a mesh whose cross-host (DCN) factors
  are the outer part of each axis, so the chatty tp/sp collectives stay
  on one host's links and only dp/pp cross hosts.
* `is_primary()` / `sync_global_devices()` / `broadcast_from_primary()`
  — the coordination helpers train loops, checkpointers and servers use.
* `spawn_ranks(fn, world_size, backend, ...)` — N processes on a file
  store, joined within a deadline and killed past it: the CPU tests'
  counterpart of the reference's `xla_force_host_platform_device_count`.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue as _queue
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from cloud_server_tpu_torch.config import MeshConfig
from cloud_server_tpu_torch.parallel.mesh import _build, world_size

# A collective that a rank never joins raises after this long (seconds).
DEFAULT_TIMEOUT_S = 300.0

_gloo_groups: dict = {}
# the timeout `initialize` gave the default group, for the groups made
# here (`new_group` would otherwise take its own 30-minute default)
_timeout_s: float | None = None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, backend: str = "nccl",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Idempotent `init_process_group`.

    `coordinator_address` is an init method ("tcp://host:port",
    "file:///path"); without it the environment's (`torchrun` sets
    MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE). `backend` is "nccl"
    on cards and "gloo" on the CPU; the caller names it, nothing picks
    one on its own. A second call is a no-op, so library code can call
    it defensively."""
    global _timeout_s
    if dist.is_initialized():
        return
    _timeout_s = timeout_s
    kwargs = {"backend": backend,
              "timeout": datetime.timedelta(seconds=timeout_s)}
    if coordinator_address is not None:
        kwargs["init_method"] = coordinator_address
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(**kwargs)


def num_slices() -> int:
    """Hosts the ranks span (1 in one process or on one host): the
    world over torchrun's per-host rank count."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    return max(1, world_size() // max(1, local))


def make_hybrid_mesh(ici: MeshConfig, dcn: MeshConfig,
                     device_type: str = "cuda"):
    """Mesh over several hosts: per-host axis sizes from `ici`, across-
    host sizes from `dcn` (their elementwise product is the global mesh).
    Ranks are host-major (torchrun's numbering), and each axis's global
    index is dcn index * ici size + ici index, so one host holds whole
    inner blocks. Keep `dcn` to the outer axes (dp, pp)."""
    for axis in ("fsdp", "ep", "sp", "tp"):
        if getattr(dcn, axis) > 1:
            raise ValueError(
                f"dcn mesh axis {axis!r} > 1: fsdp/ep/sp/tp collectives are "
                "per-layer and would serialise on DCN; keep DCN to dp/pp")
    n = ici.num_devices * dcn.num_devices
    have = world_size()
    if n != have:
        raise ValueError(
            f"hybrid mesh wants {ici.num_devices}×{dcn.num_devices}={n} "
            f"devices, got {have}")
    ici_shape = [ici.axis_sizes()[a] for a in MeshConfig.AXIS_ORDER]
    dcn_shape = [dcn.axis_sizes()[a] for a in MeshConfig.AXIS_ORDER]
    k = len(ici_shape)
    ranks = torch.arange(n).reshape(dcn_shape + ici_shape)
    # pair each axis's (dcn, ici) factors, dcn outer
    order = [d for i in range(k) for d in (i, k + i)]
    shape = [i * d for i, d in zip(ici_shape, dcn_shape)]
    return _build(device_type, ranks.permute(order).reshape(shape))


def global_mesh_config(ici: MeshConfig, dcn: MeshConfig) -> MeshConfig:
    """The MeshConfig equivalent of a hybrid mesh's global shape (what
    batch-size divisibility checks should be run against)."""
    sizes = {a: ici.axis_sizes()[a] * dcn.axis_sizes()[a]
             for a in MeshConfig.AXIS_ORDER}
    return MeshConfig(**sizes)


# -- coordination helpers ----------------------------------------------------

def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def group_timeout_s() -> float:
    """The timeout, in seconds, of the groups made here: the one
    `initialize` was given (DEFAULT_TIMEOUT_S without it)."""
    return DEFAULT_TIMEOUT_S if _timeout_s is None else _timeout_s


def new_gloo_group(ranks):
    """A new gloo group over `ranks` (global ranks), with the default
    group's timeout. A collective call: every rank of the default group
    makes it, in the same order."""
    timeout = datetime.timedelta(seconds=group_timeout_s())
    return dist.new_group(list(ranks), backend="gloo", timeout=timeout)


def gloo_group(group=None):
    """A gloo group over `group`'s ranks (the default group's when None):
    host objects travel on the CPU whatever the backend of the data
    collectives. Made once per group (see `new_gloo_group`)."""
    if group is None or group is dist.group.WORLD:
        group = dist.distributed_c10d._get_default_group()
    if dist.get_backend(group) == "gloo":
        return group
    key = id(group)
    if key not in _gloo_groups:
        _gloo_groups[key] = new_gloo_group(
            dist.get_process_group_ranks(group))
    return _gloo_groups[key]


# A BroadcastChannel message's fixed frame, in bytes (a longer pickle
# takes a second broadcast).
_FRAME_BYTES = 16384


class BroadcastChannel:
    """Picklable messages from a group's rank 0 to its other ranks over a
    gloo group: one broadcast of a fixed frame (an 8-byte length, then
    the pickle) per message, and a second for the rest of a pickle that
    outgrows it. A receive waits up to the group's timeout, then raises.
    Messages come only from this program's own rank 0."""

    def __init__(self, group):
        self.group = group
        self.src = dist.get_global_rank(group, 0)
        self._frame = torch.zeros(_FRAME_BYTES, dtype=torch.uint8)

    def send(self, obj) -> None:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        cap = self._frame.numel() - 8
        buf = self._frame.numpy()
        buf[:8] = np.frombuffer(len(data).to_bytes(8, "little"), np.uint8)
        head = np.frombuffer(data, np.uint8, count=min(len(data), cap))
        buf[8:8 + head.size] = head
        dist.broadcast(self._frame, self.src, group=self.group)
        if len(data) > cap:
            rest = torch.frombuffer(bytearray(data[cap:]), dtype=torch.uint8)
            dist.broadcast(rest, self.src, group=self.group)

    def recv(self):
        dist.broadcast(self._frame, self.src, group=self.group)
        buf = self._frame.numpy()
        n = int.from_bytes(buf[:8].tobytes(), "little")
        cap = self._frame.numel() - 8
        data = buf[8:8 + min(n, cap)].tobytes()
        if n > cap:
            rest = torch.empty(n - cap, dtype=torch.uint8)
            dist.broadcast(rest, self.src, group=self.group)
            data += rest.numpy().tobytes()
        return pickle.loads(data)


def sync_global_devices(name: str) -> None:
    """Barrier across all ranks (no-op in one process). `name` labels the
    barrier for a reader of a hang; ranks meet in call order."""
    del name
    if world_size() > 1:
        dist.barrier(group=gloo_group())


def broadcast_from_primary(tree):
    """Make rank 0's host values authoritative everywhere (an RNG seed
    read from a file, a resolved checkpoint step): any picklable object,
    over a gloo group."""
    if world_size() <= 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0, group=gloo_group())
    return box[0]


def process_env_summary() -> dict:
    """Debug snapshot for launch scripts / failure reports."""
    initialized = dist.is_initialized()
    addr = os.environ.get("MASTER_ADDR")
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": world_size(),
        "local_devices": (torch.cuda.device_count()
                          if torch.cuda.is_available() else 1),
        "global_devices": world_size(),
        "num_slices": num_slices(),
        "backend": dist.get_backend() if initialized else None,
        "coordinator": (None if addr is None else
                        f"{addr}:{os.environ.get('MASTER_PORT', '')}"),
    }


# -- a bounded launcher of ranks ---------------------------------------------

def _rank_main(fn, rank: int, world: int, backend: str, init_method: str,
               timeout_s: float, results, args) -> None:
    """A spawned rank: join the group, run `fn(rank, world, *args)`, put
    (rank, ok, value or traceback) on `results`, leave the group."""
    torch.set_num_threads(1)
    try:
        initialize(init_method, world, rank, backend=backend,
                   timeout_s=timeout_s)
        out = (rank, True, fn(rank, world, *args))
    except BaseException:  # noqa: BLE001 — reported to the parent
        out = (rank, False, traceback.format_exc())
    results.put(out)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, backend: str, *args,
                deadline_s: float = 300.0,
                timeout_s: float | None = None) -> list:
    """Run `fn(rank, world_size, *args)` in `world_size` new processes
    (the "spawn" start method: each imports `fn`'s module afresh, so it
    must live in a module that imports neither jax nor the reference)
    over a process group on a file store; returns fn's results by rank.

    The ranks are joined within `deadline_s` seconds: past it, or as
    soon as one rank fails, every rank still running is killed and this
    raises RuntimeError (with the failed rank's traceback). Collectives
    time out after `timeout_s` (the deadline by default). CUDA tensors
    among `args` reach the ranks as shared memory (torch.multiprocessing),
    the parent keeping them alive."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, world_size, backend, init,
                  deadline_s if timeout_s is None else timeout_s, results,
                  args),
            daemon=True) for r in range(world_size)]
        for p in procs:
            p.start()
        out: dict = {}
        failure = None
        deadline = time.monotonic() + deadline_s
        try:
            # drain the queue before joining (a writer blocks until its
            # item is read)
            while len(out) < world_size and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = (f"ranks {sorted(set(range(world_size)) - set(out))}"
                               f" did not finish within {deadline_s} s")
                    break
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except _queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and not p.is_alive()
                            and p.exitcode not in (0, None)]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    continue
                if ok:
                    out[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
            for r, p in enumerate(procs):
                if failure is not None:
                    break
                p.join(timeout=max(0.0, deadline - time.monotonic()) + 10)
                if p.exitcode != 0:
                    failure = f"rank {r} exited with code {p.exitcode}"
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            results.close()
    if failure is not None:
        raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}): "
                           f"{failure}")
    return [out[r] for r in range(world_size)]
