"""Host data pipeline: deterministic sharded sampling, collation, and
prefetch onto the device.

Every process runs an identical `ShardedSampler` (same seed => same
per-epoch permutation) and takes its own contiguous slice of each global
batch, as the reference does; the process index and count are arguments
(default 0 and 1: one process). On a mesh (`DataLoader.for_mesh`) they
come from the rank's place in the reference's batch sharding: the rows
split over (dp, fsdp), dp outer, and the sequence over sp (`seq_shard`),
so ranks that differ only in sp or tp read the same rows. Batches are
collated on the host, pinned and copied to the device without blocking,
in a prefetch thread.

Resume: the sampler's state is (epoch, batch_in_epoch) and
`load_state_dict` fast-forwards without touching the data.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Any, Iterator

import numpy as np
import torch

from cloud_server_tpu_torch import resolve_device


class ShardedSampler:
    """Deterministic, resumable index sampler sharded across processes.

    Each epoch draws a fresh permutation from (seed, epoch); each global
    step takes `global_batch_size` indices and this process keeps its
    `local_batch_size` slice. Incomplete trailing batches are dropped so
    shapes stay static.
    """

    def __init__(self, num_examples: int, global_batch_size: int, *,
                 seed: int = 0, shuffle: bool = True,
                 process_index: int = 0, process_count: int = 1):
        self.num_examples = num_examples
        self.global_batch_size = global_batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.process_index = process_index
        self.process_count = process_count
        if global_batch_size % self.process_count:
            raise ValueError(
                f"global_batch_size {global_batch_size} not divisible by "
                f"process_count {self.process_count}")
        self.local_batch_size = global_batch_size // self.process_count
        self.batches_per_epoch = num_examples // global_batch_size
        if self.batches_per_epoch == 0:
            raise ValueError(
                f"dataset of {num_examples} examples can't fill one global "
                f"batch of {global_batch_size}")
        self.epoch = 0
        self.batch_in_epoch = 0

    def _perm(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.num_examples)
        return np.random.default_rng(
            (self.seed, epoch)).permutation(self.num_examples)

    def __iter__(self) -> Iterator[np.ndarray]:
        """Yield this process's index slice for each global batch, forever
        (epochs advance automatically)."""
        while True:
            perm = self._perm(self.epoch)
            while self.batch_in_epoch < self.batches_per_epoch:
                g0 = self.batch_in_epoch * self.global_batch_size
                lo = g0 + self.process_index * self.local_batch_size
                local = perm[lo:lo + self.local_batch_size]
                self.batch_in_epoch += 1
                yield local
            self.epoch += 1
            self.batch_in_epoch = 0

    def state_dict(self) -> dict[str, int]:
        return {"epoch": self.epoch, "batch_in_epoch": self.batch_in_epoch}

    def load_state_dict(self, state: dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.batch_in_epoch = int(state["batch_in_epoch"])


def _collate(dataset, indices: np.ndarray) -> dict[str, np.ndarray]:
    if hasattr(dataset, "read_batch"):  # native gathered read (runtime/)
        return dataset.read_batch(indices)
    examples = [dataset[int(i)] for i in indices]
    return {k: np.stack([e[k] for e in examples]) for k in examples[0]}


def batch_layout(mesh) -> dict:
    """This rank's place in the reference's `batch_sharding` (batch over
    (dp, fsdp), sequence over sp): {"process_index", "process_count",
    "seq_shard": (index, count)}; one process without a mesh."""
    if mesh is None:
        return {"process_index": 0, "process_count": 1, "seq_shard": (0, 1)}
    from cloud_server_tpu_torch.parallel.mesh import axis_size

    def coord(axis):
        return mesh.get_local_rank(axis) if axis_size(mesh, axis) > 1 else 0
    fsdp = axis_size(mesh, "fsdp")
    return {"process_index": coord("dp") * fsdp + coord("fsdp"),
            "process_count": axis_size(mesh, "dp") * fsdp,
            "seq_shard": (coord("sp"), axis_size(mesh, "sp"))}


def to_device(local: dict[str, np.ndarray],
              device: torch.device) -> dict[str, torch.Tensor]:
    """Host arrays -> int64 tensors on `device`: pinned and copied without
    blocking when the device is a GPU."""
    out = {}
    for k, v in local.items():
        t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.int64))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def prefetch(it: Iterator[Any], size: int = 2) -> Iterator[Any]:
    """Overlap host-side batch production with device compute: a daemon
    thread runs the upstream iterator (reads, collation, the copy to the
    device); the consumer pops ready batches from a bounded queue.
    Closing the returned generator stops the thread and waits for it: a
    producer left running when the interpreter exits can be caught
    inside a torch call, which aborts the process."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    stop = threading.Event()
    _END = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue_mod.Full:
                pass
        return False

    def producer():
        try:
            for item in it:
                if not put(item):
                    return
        finally:
            put(_END)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            yield item
    finally:
        stop.set()
        t.join()


class DataLoader:
    """dataset + sampler + collate + copy to the device + prefetch.

    Yields {"tokens": (local_B, S) int64 tensor on `device`} forever
    (epochs advance inside the sampler); `state_dict`/`load_state_dict`
    give exact data-stream resume.
    """

    def __init__(self, dataset, global_batch_size: int, device=None, *,
                 seed: int = 0, shuffle: bool = True, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 seq_shard: tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.seq_shard = seq_shard
        self.sampler = ShardedSampler(
            len(dataset), global_batch_size, seed=seed, shuffle=shuffle,
            process_index=process_index, process_count=process_count)

    @classmethod
    def for_mesh(cls, dataset, global_batch_size: int, device, mesh,
                 **kwargs) -> "DataLoader":
        """A loader yielding this rank's block of each global batch on
        `mesh` (`batch_layout`); the plain loader without one."""
        return cls(dataset, global_batch_size, device, **kwargs,
                   **batch_layout(mesh))

    def _slice(self, local: dict[str, np.ndarray]) -> dict:
        i, n = self.seq_shard
        if n == 1:
            return local
        out = {}
        for k, v in local.items():
            s = v.shape[1]
            if s % n:
                raise ValueError(f"sequence length {s} does not split over "
                                 f"sp={n}")
            out[k] = v[:, i * (s // n):(i + 1) * (s // n)]
        return out

    def _produce(self) -> Iterator[dict[str, torch.Tensor]]:
        for indices in self.sampler:
            yield to_device(self._slice(_collate(self.dataset, indices)),
                            self.device)

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        if self.prefetch > 0:
            return prefetch(self._produce(), self.prefetch)
        return self._produce()

    def state_dict(self) -> dict[str, int]:
        return self.sampler.state_dict()

    def load_state_dict(self, state: dict[str, int]) -> None:
        self.sampler.load_state_dict(state)
