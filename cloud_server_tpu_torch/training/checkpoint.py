"""Checkpoint / resume, on one device or a mesh, in torch's own file
format.

A checkpoint directory holds one subdirectory per saved step, named by
the step. Each holds one file per item, so a reader loads only what it
needs:

    <dir>/<step>/params.pt   the parameters ('/'-joined leaf paths)
    <dir>/<step>/opt.pt      AdamW's moments (mu/..., nu/...) of the
                             trained leaves (a LoRA run's: the adapters)
    <dir>/<step>/ema.pt      the EMA tree, when TrainConfig.ema_decay > 0
    <dir>/<step>/meta.json   step, AdamW's update count, the item names,
                             the metrics passed to `save`, and write_s:
                             the seconds the item files took to write
                             and sync

A step is written under a temporary name and renamed when every file is
complete and synced, so a save that was cut off is never listed as a
step. Files are `torch.save` dicts of host tensors, read back with
`torch.load(weights_only=True)`: tensors round-trip bit for bit.

Async save: `save` snapshots the state to host memory (the copy waits
for the device, since the next step updates the parameters in place)
and a writer thread writes the files while training goes on; the next
`save`, `wait` or `close` waits for it. Errors of the writer are raised
there.

On a mesh (`Checkpointer(mesh=)`) the files are the same: every rank
takes part in gathering each leaf from its shards, one leaf at a time,
and rank 0 alone copies the gathered (full) leaf to host memory and
writes the leaves; a rank's device holds its shards plus one full leaf
at most. A restore maps the files (`torch.load(mmap=True)`) and copies
out this rank's slices, so a rank reads only its part of them, and a
checkpoint saved on one mesh (or on one device) restores onto any other
bit for bit (elastic resume). One writer keeps the format, the atomic
rename and the async writer of the single-device case, and lets serving
and `restore_params` read any run's checkpoint; the price is each leaf
gathered once per save.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import torch

from cloud_server_tpu_torch import resolve_device
from cloud_server_tpu_torch.config import ModelConfig, TrainConfig
from cloud_server_tpu_torch.models import moe, transformer
from cloud_server_tpu_torch.training.optim import (
    EmaState, FusedAdamWState, ema_params, flatten, map_tree,
    optimizer_for_module)
from cloud_server_tpu_torch.parallel import collectives
from cloud_server_tpu_torch.parallel.distributed import is_primary
from cloud_server_tpu_torch.parallel.sharding import shard_tensor
from cloud_server_tpu_torch.training.train_step import (TrainState,
                                                        init_train_state,
                                                        state_shardings)

_MISMATCH = (
    "restore of step {step} failed with a structure mismatch. If "
    "TrainConfig.ema_decay was toggled since this checkpoint was written, "
    "the optimizer-state tree no longer matches — resume with the original "
    "ema_decay setting (or restore params-only via restore_params and "
    "re-init the optimizer).")


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


def _split_opt(opt_state) -> tuple[FusedAdamWState, dict | None]:
    """(the AdamW state, the EMA tree or None) of an optimizer state."""
    if isinstance(opt_state, FusedAdamWState):
        return opt_state, None
    adam = next(p for p in opt_state if isinstance(p, FusedAdamWState))
    return adam, ema_params(opt_state)


def _items(state: TrainState) -> tuple[dict, dict]:
    """The state as {item: {path: tensor}} and its meta record."""
    adam, ema = _split_opt(state.opt_state)
    items = {"params": dict(flatten(state.params)),
             "opt": {**{f"mu/{k}": t for k, t in flatten(adam.mu)},
                     **{f"nu/{k}": t for k, t in flatten(adam.nu)}}}
    if ema is not None:
        items["ema"] = dict(flatten(ema))
    meta = {"step": int(state.step), "count": int(adam.count),
            "items": sorted(items)}
    return items, meta


def _item_splits(items: dict, model_cfg, mesh, loss_fn_module,
                 rules=None) -> dict:
    """{item: {path: splits}} of a state's items on `mesh` under `rules`
    (layers over pp in a pipeline, experts over ep, adapters like their
    layers): the moments and the EMA shard like their parameters."""
    by_path = dict(flatten(state_shardings(model_cfg, mesh, rules,
                                           loss_fn_module)))
    out = {}
    for name, leaves in items.items():
        out[name] = {}
        for k in leaves:
            path = k.split("/", 1)[1] if name == "opt" else k
            out[name][k] = by_path[path]
    return out


def _gather_leaf(t: torch.Tensor, splits, mesh) -> torch.Tensor:
    """The full leaf from every rank's shard of it (a collective: every
    rank of the mesh calls it, in the same order)."""
    t = t.detach()
    for dim, axis in reversed(splits):
        t = collectives.all_gather_ad(t.contiguous(), mesh.get_group(axis),
                                      tiled_axis=dim)
    return t


def _gather_to_host(items: dict, splits: dict, mesh) -> dict | None:
    """Rank 0's host copies of the full leaves of a mesh state's items
    (None on the other ranks). One leaf at a time: each gathered leaf is
    dropped before the next is gathered, so no rank's device ever holds
    more than its shards and one full leaf."""
    primary = is_primary()
    host: dict = {}
    for name, leaves in items.items():
        host[name] = {}
        for k, t in leaves.items():
            full = _gather_leaf(t, splits[name][k], mesh)
            if primary:
                host[name][k] = full.to("cpu", copy=True)
            del full
    return host if primary else None


def _slice_to(t: torch.Tensor, splits, mesh, device) -> torch.Tensor:
    """This rank's slice of a leaf read through a file map, in memory
    of its own on `device` (never a view of the map)."""
    part = shard_tensor(t, splits, mesh)
    return part.to(device, copy=part is t)


def _snapshot(items: dict) -> dict:
    """Host copies of every tensor (never views of the live state, which
    the next optimizer step updates in place)."""
    return {name: {k: t.detach().to("cpu", copy=True) for k, t in d.items()}
            for name, d in items.items()}


def _write_file(path: str, obj) -> None:
    with open(path, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _load(path: str, device, mmap: bool = False) -> dict:
    """A checkpoint file's tensors; `mmap`: mapped, not read (host
    tensors whose pages are read when touched)."""
    return torch.load(path, map_location=device, weights_only=True,
                      mmap=mmap)


def abstract_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                         loss_fn_module=None) -> TrainState:
    """A TrainState of meta tensors with the names, shapes and dtypes a
    training run of these configs (and `loss_fn_module`, the family of
    model_cfg by default) holds: the target a restore checks a
    checkpoint against, without allocating anything."""
    module = loss_fn_module or moe.module_for(model_cfg)
    dtype = transformer.torch_dtype(model_cfg.param_dtype)
    params = map_tree(lambda shape: torch.empty(shape, dtype=dtype,
                                                device="meta"),
                      module.param_shapes(model_cfg))
    opt = optimizer_for_module(train_cfg, model_cfg, module)
    return TrainState(step=0, params=params, opt_state=opt.init(params))


class Checkpointer:
    """Step-indexed checkpoints of TrainStates: cadence
    (`save_interval_steps` — `save()` is a no-op off cadence unless
    forced, so the loop may call it every step), retention (the newest
    `max_to_keep` steps stay) and async save."""

    def __init__(self, directory: str | os.PathLike, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1, async_save: bool = True,
                 mesh=None, model_cfg: ModelConfig | None = None,
                 loss_fn_module=None, rules=None):
        """`mesh`: the DeviceMesh of the states saved and restored (every
        rank of it makes the Checkpointer; rank 0 writes), with the
        `model_cfg` (and `loss_fn_module`) whose logical axes place the
        leaves by `rules` (DEFAULT_RULES by default)."""
        self.directory = os.path.abspath(os.fspath(directory))
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, save_interval_steps)
        self.async_save = async_save
        self.mesh = mesh
        self.model_cfg = model_cfg
        self.loss_fn_module = loss_fn_module
        self.rules = rules
        if mesh is not None and model_cfg is None:
            raise ValueError("a Checkpointer on a mesh needs model_cfg")
        # the steps every rank agrees are saved (a mesh's ranks decide
        # alike whether to take part in a save)
        self._saved = set(self.all_steps())
        self._thread: threading.Thread | None = None
        self._inflight: int | None = None
        self._error: Exception | None = None

    # -- save ---------------------------------------------------------------

    def save(self, state: TrainState, *, metrics: dict | None = None,
             force: bool = False) -> bool:
        """Save `state` at its own step counter. Returns False when skipped
        (off cadence, or the step is already saved). When the optimizer
        keeps an EMA of the parameters, the EMA tree is its own item, so
        serving can read it alone."""
        step = int(state.step)
        if self.mesh is not None:
            if step in self._saved:
                return False
        elif step in self.all_steps() or step == self._inflight:
            return False  # even force=True must not collide with a save
        if not force and step % self.save_interval_steps:
            return False
        self.wait()
        items, meta = _items(state)
        meta["metrics"] = {k: float(v) for k, v in (metrics or {}).items()}
        if self.mesh is None:
            host = _snapshot(items)
        else:
            host = _gather_to_host(items, _item_splits(
                items, self.model_cfg, self.mesh, self.loss_fn_module,
                self.rules),
                self.mesh)
            self._saved.add(step)
            if host is None:
                return True
        if not self.async_save:
            self._write(step, host, meta)
            self._saved.add(step)
            return True
        self._inflight = step
        self._saved.add(step)
        self._thread = threading.Thread(
            target=self._write_async, args=(step, host, meta), daemon=True,
            name="checkpoint-writer")
        self._thread.start()
        return True

    def _write_async(self, step, host, meta) -> None:
        try:
            self._write(step, host, meta)
        except Exception as e:  # raised again by wait()
            self._error = e

    def _write(self, step: int, host: dict, meta: dict) -> None:
        os.makedirs(self.directory, exist_ok=True)
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        t0 = time.perf_counter()
        for name, tensors in host.items():
            _write_file(os.path.join(tmp, f"{name}.pt"), tensors)
        meta = {**meta, "write_s": time.perf_counter() - t0}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        fd = os.open(self.directory, os.O_RDONLY)  # make the rename durable
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def restore(self, target: TrainState, step: int | None = None, *,
                device=None) -> TrainState:
        """The saved state of `step` (default: the latest), checked against
        `target`'s tree (names, shapes, dtypes; meta tensors from
        `abstract_train_state` will do) and loaded onto `device` (default:
        target's device, or CUDA for a meta target). The parameters the
        optimizer keeps moments for come back as autograd leaves, ready
        to train; frozen ones (LoRA's base) do not. On a mesh `target`
        holds the full shapes (`abstract_train_state`) and each rank
        keeps its slices of the saved leaves."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found under {self.directory}")
        if device is None:
            dev = next(t for _, t in flatten(target.params)).device
            device = dev if dev.type != "meta" else None
        device = resolve_device(device)
        root = os.path.join(self.directory, str(step))
        with open(os.path.join(root, "meta.json")) as f:
            meta = json.load(f)
        want, _ = _items(target)
        if sorted(want) != meta["items"]:
            raise ValueError(_MISMATCH.format(step=step))
        on_mesh = self.mesh is not None
        got = {name: _load(os.path.join(root, f"{name}.pt"),
                           "cpu" if on_mesh else device, mmap=on_mesh)
               for name in meta["items"]}
        for name, leaves in want.items():
            if sorted(leaves) != sorted(got[name]) or any(
                    t.shape != got[name][k].shape
                    or t.dtype != got[name][k].dtype
                    for k, t in leaves.items()):
                raise ValueError(_MISMATCH.format(step=step))
        if self.mesh is not None:
            splits = _item_splits(got, self.model_cfg, self.mesh,
                                  self.loss_fn_module, self.rules)
            got = {name: {k: _slice_to(t, splits[name][k], self.mesh, device)
                          for k, t in leaves.items()}
                   for name, leaves in got.items()}
        trained = {k[len("mu/"):] for k in got["opt"] if k.startswith("mu/")}
        params = _unflatten({k: p.requires_grad_(k in trained)
                             for k, p in got["params"].items()})
        opt = _unflatten(got["opt"])
        adam = FusedAdamWState(count=meta["count"], mu=opt["mu"],
                               nu=opt["nu"])
        opt_state = adam if "ema" not in got else (
            adam, EmaState(_unflatten(got["ema"])))
        return TrainState(step=meta["step"], params=params,
                          opt_state=opt_state)

    # -- bookkeeping --------------------------------------------------------

    def all_steps(self) -> list[int]:
        return all_steps(self.directory)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until the in-flight async save is durable."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._inflight = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "Checkpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def all_steps(directory: str | os.PathLike) -> list[int]:
    """The completed steps under `directory`, in increasing order."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(n) for n in names if n.isdigit()
                  and os.path.isdir(os.path.join(directory, n)))


def _latest_step(directory: str) -> int:
    steps = all_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    return steps[-1]


def restore_params(checkpoint_dir: str | os.PathLike, model_cfg: ModelConfig,
                   *, step: int | None = None, device=None,
                   loss_fn_module=None, mesh=None, rules=None) -> dict:
    """The parameters of a saved TrainState (the latest step unless
    `step`), read from their own file: the optimizer's moments are never
    read. On `device` (CUDA unless named), at the saved dtype, checked
    against `loss_fn_module`'s shapes (the family of model_cfg by
    default; a LoRA module's {"base", "lora"} tree). On a `mesh`, this
    rank's slices (placed by `rules`)."""
    directory = os.path.abspath(os.fspath(checkpoint_dir))
    if step is None:
        step = _latest_step(directory)
    path = os.path.join(directory, str(step), "params.pt")
    if mesh is None:
        return _restore_tree(path, model_cfg, device, step, loss_fn_module)
    full = _restore_tree(path, model_cfg, "cpu", step, loss_fn_module,
                         mmap=True)
    splits = dict(flatten(state_shardings(model_cfg, mesh, rules,
                                          loss_fn_module)))
    dev = resolve_device(device)
    return _unflatten({k: _slice_to(t, splits[k], mesh, dev)
                       for k, t in flatten(full)})


def restore_ema_params(checkpoint_dir: str | os.PathLike,
                       model_cfg: ModelConfig, *, step: int | None = None,
                       device=None, loss_fn_module=None) -> dict:
    """The EMA parameter tree (float32) written when TrainConfig.ema_decay
    > 0: one params-sized read, drop-in wherever params go."""
    directory = os.path.abspath(os.fspath(checkpoint_dir))
    if step is None:
        step = _latest_step(directory)
    path = os.path.join(directory, str(step), "ema.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint step {step} has no 'ema' item — was the run "
            "trained with TrainConfig.ema_decay > 0 (and saved by this "
            "version)?")
    return _restore_tree(path, model_cfg, device, step, loss_fn_module)


def _restore_tree(path: str, model_cfg: ModelConfig, device, step,
                  loss_fn_module=None, mmap: bool = False) -> dict:
    flat = _load(path, resolve_device(device), mmap)
    module = loss_fn_module or moe.module_for(model_cfg)
    want = dict(flatten(module.param_shapes(model_cfg)))
    if sorted(want) != sorted(flat) or any(
            tuple(flat[k].shape) != tuple(s) for k, s in want.items()):
        raise ValueError(f"checkpoint step {step} does not hold the "
                         "parameters of this model config")
    return _unflatten(flat)


def restore_or_init(ckpt: Checkpointer, model_cfg: ModelConfig,
                    train_cfg: TrainConfig, seed: int = 0, device=None,
                    loss_fn_module=None) -> tuple[TrainState, bool]:
    """The resume entry point: the latest checkpoint of `ckpt` if there
    is one, else a fresh state from `seed`. Returns (state, resumed)."""
    if ckpt.latest_step() is not None:
        target = abstract_train_state(model_cfg, train_cfg, loss_fn_module)
        return ckpt.restore(target, device=device), True
    return init_train_state(model_cfg, train_cfg, seed, device,
                            loss_fn_module, mesh=ckpt.mesh,
                            rules=ckpt.rules), False
