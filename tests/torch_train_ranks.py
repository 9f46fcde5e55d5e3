"""Rank functions of the parallel-training tests
(`tests/test_torch_parallel_train.py`), run by `parallel.spawn_ranks` in
processes of their own over gloo. This module imports torch and the port
only (each spawned rank imports it afresh). Results go back as numpy
arrays and plain Python values."""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import numpy as np
import torch

from cloud_server_tpu_torch.config import MeshConfig, ModelConfig, TrainConfig
from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
from cloud_server_tpu_torch.data.loader import DataLoader, batch_layout
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.parallel import make_mesh
from cloud_server_tpu_torch.parallel.ring_attention import (
    ring_attention_sharded)
from cloud_server_tpu_torch.parallel.ulysses import ulysses_attention_sharded
from cloud_server_tpu_torch.training import checkpoint as ckpt_mod
from cloud_server_tpu_torch.training import train_step as ts
from cloud_server_tpu_torch.training.optim import flatten, map_tree


def torch_tree(np_tree: dict) -> dict:
    return map_tree(lambda a: torch.from_numpy(np.array(a)), np_tree)


def np_flat(tree: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in flatten(tree)}


def block(x: np.ndarray, layout: dict) -> np.ndarray:
    """The rank's (rows, sequence) block of a (B, S, ...) global array."""
    i, n = layout["process_index"], layout["process_count"]
    j, m = layout["seq_shard"]
    b, s = x.shape[0] // n, x.shape[1] // m
    return x[i * b:(i + 1) * b, j * s:(j + 1) * s]


def full_tree(tree: dict, cfg: ModelConfig, mesh) -> dict:
    """A params-shaped tree of a mesh state (parameters or a moment),
    gathered, flat ('/'-joined); without a mesh as it is."""
    if mesh is None:
        return np_flat(tree)
    splits = dict(flatten(ts.state_shardings(cfg, mesh)))
    return {k: ckpt_mod._gather_leaf(v, splits[k], mesh).numpy().copy()
            for k, v in flatten(tree)}


def train(cfg: ModelConfig, tcfg: TrainConfig, np_params: dict,
          tokens: np.ndarray, steps: int, mesh=None, seg=None) -> dict:
    """`steps` train steps on the given weights and global batch (and
    packed segment ids; the rank's block of them on a mesh): per-step
    metrics and the final parameters (gathered)."""
    params = torch_tree(np_params)
    state = ts.train_state_from_params(params, tcfg, cfg, mesh=mesh)
    step = ts.make_train_step(cfg, tcfg, mesh=mesh)
    layout = batch_layout(mesh)
    batch = {"tokens": torch.from_numpy(block(tokens, layout))}
    if seg is not None:
        batch["segment_ids"] = torch.from_numpy(block(seg, layout))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    adam = state.opt_state
    return {"metrics": metrics, "params": full_tree(state.params, cfg, mesh),
            "mu": full_tree(adam.mu, cfg, mesh),
            "nu": full_tree(adam.nu, cfg, mesh), "count": adam.count}


def _mesh(**axes):
    return make_mesh(MeshConfig(**axes), "cpu")


def attention(rank: int, world: int, q, k, v, cot, seg, impl: str, axes):
    """The rank's output and q/k/v gradients of ring or Ulysses attention
    on its (rows, sequence, heads) block of the global arrays, against the
    cotangent `cot`."""
    mesh = _mesh(**axes)
    layout = batch_layout(mesh)
    tp = mesh.get_local_rank("tp") if axes.get("tp", 1) > 1 else 0
    ntp = axes.get("tp", 1)

    def heads(x):
        h = x.shape[2] // ntp
        return block(x, layout)[:, :, tp * h:(tp + 1) * h]

    qt, kt, vt = (torch.from_numpy(heads(a).copy()).requires_grad_(True)
                  for a in (q, k, v))
    segt = None if seg is None else torch.from_numpy(block(seg, layout).copy())
    fn = ring_attention_sharded if impl == "ring" else (
        ulysses_attention_sharded)
    try:
        out = fn(qt, kt, vt, mesh, segment_ids=segt)
    except ValueError as e:
        return {"error": str(e)}
    (out * torch.from_numpy(heads(cot).copy())).sum().backward()
    return {"out": out.detach().numpy(), "dq": qt.grad.numpy(),
            "dk": kt.grad.numpy(), "dv": vt.grad.numpy(), "layout": layout,
            "tp": tp}


def world4(rank: int, world: int, payload: dict) -> dict:
    """Every case of the four-rank world, one mesh after another."""
    out = {}
    cfg, tcfg = payload["cfg"], payload["tcfg"]
    params, tokens = payload["params"], payload["tokens"]
    # the reference's sharded step at fsdp 2 x tp 2, two steps; the
    # rank's shards as placed by the rules
    mesh = _mesh(fsdp=2, tp=2)
    state = ts.train_state_from_params(torch_tree(params), tcfg, cfg,
                                       mesh=mesh)
    out["shards"] = {k: (tuple(v.shape), v.detach().numpy().copy())
                     for k, v in flatten(state.params)}
    out["coords"] = {a: mesh.get_local_rank(a) for a in ("fsdp", "tp")}
    out["fsdp2_tp2"] = train(cfg, tcfg, params, tokens, 2, mesh)
    out["fsdp2_tp2_fused"] = train(dataclasses.replace(cfg,
                                                       **payload["fused"]),
                                   tcfg, params, tokens, 2, mesh)
    # grad accumulation keeps each microbatch sharded like the batch
    out["accum"] = train(cfg, dataclasses.replace(tcfg, microbatch_steps=2),
                         params, tokens, 1, mesh)
    for name, axes, over, packed in payload["own_cases"]:
        out[name] = train(dataclasses.replace(cfg, **over), tcfg, params,
                          tokens, 2, _mesh(**axes),
                          seg=payload["seg"] if packed else None)
    for name, args in payload["attention"].items():
        out[name] = attention(rank, world, *args)
    # the loader's rows: two global batches of a synthetic set
    ds = SyntheticLMDataset(16, 8, 64, seed=3)
    loader = DataLoader.for_mesh(ds, 4, "cpu", _mesh(fsdp=2, sp=2),
                                 seed=5, prefetch=0)
    it = iter(loader)
    out["loader"] = {"layout": loader.seq_shard,
                     "index": loader.sampler.process_index,
                     "count": loader.sampler.process_count,
                     "batches": [next(it)["tokens"].numpy()
                                 for _ in range(2)]}
    # eval on the mesh: the global batch's sums
    from cloud_server_tpu_torch.training.eval import make_eval_step
    mesh = _mesh(fsdp=2, tp=2)
    shards = ts.shard_tree(torch_tree(params), ts.state_shardings(cfg, mesh),
                           mesh)
    ev = make_eval_step(cfg, mesh=mesh)(shards, {"tokens": torch.from_numpy(
        block(tokens, batch_layout(mesh)))})
    out["eval"] = {k: float(v) for k, v in ev.items()}
    out["refusals"] = refusals(cfg, tcfg)
    return out


def refusals(cfg: ModelConfig, tcfg: TrainConfig) -> dict:
    """What a mesh does not train yet: the NotImplementedError messages."""
    from cloud_server_tpu_torch.models import lora, moe

    def err(fn):
        try:
            fn()
        except NotImplementedError as e:
            return str(e)
        return None

    mesh = _mesh(fsdp=2, tp=2)
    moe_cfg = dataclasses.replace(cfg, num_experts=4)
    lmod = lora.make_lora_module(lora.LoRAConfig(rank=2))
    sp_mesh = _mesh(fsdp=2, sp=2)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    return {
        "moe": err(lambda: ts.make_train_step(moe_cfg, tcfg, mesh=mesh)),
        "lora": err(lambda: ts.make_train_step(cfg, tcfg, mesh=mesh,
                                               loss_fn_module=lmod)),
        "sp_flash": err(lambda: ts.make_train_step(
            dataclasses.replace(cfg, attention_impl="flash"), tcfg,
            mesh=sp_mesh)(ts.train_state_from_params(
                torch_tree(_zeros(cfg)), tcfg, cfg, mesh=sp_mesh),
                {"tokens": tokens})),
    }


def _zeros(cfg: ModelConfig) -> dict:
    return map_tree(lambda shape: np.zeros(shape, np.float32),
                    transformer.param_shapes(cfg))


@contextlib.contextmanager
def watch_gathers():
    """While open, `checkpoint._gather_leaf` is watched: the list it
    yields gets, at each gather, (the bytes of the full leaves gathered
    before it that are still alive, the bytes of the leaf it gathers).
    A collective's work may hold its output a moment after it returned,
    so a leaf that was dropped can still count once."""
    live, held = [], []
    gather = ckpt_mod._gather_leaf

    def watched(t, splits, mesh):
        alive = sum(x.nbytes for x in (r() for r in live) if x is not None)
        out = gather(t, splits, mesh)
        held.append((alive, out.nbytes))
        live.append(weakref.ref(out))
        return out

    ckpt_mod._gather_leaf = watched
    try:
        yield held
    finally:
        ckpt_mod._gather_leaf = gather


@contextlib.contextmanager
def watch_loads():
    """While open, `checkpoint._load` is watched: the list it yields
    gets (file name, mapped) of each checkpoint file read."""
    loads = []
    load = ckpt_mod._load

    def watched(path, device, mmap=False):
        loads.append((path.rsplit("/", 1)[-1], mmap))
        return load(path, device, mmap)

    ckpt_mod._load = watched
    try:
        yield loads
    finally:
        ckpt_mod._load = load


def world2(rank: int, world: int, payload: dict, ckpt_dir: str) -> dict:
    """dp 2 against the single-device step; then fsdp 2 trains two steps
    and saves (rank 0 writes the gathered leaves) for the elastic
    restore."""
    cfg, tcfg = payload["cfg"], payload["tcfg"]
    out = {"dp2": train(cfg, tcfg, payload["params"], payload["tokens"], 2,
                        _mesh(dp=2))}
    mesh = _mesh(fsdp=2)
    state = ts.train_state_from_params(torch_tree(payload["params"]), tcfg,
                                       cfg, mesh=mesh)
    step = ts.make_train_step(cfg, tcfg, mesh=mesh)
    batch = {"tokens": torch.from_numpy(block(payload["tokens"],
                                              batch_layout(mesh)))}
    for _ in range(2):
        state, _ = step(state, batch)
    with ckpt_mod.Checkpointer(ckpt_dir, async_save=True, mesh=mesh,
                               model_cfg=cfg) as ck, watch_gathers() as held:
        out["saved"] = ck.save(state, force=True)
    out["held_at_gather"] = held
    out["n_leaves"] = sum(len(flatten(t)) for t in (
        state.params, state.opt_state.mu, state.opt_state.nu))
    return out


def world8(rank: int, world: int, cfg: ModelConfig, tcfg: TrainConfig,
           ckpt_dir: str) -> dict:
    """The fsdp 2 checkpoint restored onto fsdp 4 x tp 2: the rank's
    slices of every item, and its parameters through restore_params."""
    mesh = _mesh(fsdp=4, tp=2)
    ck = ckpt_mod.Checkpointer(ckpt_dir, mesh=mesh, model_cfg=cfg)
    target = ckpt_mod.abstract_train_state(cfg, tcfg)
    with watch_loads() as loads:
        state = ck.restore(target, device="cpu")
        params = ckpt_mod.restore_params(ckpt_dir, cfg, device="cpu",
                                         mesh=mesh)
    adam, _ = ckpt_mod._split_opt(state.opt_state)
    return {"step": state.step, "count": adam.count, "loads": loads,
            "params": np_flat(state.params), "mu": np_flat(adam.mu),
            "nu": np_flat(adam.nu), "restore_params": np_flat(params),
            "coords": {a: mesh.get_local_rank(a) for a in ("fsdp", "tp")}}
