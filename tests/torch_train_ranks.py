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
    """What a mesh refuses: the NotImplementedError messages (None where
    the train step builds)."""
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


# -- pipeline, expert and adapter parallelism ----------------------------------

def _module(name: str, lora_cfg=None):
    from cloud_server_tpu_torch.models import lora, moe
    base = moe if name == "moe" else transformer
    if lora_cfg is None:
        return base
    return lora.make_lora_module(lora_cfg, base_module=base)


def deep_tree(np_tree: dict) -> dict:
    """A nested dict of numpy arrays (any depth) as torch tensors."""
    return {k: deep_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in np_tree.items()}


def full_grads(grads: dict, splits: dict, mesh) -> dict:
    """Every rank's gradient shards summed over the data axes (the train
    step's sums) and gathered into whole leaves, flat."""
    sync = ts._GradSync(mesh, splits)
    sync.grads_(grads)
    flat = dict(flatten(splits))
    return {k: ckpt_mod._gather_leaf(g, flat[k], mesh).numpy().copy()
            for k, g in flatten(grads)}


def pipe_case(cfg: ModelConfig, np_params: dict, tokens: np.ndarray,
              axes: dict, m: int, what=("forward",), module: str =
              "transformer", seg=None, loss_kw=None) -> dict:
    """The pipelined forward (the rank's logits and the router
    statistics) and/or loss and whole gradients over `axes`, on the
    reference's weights and global batch (and packed segment ids)."""
    from cloud_server_tpu_torch.parallel.pipeline import (
        make_pipelined_forward, make_pipelined_loss, pipeline_rules)
    mesh = _mesh(**axes)
    mod = _module(module)
    rules = pipeline_rules()
    splits = ts.state_shardings(cfg, mesh, rules, mod)
    params = ts.shard_tree(deep_tree(np_params), splits, mesh)
    layout = batch_layout(mesh)
    batch = {"tokens": torch.from_numpy(block(tokens, layout))}
    if seg is not None:
        batch["segment_ids"] = torch.from_numpy(block(seg, layout))
    out = {"layout": layout}
    if "forward" in what:
        with torch.no_grad():
            res = make_pipelined_forward(cfg, mesh, m, loss_fn_module=mod)(
                params, batch["tokens"], batch.get("segment_ids"))
        logits, aux = res if module == "moe" else (res, {})
        out["logits"] = logits.numpy()
        out["aux"] = {k: float(v) for k, v in aux.items()}
    if "grads" in what:
        params = map_tree(lambda p: p.requires_grad_(True), params)
        loss_fn = make_pipelined_loss(cfg, mesh, m, loss_fn_module=mod,
                                      **(loss_kw or {}))
        loss, metrics = loss_fn(params, batch, cfg)
        loss.backward()
        plan = transformer.MeshPlan(mesh, cfg, rules)
        out["loss"] = float(plan.psum_data(loss))
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        grads = map_tree(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        out["grads"] = full_grads(grads, splits, mesh)
    return out


def train_case(cfg: ModelConfig, tcfg: TrainConfig, np_params: dict,
               tokens: np.ndarray, axes: dict, steps: int, *,
               module: str = "transformer", lora_cfg=None,
               pipeline_m: int = 0, hybrid=None) -> dict:
    """`steps` train steps over `axes` (a pipelined loss of `pipeline_m`
    microbatches when > 0; a hybrid mesh when `hybrid` is (ici axes, dcn
    axes)) on the given weights (a LoRA module's {"base", "lora"} tree
    with `lora_cfg`): per-step metrics, the final parameters and both
    moments (whole leaves, flat), and the rank's shard shapes."""
    from cloud_server_tpu_torch.parallel import make_hybrid_mesh
    from cloud_server_tpu_torch.parallel.pipeline import (
        make_pipelined_loss, pipeline_rules)
    if hybrid is not None:
        mesh = make_hybrid_mesh(MeshConfig(**hybrid[0]),
                                MeshConfig(**hybrid[1]), "cpu")
    else:
        mesh = _mesh(**axes)
    mod = _module(module, lora_cfg)
    rules = loss_fn = None
    if pipeline_m:
        rules = pipeline_rules()
        loss_fn = make_pipelined_loss(cfg, mesh, pipeline_m,
                                      loss_fn_module=mod,
                                      aux_loss_coef=tcfg.moe_aux_loss_coef,
                                      router_z_coef=tcfg.moe_router_z_coef)
    state = ts.train_state_from_params(deep_tree(np_params), tcfg, cfg, mod,
                                       mesh=mesh, rules=rules)
    shapes = {k: tuple(v.shape) for k, v in flatten(state.params)}
    step = ts.make_train_step(cfg, tcfg, mesh=mesh, rules=rules,
                              loss_fn=loss_fn, loss_fn_module=mod)
    batch = {"tokens": torch.from_numpy(block(tokens, batch_layout(mesh)))}
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    splits = dict(flatten(ts.state_shardings(cfg, mesh, rules, mod)))

    def whole(tree):
        return {k: ckpt_mod._gather_leaf(v, splits[k], mesh).numpy().copy()
                for k, v in flatten(tree)}
    adam = state.opt_state
    return {"metrics": metrics, "params": whole(state.params),
            "mu": whole(adam.mu), "nu": whole(adam.nu), "count": adam.count,
            "shapes": shapes, "coords": {a: mesh.get_local_rank(a)
                                         for a in mesh.mesh_dim_names}}


def run_cases(rank: int, world: int, cases: list) -> dict:
    """Each (name, function name, kwargs) of `cases` in turn: the
    function of this module called with the kwargs."""
    import sys
    mod = sys.modules[__name__]
    return {name: getattr(mod, fn)(**kw) for name, fn, kw in cases}


def watchdog_case(timeout_s: float, per_axis_s: float, axes: dict,
                  beat: bool) -> dict:
    """A CollectiveWatchdog on a mesh of `axes`: its timeout and comm
    axes, whether it fired (after one beat, or none) and its report."""
    import io
    import time
    from contextlib import redirect_stderr
    from cloud_server_tpu_torch.utils.failure import CollectiveWatchdog
    mesh = _mesh(**axes)
    fired = []
    err = io.StringIO()
    dog = CollectiveWatchdog(mesh, timeout_s=timeout_s,
                             per_axis_s=per_axis_s, on_hang=fired.append,
                             poll_s=0.02)
    with redirect_stderr(err), dog:
        if beat:
            dog.beat()
            deadline = time.monotonic() + 5.0
            while not dog.fired and time.monotonic() < deadline:
                time.sleep(0.02)
        else:
            time.sleep(0.4)  # a long first step before any beat
    return {"timeout_s": dog.timeout_s, "comm_axes": dog.comm_axes,
            "fired": dog.fired, "calls": len(fired),
            "report": err.getvalue()}


def pipe_refusals(cfg: ModelConfig) -> dict:
    """The pipeline's ValueErrors on a pp 4 mesh: 3 layers over pp 4, and
    packed rows with ring or Ulysses attention."""
    from cloud_server_tpu_torch.parallel.pipeline import (
        make_pipelined_loss, pipeline_rules)
    mesh = _mesh(pp=4)
    out = {}
    try:
        make_pipelined_loss(dataclasses.replace(cfg, num_layers=3), mesh, 2)
    except ValueError as e:
        out["layers"] = str(e)
    params = ts.shard_tree(
        map_tree(torch.zeros, transformer.param_shapes(cfg)),
        ts.state_shardings(cfg, mesh, pipeline_rules()), mesh)
    tokens = torch.zeros((4, 8), dtype=torch.long)
    for impl in ("ring", "ulysses"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        try:
            make_pipelined_loss(c, mesh, 2)(
                params, {"tokens": tokens, "segment_ids": tokens + 1}, c)
        except ValueError as e:
            out[impl] = str(e)
    return out


# AdamW's step of an element is lr * m / (sqrt(v) + eps): where the
# gradient is small the step turns on its last bits, which a sum over
# ranks reorders, so parameters are compared where sqrt(v_hat) >=
# ADAM_DETERMINED or the gradient is exactly 0 (tests/
# test_torch_parallel_train.py's rule).
ADAM_DETERMINED = 1e-5
ADAM_DETERMINED_SHARE = 0.95


def assert_run_close(got: dict, want: dict, what: str,
                     tcfg: TrainConfig) -> None:
    """Each step's loss, accuracy and grad norm within rtol 1e-5 / atol
    1e-7, both AdamW moments of every leaf within 1e-4 of the leaf's
    largest entry, and every parameter within 1e-6 of the leaf's largest
    entry where AdamW's step is set by the gradient (the rest within
    twice the learning rate a step): the tolerances of the parallel
    training tests."""
    assert len(got["metrics"]) == len(want["metrics"])
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what} step {i} {key}")
    assert got["count"] == want["count"]
    for item in ("params", "mu", "nu"):
        assert sorted(got[item]) == sorted(want[item]), item
    steps = want["count"]
    for path, w in want["params"].items():
        if path not in want["mu"]:  # a frozen leaf: bit for bit
            np.testing.assert_array_equal(got["params"][path], w,
                                          err_msg=f"{what} {path}")
            continue
        for m in ("mu", "nu"):
            wm = want[m][path]
            np.testing.assert_allclose(
                got[m][path], wm, rtol=0,
                atol=1e-4 * max(float(np.abs(wm).max()), 1e-30),
                err_msg=f"{what} {m} {path}")
        v_hat = want["nu"][path] / (1.0 - tcfg.beta2 ** steps)
        set_by_grad = (np.sqrt(v_hat) >= ADAM_DETERMINED) | (v_hat == 0)
        assert set_by_grad.mean() >= ADAM_DETERMINED_SHARE, f"{what} {path}"
        g = got["params"][path]
        np.testing.assert_allclose(
            g[set_by_grad], w[set_by_grad], rtol=0,
            atol=1e-6 * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{what} {path}")
        assert np.all(np.abs(g - w)[~set_by_grad]
                      <= 2 * tcfg.learning_rate * steps), f"{what} {path}"


def lora_ckpt_case(cfg: ModelConfig, tcfg: TrainConfig, lora_cfg,
                   axes: dict, ckpt_dir: str) -> dict:
    """A LoRA TrainState on a mesh saved (rank 0 writes the gathered
    leaves) and restored onto the same mesh: whether every rank's
    restored shards equal its saved ones bit for bit."""
    from cloud_server_tpu_torch.models import lora
    mesh = _mesh(**axes)
    module = lora.make_lora_module(lora_cfg)
    state = ts.init_train_state(cfg, tcfg, 0, "cpu", module, mesh=mesh)
    with ckpt_mod.Checkpointer(ckpt_dir, async_save=False, mesh=mesh,
                               model_cfg=cfg, loss_fn_module=module) as ck:
        saved = ck.save(state, force=True)
    torch.distributed.barrier()  # rank 0 has written
    ck = ckpt_mod.Checkpointer(ckpt_dir, mesh=mesh, model_cfg=cfg,
                               loss_fn_module=module)
    restored = ck.restore(ckpt_mod.abstract_train_state(cfg, tcfg, module),
                          device="cpu")
    want, got = dict(flatten(state.params)), dict(flatten(restored.params))
    return {"saved": saved, "keys_equal": sorted(want) == sorted(got),
            "equal": all(torch.equal(want[k], got[k]) for k in want),
            "lora_leaves": sum(k.startswith("lora/") for k in want)}


def moe_ckpt_case(cfg: ModelConfig, tcfg: TrainConfig, tokens: np.ndarray,
                  ckpt_dir: str) -> dict:
    """An MoE state at fsdp 2 x ep 2, one step trained, saved (rank 0
    writes the gathered leaves), then restored onto ep 4: the rank's
    restored parameters and moments, and its ep coordinate."""
    from cloud_server_tpu_torch.models import moe
    mesh = _mesh(fsdp=2, ep=2)
    state = ts.init_train_state(cfg, tcfg, 0, "cpu", moe, mesh=mesh)
    step = ts.make_train_step(cfg, tcfg, mesh=mesh, loss_fn_module=moe)
    state, _ = step(state, {"tokens": torch.from_numpy(
        block(tokens, batch_layout(mesh)))})
    with ckpt_mod.Checkpointer(ckpt_dir, async_save=False, mesh=mesh,
                               model_cfg=cfg, loss_fn_module=moe) as ck:
        saved = ck.save(state, force=True)
    torch.distributed.barrier()  # rank 0 has written
    ep4 = _mesh(ep=4)
    ck = ckpt_mod.Checkpointer(ckpt_dir, mesh=ep4, model_cfg=cfg,
                               loss_fn_module=moe)
    got = ck.restore(ckpt_mod.abstract_train_state(cfg, tcfg, moe),
                     device="cpu")
    adam, _ = ckpt_mod._split_opt(got.opt_state)
    return {"saved": saved, "ep": ep4.get_local_rank("ep"),
            "params": np_flat(got.params), "mu": np_flat(adam.mu),
            "nu": np_flat(adam.nu), "step": got.step}


def card_mailbox_case(rank: int, world: int, buffers: list) -> dict:
    """Each collective of `collectives._CardMailbox` over `buffers` (one
    shared-memory mailbox a rank, small, so a collective runs in several
    pieces) against gloo's on the same inputs: per case whether the
    results are bit-equal. The sums are held against the ranks' inputs
    summed in rank order, the mailbox's order (gloo's ring sums three
    ranks in another)."""
    import torch.distributed as dist
    from cloud_server_tpu_torch.parallel import collectives as c
    group = dist.group.WORLD
    box = c._CardMailbox(group, buffers, "cpu")
    gen = torch.Generator().manual_seed(100 + rank)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((2 * world, 3 * world, 37), generator=gen).to(dtype)
        cases = {
            "psum": (c.psum, {}),
            "gather0": (c.all_gather, {"tiled_axis": 0}),
            "gather1": (c.all_gather, {"tiled_axis": 1}),
            "scatter0": (c.reduce_scatter, {"scatter_axis": 0}),
            "scatter1": (c.reduce_scatter, {"scatter_axis": 1}),
            "a2a_0_1": (c.all_to_all, {"split_axis": 0, "concat_axis": 1}),
            "a2a_1_1": (c.all_to_all, {"split_axis": 1, "concat_axis": 1}),
            "shift+1": (c.ppermute_shift, {"shift": 1}),
            "shift-1": (c.ppermute_shift, {"shift": -1}),
        }
        xs = c.all_gather(x, group).chunk(world)
        total = xs[0].clone()
        for other in xs[1:]:
            total += other
        sums = {"psum": total,
                "scatter0": total.chunk(world, 0)[rank],
                "scatter1": total.chunk(world, 1)[rank]}
        for name, (op, kw) in cases.items():
            want = sums.get(name)
            if want is None:
                want = op(x.clone(), group, **kw)
            got = box.run(op, x, **kw)
            out[f"{name} {dtype}"] = bool(got.shape == want.shape
                                          and torch.equal(got, want))
        y = x.clone()
        box.allreduce_(y.view(-1))
        out[f"allreduce_ {dtype}"] = torch.equal(y, total)
    return out
