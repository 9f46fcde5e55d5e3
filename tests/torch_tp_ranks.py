"""Rank functions of the port's tensor-parallel tests.

`parallel.spawn_ranks` starts each rank as a fresh process that imports
the rank function's module, so this module imports torch and the port
only: never jax, the reference package or a test module. The tests call
these functions through `spawn_ranks` and compare what rank 0 returns
with the reference's servers in their own process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cloud_server_tpu_torch.config import InferConfig, MeshConfig, ModelConfig
from cloud_server_tpu_torch.inference.paged_server import PagedInferenceServer
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import paged_attention as pa
from cloud_server_tpu_torch.parallel import collectives as coll
from cloud_server_tpu_torch.parallel import distributed as pdist
from cloud_server_tpu_torch.parallel.mesh import make_mesh


def serve(params, cfg, icfg, prompts, max_new, sampling=None, mesh=None,
          **kw):
    """The prompts through one paged server on the CPU (every rank of a
    mesh builds it; rank 0 serves, the others follow). `_icfg` in `kw`
    replaces `icfg`. Returns rank 0's tokens, or a follower's
    paged-attention counters."""
    icfg = kw.pop("_icfg", icfg)
    srv = PagedInferenceServer(params, cfg, icfg, mesh=mesh, device="cpu",
                               **kw)
    if mesh is not None and srv.tp_stats()["rank"] > 0:
        pa.reset_counters()
        srv.follow()
        return {"follower": pa.counters()}
    reqs = [srv.submit(p, max_new_tokens=max_new,
                       sampling=None if sampling is None else sampling[i])
            for i, p in enumerate(prompts)]
    srv.run_until_idle()
    stats = srv.tp_stats()
    srv.stop()
    return {"tokens": [r.tokens for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "preemptions": srv.preemptions, "tp": stats}


def _refusal(fn) -> str | None:
    """The NotImplementedError message `fn()` raises, else None."""
    try:
        fn()
    except NotImplementedError as exc:
        return str(exc)
    return None


def refusals(params, cfg, icfg, mesh, server_kw) -> dict:
    """What a tp server refuses: each constructor refusal on every rank
    (none reaches a collective), then, on a constructed server, each
    method refusal on rank 0."""
    from cloud_server_tpu_torch.inference.server import InferenceServer
    from cloud_server_tpu_torch.models import moe
    from cloud_server_tpu_torch.models.quantization import quantize_params

    def build(p=params, c=cfg, m=mesh, **kw):
        return lambda: PagedInferenceServer(p, c, icfg, mesh=m,
                                            device="cpu",
                                            **{**server_kw, **kw})

    mcfg = dataclasses.replace(cfg, num_experts=4)
    out = {
        "draft_model": _refusal(build(draft_params=params, draft_cfg=cfg,
                                      spec_drafts=2)),
        "moe": _refusal(build(
            p=moe.init_params(mcfg, 0, device="cpu"), c=mcfg)),
        "int8_weights": _refusal(build(p=quantize_params(params))),
        "contiguous": _refusal(lambda: InferenceServer(
            params, cfg, icfg, max_slots=2, max_len=32, device="cpu",
            mesh=mesh)),
    }
    fsdp = make_mesh(MeshConfig(fsdp=mesh.size()), device_type="cpu")
    out["mesh_axis_fsdp"] = _refusal(build(m=fsdp))
    srv = build()()
    if srv.tp_stats()["rank"] > 0:
        srv.follow()
        return out
    out.update({
        "embed": _refusal(lambda: srv.embed([[1, 2, 3]])),
        "add_adapter": _refusal(lambda: srv.add_adapter("a", {}, None)),
        "migrate_export": _refusal(lambda: srv.migrate_export(None)),
        "migrate_salvage": _refusal(lambda: srv.migrate_salvage(None)),
        "migrate_import": _refusal(lambda: srv.migrate_import(None)),
        "drain_migrate": _refusal(lambda: srv.drain(
            migrate=lambda snap, req: False)),
        "handoff": _refusal(lambda: srv.submit(
            [1, 2], max_new_tokens=2, handoff=lambda req: None)),
    })
    srv.stop()
    return out


def serve_cases(rank: int, world: int, tree: dict, cfg: ModelConfig,
                icfg: InferConfig, prompts, server_kw: dict,
                cases: list) -> dict:
    """Every case through a tp-`world` server over gloo on the CPU.
    `tree` is the reference's parameters as numpy arrays; each case is
    (name, config overrides, server kwargs, per-request SamplingParams or
    None, max_new_tokens), or (name, "refusals") and (name,
    "indivisible", config overrides). Returns {name: result} (rank 0's
    tokens, or what a follower saw)."""
    mesh = make_mesh(MeshConfig(tp=world), device_type="cpu")
    params = transformer.params_from_numpy(tree, cfg, "cpu")
    out: dict = {}
    for case in cases:
        name = case[0]
        if case[1] == "refusals":
            out[name] = refusals(params, cfg, icfg, mesh, server_kw)
            continue
        if case[1] == "indivisible":
            c = dataclasses.replace(cfg, **case[2])
            try:
                PagedInferenceServer(
                    transformer.init_params(c, 0, device="cpu"), c, icfg,
                    mesh=mesh, device="cpu", **server_kw)
            except ValueError as exc:
                out[name] = str(exc)
            continue
        _, overrides, kw, sampling, max_new = case
        c = dataclasses.replace(cfg, **overrides)
        out[name] = serve(params, c, icfg, prompts, max_new, sampling,
                          mesh=mesh, **{**server_kw, **kw})
    return out


def idle_then_restart(rank: int, world: int, tree: dict, cfg: ModelConfig,
                      icfg: InferConfig, prompts, server_kw: dict,
                      idle_s: float) -> dict:
    """A tp server whose rank 0 neither steps nor sends for `idle_s`
    seconds (longer than the group's timeout, which the caller sets),
    then serves `prompts` and stops; rank 0 then tries start() and
    step(). Returns rank 0's tokens, its message count, and what each
    refused call raised and how long it took; a follower returns after
    follow() has returned."""
    import time
    mesh = make_mesh(MeshConfig(tp=world), device_type="cpu")
    params = transformer.params_from_numpy(tree, cfg, "cpu")
    srv = PagedInferenceServer(params, cfg, icfg, mesh=mesh, device="cpu",
                               **server_kw)
    if rank > 0:
        srv.follow()
        return {"followed": True}
    time.sleep(idle_s)
    idle_messages = srv.tp_stats()["messages"]
    reqs = [srv.submit(p, max_new_tokens=8) for p in prompts]
    srv.run_until_idle()
    srv.stop()
    refused = {}
    for name, call in (("start", srv.start), ("step", srv.step)):
        t0 = time.perf_counter()
        try:
            call()
        except RuntimeError as exc:
            refused[name] = (str(exc), time.perf_counter() - t0)
    return {"tokens": [r.tokens for r in reqs],
            "idle_messages": idle_messages, "refused": refused}


def parallel_checks(rank: int, world: int) -> dict:
    """`parallel/` in a `world`-rank gloo group (world 4): a (dp 2, tp 2)
    mesh, a hybrid one (tp 2 on a host, dp across) and their errors;
    each collective of `parallel.collectives` on the mesh's 2-rank tp
    group, on inputs that depend on the rank; the coordination helpers.
    Returns what the test holds against the reference and numpy."""
    from cloud_server_tpu_torch.config import MeshConfig as M

    def err(fn):
        try:
            fn()
        except ValueError as exc:
            return str(exc)
        return None

    def layout(mesh):
        return (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
                mesh.mesh.tolist())

    full = make_mesh(M(dp=world // 2, tp=2), device_type="cpu")
    res = {
        "full": layout(full),
        "hybrid": layout(pdist.make_hybrid_mesh(M(tp=2), M(dp=world // 2),
                                                device_type="cpu")),
        "too_many": err(lambda: make_mesh(M(tp=2 * world),
                                          device_type="cpu")),
        "dcn_tp": err(lambda: pdist.make_hybrid_mesh(
            M(dp=2), M(tp=2), device_type="cpu")),
        "hybrid_size": err(lambda: pdist.make_hybrid_mesh(
            M(tp=2), M(dp=world), device_type="cpu")),
        "num_slices": pdist.num_slices(),
        "tp_local_rank": full.get_local_rank("tp"),
    }
    g = full.get_group("tp")
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * rank
    out = {
        "psum": coll.psum(x.clone(), g),
        "pmean": coll.pmean(x.clone(), g),
        "all_gather0": coll.all_gather(x, g),
        "all_gather1": coll.all_gather(x, g, tiled_axis=1),
        "reduce_scatter0": coll.reduce_scatter(x, g),
        "reduce_scatter1": coll.reduce_scatter(x, g, scatter_axis=1),
        "ppermute": coll.ppermute_shift(x, g),
        "ppermute_back": coll.ppermute_shift(x, g, shift=-1),
        "all_to_all": coll.all_to_all(x, g, split_axis=0, concat_axis=1),
        "ring": coll.ring_exchange({"k": x, "v": [x + 1]}, g)["v"][0],
    }
    res.update({k: v.numpy() for k, v in out.items()})
    res["pvary_is_identity"] = coll.pvary(x, ("tp",)) is x
    res["broadcast"] = pdist.broadcast_from_primary({"rank": rank})
    pdist.sync_global_devices("parallel_checks")
    res["is_primary"] = pdist.is_primary()
    res["summary"] = pdist.process_env_summary()
    return res


def spawn_probe(rank: int, world: int, fail_rank: int) -> int:
    """spawn_ranks' failure path: rank `fail_rank` raises."""
    if rank == fail_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def np_tree(params) -> dict:
    """A parameter tree as numpy arrays."""
    if isinstance(params, dict):
        return {k: np_tree(v) for k, v in params.items()}
    return np.asarray(params)
