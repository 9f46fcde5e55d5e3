"""The port's 8-rank parallel training (one process a rank over gloo on
the CPU) against the reference's on the conftest's 8 CPU devices, on the
reference's weights and batch crossed as numpy arrays:

* the pipeline at pp 2 x fsdp 4 (forward) and pp 4 x fsdp 2 (two train
  steps against the reference's, then ten that learn): the rest of
  `tests/test_pipeline.py`;
* MoE training at fsdp 2 x ep 4 (`tests/test_moe.py`'s expert
  parallelism, routing global over the batch), the expert
  leaves split E/4 a rank;
* the train step over a hybrid mesh (fsdp 2 x tp 2 inside a host, dp 2
  across: `tests/test_distributed.py`) against the reference's hybrid
  step and the port's plain dp 2 x fsdp 2 x tp 2 one;
* `CollectiveWatchdog` on a fsdp 4 x sp 2 and a fsdp 8 mesh
  (`tests/test_sanitizer.py`)."""

import os
import sys

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import MeshConfig as RefMeshConfig
from cloud_server_tpu.config import ModelConfig as RefModelConfig
from cloud_server_tpu.config import TrainConfig as RefTrainConfig
from cloud_server_tpu.models import moe as ref_moe
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu.parallel.distributed import (
    make_hybrid_mesh as ref_hybrid_mesh)
from cloud_server_tpu.parallel.mesh import make_mesh as ref_make_mesh
from cloud_server_tpu.parallel.pipeline import (
    make_pipelined_forward as ref_forward)
from cloud_server_tpu.parallel.pipeline import (
    make_pipelined_loss as ref_loss)
from cloud_server_tpu.parallel.sharding import DEFAULT_RULES as REF_RULES
from cloud_server_tpu.training import init_train_state as ref_init_state
from cloud_server_tpu.training import make_train_step as ref_make_step
from cloud_server_tpu_torch.config import ModelConfig, TrainConfig
from cloud_server_tpu_torch.parallel import spawn_ranks
from cloud_server_tpu_torch.training.optim import flatten

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_ranks as ranks  # noqa: E402
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

# tests/test_pipeline.py's model (4 layers)
_PIPE = dict(vocab_size=64, embed_dim=32, num_layers=4, num_heads=4,
             num_kv_heads=4, head_dim=8, mlp_dim=64, max_seq_len=32,
             dtype="float32", param_dtype="float32", remat="none")
# tests/test_moe.py's MOE_TINY (capacity factor at its default)
_MOE = dict(_PIPE, num_layers=2, num_experts=4, num_experts_per_token=2)
# tests/test_distributed.py's model
_HYB = dict(_PIPE, num_layers=2, num_kv_heads=2)
_PIPE_TRAIN = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10,
                   batch_size=8, seq_len=16)
_MOE_TRAIN = dict(learning_rate=3e-3, warmup_steps=2, total_steps=8,
                  batch_size=8, seq_len=16)
_HYB_TRAIN = dict(learning_rate=1e-2, warmup_steps=2, total_steps=4,
                  batch_size=8, seq_len=16)
PIPE_RULES = {**REF_RULES, "layers": "pp"}
DEADLINE_S = 240.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    return dict(flatten(_np(tree)))


def _ref_train(cfg, tcfg, mesh, np_params, tokens, steps, *, rules=REF_RULES,
               loss_fn=None, module=ref_transformer) -> dict:
    state = ref_init_state(cfg, tcfg, mesh, jax.random.key(0), rules=rules,
                           loss_fn_module=module)
    state = state._replace(params=jax.tree.map(
        lambda p, x: jax.device_put(p, x.sharding), np_params, state.params))
    step, bsh = ref_make_step(cfg, tcfg, mesh, rules=rules, loss_fn=loss_fn,
                              loss_fn_module=module)
    batch = {"tokens": jax.device_put(tokens, bsh)}
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    adam = state.opt_state
    return {"metrics": metrics, "params": _flat(state.params),
            "mu": _flat(adam.mu), "nu": _flat(adam.nu),
            "count": int(adam.count)}


def _reference(inp) -> dict:
    pipe = RefModelConfig(**_PIPE)
    out = {"fwd": np.asarray(ref_forward(
        pipe, ref_make_mesh(RefMeshConfig(fsdp=4, pp=2)), 2)(
            inp["pipe"], inp["tokens"]))}
    mesh = ref_make_mesh(RefMeshConfig(pp=4, fsdp=2))
    out["pipe_train"] = _ref_train(
        pipe, RefTrainConfig(**_PIPE_TRAIN), mesh, inp["pipe"],
        inp["tokens"], 2, rules=PIPE_RULES,
        loss_fn=ref_loss(pipe, mesh, num_microbatches=4))
    out["moe_train"] = _ref_train(
        RefModelConfig(**_MOE), RefTrainConfig(**_MOE_TRAIN),
        ref_make_mesh(RefMeshConfig(fsdp=2, ep=4)), inp["moe"],
        inp["tokens"], 2, module=ref_moe)
    out["hybrid"] = _ref_train(
        RefModelConfig(**_HYB), RefTrainConfig(**_HYB_TRAIN),
        ref_hybrid_mesh(RefMeshConfig(fsdp=2, tp=2), RefMeshConfig(dp=2)),
        inp["hyb"], inp["tokens"], 2)
    return out


@pytest.fixture(scope="module")
def runs():
    """One 8-rank spawn running every case in turn, while this process
    runs the reference."""
    inp = {
        "pipe": _np(ref_transformer.init_params(RefModelConfig(**_PIPE),
                                                jax.random.key(0))),
        "moe": _np(ref_moe.init_params(RefModelConfig(**_MOE),
                                       jax.random.key(0))),
        "hyb": _np(ref_transformer.init_params(RefModelConfig(**_HYB),
                                               jax.random.key(0))),
        "tokens": np.asarray(jax.random.randint(
            jax.random.key(2), (8, 16), 0, 64)).astype(np.int64)}
    pipe, moe_cfg = ModelConfig(**_PIPE), ModelConfig(**_MOE)
    hyb = ModelConfig(**_HYB)
    ptcfg, mtcfg = TrainConfig(**_PIPE_TRAIN), TrainConfig(**_MOE_TRAIN)
    htcfg = TrainConfig(**_HYB_TRAIN)
    cases = [
        ("fwd", "pipe_case", dict(
            cfg=pipe, np_params=inp["pipe"], tokens=inp["tokens"],
            axes={"fsdp": 4, "pp": 2}, m=2)),
        ("pipe_train", "train_case", dict(
            cfg=pipe, tcfg=ptcfg, np_params=inp["pipe"],
            tokens=inp["tokens"], axes={"pp": 4, "fsdp": 2}, steps=2,
            pipeline_m=4)),
        ("pipe_learns", "train_case", dict(
            cfg=pipe, tcfg=ptcfg, np_params=inp["pipe"],
            tokens=inp["tokens"], axes={"pp": 4, "fsdp": 2}, steps=10,
            pipeline_m=4)),
        ("moe_train", "train_case", dict(
            cfg=moe_cfg, tcfg=mtcfg, np_params=inp["moe"],
            tokens=inp["tokens"], axes={"fsdp": 2, "ep": 4}, steps=2,
            module="moe")),
        ("moe_learns", "train_case", dict(
            cfg=moe_cfg, tcfg=mtcfg, np_params=inp["moe"],
            tokens=inp["tokens"], axes={"fsdp": 2, "ep": 4}, steps=8,
            module="moe")),
        ("hybrid", "train_case", dict(
            cfg=hyb, tcfg=htcfg, np_params=inp["hyb"],
            tokens=inp["tokens"], axes={}, steps=2,
            hybrid=({"fsdp": 2, "tp": 2}, {"dp": 2}))),
        ("plain", "train_case", dict(
            cfg=hyb, tcfg=htcfg, np_params=inp["hyb"],
            tokens=inp["tokens"], axes={"dp": 2, "fsdp": 2, "tp": 2},
            steps=2)),
        ("watchdog", "watchdog_case", dict(
            timeout_s=0.2, per_axis_s=0.05, axes={"fsdp": 4, "sp": 2},
            beat=True)),
        ("watchdog_quiet", "watchdog_case", dict(
            timeout_s=0.1, per_axis_s=0.0, axes={"fsdp": 8}, beat=False)),
    ]
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        f8 = ex.submit(spawn_ranks, ranks.run_cases, 8, "gloo", cases,
                       deadline_s=DEADLINE_S)
        ref = _reference(inp)
        return {"ref": ref, "w8": f8.result(), "inp": inp}


def test_pipelined_forward_pp2_with_batch_sharding(runs):
    """pp 2 x fsdp 4, 2 microbatches: each rank's share of each
    microbatch (global rows i * 4 + q, for batch rank q) equals the
    reference's logits of those rows."""
    want = runs["ref"]["fwd"]
    for res in runs["w8"]:
        got = res["fwd"]
        q = got["layout"]["process_index"]
        np.testing.assert_allclose(got["logits"], want[[q, 4 + q]],
                                   atol=2e-4)


def test_pipelined_training_step_matches_reference_and_learns(runs):
    """pp 4 x fsdp 2 with the pipeline's rules: two steps against the
    reference's (losses, moments, parameters), and ten that learn."""
    tcfg = TrainConfig(**_PIPE_TRAIN)
    for rank, res in enumerate(runs["w8"]):
        ranks.assert_run_close(res["pipe_train"], runs["ref"]["pipe_train"],
                               f"rank {rank}", tcfg)
        losses = [m["loss"] for m in res["pipe_learns"]["metrics"]]
        assert losses[-1] < losses[0], losses
        # each rank holds its stage's layer
        assert res["pipe_train"]["shapes"]["layers/wq"][0] == 1


def test_moe_trains_with_expert_parallelism(runs):
    """fsdp 2 x ep 4, routing global over the batch: two steps against the reference's sharded step, eight that
    learn, and each rank's expert leaves hold E/4 experts."""
    tcfg = TrainConfig(**_MOE_TRAIN)
    e = _MOE["num_experts"]
    for rank, res in enumerate(runs["w8"]):
        ranks.assert_run_close(res["moe_train"], runs["ref"]["moe_train"],
                               f"rank {rank}", tcfg)
        losses = [m["loss"] for m in res["moe_learns"]["metrics"]]
        assert losses[-1] < losses[0], losses
        shapes = res["moe_train"]["shapes"]
        assert shapes["layers/w_gate"][1] == e // 4
        assert shapes["layers/w_down"][1] == e // 4
        for g, w in zip(res["moe_train"]["metrics"],
                        runs["ref"]["moe_train"]["metrics"]):
            np.testing.assert_allclose(g["dropped_frac"], w["dropped_frac"],
                                       atol=1e-7)


def test_train_step_over_hybrid_mesh(runs):
    """A hybrid mesh (fsdp 2 x tp 2 inside, dp 2 across) drops into the
    train step: the reference's hybrid step, and the plain mesh's."""
    tcfg = TrainConfig(**_HYB_TRAIN)
    for rank, res in enumerate(runs["w8"]):
        ranks.assert_run_close(res["hybrid"], runs["ref"]["hybrid"],
                               f"rank {rank}", tcfg)
        np.testing.assert_allclose(
            [m["loss"] for m in res["hybrid"]["metrics"]],
            [m["loss"] for m in res["plain"]["metrics"]], rtol=2e-4)


def test_collective_watchdog_names_comm_axes(runs):
    """The timeout grows once per comm-active axis; a hang fires the
    handler and the report names the axes."""
    for res in runs["w8"]:
        got = res["watchdog"]
        assert got["timeout_s"] == pytest.approx(0.2 + 2 * 0.05)
        assert got["comm_axes"] == {"fsdp": 4, "sp": 2}
        assert got["fired"] and got["calls"] == 1
        assert "collective deadlock" in got["report"]
        assert "fsdp" in got["report"] and "sp" in got["report"]


def test_collective_watchdog_disarmed_until_first_beat(runs):
    for res in runs["w8"]:
        got = res["watchdog_quiet"]
        assert not got["fired"] and got["calls"] == 0
        assert got["comm_axes"] == {"fsdp": 8}

