"""The port's pipeline parallelism (`parallel/pipeline.py`, one process a
rank over gloo on the CPU, started by `parallel.spawn_ranks`) against
the reference's (`cloud_server_tpu/parallel/pipeline.py` under shard_map
on the conftest's 8 CPU devices), on the reference's weights and batch
crossed as numpy arrays: the counterparts of `tests/test_pipeline.py`
(forward at pp 4, loss and gradients at pp 2, the vocab-chunked CE at
pp 4, the MoE stack at pp 4, gradient accumulation around the pipeline)
and of `tests/test_packed_parallel.py`'s pipelined packed cases
(pp 2 x fsdp 2). The 8-rank cases (pp 2 x fsdp 4 forward, pp 4 x fsdp 2
training) are `test_torch_parallel_mesh8.py`'s."""

import concurrent.futures
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import MeshConfig as RefMeshConfig
from cloud_server_tpu.config import ModelConfig as RefModelConfig
from cloud_server_tpu.config import TrainConfig as RefTrainConfig
from cloud_server_tpu.data.packing import pack_documents
from cloud_server_tpu.models import moe as ref_moe
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu.parallel.mesh import make_mesh as ref_make_mesh
from cloud_server_tpu.parallel.pipeline import (
    make_pipelined_forward as ref_forward)
from cloud_server_tpu.parallel.pipeline import (
    make_pipelined_loss as ref_loss)
from cloud_server_tpu.training import init_train_state as ref_init_state
from cloud_server_tpu.training import make_train_step as ref_make_step
from cloud_server_tpu_torch.config import ModelConfig, TrainConfig
from cloud_server_tpu_torch.parallel import spawn_ranks
from cloud_server_tpu_torch.training.optim import flatten

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_ranks as ranks  # noqa: E402
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

_TINY = dict(vocab_size=64, embed_dim=32, num_layers=4, num_heads=4,
             num_kv_heads=4, head_dim=8, mlp_dim=64, max_seq_len=32,
             dtype="float32", param_dtype="float32", remat="none")
_MOE = dict(num_experts=4, num_experts_per_token=2,
            expert_capacity_factor=8.0)
# tests/test_packed_parallel.py's model: 2 layers, max_seq_len 64
_PACKED = dict(_TINY, num_layers=2, max_seq_len=64)
_PACKED_MOE = dict(num_experts=4, num_experts_per_token=2,
                   expert_capacity_factor=4.0)
DEADLINE_S = 240.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    return dict(flatten(_np(tree)))


def _packed_batch(seq_len=32, rows=4, seed=0):
    """tests/test_packed_parallel.py's packed rows."""
    rng = np.random.RandomState(seed)
    rows_toks, rows_segs = [], []
    for _ in range(rows):
        docs = [list(rng.randint(1, 60, rng.randint(4, 12)))
                for _ in range(3)]
        t, s = pack_documents(docs, seq_len)
        rows_toks.append(np.asarray(t)[0])
        rows_segs.append(np.asarray(s)[0])
    return (np.stack(rows_toks).astype(np.int64),
            np.stack(rows_segs).astype(np.int64))


def _inputs():
    """The reference's weights (its init) and batches, as numpy."""
    tiny = RefModelConfig(**_TINY)
    moe_cfg = RefModelConfig(**_TINY, **_MOE)
    packed = RefModelConfig(**_PACKED)
    packed_moe = RefModelConfig(**_PACKED, **_PACKED_MOE)
    tok = np.asarray(jax.random.randint(jax.random.key(1), (8, 16), 0, 64))
    return {
        "dense": _np(ref_transformer.init_params(tiny, jax.random.key(0))),
        "moe": _np(ref_moe.init_params(moe_cfg, jax.random.key(0))),
        "packed": _np(ref_transformer.init_params(packed,
                                                  jax.random.key(0))),
        "packed_grads": _np(ref_transformer.init_params(
            packed, jax.random.key(1))),
        "packed_moe": _np(ref_moe.init_params(packed_moe,
                                              jax.random.key(0))),
        "tokens": tok.astype(np.int64),
        "tokens4": np.asarray(jax.random.randint(
            jax.random.key(1), (4, 16), 0, 64)).astype(np.int64),
        "pk": _packed_batch(), "pk_grads": _packed_batch(seed=3),
        "pk_moe": _packed_batch(seed=5)}


def _ref_grads(cfg, axes, m, params, batch, module=ref_transformer, **kw):
    mesh = ref_make_mesh(RefMeshConfig(**axes))
    fn = ref_loss(cfg, mesh, m, loss_fn_module=module, **kw)
    with mesh:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: fn(p, b, cfg), has_aux=True))(params, batch)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _flat(grads)}


def _reference(inp) -> dict:
    tiny = RefModelConfig(**_TINY)
    moe_cfg = RefModelConfig(**_TINY, **_MOE)
    out = {}
    out["fwd_pp4"] = np.asarray(ref_forward(
        tiny, ref_make_mesh(RefMeshConfig(pp=4)), 4)(inp["dense"],
                                                     inp["tokens"]))
    out["grads_pp2"] = _ref_grads(tiny, {"pp": 2}, 2, inp["dense"],
                                  {"tokens": inp["tokens4"]})
    chunked = dataclasses.replace(tiny, vocab_chunk=16)
    out["chunked_pp4"] = _ref_grads(chunked, {"pp": 4}, 4, inp["dense"],
                                    {"tokens": inp["tokens"]})
    logits, aux = ref_forward(moe_cfg, ref_make_mesh(RefMeshConfig(pp=4)), 4,
                              loss_fn_module=ref_moe)(inp["moe"],
                                                      inp["tokens"])
    out["moe_fwd_pp4"] = {"logits": np.asarray(logits),
                          "aux": {k: float(v) for k, v in aux.items()}}
    out["moe_grads_pp4"] = _ref_grads(moe_cfg, {"pp": 4}, 4, inp["moe"],
                                      {"tokens": inp["tokens"]},
                                      module=ref_moe)
    # grad accumulation around the pipeline (learning rate 0: the loss)
    tcfg = RefTrainConfig(learning_rate=0.0, warmup_steps=1, total_steps=10,
                          microbatch_steps=2)
    mesh = ref_make_mesh(RefMeshConfig(pp=4))
    for name, mb_steps, m in (("accum", 2, 2), ("flat", 1, 4)):
        t = dataclasses.replace(tcfg, microbatch_steps=mb_steps)
        fn = ref_loss(tiny, mesh, m)
        state = ref_init_state(tiny, t, mesh, jax.random.key(0))
        state = state._replace(params=jax.tree.map(
            lambda p, x: jax.device_put(p, x.sharding), inp["dense"],
            state.params))
        step, bsh = ref_make_step(tiny, t, mesh, loss_fn=fn)
        _, metrics = step(state, {"tokens": jax.device_put(inp["tokens"],
                                                           bsh)})
        out[name] = float(metrics["loss"])
    # packed rows through the pipeline at pp 2 x fsdp 2
    packed = RefModelConfig(**_PACKED)
    tok, seg = inp["pk"]
    out["packed_loss"] = _ref_grads(packed, {"pp": 2, "fsdp": 2}, 2,
                                    inp["packed"],
                                    {"tokens": tok, "segment_ids": seg})
    tok, seg = inp["pk_grads"]
    out["packed_grads"] = _ref_grads(packed, {"pp": 2, "fsdp": 2}, 2,
                                     inp["packed_grads"],
                                     {"tokens": tok, "segment_ids": seg})
    packed_moe = RefModelConfig(**_PACKED, **_PACKED_MOE)
    tok, seg = inp["pk_moe"]
    out["packed_moe"] = _ref_grads(packed_moe, {"pp": 2, "fsdp": 2}, 2,
                                   inp["packed_moe"],
                                   {"tokens": tok, "segment_ids": seg},
                                   module=ref_moe, aux_loss_coef=0.0)
    return out


@pytest.fixture(scope="module")
def runs():
    """The spawns (2 ranks: pp 2; 4 ranks: pp 4 and pp 2 x fsdp 2), run
    while this process runs the reference."""
    inp = _inputs()
    tiny, moe_cfg = ModelConfig(**_TINY), ModelConfig(**_TINY, **_MOE)
    packed = ModelConfig(**_PACKED)
    packed_moe = ModelConfig(**_PACKED, **_PACKED_MOE)
    tcfg = TrainConfig(learning_rate=0.0, warmup_steps=1, total_steps=10)
    w2 = [("grads_pp2", "pipe_case", dict(
        cfg=tiny, np_params=inp["dense"], tokens=inp["tokens4"],
        axes={"pp": 2}, m=2, what=("grads",)))]
    w4 = [
        ("fwd_pp4", "pipe_case", dict(
            cfg=tiny, np_params=inp["dense"], tokens=inp["tokens"],
            axes={"pp": 4}, m=4)),
        ("chunked_pp4", "pipe_case", dict(
            cfg=dataclasses.replace(tiny, vocab_chunk=16),
            np_params=inp["dense"], tokens=inp["tokens"], axes={"pp": 4},
            m=4, what=("grads",))),
        ("moe_pp4", "pipe_case", dict(
            cfg=moe_cfg, np_params=inp["moe"], tokens=inp["tokens"],
            axes={"pp": 4}, m=4, what=("forward", "grads"),
            module="moe")),
        ("accum", "train_case", dict(
            cfg=tiny, tcfg=dataclasses.replace(tcfg, microbatch_steps=2),
            np_params=inp["dense"], tokens=inp["tokens"], axes={"pp": 4},
            steps=1, pipeline_m=2)),
        ("flat", "train_case", dict(
            cfg=tiny, tcfg=tcfg, np_params=inp["dense"],
            tokens=inp["tokens"], axes={"pp": 4}, steps=1, pipeline_m=4)),
        ("packed_loss", "pipe_case", dict(
            cfg=packed, np_params=inp["packed"], tokens=inp["pk"][0],
            seg=inp["pk"][1], axes={"pp": 2, "fsdp": 2}, m=2,
            what=("grads",))),
        ("packed_grads", "pipe_case", dict(
            cfg=packed, np_params=inp["packed_grads"],
            tokens=inp["pk_grads"][0], seg=inp["pk_grads"][1],
            axes={"pp": 2, "fsdp": 2}, m=2, what=("grads",))),
        ("packed_moe", "pipe_case", dict(
            cfg=packed_moe, np_params=inp["packed_moe"],
            tokens=inp["pk_moe"][0], seg=inp["pk_moe"][1],
            axes={"pp": 2, "fsdp": 2}, m=2, what=("grads",),
            module="moe", loss_kw={"aux_loss_coef": 0.0})),
        ("refusals", "pipe_refusals", dict(cfg=tiny)),
    ]
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        f2 = ex.submit(spawn_ranks, ranks.run_cases, 2, "gloo", w2,
                       deadline_s=DEADLINE_S)
        f4 = ex.submit(spawn_ranks, ranks.run_cases, 4, "gloo", w4,
                       deadline_s=DEADLINE_S)
        ref = _reference(inp)
        return {"ref": ref, "w2": f2.result(), "w4": f4.result(),
                "inp": inp}


def _close_grads(got, want, atol, rtol=0.0, what=""):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=atol, rtol=rtol,
                                   err_msg=f"{what} {k}")


def test_pipelined_forward_matches_reference(runs):
    """pp 4, 4 microbatches: every rank's logits equal the reference's
    pipelined forward (tests/test_pipeline.py's atol)."""
    for res in runs["w4"]:
        np.testing.assert_allclose(res["fwd_pp4"]["logits"],
                                   runs["ref"]["fwd_pp4"], atol=2e-4)


def test_pipelined_grads_match_reference(runs):
    """pp 2: the loss (rtol 1e-5) and every whole gradient."""
    want = runs["ref"]["grads_pp2"]
    for res in runs["w2"]:
        got = res["grads_pp2"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        _close_grads(got["grads"], want["grads"], atol=3e-4)


def test_pipelined_fused_ce_matches_reference(runs):
    """vocab_chunk 16 at pp 4: the chunked CE's loss and gradients."""
    want = runs["ref"]["chunked_pp4"]
    for res in runs["w4"]:
        got = res["chunked_pp4"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        _close_grads(got["grads"], want["grads"], atol=2e-4, rtol=1e-3)


def test_pipelined_moe_matches_reference(runs):
    """The MoE stack at pp 4: logits, the router statistics (the mean
    over microbatches), the loss, its metrics and the gradients."""
    want_fwd = runs["ref"]["moe_fwd_pp4"]
    want = runs["ref"]["moe_grads_pp4"]
    for res in runs["w4"]:
        got = res["moe_pp4"]
        np.testing.assert_allclose(got["logits"], want_fwd["logits"],
                                   atol=2e-4)
        for k, v in want_fwd["aux"].items():
            np.testing.assert_allclose(got["aux"][k], v, rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for k in ("loss", "accuracy", "load_balance", "router_z",
                  "dropped_frac"):
            np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                       rtol=1e-4, err_msg=k)
        _close_grads(got["grads"], want["grads"], atol=3e-4, rtol=1e-3)


def test_pipeline_composes_with_grad_accum(runs):
    """Two accumulation steps of a 2-microbatch pipeline give the loss of
    one 4-microbatch pipeline, as the reference's do."""
    ref = runs["ref"]
    np.testing.assert_allclose(ref["accum"], ref["flat"], rtol=1e-5)
    for res in runs["w4"]:
        for name in ("accum", "flat"):
            np.testing.assert_allclose(
                res[name]["metrics"][0]["loss"], ref[name], rtol=1e-5,
                err_msg=name)


@pytest.mark.parametrize("case", ["packed_loss", "packed_grads",
                                  "packed_moe"])
def test_pipelined_packed_matches_reference(runs, case):
    """Packed rows through the pipeline at pp 2 x fsdp 2 (segment ids
    and positions ride with the activations): the loss, and the
    gradients of the dense stack (tests/test_packed_parallel.py's
    tolerances)."""
    want = runs["ref"][case]
    for res in runs["w4"]:
        got = res[case]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        if case != "packed_moe":
            _close_grads(got["grads"], want["grads"], atol=2e-4, rtol=2e-3)


def test_pipeline_refusals(runs):
    """The reference's refusals: layers that do not split over pp, and
    packed rows under ring or Ulysses attention (ValueError)."""
    for res in runs["w4"]:
        got = res["refusals"]
        assert "not divisible by pp" in got["layers"]
        for impl in ("ring", "ulysses"):
            assert "pipelined packed batches" in got[impl]
