"""Adapters and experts on a mesh (one process a rank over gloo on the
CPU) against the reference's sharded training on the conftest's 8 CPU
devices, on the reference's weights and batch crossed as numpy arrays:

* LoRA at fsdp 2 x tp 2 (`tests/test_lora.py`'s sharded LoRA): two steps
  against the reference's (the frozen base bit for bit, the adapters'
  moments and values), eight steps' losses, the base without moments;
* a LoRA state saved and restored on an fsdp 2 x tp 2 mesh, bit for bit;
* LoRA over an MoE base at fsdp 2 x ep 2 (one adapter stack an expert,
  split over ep), trained against the reference's;
* MoE at fsdp 2 x ep 2 with a capacity that drops: the global routing's
  drops and the step against the reference's."""

import concurrent.futures
import os
import sys

import jax
import numpy as np
import optax
import pytest

from cloud_server_tpu.config import MeshConfig as RefMeshConfig
from cloud_server_tpu.config import ModelConfig as RefModelConfig
from cloud_server_tpu.config import TrainConfig as RefTrainConfig
from cloud_server_tpu.models import lora as ref_lora
from cloud_server_tpu.models import moe as ref_moe
from cloud_server_tpu.parallel.mesh import make_mesh as ref_make_mesh
from cloud_server_tpu.training import init_train_state as ref_init_state
from cloud_server_tpu.training import make_train_step as ref_make_step
from cloud_server_tpu_torch.config import ModelConfig, TrainConfig
from cloud_server_tpu_torch.models.lora import LoRAConfig
from cloud_server_tpu_torch.parallel import spawn_ranks
from cloud_server_tpu_torch.training.optim import flatten

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_ranks as ranks  # noqa: E402
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

# tests/test_lora.py's models, adapters and train config
_TINY = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=8, mlp_dim=64, max_seq_len=32,
             dtype="float32", param_dtype="float32", remat="none")
_MOE_TINY = dict(_TINY, mlp_dim=32, num_experts=4, num_experts_per_token=2,
                 expert_capacity_factor=4.0)
_DENSE_LORA = dict(rank=4, alpha=8.0, targets=("wq", "wv", "w_down"))
_MOE_LORA = dict(rank=4, alpha=8.0, targets=("wq", "wv", "w_gate", "w_down"))
_TRAIN = dict(learning_rate=3e-3, warmup_steps=2, total_steps=8,
              batch_size=8, seq_len=16)
# experts with a capacity that drops primary assignments too (factor
# 0.5: 32 slots an expert for 128 tokens' 256 assignments)
_DROPS = dict(_TINY, num_kv_heads=4, num_experts=4, num_experts_per_token=2,
              expert_capacity_factor=0.5)
DEADLINE_S = 240.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _arrays(tree) -> dict:
    """The array leaves of a nested tree, flat (optax's MaskedNode
    placeholders of frozen leaves dropped)."""
    return {k: np.asarray(v) for k, v in flatten(_np(tree))
            if not isinstance(v, optax.MaskedNode)}


def _ref_run(cfg, axes, np_params, tokens, steps, module) -> dict:
    tcfg = RefTrainConfig(**_TRAIN)
    mesh = ref_make_mesh(RefMeshConfig(**axes))
    state = ref_init_state(cfg, tcfg, mesh, jax.random.key(0),
                           loss_fn_module=module)
    state = state._replace(params=jax.tree.map(
        lambda p, x: jax.device_put(p, x.sharding), np_params, state.params))
    step, bsh = ref_make_step(cfg, tcfg, mesh, loss_fn_module=module)
    batch = {"tokens": jax.device_put(tokens, bsh)}
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    adam = state.opt_state
    if hasattr(adam, "inner_states"):  # the label-masked (LoRA) optimizer
        adam = adam.inner_states["trainable"].inner_state
    return {"metrics": metrics, "params": _arrays(state.params),
            "mu": _arrays(adam.mu), "nu": _arrays(adam.nu),
            "count": int(adam.count)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 4-rank spawn running every case in turn, while this process
    runs the reference."""
    dense = RefModelConfig(**_TINY)
    moe_base = RefModelConfig(**_MOE_TINY)
    drops = RefModelConfig(**_DROPS)
    dense_mod = ref_lora.make_lora_module(ref_lora.LoRAConfig(**_DENSE_LORA))
    moe_mod = ref_lora.make_lora_module(ref_lora.LoRAConfig(**_MOE_LORA),
                                        base_module=ref_moe)
    inp = {"dense": _np(dense_mod.init_params(dense, jax.random.key(0))),
           "moe": _np(moe_mod.init_params(moe_base, jax.random.key(0))),
           "drops": _np(ref_moe.init_params(drops, jax.random.key(0))),
           "tokens": np.asarray(jax.random.randint(
               jax.random.key(7), (8, 16), 0, 64)).astype(np.int64)}
    tcfg = TrainConfig(**_TRAIN)
    ckpt_dir = str(tmp_path_factory.mktemp("lora_ckpt") / "ck")
    cases = []
    for name, cfg, params, axes, module, lcfg in (
            ("dense", ModelConfig(**_TINY), inp["dense"],
             {"fsdp": 2, "tp": 2}, "transformer", _DENSE_LORA),
            ("moe", ModelConfig(**_MOE_TINY), inp["moe"],
             {"fsdp": 2, "ep": 2}, "moe", _MOE_LORA),
            ("drops", ModelConfig(**_DROPS), inp["drops"],
             {"fsdp": 2, "ep": 2}, "moe", None)):
        for steps in (2, 8):
            cases.append((f"{name}_{steps}", "train_case", dict(
                cfg=cfg, tcfg=tcfg, np_params=params, tokens=inp["tokens"],
                axes=axes, steps=steps, module=module,
                lora_cfg=None if lcfg is None else LoRAConfig(**lcfg))))
    cases.append(("ckpt", "lora_ckpt_case", dict(
        cfg=ModelConfig(**_TINY), tcfg=tcfg,
        lora_cfg=LoRAConfig(**_DENSE_LORA), axes={"fsdp": 2, "tp": 2},
        ckpt_dir=ckpt_dir)))
    moe_ckpt = str(tmp_path_factory.mktemp("moe_ckpt") / "ck")
    cases.append(("moe_ckpt", "moe_ckpt_case", dict(
        cfg=ModelConfig(**_DROPS), tcfg=tcfg, tokens=inp["tokens"],
        ckpt_dir=moe_ckpt)))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        f4 = ex.submit(spawn_ranks, ranks.run_cases, 4, "gloo", cases,
                       deadline_s=DEADLINE_S)
        ref = {}
        for name, cfg, module, axes in (
                ("dense", dense, dense_mod, {"fsdp": 2, "tp": 2}),
                ("moe", moe_base, moe_mod, {"fsdp": 2, "ep": 2}),
                ("drops", drops, ref_moe, {"fsdp": 2, "ep": 2})):
            for steps in (2, 8):
                ref[f"{name}_{steps}"] = _ref_run(
                    cfg, axes, inp[name], inp["tokens"], steps, module)
        return {"ref": ref, "w4": f4.result(), "inp": inp,
                "moe_ckpt": moe_ckpt}


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_sharded_lora_matches_reference(runs, name):
    """LoRA over a dense base at fsdp 2 x tp 2 and over an MoE base at
    fsdp 2 x ep 2: two steps against the reference's sharded step (the
    base bit for bit, the adapters' moments and values), and the eight
    steps' losses within the reference test's rtol 2e-4."""
    tcfg = TrainConfig(**_TRAIN)
    for rank, res in enumerate(runs["w4"]):
        ranks.assert_run_close(res[f"{name}_2"], runs["ref"][f"{name}_2"],
                               f"{name} rank {rank}", tcfg)
        got = [m["loss"] for m in res[f"{name}_8"]["metrics"]]
        want = [m["loss"] for m in runs["ref"][f"{name}_8"]["metrics"]]
        np.testing.assert_allclose(got, want, rtol=2e-4)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_sharded_lora_trains_adapters_only(runs, name):
    """Eight steps learn; the base is bit for bit the initial one, has no
    moments, and some adapter B moved off zero."""
    p0 = dict(flatten(runs["inp"][name]))
    for res in runs["w4"]:
        got = res[f"{name}_8"]
        losses = [m["loss"] for m in got["metrics"]]
        assert losses[-1] < losses[0] - (0.05 if name == "moe" else 0.0)
        for k, v in p0.items():
            if k.startswith("base/"):
                np.testing.assert_array_equal(got["params"][k], v)
                assert k not in got["mu"]
        assert any(float(np.abs(got["params"][k]).max()) > 0
                   for k in got["params"]
                   if k.startswith("lora/") and k.endswith("/b"))
        if name == "moe":
            # one adapter stack an expert, split over ep: E/2 a rank
            assert got["shapes"]["lora/layers/w_gate/a"][1] == 2


def test_lora_checkpoint_roundtrip_on_a_mesh(runs):
    """A LoRA state on fsdp 2 x tp 2 saved (rank 0 writes) and restored
    onto the mesh: every rank's shards bit for bit."""
    for res in runs["w4"]:
        got = res["ckpt"]
        assert got["saved"] and got["keys_equal"] and got["equal"]
        assert got["lora_leaves"] == 6


def test_moe_drops_route_globally(runs):
    """Capacity factor 0.5 at fsdp 2 x ep 2: tokens drop, and the drops,
    losses, moments and parameters are the reference's (routing over the
    whole batch, as its jit routes all B*S tokens at once)."""
    tcfg = TrainConfig(**_TRAIN)
    want = runs["ref"]["drops_2"]
    assert want["metrics"][0]["dropped_frac"] > 0
    for rank, res in enumerate(runs["w4"]):
        ranks.assert_run_close(res["drops_2"], want, f"rank {rank}", tcfg)
        for g, w in zip(res["drops_8"]["metrics"],
                        runs["ref"]["drops_8"]["metrics"]):
            np.testing.assert_allclose(g["dropped_frac"], w["dropped_frac"],
                                       atol=1e-7)


def test_moe_checkpoint_restores_onto_one_device_and_ep4(runs):
    """An MoE state saved at fsdp 2 x ep 2 (each expert leaf gathered
    over both axes, one leaf at a time) restores onto ep 4 (each rank's
    quarter of the experts) and onto one device (the files as saved),
    bit for bit."""
    import torch
    from cloud_server_tpu_torch.models import moe
    from cloud_server_tpu_torch.training import checkpoint as ckpt
    root = os.path.join(runs["moe_ckpt"], "1")
    saved = {name: torch.load(os.path.join(root, f"{name}.pt"),
                              weights_only=True) for name in ("params", "opt")}
    experts = ("layers/w_gate", "layers/w_up", "layers/w_down")
    for res in runs["w4"]:
        got = res["moe_ckpt"]
        assert got["saved"] and got["step"] == 1
        for item, prefix in (("params", ""), ("mu", "mu/"), ("nu", "nu/")):
            src = saved["params" if item == "params" else "opt"]
            for k, v in got[item].items():
                want = src[prefix + k]
                if k in experts:
                    n = want.shape[1] // 4
                    want = want.narrow(1, got["ep"] * n, n)
                np.testing.assert_array_equal(v, want.numpy(),
                                              err_msg=f"{item} {k}")
    cfg = ModelConfig(**_DROPS)
    one = ckpt.Checkpointer(runs["moe_ckpt"]).restore(
        ckpt.abstract_train_state(cfg, TrainConfig(**_TRAIN), moe),
        device="cpu")
    for k, v in flatten(one.params):
        np.testing.assert_array_equal(v.detach().numpy(),
                                      saved["params"][k].numpy())
