"""The port's evaluation (`training/eval.py`) against the reference's, on
the CPU in float32 with the same weights (carried as numpy arrays) and
the same batches, with the dense CE and with ce_impl="pallas" (the
reference's fused-CE kernels in interpret mode): eval_loss, eval_ppl,
eval_accuracy and eval_tokens within 1e-5 relative; an empty sweep gives
NaNs and 0 tokens in both."""

import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import MeshConfig, ModelConfig
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu.parallel.mesh import make_mesh
from cloud_server_tpu.training import eval as ref_eval
from cloud_server_tpu_torch import config as tconfig
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import fused_ce as fc
from cloud_server_tpu_torch.training import eval as teval

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

CFG = ModelConfig(
    vocab_size=128, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=64, dtype="float32",
    param_dtype="float32", remat="none")


def _batches(masked: bool):
    r = np.random.default_rng(11)
    out = []
    for i in range(3):
        b = {"tokens": r.integers(0, CFG.vocab_size, (4, 32)).astype(
            np.int32)}
        if masked and i == 1:
            mask = np.ones((4, 32), np.float32)
            mask[2:, 20:] = 0.0
            b["mask"] = mask
        out.append(b)
    return out


@pytest.mark.parametrize("ce_impl,masked", [("dense", False),
                                            ("dense", True),
                                            ("pallas", True)])
def test_evaluate_matches_reference(ce_impl, masked):
    cfg = dataclasses.replace(CFG, ce_impl=ce_impl)
    ref_params = ref_tf.init_params(cfg, jax.random.key(3))
    batches = _batches(masked)
    ref_step, _ = ref_eval.make_eval_step(cfg, make_mesh(MeshConfig()))
    want = ref_eval.evaluate(
        ref_params, [{k: jnp.asarray(v) for k, v in b.items()}
                     for b in batches], ref_step, max_batches=2)

    tcfg = tconfig.ModelConfig(**dataclasses.asdict(cfg))
    params = transformer.params_from_numpy(
        jax.tree.map(np.asarray, ref_params), tcfg, device="cpu")
    step = teval.make_eval_step(tcfg)
    fc.reset_counters()
    got = teval.evaluate(params, [{k: torch.from_numpy(v)
                                   for k, v in b.items()}
                                  for b in batches], step, max_batches=2)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
    assert got["eval_ppl"] == pytest.approx(math.exp(got["eval_loss"]))
    # with the fused CE, eval runs its forward alone
    want_calls = 2 if ce_impl == "pallas" else 0
    assert fc.counters()["plain_calls"] == want_calls


def test_empty_sweep_gives_nans():
    ref_step, _ = ref_eval.make_eval_step(CFG, make_mesh(MeshConfig()))
    want = ref_eval.evaluate({}, [], ref_step)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(CFG))
    got = teval.evaluate({}, [], teval.make_eval_step(tcfg))
    assert sorted(got) == sorted(want)
    assert got["eval_tokens"] == want["eval_tokens"] == 0.0
    for key in ("eval_loss", "eval_ppl", "eval_accuracy"):
        assert math.isnan(got[key]) and math.isnan(want[key])


def test_eval_step_sums_and_runs_without_grad():
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(CFG))
    params = transformer.init_params(tcfg, 0, device="cpu")
    params = {g: {n: t.requires_grad_(True) for n, t in leaves.items()}
              for g, leaves in params.items()}
    out = teval.make_eval_step(tcfg)(
        params, {"tokens": torch.from_numpy(_batches(False)[0]["tokens"])})
    assert float(out["n_tokens"]) == 4 * 31
    assert not any(v.requires_grad for v in out.values())
