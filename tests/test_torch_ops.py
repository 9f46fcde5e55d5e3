"""The port's plain ops against the reference's, in float32 on the CPU:
rms_norm, rope (none / linear / llama3 scaling), swiglu and
causal_attention. Inputs are numpy arrays from a seed, fed to both."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.ops import activations as ref_act
from cloud_server_tpu.ops import attention as ref_attn
from cloud_server_tpu.ops import norms as ref_norms
from cloud_server_tpu.ops import rope as ref_rope
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.ops import activations, attention, norms, rope

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=atol)


def test_rms_norm():
    r = _rng()
    x = r.standard_normal((3, 5, 16)).astype(np.float32)
    s = r.standard_normal((16,)).astype(np.float32)
    _close(norms.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
           ref_norms.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("scaling", [
    {}, {"rope_scaling": "linear", "rope_scaling_factor": 4.0},
    {"rope_scaling": "llama3", "rope_scaling_factor": 8.0,
     "rope_low_freq_factor": 1.0, "rope_high_freq_factor": 4.0,
     "rope_original_max_len": 64}])
def test_rope_table_and_apply(scaling):
    cfg = ModelConfig(head_dim=16, rope_theta=500000.0, **scaling)
    tcfg = TModelConfig(**dataclasses.asdict(cfg))
    cos_r, sin_r = ref_rope.rope_table(cfg, 96)
    cos_t, sin_t = rope.rope_table(tcfg, 96)
    _close(cos_t, cos_r)
    _close(sin_t, sin_r)
    r = _rng(1)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = r.integers(0, 96, (2, 7))
    _close(rope.apply_rope(torch.from_numpy(x), cos_t, sin_t,
                           torch.from_numpy(pos)),
           ref_rope.apply_rope(jnp.asarray(x), cos_r, sin_r,
                               jnp.asarray(pos)))


def test_swiglu():
    r = _rng(2)
    g = r.standard_normal((4, 9)).astype(np.float32)
    u = r.standard_normal((4, 9)).astype(np.float32)
    _close(activations.swiglu(torch.from_numpy(g), torch.from_numpy(u)),
           ref_act.swiglu(jnp.asarray(g), jnp.asarray(u)))


@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2)])
@pytest.mark.parametrize("decode", [False, True])
def test_causal_attention(h, kh, decode):
    r = _rng(3)
    b, sq, skv, d = 2, (3 if decode else 12), 12, 8
    q = r.standard_normal((b, sq, h, d)).astype(np.float32)
    k = r.standard_normal((b, skv, kh, d)).astype(np.float32)
    v = r.standard_normal((b, skv, kh, d)).astype(np.float32)
    kw_r, kw_t = {}, {}
    if decode:
        lens = np.asarray([7, 12], np.int32)
        pos = lens[:, None] - sq + np.arange(sq)[None]
        kw_r = dict(q_positions=jnp.asarray(pos), kv_length=jnp.asarray(lens))
        kw_t = dict(q_positions=torch.from_numpy(pos),
                    kv_length=torch.from_numpy(lens))
    want = ref_attn.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw_r)
    got = attention.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), **kw_t)
    _close(got, want)
    assert attention.NEG_INF == ref_attn.NEG_INF
