"""The port's dense forward against the reference's on the same numpy
weights, float32 on the CPU (rtol 1e-4): a plain MHA config and one with
llama3 rope scaling and GQA. Also the weight loader and the on-device
initialisation's distribution."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.models import transformer

BASE = dict(vocab_size=97, embed_dim=32, num_layers=2, num_heads=4,
            head_dim=8, mlp_dim=64, max_seq_len=64, dtype="float32",
            param_dtype="float32", remat="none")
CONFIGS = {
    "mha": ModelConfig(num_kv_heads=4, **BASE),
    "llama3_gqa": ModelConfig(
        num_kv_heads=2, rope_theta=500000.0, rope_scaling="llama3",
        rope_scaling_factor=8.0, rope_low_freq_factor=1.0,
        rope_high_freq_factor=4.0, rope_original_max_len=16, norm_eps=1e-5,
        **BASE),
}


def _tcfg(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logits_match_reference(name):
    cfg = CONFIGS[name]
    ref_params = ref_tf.init_params(cfg, jax.random.key(3))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 19))
    want = np.asarray(ref_tf.forward(ref_params, jnp.asarray(tokens), cfg))
    params = transformer.params_from_numpy(
        jax.tree.map(np.asarray, ref_params), _tcfg(cfg), device="cpu")
    got = transformer.forward(params, torch.from_numpy(tokens), _tcfg(cfg))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_params_from_numpy_layouts_and_cast():
    cfg = dataclasses.replace(CONFIGS["llama3_gqa"], dtype="bfloat16")
    tree = jax.tree.map(np.asarray, ref_tf.init_params(cfg, jax.random.key(0)))
    params = transformer.params_from_numpy(tree, _tcfg(cfg), device="cpu")
    shapes = transformer.param_shapes(_tcfg(cfg))
    for group, leaves in shapes.items():
        for leaf, shape in leaves.items():
            t = params[group][leaf]
            assert tuple(t.shape) == shape
            assert t.dtype == torch.bfloat16
    assert tuple(params["layers"]["wq"].shape) == (2, 32, 4, 8)
    assert tuple(params["layers"]["wo"].shape) == (2, 4, 8, 32)
    assert tuple(params["lm_head"]["kernel"].shape) == (32, 97)


def test_init_params_distribution():
    """Same family as the reference's init: truncated normal at +-2 sd,
    std 1/sqrt(fan_in) before truncation; norm scales 1; reproducible
    from the seed."""
    cfg = _tcfg(dataclasses.replace(CONFIGS["mha"], embed_dim=256,
                                    mlp_dim=512))
    a = transformer.init_params(cfg, 5, device="cpu")
    b = transformer.init_params(cfg, 5, device="cpu")
    w = a["layers"]["w_gate"]
    assert torch.equal(w, b["layers"]["w_gate"])
    std = 1.0 / np.sqrt(256)
    assert float(w.abs().max()) <= 2 * std + 1e-6
    # a normal truncated at 2 sd keeps ~0.88 of the variance
    assert abs(float(w.std()) / std - 0.88) < 0.03
    assert torch.equal(a["layers"]["attn_norm"],
                       torch.ones_like(a["layers"]["attn_norm"]))


def test_unported_attention_impl_raises():
    cfg = _tcfg(dataclasses.replace(CONFIGS["mha"], attention_impl="ring"))
    params = transformer.init_params(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError):
        transformer.forward(params, torch.zeros((1, 4), dtype=torch.long),
                            cfg)


@pytest.mark.parametrize("make", ["init_params", "params_from_numpy"])
def test_params_default_to_cuda(make):
    """Without a device named the weights go to the card; without a card
    that raises, and nothing is drawn on the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _tcfg(CONFIGS["mha"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if make == "init_params":
            transformer.init_params(cfg, 0)
        else:
            transformer.params_from_numpy(
                {"final_norm": {"scale": np.ones((32,), np.float32)}}, cfg)
