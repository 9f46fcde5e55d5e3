"""The unembed in bfloat16: float32 logits from bfloat16 hidden states and
head, as the reference asks its compiler for them
(preferred_element_type=float32). Held against the reference on the CPU
within 1e-5 of the largest logit — a product rounded to bfloat16 first
errs by up to 2^-9 of each logit and fails this."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.models import transformer

CFG = ModelConfig(vocab_size=300, embed_dim=64, num_layers=1, num_heads=4,
                  num_kv_heads=4, head_dim=16, mlp_dim=128, max_seq_len=32,
                  dtype="bfloat16", param_dtype="float32")


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_unembed_bf16_gives_f32_logits_of_the_reference(softcap):
    cfg = dataclasses.replace(CFG, logits_softcap=softcap)
    r = np.random.default_rng(11)
    x = r.standard_normal((3, 5, cfg.embed_dim)).astype(np.float32)
    head = (r.standard_normal((cfg.embed_dim, cfg.vocab_size))
            / np.sqrt(cfg.embed_dim)).astype(np.float32) * 4
    x_bf = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(ref_tf.unembed(x_bf, {"lm_head": {"kernel": head}},
                                     cfg))
    tcfg = TModelConfig(**dataclasses.asdict(cfg))
    got = transformer.unembed(
        torch.from_numpy(np.asarray(x_bf.astype(jnp.float32))).to(
            torch.bfloat16),
        {"lm_head": {"kernel": torch.from_numpy(head)}}, tcfg)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
