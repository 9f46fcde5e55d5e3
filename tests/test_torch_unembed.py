"""The unembed in bfloat16: float32 logits from bfloat16 hidden states and
head, as the reference asks its compiler for them
(preferred_element_type=float32). Held against the reference on the CPU
within 1e-5 of the largest logit — a product rounded to bfloat16 first
errs by up to 2^-9 of each logit and fails this."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.models import transformer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_f32_on_the_cpu(dtype):
    """The float32-output product on the CPU: float32 operands multiply as
    they are, low-precision ones widened first (exact products), over
    leading axes, differentiable in both operands."""
    from cloud_server_tpu_torch.ops import matmul_f32
    r = np.random.default_rng(5)
    a = torch.from_numpy(r.standard_normal((2, 3, 16)).astype(np.float32))
    b = torch.from_numpy(r.standard_normal((16, 24)).astype(np.float32))
    a, b = a.to(dtype).requires_grad_(True), b.to(dtype).requires_grad_(True)
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32 and out.shape == (2, 3, 24)
    assert torch.equal(out.detach(), a.detach().float() @ b.detach().float())
    out.sum().backward()
    assert a.grad.dtype == dtype and b.grad.dtype == dtype
    assert a.grad.shape == a.shape and b.grad.shape == b.shape
