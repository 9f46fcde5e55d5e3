"""The port's beam search against the reference's `beam_search` on the
same weights (float32, CPU): tokens equal and scores within 1e-4 over
EOS x length penalty, ragged and batched prompts independent, k=1
equal to greedy, and the tiny-vocabulary ValueError."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.inference.beam import beam_search as ref_beam
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import beam_search, engine
from cloud_server_tpu_torch.models.transformer import params_from_numpy
from cloud_server_tpu_torch.utils import prng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
TCFG = TModelConfig(**dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def weights():
    ref = ref_tf.init_params(CFG, jax.random.key(0))
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), TCFG,
                                  device="cpu")


def _both(weights, prompts, lens=None, **kw):
    ref, port = weights
    rt, rs = ref_beam(ref, jnp.asarray(prompts, jnp.int32), cfg=CFG,
                      prompt_lengths=(None if lens is None
                                      else jnp.asarray(lens)), **kw)
    pt, ps = beam_search(port, torch.tensor(prompts), cfg=TCFG,
                         prompt_lengths=(None if lens is None
                                         else torch.tensor(lens)), **kw)
    return (np.asarray(rt), np.asarray(rs)), (pt.numpy(), ps.numpy())


@pytest.mark.parametrize("eos,pen", [(-1, 1.0), (7, 1.0), (7, 0.0)])
def test_beam_matches_reference(weights, eos, pen):
    (rt, rs), (pt, ps) = _both(weights, [[5, 9, 3]], k=3, max_new=5,
                               eos_token_id=eos, length_penalty=pen)
    assert pt.tolist() == rt.tolist()
    np.testing.assert_allclose(ps, rs, rtol=1e-4, atol=1e-4)


def test_beam_batched_prompts_independent(weights):
    """Each batch row's beams equal the row run alone, and a ragged batch
    equals the reference's."""
    _, port = weights
    prompts = [[5, 9, 3], [17, 2, 40]]
    both_t, both_s = beam_search(port, torch.tensor(prompts), cfg=TCFG,
                                 k=2, max_new=4, eos_token_id=-1)
    for i, p in enumerate(prompts):
        one_t, one_s = beam_search(port, torch.tensor([p]), cfg=TCFG, k=2,
                                   max_new=4, eos_token_id=-1)
        assert both_t[i].tolist() == one_t[0].tolist()
        np.testing.assert_allclose(both_s[i].numpy(), one_s[0].numpy(),
                                   rtol=1e-5)
    (rt, rs), (pt, ps) = _both(weights, [[5, 9, 3, 0], [17, 2, 40, 8]],
                               lens=[3, 4], k=2, max_new=4, eos_token_id=9)
    assert pt.tolist() == rt.tolist()
    np.testing.assert_allclose(ps, rs, rtol=1e-4, atol=1e-4)


def test_beam_k1_is_greedy(weights):
    """Width 1 with no EOS reduces to greedy decoding."""
    _, port = weights
    icfg = TInferConfig(max_decode_len=6, temperature=0.0, eos_token_id=-1,
                        pad_token_id=0)
    greedy = engine.generate(port, torch.tensor([[5, 9, 3]]), prng.key(0),
                             cfg=TCFG, infer_cfg=icfg)
    toks, _ = beam_search(port, torch.tensor([[5, 9, 3]]), cfg=TCFG, k=1,
                          max_new=6, eos_token_id=-1)
    assert toks[0, 0].tolist() == greedy[0].tolist()


def test_beam_tiny_vocab_rejected():
    """2k > vocab_size is the reference's ValueError; at 2k == V the
    search runs."""
    tiny = ModelConfig(
        vocab_size=6, embed_dim=32, num_layers=1, num_heads=2,
        num_kv_heads=2, head_dim=8, mlp_dim=32, max_seq_len=64,
        dtype="float32", param_dtype="float32", remat="none")
    ttiny = TModelConfig(**dataclasses.asdict(tiny))
    ref = ref_tf.init_params(tiny, jax.random.key(0))
    port = params_from_numpy(jax.tree.map(np.asarray, ref), ttiny,
                             device="cpu")
    with pytest.raises(ValueError) as want:
        ref_beam(ref, jnp.asarray([[1, 2]], jnp.int32), cfg=tiny, k=4,
                 max_new=4)
    with pytest.raises(ValueError) as got:
        beam_search(port, torch.tensor([[1, 2]]), cfg=ttiny, k=4, max_new=4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="max_len"):
        beam_search(port, torch.tensor([[1, 2]]), cfg=ttiny, k=2,
                    max_new=4, max_len=5)
    toks, scores = beam_search(port, torch.tensor([[1, 2]]), cfg=ttiny, k=3,
                               max_new=4)
    assert toks.shape == (1, 3, 4)
