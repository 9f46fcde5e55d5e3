"""The port's contiguous engine against the reference's, on the same
weights in float32 on the CPU: prefill + decode against the full forward
and against the reference's logits (rtol = atol = 1e-4), greedy and
seeded `generate` token for token, EOS freezing, ragged prompts, top-k /
top-p sampling through the same threefry draws, `verify_step` (window
logits, lengths left alone), the int8 cache, the flash route's prefill
against the plain one, and the reference's ValueErrors."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference import engine as ref_engine
from cloud_server_tpu.inference.sampling import sample_logits as ref_sample
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import engine
from cloud_server_tpu_torch.inference.sampling import sample_logits
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import flash_attention as flash_mod
from cloud_server_tpu_torch.utils import prng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

TINY = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=64, dtype="float32",
    param_dtype="float32", remat="none")
TOL = dict(rtol=1e-4, atol=1e-4)


def _port(cfg=TINY):
    return TModelConfig(**dataclasses.asdict(cfg))


def _picfg(icfg):
    return TInferConfig(**dataclasses.asdict(icfg))


@pytest.fixture(scope="module")
def weights():
    ref = ref_tf.init_params(TINY, jax.random.key(0))
    port = transformer.params_from_numpy(jax.tree.map(np.asarray, ref),
                                         _port(), device="cpu")
    return ref, port


def _t(x):
    return torch.from_numpy(np.array(x)).long()


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_prefill_then_decode_matches_full_forward(weights, kv):
    """Teacher-forced cache decode reproduces the full forward, and the
    reference's cache decode step for step (the int8 cache against the
    reference's int8 cache)."""
    ref, port = weights
    cfg = dataclasses.replace(TINY, kv_cache_dtype=kv)
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (2, 12), 0,
                                           TINY.vocab_size))
    p = 6
    full = transformer.forward(port, _t(tokens), _port()).numpy()
    rc = ref_engine.init_cache(cfg, 2, 16)
    rl, rc = ref_engine.prefill(ref, jnp.asarray(tokens[:, :p]), cfg, rc)
    pc = engine.init_cache(_port(cfg), 2, 16)
    pl, pc = engine.prefill(port, _t(tokens[:, :p]), _port(cfg), pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
    if kv == "model":
        np.testing.assert_allclose(pl.numpy(), full[:, p - 1], **TOL)
    for t in range(p, 12):
        rl, rc = ref_engine.decode_step(ref, jnp.asarray(tokens[:, t]), cfg,
                                        rc)
        pl, pc = engine.decode_step(port, _t(tokens[:, t]), _port(cfg), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL,
                                   err_msg=f"step {t}")
        if kv == "model":
            np.testing.assert_allclose(pl.numpy(), full[:, t], **TOL)
    assert pc.length.tolist() == [12, 12]
    if kv == "int8":
        # the quantized entries the two caches hold are the same values
        np.testing.assert_array_equal(pc.k.numpy()[:, :, :12],
                                      np.asarray(rc.k)[:, :, :12])


def test_greedy_generate_matches_naive_rollout(weights):
    ref, port = weights
    prompt = np.asarray(jax.random.randint(jax.random.key(2), (2, 4), 0,
                                           TINY.vocab_size))
    icfg = InferConfig(max_decode_len=6, temperature=0.0)
    got = engine.generate(port, _t(prompt), prng.key(0), cfg=_port(),
                          infer_cfg=_picfg(icfg))
    seq = _t(prompt)
    naive = []
    for _ in range(6):
        nxt = transformer.forward(port, seq, _port())[:, -1].argmax(-1)
        naive.append(nxt)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    assert got.tolist() == torch.stack(naive, dim=1).tolist()
    want = ref_engine.generate(ref, jnp.asarray(prompt), jax.random.key(0),
                               cfg=TINY, infer_cfg=icfg)
    assert got.tolist() == np.asarray(want).tolist()


def test_eos_freezes_sequence_to_pad(weights):
    ref, port = weights
    prompt = np.zeros((1, 4), np.int32)
    base = engine.generate(port, _t(prompt), prng.key(0), cfg=_port(),
                           infer_cfg=_picfg(InferConfig(
                               max_decode_len=8, temperature=0.0)))
    eos = int(base[0, 0])
    icfg = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=eos,
                       pad_token_id=63)
    out = engine.generate(port, _t(prompt), prng.key(0), cfg=_port(),
                          infer_cfg=_picfg(icfg))
    assert int(out[0, 0]) == eos and (out[0, 1:] == 63).all()
    want = ref_engine.generate(ref, jnp.asarray(prompt), jax.random.key(0),
                               cfg=TINY, infer_cfg=icfg)
    assert out.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk1_equals_greedy(seed):
    logits = np.asarray(jax.random.normal(jax.random.key(seed), (4, 64)))
    greedy = sample_logits(torch.from_numpy(logits), prng.key(1),
                           _picfg(InferConfig(temperature=0.0)))
    topk1 = sample_logits(torch.from_numpy(logits), prng.key(1),
                          _picfg(InferConfig(temperature=1.0, top_k=1)))
    assert greedy.tolist() == topk1.tolist()


@pytest.mark.parametrize("top_p", [0.01, 0.0, -1.0])
def test_top_p_keeps_the_top_token(top_p):
    """top_p below the top token's mass keeps it; top_p <= 0 keeps the
    argmax instead of masking the whole vocabulary."""
    logits = torch.tensor([[10.0, 0.0, -10.0, -10.0]])
    icfg = InferConfig(temperature=1.0, top_p=top_p)
    tok = sample_logits(logits, prng.key(0), _picfg(icfg))
    want = ref_sample(jnp.asarray(logits.numpy()), jax.random.key(0), icfg)
    assert int(tok[0]) == int(want[0]) == 0


def test_ragged_prefill_decode_matches_unpadded(weights):
    """A right-padded ragged batch matches each prompt run unpadded, and
    the reference's ragged generate token for token."""
    ref, port = weights
    lens = [3, 6]
    p = max(lens)
    tokens = np.asarray(jax.random.randint(jax.random.key(7), (2, p), 1,
                                           TINY.vocab_size))
    padded = tokens * (np.arange(p)[None, :] < np.asarray(lens)[:, None])
    cache = engine.init_cache(_port(), 2, 16)
    logits, cache = engine.prefill(port, _t(padded), _port(), cache,
                                   torch.tensor(lens))
    ragged = []
    for _ in range(4):
        tok = logits.argmax(-1)
        ragged.append(tok)
        logits, cache = engine.decode_step(port, tok, _port(), cache)
    for i, ln in enumerate(lens):
        c = engine.init_cache(_port(), 1, 16)
        lg, c = engine.prefill(port, _t(tokens[i:i + 1, :ln]), _port(), c)
        for t in range(4):
            tok = lg.argmax(-1)
            assert int(tok[0]) == int(ragged[t][i]), (i, t)
            lg, c = engine.decode_step(port, tok, _port(), c)
    icfg = InferConfig(max_decode_len=5, temperature=0.0)
    want = ref_engine.generate(ref, jnp.asarray(padded), jax.random.key(0),
                               cfg=TINY, infer_cfg=icfg,
                               prompt_lengths=jnp.asarray(lens))
    got = engine.generate(port, _t(padded), prng.key(0), cfg=_port(),
                          infer_cfg=_picfg(icfg),
                          prompt_lengths=torch.tensor(lens))
    assert got.tolist() == np.asarray(want).tolist()


def test_sampling_distribution_respects_top_k():
    logits = torch.tensor([[0.0, 0.1, 0.2, 5.0]])
    icfg = InferConfig(temperature=1.0, top_k=2)
    toks = [int(sample_logits(logits, prng.key(i), _picfg(icfg))[0])
            for i in range(20)]
    assert set(toks) <= {2, 3}
    want = [int(ref_sample(jnp.asarray(logits.numpy()), jax.random.key(i),
                           icfg)[0]) for i in range(20)]
    assert toks == want


@pytest.mark.parametrize("icfg", [
    InferConfig(max_decode_len=7, temperature=0.8, top_k=10, top_p=0.9),
    InferConfig(max_decode_len=7, temperature=1.0, eos_token_id=5,
                pad_token_id=0)], ids=["top_k_top_p", "eos"])
@pytest.mark.parametrize("kv", ["model", "int8"])
def test_seeded_generate_matches_reference(weights, icfg, kv):
    """Seeded generate draws the reference's threefry stream (key
    split(key, n)[t] at step t): the same tokens, ragged, with either
    cache."""
    ref, port = weights
    cfg = dataclasses.replace(TINY, kv_cache_dtype=kv)
    prompt = np.asarray([[5, 9, 3, 7, 0], [17, 2, 40, 8, 21]], np.int32)
    lens = [4, 5]
    want = ref_engine.generate(ref, jnp.asarray(prompt), jax.random.key(3),
                               cfg=cfg, infer_cfg=icfg,
                               prompt_lengths=jnp.asarray(lens))
    got = engine.generate(port, _t(prompt), prng.key(3), cfg=_port(cfg),
                          infer_cfg=_picfg(icfg),
                          prompt_lengths=torch.tensor(lens))
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_verify_step_matches_reference(weights, kv):
    """A ragged (B, K) window: logits at every position equal the
    reference's, the cache holds the window's entries and the lengths are
    not advanced."""
    ref, port = weights
    cfg = dataclasses.replace(TINY, kv_cache_dtype=kv)
    prompt = np.asarray([[5, 9, 3, 7], [17, 2, 40, 8]], np.int32)
    lens = [3, 4]
    window = np.asarray([[11, 12, 13], [21, 22, 23]], np.int32)
    rc = ref_engine.init_cache(cfg, 2, 16)
    _, rc = ref_engine.prefill(ref, jnp.asarray(prompt), cfg, rc,
                               jnp.asarray(lens))
    rl, rc = ref_engine.verify_step(ref, jnp.asarray(window), cfg, rc)
    pc = engine.init_cache(_port(cfg), 2, 16)
    _, pc = engine.prefill(port, _t(prompt), _port(cfg), pc,
                           torch.tensor(lens))
    pl, pc = engine.verify_step(port, _t(window), _port(cfg), pc)
    assert pl.shape == (2, 3, TINY.vocab_size)
    np.testing.assert_allclose(pl.numpy(), np.asarray(rl), **TOL)
    assert pc.length.tolist() == lens
    for b, ln in enumerate(lens):
        np.testing.assert_allclose(
            pc.k[:, b, ln:ln + 3].float().numpy(),
            np.asarray(rc.k[:, b, ln:ln + 3], np.float32), **TOL)


def test_flash_route_prefill_matches_plain(weights):
    """attention_impl "flash" prefills through the flash wrapper (its
    plain version on the CPU) with the same logits and cache as the plain
    route, on a prompt the kernel would pad (S not a multiple of 64)."""
    _, port = weights
    tokens = np.asarray(jax.random.randint(jax.random.key(4), (2, 70), 0,
                                           TINY.vocab_size))
    out = {}
    for impl in ("xla", "flash"):
        cfg = _port(dataclasses.replace(TINY, attention_impl=impl,
                                        max_seq_len=128))
        calls = flash_mod.plain_calls
        cache = engine.init_cache(cfg, 2, 80)
        logits, cache = engine.prefill(port, _t(tokens), cfg, cache,
                                       torch.tensor([70, 41]))
        out[impl] = (logits, cache.k, flash_mod.plain_calls - calls)
    np.testing.assert_allclose(out["flash"][0].numpy(),
                               out["xla"][0].numpy(), **TOL)
    np.testing.assert_allclose(out["flash"][1].numpy(),
                               out["xla"][1].numpy(), **TOL)
    assert out["flash"][2] == TINY.num_layers and out["xla"][2] == 0


def test_refusals_match_the_reference(weights):
    """The reference's ValueErrors: an unknown cache dtype, the pallas
    and unknown decode impls, and a max_len the cache would wrap."""
    ref, port = weights
    for cfg, call in [
            (dataclasses.replace(TINY, kv_cache_dtype="fp8"),
             lambda m, c, p, e: m.init_cache(c, 1, 8)),
            (dataclasses.replace(TINY, decode_attention_impl="pallas"),
             lambda m, c, p, e: m.decode_step(
                 p, e(np.zeros(1, np.int32)), c, m.init_cache(c, 1, 8))),
            (dataclasses.replace(TINY, decode_attention_impl="triton"),
             lambda m, c, p, e: m.decode_step(
                 p, e(np.zeros(1, np.int32)), c, m.init_cache(c, 1, 8))),
            (TINY, lambda m, c, p, e: m.generate(
                p, e(np.zeros((1, 6), np.int32)),
                jax.random.key(0) if m is ref_engine else prng.key(0),
                cfg=c, infer_cfg=(InferConfig(max_decode_len=4)
                                  if m is ref_engine else
                                  _picfg(InferConfig(max_decode_len=4))),
                max_len=8))]:
        with pytest.raises(ValueError) as want:
            call(ref_engine, cfg, ref, jnp.asarray)
        with pytest.raises(ValueError) as got:
            call(engine, _port(cfg), port, _t)
        assert str(got.value) == str(want.value)
