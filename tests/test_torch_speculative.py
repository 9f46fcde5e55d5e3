"""The port's speculative rules (`inference/speculative.py`) and the
draws they consume against the reference's on the same numpy-seeded
inputs: n-gram proposals and accept counts exact, uniforms bit-exact,
tokens exact, probabilities within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig
from cloud_server_tpu.inference import sampling as ref_sampling
from cloud_server_tpu.inference import speculative as ref_spec
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.inference import sampling
from cloud_server_tpu_torch.inference import speculative as spec
from cloud_server_tpu_torch.utils import prng

B, G, V = 6, 3, 40


def _key_words(key) -> torch.Tensor:
    return torch.as_tensor(np.asarray(jax.random.key_data(key), np.int64))


def _probs(rng, shape, sharp=1.0):
    x = rng.standard_normal(shape).astype(np.float32) * sharp
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_uniform_and_categorical_bits_match_jax():
    key = jax.random.key(11)
    tk = _key_words(key)
    assert np.array_equal(np.asarray(jax.random.uniform(key, (B, G))),
                          prng.uniform(tk, (B, G)).numpy())
    logits = np.random.default_rng(0).standard_normal((B, V)).astype(
        np.float32)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits)))
    got = prng.categorical(tk, torch.as_tensor(logits)).numpy()
    assert np.array_equal(want, got)


def test_row_pos_keys_and_keyed_draws_match():
    rng = np.random.default_rng(1)
    seeds = rng.integers(0, 2 ** 32, (B,), dtype=np.uint32)
    pos = rng.integers(0, 500, (B,), dtype=np.int32)
    for tag in (spec._TAG_DRAFT, spec._TAG_ACCEPT, spec._TAG_RESIDUAL):
        want = np.asarray(jax.random.key_data(ref_spec._row_pos_keys(
            jnp.asarray(seeds), jnp.asarray(pos), tag)))
        got = spec._row_pos_keys(torch.as_tensor(seeds.astype(np.int64)),
                                 torch.as_tensor(pos.astype(np.int64)), tag)
        assert np.array_equal(want, got.numpy())
    probs = _probs(rng, (B, V), 2.0)
    keys = ref_spec._row_pos_keys(jnp.asarray(seeds), jnp.asarray(pos), 7)
    want = np.asarray(ref_spec.sample_from_probs_keyed(jnp.asarray(probs),
                                                       keys))
    got = spec.sample_from_probs_keyed(
        torch.as_tensor(probs), torch.as_tensor(np.asarray(
            jax.random.key_data(keys), np.int64)))
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("keyed", [False, True])
def test_accept_uniforms_bit_exact(keyed):
    rng = np.random.default_rng(2)
    key = jax.random.key(5)
    seeds = rng.integers(0, 2 ** 32, (B,), dtype=np.uint32)
    pos0 = rng.integers(0, 300, (B,), dtype=np.int32)
    want = np.asarray(ref_spec._accept_uniforms(
        key, B, G, jnp.asarray(seeds) if keyed else None,
        jnp.asarray(pos0) if keyed else None))
    got = spec._accept_uniforms(
        _key_words(key), B, G,
        torch.as_tensor(seeds.astype(np.int64)) if keyed else None,
        torch.as_tensor(pos0.astype(np.int64)) if keyed else None)
    assert np.array_equal(want, got.numpy())


def _ngram_case(seed):
    rng = np.random.default_rng(seed)
    hl = 24
    hist = rng.integers(1, 5, (B, hl)).astype(np.int32)
    valid = rng.integers(3, hl + 1, (B,)).astype(np.int32)
    t2 = hist[np.arange(B), np.maximum(valid - 2, 0)]
    t1 = hist[np.arange(B), valid - 1]
    return hist, valid, t2, t1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_drafts_match(seed):
    hist, valid, t2, t1 = _ngram_case(seed)
    want = np.asarray(ref_spec._ngram_drafts(
        jnp.asarray(hist), jnp.asarray(valid), jnp.asarray(t2),
        jnp.asarray(t1), G, 0))
    got = spec._ngram_drafts(torch.as_tensor(hist),
                             torch.as_tensor(valid).long(),
                             torch.as_tensor(t2).long(),
                             torch.as_tensor(t1).long(), G, 0)
    assert np.array_equal(want, got.numpy())
    assert (want != 0).any()  # some rows really found a bigram


def _windows(seed, sharp):
    rng = np.random.default_rng(seed)
    p = _probs(rng, (B, G + 1, V), sharp)
    q = _probs(rng, (B, G, V), sharp)
    # drafts: the target's argmax on some rows (they accept), noise
    # elsewhere (they reject at a random depth)
    drafts = rng.integers(0, V, (B, G)).astype(np.int32)
    drafts[: B // 2] = p[: B // 2, :G].argmax(-1)
    seeds = rng.integers(0, 2 ** 32, (B,), dtype=np.uint32)
    pos0 = rng.integers(0, 300, (B,), dtype=np.int32)
    return p, q, drafts, seeds, pos0


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("point_mass", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_accept_rule_matches(keyed, point_mass, seed):
    p, q, drafts, seeds, pos0 = _windows(seed, 4.0)
    key = jax.random.key(seed + 3)
    kw_ref = (dict(seeds=jnp.asarray(seeds), pos0=jnp.asarray(pos0))
              if keyed else {})
    kw = (dict(seeds=torch.as_tensor(seeds.astype(np.int64)),
               pos0=torch.as_tensor(pos0.astype(np.int64)))
          if keyed else {})
    tk = _key_words(key)
    if point_mass:
        want = ref_spec._accept_point_mass(jnp.asarray(drafts),
                                           jnp.asarray(p), key, **kw_ref)
        got = spec._accept_point_mass(torch.as_tensor(drafts),
                                      torch.as_tensor(p), tk, **kw)
    else:
        want = ref_spec._accept_drafts(jnp.asarray(drafts), jnp.asarray(q),
                                       jnp.asarray(p), key, **kw_ref)
        got = spec._accept_drafts(torch.as_tensor(drafts),
                                  torch.as_tensor(q), torch.as_tensor(p),
                                  tk, **kw)
    n_want, x_want = map(np.asarray, want)
    assert np.array_equal(n_want, got[0].numpy())
    assert np.array_equal(x_want, got[1].numpy())
    assert len(set(n_want.tolist())) > 1  # accepts and rejects both seen


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(0.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 8, 0.9)])
def test_sampling_probs_and_draw_match(temperature, top_k, top_p):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((B, G + 1, V)).astype(np.float32) * 3
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    want = np.asarray(ref_sampling.sampling_probs(jnp.asarray(logits),
                                                  InferConfig(**kw)))
    got = sampling.sampling_probs(torch.as_tensor(logits),
                                  TInferConfig(**kw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    key = jax.random.key(9)
    tok_want = np.asarray(ref_sampling.sample_from_probs(
        jnp.asarray(want[:, 0]), key))
    tok_got = sampling.sample_from_probs(torch.tensor(want[:, 0]),
                                         _key_words(key)).numpy()
    assert np.array_equal(tok_want, tok_got)
