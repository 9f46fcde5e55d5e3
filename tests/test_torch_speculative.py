"""The port's speculative rules (`inference/speculative.py`) and the
draws they consume against the reference's on the same numpy-seeded
inputs: n-gram proposals and accept counts exact, uniforms bit-exact,
tokens exact, probabilities within 1e-6; and `speculative_generate`
(draft model, self-draft and n-gram; greedy, EOS, ragged and seeded)
against the reference's on the same float32 weights, token for token."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference import sampling as ref_sampling
from cloud_server_tpu.inference import speculative as ref_spec
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.inference import sampling
from cloud_server_tpu_torch.inference import speculative as spec
from cloud_server_tpu_torch.utils import prng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

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


# ---------------------------------------------------------------------------
# speculative_generate, the batch API, against the reference's
# ---------------------------------------------------------------------------

SPEC_TARGET = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=512, dtype="float32",
    param_dtype="float32", remat="none")
SPEC_DRAFT = ModelConfig(
    vocab_size=64, embed_dim=16, num_layers=1, num_heads=2, num_kv_heads=2,
    head_dim=8, mlp_dim=32, max_seq_len=512, dtype="float32",
    param_dtype="float32", remat="none")


def _tcfg(cfg):
    from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
    return TModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def spec_models():
    """(reference params, port params) of the target and the draft."""
    from cloud_server_tpu.models import transformer as ref_tf
    from cloud_server_tpu_torch.models.transformer import params_from_numpy
    out = []
    for cfg, seed in ((SPEC_TARGET, 0), (SPEC_DRAFT, 1)):
        ref = ref_tf.init_params(cfg, jax.random.key(seed))
        out.append((ref, params_from_numpy(jax.tree.map(np.asarray, ref),
                                           _tcfg(cfg), device="cpu")))
    return out


def _greedy(n, eos=-1):
    return InferConfig(max_decode_len=n, temperature=0.0, eos_token_id=eos,
                       pad_token_id=0)


def _spec_both(spec_models, prompt, icfg, *, draft, g, seed=3, lens=None):
    """The reference's and the port's speculative_generate on the same
    weights, prompt and key; draft "model", "self" or None (n-gram)."""
    from cloud_server_tpu.inference.speculative import (
        speculative_generate as ref_spec)
    from cloud_server_tpu_torch.inference.speculative import (
        speculative_generate)
    (rt, pt), (rd, pd) = spec_models
    dcfg = {"model": SPEC_DRAFT, "self": SPEC_TARGET, None: None}[draft]
    rdp = {"model": rd, "self": rt, None: None}[draft]
    pdp = {"model": pd, "self": pt, None: None}[draft]
    want = ref_spec(rt, rdp, jnp.asarray(prompt, jnp.int32),
                    jax.random.key(seed), cfg=SPEC_TARGET, draft_cfg=dcfg,
                    infer_cfg=icfg, num_draft=g,
                    prompt_lengths=None if lens is None
                    else jnp.asarray(lens, jnp.int32))
    got = speculative_generate(
        pt, pdp, torch.tensor(np.asarray(prompt)), prng.key(seed),
        cfg=_tcfg(SPEC_TARGET),
        draft_cfg=None if dcfg is None else _tcfg(dcfg),
        infer_cfg=TInferConfig(**dataclasses.asdict(icfg)), num_draft=g,
        prompt_lengths=None if lens is None else torch.tensor(lens))
    return np.asarray(want), got.numpy()


def _generate(spec_models, prompt, icfg, lens=None):
    from cloud_server_tpu_torch.inference import engine
    pt = spec_models[0][1]
    return engine.generate(
        pt, torch.tensor(np.asarray(prompt)), prng.key(2),
        cfg=_tcfg(SPEC_TARGET),
        infer_cfg=TInferConfig(**dataclasses.asdict(icfg)),
        prompt_lengths=None if lens is None else torch.tensor(lens)).numpy()


@pytest.mark.parametrize("draft", ["model", None],
                         ids=["draft_model", "ngram"])
def test_greedy_exact_vs_generate(spec_models, draft):
    """Greedy speculative output equals plain greedy generate and the
    reference's speculative output, whatever the drafts propose."""
    icfg = _greedy(24)
    prompt = np.random.RandomState(0).randint(1, 64, (2, 8))
    want, got = _spec_both(spec_models, prompt, icfg, draft=draft, g=4)
    assert got.tolist() == want.tolist()
    assert got.tolist() == _generate(spec_models, prompt, icfg).tolist()


def test_greedy_exact_self_draft(spec_models):
    icfg = _greedy(16)
    want, got = _spec_both(spec_models, [[3, 7, 11, 2]], icfg, draft="self",
                           g=3)
    assert got.tolist() == want.tolist()
    assert got.tolist() == _generate(spec_models, [[3, 7, 11, 2]],
                                     icfg).tolist()


def test_ragged_prompts_greedy(spec_models):
    icfg = _greedy(12)
    ragged = [[5, 9, 3, 17, 6, 2], [8, 4, 1, 0, 0, 0]]
    want, got = _spec_both(spec_models, ragged, icfg, draft="model", g=4,
                           lens=[6, 3])
    assert got.tolist() == want.tolist()
    assert got[1].tolist() == _generate(spec_models, [[8, 4, 1]],
                                        icfg)[0].tolist()


@pytest.mark.parametrize("at", [0, 2], ids=["first_token", "third_token"])
def test_eos_stops_and_pads(spec_models, at):
    """Whichever token greedy emits at position `at` becomes the eos id:
    it is emitted (the very first token too) and the rest pads, as in
    generate and the reference."""
    prompt = [[3, 1, 4]]
    eos = int(_generate(spec_models, prompt, _greedy(16))[0, at])
    icfg = _greedy(16, eos=eos)
    want, got = _spec_both(spec_models, prompt, icfg, draft="model", g=4)
    assert got.tolist() == want.tolist()
    assert got.tolist() == _generate(spec_models, prompt, icfg).tolist()
    pos = list(got[0]).index(eos)
    assert (got[0, pos + 1:] == 0).all()


@pytest.mark.parametrize("draft", ["model", None],
                         ids=["draft_model", "ngram"])
def test_temperature_matches_reference(spec_models, draft):
    """At temperature 0.8 / top-k 20 the draws follow the reference's
    key stream: the same tokens."""
    icfg = InferConfig(max_decode_len=20, temperature=0.8, top_k=20,
                       eos_token_id=-1, pad_token_id=0)
    want, got = _spec_both(spec_models, [[3, 7], [9, 2]], icfg, draft=draft,
                           g=4, seed=5)
    assert got.shape == (2, 20)
    assert got.tolist() == want.tolist()


def test_ngram_greedy_exact_repetitive_prompt(spec_models):
    icfg = _greedy(20)
    ragged = [[5, 9, 3] * 5, [7, 2, 7, 2, 7, 2, 7, 2] + [0] * 7]
    want, got = _spec_both(spec_models, ragged, icfg, draft=None, g=3,
                           seed=1, lens=[15, 8])
    assert got.tolist() == want.tolist()
    for i, doc in enumerate(([5, 9, 3] * 5, [7, 2] * 4)):
        assert got[i].tolist() == _generate(spec_models, [doc],
                                            icfg)[0].tolist()


def test_ngram_mismatched_args_raise(spec_models):
    from cloud_server_tpu_torch.inference.speculative import (
        speculative_generate)
    (_, pt), (_, pd) = spec_models
    icfg = TInferConfig(**dataclasses.asdict(_greedy(4)))
    for dp, dc in ((None, _tcfg(SPEC_DRAFT)), (pd, None)):
        with pytest.raises(ValueError, match="together"):
            speculative_generate(pt, dp, torch.tensor([[1, 2]]),
                                 prng.key(0), cfg=_tcfg(SPEC_TARGET),
                                 draft_cfg=dc, infer_cfg=icfg)
