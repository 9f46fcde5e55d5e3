"""The port's sampling against the reference's: the per-row filter chain
(filtered_logits_rows), greedy argmax, and the top-k / top-p masks. The
per-request path draws from jax.random's threefry2x32, ported bit for
bit (`utils/prng.py`): its key, fold_in and bits equal jax's, its Gumbel
noise is within one float32 ulp of jax's (the two logs round
differently), and seeded draws are the reference's token for token. The
server-global path draws from one key over the whole (rows, V) logits,
as jax.random.categorical does, and is the reference's token for token
too."""

import os
import sys
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig
from cloud_server_tpu.inference import sampling as ref_s
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.inference import sampling
from cloud_server_tpu_torch.utils import prng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

V = 50


def _logits(seed, b=4):
    # a moderate spread: with top_p = 1 the cumulative mass of the last
    # tokens must not round across 1.0 (a float tie both versions may
    # break either way)
    return np.random.default_rng(seed).standard_normal((b, V)).astype(
        np.float32)


def _rows(params):
    cfg = InferConfig(temperature=0.7, top_k=0, top_p=1.0)
    ref_rows = ref_s.make_rows(params, cfg, [11, 12, 13, 14],
                               prompt_lens=[3, 3, 3, 3])
    port_rows = sampling.make_rows(
        [None if p is None else sampling.SamplingParams(**p.__dict__)
         for p in params], TInferConfig(temperature=0.7), [11, 12, 13, 14],
        prompt_lens=[3, 3, 3, 3])
    for a, b in zip(ref_rows, port_rows):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return ref_rows, sampling.rows_to(port_rows, "cpu")


PARAMS = [None,
          ref_s.SamplingParams(temperature=1.3, top_k=5),
          ref_s.SamplingParams(top_p=0.6, min_p=0.05),
          ref_s.SamplingParams(temperature=0.0, logit_bias=((3, 4.0),))]


@pytest.mark.parametrize("extras", [False, True])
def test_filtered_logits_rows_match_reference(extras):
    """The whole chain; with `extras` also the allowed-token mask,
    penalties and the min_tokens EOS suppression."""
    params = PARAMS
    if extras:
        params = PARAMS[:3] + [ref_s.SamplingParams(
            repetition_penalty=1.3, presence_penalty=0.5,
            frequency_penalty=0.2, min_tokens=4)]
    ref_rows, rows = _rows(params)
    x = _logits(0)
    kw_r, kw_t = {}, {}
    if extras:
        r = np.random.default_rng(9)
        arrays = dict(prompt_mask=r.random((4, V)) < 0.2,
                      out_counts=r.integers(0, 3, (4, V)).astype(np.int32),
                      allowed_mask=r.random((4, V)) < 0.8,
                      positions=np.asarray([4, 5, 6, 5], np.int32))
        kw_r = {k: jnp.asarray(v) for k, v in arrays.items()}
        kw_t = {k: torch.from_numpy(v) for k, v in arrays.items()}
        kw_r["eos_id"] = kw_t["eos_id"] = 7
    want_f, want_raw = ref_s.filtered_logits_rows(
        jnp.asarray(x), ref_rows._replace(
            **{k: jnp.asarray(v) for k, v in ref_rows._asdict().items()}),
        **kw_r)
    got_f, got_raw = sampling.filtered_logits_rows(torch.from_numpy(x), rows,
                                                   **kw_t)
    # entries at or below -1e29 are impossible tokens in both versions;
    # how far below (a masked logit scaled by a penalty or temperature)
    # can differ where a float tie decides the top-p tail
    def floor(a):
        return np.maximum(np.asarray(a), -1e29)

    np.testing.assert_allclose(floor(got_raw.numpy()), floor(want_raw),
                               atol=1e-5)
    np.testing.assert_allclose(floor(got_f.numpy()), floor(want_f),
                               atol=1e-5, rtol=1e-5)


def test_greedy_argmax():
    x = _logits(1)
    cfg = TInferConfig(temperature=0.0)
    got = sampling.sample_logits(torch.from_numpy(x), None, cfg)
    want = ref_s.sample_logits(jnp.asarray(x), None, InferConfig(
        temperature=0.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # greedy rows of the per-row path take the argmax of the raw logits
    _, rows = _rows(PARAMS)
    toks = sampling.sample_logits_rows(torch.from_numpy(x), rows,
                                       torch.full((4,), 5))
    assert int(toks[3]) == int(np.argmax(x[3] + 4.0 * (np.arange(V) == 3)))


@pytest.mark.parametrize("k,p", [(5, 1.0), (0, 0.5), (7, 0.3)])
def test_top_k_top_p_masks(k, p):
    x = _logits(2)
    cfg = InferConfig(temperature=0.8, top_k=k, top_p=p)
    want = ref_s._filtered_logits(jnp.asarray(x), cfg)
    got = sampling._filtered_logits(torch.from_numpy(x), TInferConfig(
        temperature=0.8, top_k=k, top_p=p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_draws_follow_the_filtered_distribution():
    """Frequencies of many seeded draws match softmax(filtered logits)."""
    x = torch.from_numpy(_logits(3, b=1)).repeat(4000, 1)
    cfg = TInferConfig(temperature=1.0, top_k=6)
    toks = sampling.sample_logits(x, prng.key(0), cfg)
    probs = torch.softmax(sampling._filtered_logits(x[:1], cfg), -1)[0]
    freq = torch.bincount(toks, minlength=V).float() / len(toks)
    assert float((freq - probs).abs().max()) < 0.03
    assert set(toks.tolist()) <= set(torch.topk(x[0], 6).indices.tolist())


def test_row_draws_depend_only_on_seed_and_position():
    """A row's draw is a function of (seed, position) alone: the same row
    beside other rows, at another batch index, gives the same token."""
    x = torch.from_numpy(_logits(5, b=1)).repeat(3, 1)
    _, rows = _rows([ref_s.SamplingParams(seed=7, temperature=1.0)] * 4)
    rows3 = sampling.SamplingRows(*(t[:3] for t in rows))
    alone = sampling.sample_logits_rows(x[:1], sampling.SamplingRows(
        *(t[:1] for t in rows)), torch.tensor([9]))
    crowd = sampling.sample_logits_rows(x, rows3, torch.tensor([4, 9, 2]))
    assert int(crowd[1]) == int(alone[0])
    k1 = prng.fold_in(prng.key(torch.tensor([7, 9])), torch.tensor([3, 3]))
    k2 = prng.fold_in(prng.key(torch.tensor([1, 7])), torch.tensor([0, 3]))
    assert torch.equal(k1[0], k2[1]) and not torch.equal(k1[0], k1[1])
    u = prng.gumbel_low(k1, 1000)
    assert bool(torch.isfinite(u).all())
    # Gumbel(0, 1): mean is the Euler-Mascheroni constant
    assert abs(float(u.mean()) - 0.5772) < 0.1


@pytest.mark.parametrize("seed", [0, 7, 2 ** 32 - 3])
def test_split_and_2d_bits_match_jax_random(seed):
    """split(k, n) and a (rows, V) bits/gumbel draw equal jax.random's:
    the partitionable layout numbers the elements of the whole shape, so
    row r of a (R, V) draw is the flat run [r V, (r + 1) V)."""
    k = prng.key(torch.tensor(seed))
    jk = jax.random.key(seed)
    for n in (1, 2, 8):
        np.testing.assert_array_equal(
            prng.split(k, n).numpy(), np.asarray(jax.random.key_data(
                jax.random.split(jk, n))).astype(np.int64))
    sub = prng.split(prng.split(k, 2)[1], 4)[3]
    jsub = jax.random.split(jax.random.split(jk)[1], 4)[3]
    np.testing.assert_array_equal(
        prng.bits(sub, (3, 77)).numpy(),
        np.asarray(jax.random.bits(jsub, (3, 77))).astype(np.int64))
    np.testing.assert_allclose(
        prng.gumbel_low(sub, (5, 33)).numpy(),
        np.asarray(jax.random.gumbel(jsub, (5, 33))), rtol=0, atol=2e-6)
    # the host's split on plain ints: the server's `_next_rng`
    words = prng.threefry2x32(0, seed, 0, 1)
    np.testing.assert_array_equal(
        np.asarray(words), prng.split(k, 2)[1].numpy())


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (7, 1.0), (0, 0.7)])
def test_server_global_draws_match_reference(top_k, top_p):
    """sample_logits(logits, key, cfg) over (rows, V) logits: the
    reference's jax.random.categorical tokens, for 64 keys down a split
    chain and rows at a moderate logit spread."""
    cfg = InferConfig(temperature=0.8, top_k=top_k, top_p=top_p)
    tcfg = TInferConfig(temperature=0.8, top_k=top_k, top_p=top_p)
    x = (np.random.default_rng(3).standard_normal((6, V)) * 1.5).astype(
        np.float32)
    jk, k = jax.random.key(11), prng.key(torch.tensor(11))
    for _ in range(64):
        jk, jsub = jax.random.split(jk)
        k, sub = prng.split(k, 2)
        want = ref_s.sample_logits(jnp.asarray(x), jsub, cfg)
        got = sampling.sample_logits(torch.from_numpy(x), sub, tcfg)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 32 - 1])
def test_threefry_matches_jax_random(seed):
    """key, fold_in and bits equal jax.random's bit for bit (partitionable
    threefry, jax's default); the Gumbel draws agree to one float32 ulp
    at their size (|g| < 16 here: 2e-6)."""
    positions = [0, 1, 77, 2 ** 31 + 5]
    keys = prng.fold_in(prng.key(torch.tensor([seed] * len(positions))),
                        torch.tensor(positions))
    for i, pos in enumerate(positions):
        want = jax.random.fold_in(jax.random.key(seed), pos)
        np.testing.assert_array_equal(
            keys[i].numpy(),
            np.asarray(jax.random.key_data(want)).astype(np.int64))
        np.testing.assert_array_equal(
            prng.bits(keys[i], 513).numpy(),
            np.asarray(jax.random.bits(want, (513,))).astype(np.int64))
        np.testing.assert_allclose(
            prng.gumbel_low(keys[i], 513).numpy(),
            np.asarray(jax.random.gumbel(want, (513,))), rtol=0, atol=2e-6)


def test_seeded_row_draws_match_reference_token_for_token():
    """300 seeded rows with temperature, top-k, top-p and min-p at a
    moderate logit spread, at scattered positions: the same tokens as the
    reference's jax.vmap(jax.random.categorical) draws."""
    b = 300
    r = np.random.default_rng(21)
    kinds = [dict(temperature=0.9), dict(temperature=1.2, top_k=8),
             dict(temperature=0.7, top_p=0.8),
             dict(temperature=1.0, min_p=0.05)]
    params = [ref_s.SamplingParams(seed=int(r.integers(0, 2 ** 32)),
                                   **kinds[i % 4]) for i in range(b)]
    ref_rows = ref_s.make_rows(params, InferConfig(temperature=0.7),
                               list(range(b)), prompt_lens=[3] * b)
    port_rows = sampling.make_rows(
        [sampling.SamplingParams(**p.__dict__) for p in params],
        TInferConfig(temperature=0.7), list(range(b)), prompt_lens=[3] * b)
    x = (r.standard_normal((b, V)) * 1.5).astype(np.float32)
    pos = r.integers(0, 5000, b).astype(np.int32)
    want = ref_s.sample_logits_rows(
        jnp.asarray(x), ref_rows._replace(
            **{k: jnp.asarray(v) for k, v in ref_rows._asdict().items()}),
        jnp.asarray(pos), use_bias=False)
    got = sampling.sample_logits_rows(
        torch.from_numpy(x), sampling.rows_to(port_rows, "cpu"),
        torch.from_numpy(pos), use_bias=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [False, True], ids=["rows", "window"])
@pytest.mark.parametrize("use_bias", [False, True])
def test_sampling_probs_rows_match_reference(window, use_bias):
    """The distribution speculation's accept rule compares against:
    penalties (per window position, cumulative counts), logit_bias,
    min_tokens and the allowed-token mask, within 1e-6; greedy rows are
    one-hot."""
    params = [ref_s.SamplingParams(repetition_penalty=1.3,
                                   presence_penalty=0.5,
                                   frequency_penalty=0.2, min_tokens=4),
              ref_s.SamplingParams(temperature=1.3, top_k=5,
                                   logit_bias=((3, 4.0), (7, -2.0))),
              ref_s.SamplingParams(top_p=0.6, min_p=0.05,
                                   presence_penalty=0.3),
              ref_s.SamplingParams(temperature=0.0, logit_bias=((3, 4.0),),
                                   frequency_penalty=0.4)]
    ref_rows, rows = _rows(params)
    r = np.random.default_rng(3)
    w = 3 if window else None
    shape = (4, w, V) if window else (4, V)
    x = r.standard_normal(shape).astype(np.float32)
    arrays = dict(prompt_mask=r.random((4, V)) < 0.2,
                  out_counts=r.integers(0, 3, shape).astype(np.int32),
                  allowed_mask=r.random(shape) < 0.8,
                  positions=(np.asarray([[4, 5, 6]] * 4, np.int32)
                             if window else
                             np.asarray([4, 5, 6, 5], np.int32)))
    arrays["allowed_mask"][..., 7] = True  # EOS stays allowed
    kw_r = {k: jnp.asarray(v) for k, v in arrays.items()}
    kw_t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    want = ref_s.sampling_probs_rows(
        jnp.asarray(x), ref_rows._replace(
            **{k: jnp.asarray(v) for k, v in ref_rows._asdict().items()}),
        eos_id=7, use_bias=use_bias, **kw_r)
    got = sampling.sampling_probs_rows(torch.from_numpy(x), rows, eos_id=7,
                                       use_bias=use_bias, **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # row 0 is held below min_tokens at position 4: EOS impossible
    assert float(got[0, ..., 7].max()) == 0.0
    assert set(np.unique(got[3].numpy())) <= {0.0, 1.0}
