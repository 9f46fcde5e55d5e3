"""The port's LoRA module (the serving half of the reference's
tests/test_lora.py): config validation, the zero-init adapter, the merge
math and the config sidecar, each held against the reference's
`models/lora.py` on the same numpy inputs; the per-row delta and the
transformer blocks' `lora=` arguments against the reference's; merged
weights served by the port's server against the reference's server on
the reference's merge. Training (A18) and MoE adapters are not ported:
their target table refuses."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.models import lora as ref_lora
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.models import lora
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.models.transformer import params_from_numpy
from cloud_server_tpu_torch.ops import rope_table

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
TCFG = TModelConfig(**dataclasses.asdict(CFG))
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
SRV_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])
PROMPTS = [[5, 9, 3], [17, 2, 40, 8, 21], [60]]
ALL = tuple(sorted(lora._DENSE_TARGETS))


@pytest.fixture(scope="module")
def weights():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    return ref, params_from_numpy(jax.tree.map(np.asarray, ref), TCFG,
                                  device="cpu")


def _np_adapter(lcfg, seed):
    """An adapter as numpy arrays in the reference's layout, with a
    non-zero B (the delta is real)."""
    rng = np.random.default_rng(seed)
    shapes = ref_transformer.param_shapes(CFG)["layers"]
    out = {"layers": {}}
    for name in sorted(lcfg.targets):
        _, fan_in, fan_out = ref_lora._split_dims(name, shapes[name])
        out["layers"][name] = {
            "a": (rng.standard_normal((CFG.num_layers, fan_in, lcfg.rank))
                  / np.sqrt(fan_in)).astype(np.float32),
            "b": (0.3 * rng.standard_normal(
                (CFG.num_layers, lcfg.rank, fan_out))).astype(np.float32)}
    return out


def _port_lcfg(lcfg):
    return lora.LoRAConfig(**dataclasses.asdict(lcfg))


def _torch_tree(tree):
    return jax.tree.map(torch.from_numpy, tree)


def test_config_validation():
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        lora.LoRAConfig(targets=("wq", "nope"))
    with pytest.raises(ValueError, match="rank"):
        lora.LoRAConfig(rank=0)
    # the reference's target names, MoE's "router" included, validate
    assert set(lora._TARGETS) == set(ref_lora._TARGETS)
    assert lora._DENSE_TARGETS == ref_lora._DENSE_TARGETS
    assert lora.DEFAULT_TARGETS == ref_lora.DEFAULT_TARGETS
    assert lora.LoRAConfig(rank=4, alpha=8.0).scale == 2.0


def test_moe_target_table_refused():
    assert lora._target_table() is lora._DENSE_TARGETS
    with pytest.raises(NotImplementedError, match="MoE"):
        lora._target_table(object())
    with pytest.raises(ValueError, match="do not exist"):
        lora.init_lora_params(TCFG, lora.LoRAConfig(targets=("router",)),
                              device="cpu")


@pytest.mark.parametrize("name", ALL)
def test_split_dims_match_reference(name):
    shapes = ref_transformer.param_shapes(CFG)["layers"]
    assert (lora._split_dims(name, shapes[name])
            == ref_lora._split_dims(name, shapes[name]))


def test_init_shapes_and_zero_delta(weights):
    """A and B have the reference's shapes and dtype; B is zero, so the
    merged model is the base model exactly."""
    lcfg = ref_lora.LoRAConfig(rank=4, alpha=8.0, targets=ALL)
    want = ref_lora.init_lora_params(CFG, lcfg, jax.random.key(1))
    got = lora.init_lora_params(TCFG, _port_lcfg(lcfg), seed=1,
                                device="cpu")
    for name in ALL:
        for part in ("a", "b"):
            assert (tuple(got["layers"][name][part].shape)
                    == want["layers"][name][part].shape)
            assert got["layers"][name][part].dtype == torch.float32
        assert not got["layers"][name]["b"].any()
        a = got["layers"][name]["a"]
        _, fan_in, _ = lora._split_dims(
            name, ref_transformer.param_shapes(CFG)["layers"][name])
        # truncated normal at +-2 sd, std 1/sqrt(fan_in)
        assert a.abs().max() <= 2.0 / np.sqrt(fan_in) + 1e-6
    merged = lora.merge_lora(weights[1], got, _port_lcfg(lcfg))
    for name in ALL:
        assert torch.equal(merged["layers"][name],
                           weights[1]["layers"][name])


@pytest.mark.parametrize("targets", [("wo",), ALL], ids=["wo", "all"])
def test_merge_matches_reference(weights, targets):
    """merge = W + (alpha/r)·A@B, reshaped to the stacked layout: the
    port's merge equals the reference's on the same arrays."""
    lcfg = ref_lora.LoRAConfig(rank=2, alpha=6.0, targets=targets)
    ad = _np_adapter(lcfg, 3)
    want = ref_lora.merge_lora(weights[0], jax.tree.map(jnp.asarray, ad),
                               lcfg)
    got = lora.merge_lora(weights[1], _torch_tree(ad), _port_lcfg(lcfg))
    for name in transformer.param_shapes(TCFG)["layers"]:
        np.testing.assert_allclose(got["layers"][name].numpy(),
                                   np.asarray(want["layers"][name]),
                                   rtol=1e-6, atol=1e-6)
        if name not in targets:  # untouched leaves are shared
            assert got["layers"][name] is weights[1]["layers"][name]
    w = weights[1]["layers"]["wo"].numpy()
    a, b = ad["layers"]["wo"]["a"], ad["layers"]["wo"]["b"]
    np.testing.assert_allclose(
        got["layers"]["wo"].numpy(),
        w + 3.0 * np.einsum("lir,lro->lio", a, b).reshape(w.shape),
        rtol=1e-5, atol=1e-6)


def test_lora_config_sidecar_roundtrip(tmp_path):
    """The sidecar file is the reference's: each package reads the
    other's."""
    assert lora.load_lora_config(tmp_path) is None
    cfg = lora.LoRAConfig(rank=8, alpha=32.0, targets=("wq", "w_down"))
    lora.save_lora_config(tmp_path / "port", cfg)
    ref_cfg = ref_lora.load_lora_config(tmp_path / "port")
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    ref_lora.save_lora_config(tmp_path / "ref", ref_cfg)
    assert lora.load_lora_config(tmp_path / "ref") == cfg


def test_lora_row_delta_matches_reference():
    """Per-row (A, B, scale): each row's delta is its own adapter's; a
    zero row adds exactly zero."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((3, 5, 16)).astype(np.float32)
    a = rng.standard_normal((3, 16, 4)).astype(np.float32)
    b = rng.standard_normal((3, 4, 12)).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    scale = np.asarray([1.0, 2.0, 0.5], np.float32)
    want = np.asarray(ref_transformer.lora_row_delta(
        jnp.asarray(h), (jnp.asarray(a), jnp.asarray(b),
                         jnp.asarray(scale))))
    got = transformer.lora_row_delta(
        torch.from_numpy(h), (torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(scale))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert not got[0].any()


def _row_lora(lcfg_targets, rank, seed, rows=3):
    """{target: (a, b, scale)} per-row adapters for layer 0, row 0 the
    null adapter."""
    rng = np.random.default_rng(seed)
    shapes = ref_transformer.param_shapes(CFG)["layers"]
    out = {}
    for name in lcfg_targets:
        _, fan_in, fan_out = ref_lora._split_dims(name, shapes[name])
        a = rng.standard_normal((rows, fan_in, rank)).astype(np.float32)
        b = (0.3 * rng.standard_normal((rows, rank, fan_out))).astype(
            np.float32)
        a[0] = b[0] = 0.0
        out[name] = (a, b, np.asarray([1.0, 2.0, 0.5][:rows], np.float32))
    return out


@pytest.mark.parametrize("block", ["qkv", "out", "mlp"])
def test_blocks_with_per_row_adapters_match_reference(weights, block):
    """attention_qkv (deltas before rope), attention_out (on the
    flattened heads) and mlp_block (around SwiGLU) with per-row adapters
    equal the reference's; the null row equals the block without
    adapters exactly."""
    ref_params, params = weights
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, CFG.embed_dim)).astype(np.float32)
    lrows = _row_lora(ALL, 4, 2)
    rlp = jax.tree.map(lambda p: p[0], ref_params["layers"])
    tlp = transformer.layer_params(params, 0)
    rl = {k: tuple(map(jnp.asarray, v)) for k, v in lrows.items()}
    tl = {k: tuple(map(torch.from_numpy, v)) for k, v in lrows.items()}
    tx = torch.from_numpy(x)
    if block == "qkv":
        cos, sin = ref_transformer.rope_table(CFG, 6)
        want = ref_transformer.attention_qkv(jnp.asarray(x), rlp, CFG, cos,
                                             sin, lora=rl)
        tcos, tsin = rope_table(TCFG, 6, device="cpu")
        got = transformer.attention_qkv(tx, tlp, TCFG, tcos, tsin, lora=tl)
        plain = transformer.attention_qkv(tx, tlp, TCFG, tcos, tsin)
    elif block == "out":
        o = rng.standard_normal((3, 6, CFG.num_heads,
                                 CFG.head_dim)).astype(np.float32)
        want = (ref_transformer.attention_out(jnp.asarray(x),
                                              jnp.asarray(o), rlp, CFG,
                                              lora=rl),)
        got = (transformer.attention_out(tx, torch.from_numpy(o), tlp,
                                         TCFG, lora=tl),)
        plain = (transformer.attention_out(tx, torch.from_numpy(o), tlp,
                                           TCFG),)
    else:
        want = (ref_transformer.mlp_block(jnp.asarray(x), rlp, CFG,
                                          lora=rl),)
        got = (transformer.mlp_block(tx, tlp, TCFG, lora=tl),)
        plain = (transformer.mlp_block(tx, tlp, TCFG),)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(g[0], p[0])
        assert not torch.allclose(g[1:], p[1:])


def test_merged_weights_serve_like_reference(weights):
    """The port's server on the port's merge serves the reference
    server's tokens on the reference's merge; the merge changed the
    output."""
    lcfg = ref_lora.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
    ad = _np_adapter(lcfg, 5)
    ref_merged = ref_lora.merge_lora(weights[0],
                                     jax.tree.map(jnp.asarray, ad), lcfg)
    want = RefServer(ref_merged, CFG, GREEDY, **SRV_KW).generate(
        PROMPTS, max_new_tokens=8)
    merged = lora.merge_lora(weights[1], _torch_tree(ad), _port_lcfg(lcfg))
    srv = PagedInferenceServer(merged, TCFG,
                               TInferConfig(**dataclasses.asdict(GREEDY)),
                               device="cpu", **SRV_KW)
    got = srv.generate(PROMPTS, max_new_tokens=8)
    assert got == want
    base = RefServer(weights[0], CFG, GREEDY, **SRV_KW).generate(
        PROMPTS, max_new_tokens=8)
    assert got != base
