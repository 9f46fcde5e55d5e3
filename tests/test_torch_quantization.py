"""The port's int8 weight-only quantization against the reference's
`models/quantization.py` on the same float32 weights: `q` bit for bit
and `scale` to float32 ulp (both round half to even and clip to +-127),
the same leaves quantized and the same byte counts; the quantized
forward against the float one and the reference's quantized one
(rtol = atol = 1e-4); and the reference's quantized tree, crossed as
numpy arrays, served by both port servers token for token against the
reference's servers."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference import generate as ref_generate
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefPaged)
from cloud_server_tpu.inference.server import InferenceServer as RefServer
from cloud_server_tpu.models import quantization as ref_q
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import engine
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.server import InferenceServer
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.models.quantization import (
    QTensor, dequantize_params, quantize, quantize_params, quantized_bytes)
from cloud_server_tpu_torch.utils import prng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

TINY = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=64, dtype="float32",
    param_dtype="float32", remat="none")
TCFG = TModelConfig(**dataclasses.asdict(TINY))
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
PROMPTS = [[5, 9, 3], [17, 2, 40, 8, 21], [60], list(range(1, 14))]


def _port_tree(tree):
    """A reference tree (QTensor leaves included) as the port's, on the
    CPU."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, ref_q.QTensor):
            return QTensor(torch.from_numpy(np.array(x.q)),
                           torch.from_numpy(np.array(x.scale)))
        return torch.from_numpy(np.array(x))
    return conv(tree)


@pytest.fixture(scope="module")
def weights():
    """(reference f32 tree, its quantized tree, the port's f32 tree)."""
    ref = ref_tf.init_params(TINY, jax.random.key(0))
    return ref, ref_q.quantize_params(ref), _port_tree(ref)


@pytest.mark.parametrize("axes", [(1,), (0, 2)])
def test_quantize_roundtrip_error_bound(axes):
    """Per-channel symmetric int8: error <= scale / 2 elementwise, and the
    payload and scales are the reference's."""
    w = np.asarray(jax.random.normal(jax.random.key(0), (4, 16, 8)))
    qt = quantize(torch.from_numpy(w), axes)
    assert qt.q.dtype == torch.int8
    assert qt.scale.shape == tuple(1 if i in axes else n
                                   for i, n in enumerate(w.shape))
    err = (qt.dequantize() - torch.from_numpy(w)).abs()
    assert (err <= qt.scale / 2 + 1e-7).all()
    want = ref_q.quantize(jnp.asarray(w), axes)
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(want.scale))


def test_quantize_params_matches_reference_bit_for_bit(weights):
    """The same leaves are quantized (every block weight and the untied
    lm_head; norms and embeddings stay), `q` bit-exact, `scale` within
    a float32 ulp, and the byte counts equal."""
    ref, refq, port = weights
    got = quantize_params(port)
    for group, leaves in refq.items():
        for name, want in leaves.items():
            leaf = got[group][name]
            assert isinstance(leaf, QTensor) == isinstance(
                want, ref_q.QTensor), (group, name)
            if isinstance(leaf, QTensor):
                np.testing.assert_array_equal(leaf.q.numpy(),
                                              np.asarray(want.q))
                np.testing.assert_array_max_ulp(
                    leaf.scale.numpy(), np.asarray(want.scale), 1)
    assert isinstance(got["lm_head"]["kernel"], QTensor)
    assert not isinstance(got["embed"]["tokens"], QTensor)
    stored, bf16 = quantized_bytes(got)
    assert (stored, bf16) == ref_q.quantized_bytes(refq)
    assert stored < 0.75 * bf16


def test_scale_constant_along_contraction_axes(weights):
    layers = quantize_params(weights[2])["layers"]
    assert layers["wq"].scale.shape[1] == 1          # (L, D, H, Dh): D
    assert layers["wo"].scale.shape[1:3] == (1, 1)   # (L, H, Dh, D): H, Dh
    # a layer slice takes the payload and its scales together
    sl = layers["w_up"][1]
    assert sl.shape == (32, 64) and sl.scale.shape == (1, 64)
    np.testing.assert_array_equal(sl.q.numpy(), layers["w_up"].q[1].numpy())


def test_quantized_forward_close_to_fp(weights):
    """The quantized forward stays close to the float one (argmax agrees,
    cosine > 0.999) and equals the reference's quantized forward."""
    ref, refq, port = weights
    tokens = np.asarray(jax.random.randint(jax.random.key(1), (2, 16), 0,
                                           TINY.vocab_size))
    t = torch.from_numpy(tokens).long()
    fp = transformer.forward(port, t, TCFG)
    got = transformer.forward(quantize_params(port), t, TCFG)
    assert float((fp.argmax(-1) == got.argmax(-1)).float().mean()) > 0.9
    cos = torch.nn.functional.cosine_similarity(fp.ravel(), got.ravel(),
                                                dim=0)
    assert float(cos) > 0.999
    want = ref_tf.forward(refq, jnp.asarray(tokens), TINY)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_quantized_generate_matches_reference(weights):
    _, refq, _ = weights
    prompt = np.asarray(jax.random.randint(jax.random.key(2), (2, 4), 0,
                                           TINY.vocab_size))
    icfg = InferConfig(max_decode_len=6, temperature=0.0)
    want = ref_generate(refq, jnp.asarray(prompt), jax.random.key(0),
                        cfg=TINY, infer_cfg=icfg)
    got = engine.generate(_port_tree(refq), torch.from_numpy(prompt).long(),
                          prng.key(0), cfg=TCFG,
                          infer_cfg=TInferConfig(**dataclasses.asdict(icfg)))
    assert got.shape == (2, 6)
    assert got.tolist() == np.asarray(want).tolist()


def test_dequantize_params_roundtrip(weights):
    ref, refq, port = weights
    deq = dequantize_params(quantize_params(port))
    assert isinstance(deq["layers"]["wq"], torch.Tensor)
    assert float((deq["layers"]["wq"] - port["layers"]["wq"]).abs().max()
                 ) < 0.05
    np.testing.assert_array_equal(
        deq["layers"]["wq"].numpy(),
        np.asarray(ref_q.dequantize_params(refq)["layers"]["wq"]))


def test_moe_params_are_refused():
    """MoE expert weights (4-D MLP leaves) quantize over their D axis per
    (layer, expert, output channel), bit for bit as the reference's, and
    the router stays float (tests/test_torch_moe.py serves them)."""
    rng = np.random.default_rng(3)
    tree = {"layers": {
        "w_gate": rng.normal(size=(2, 4, 8, 16)).astype(np.float32),
        "w_down": rng.normal(size=(2, 4, 16, 8)).astype(np.float32),
        "router": rng.normal(size=(2, 8, 4)).astype(np.float32)}}
    want = ref_q.quantize_params(jax.tree.map(jnp.asarray, tree))
    got = quantize_params({"layers": {k: torch.from_numpy(v) for k, v in
                                      tree["layers"].items()}})
    assert not isinstance(got["layers"]["router"], QTensor)
    for name in ("w_gate", "w_down"):
        assert got["layers"][name].scale.shape == (2, 4, 1,
                                                   tree["layers"][name]
                                                   .shape[3])
        np.testing.assert_array_equal(got["layers"][name].q.numpy(),
                                      np.asarray(want["layers"][name].q))


def _run(srv):
    reqs = [srv.submit(p, max_new_tokens=10) for p in PROMPTS[:2]]
    for _ in range(3):
        srv.step()
    reqs += [srv.submit(p, max_new_tokens=10) for p in PROMPTS[2:]]
    srv.run_until_idle()
    return [r.result() for r in reqs]


@pytest.mark.parametrize("server", ["paged", "contiguous"])
def test_quantized_servers_match_reference(weights, server):
    """The reference's quantized tree, crossed as numpy arrays, served by
    the port's server: the reference server's tokens on the same tree,
    the QTensor leaves kept quantized in the server's params."""
    _, refq, _ = weights
    ticfg = TInferConfig(**dataclasses.asdict(GREEDY))
    if server == "paged":
        kw = dict(max_slots=4, max_context=64, page_size=8,
                  prefill_chunk=16, prompt_buckets=[16, 32])
        want = _run(RefPaged(refq, TINY, GREEDY, overlap=False, **kw))
        srv = PagedInferenceServer(_port_tree(refq), TCFG, ticfg,
                                   device="cpu", **kw)
    else:
        kw = dict(max_slots=4, max_len=64)
        want = _run(RefServer(refq, TINY, GREEDY, **kw))
        srv = InferenceServer(_port_tree(refq), TCFG, ticfg, device="cpu",
                              **kw)
    assert isinstance(srv.params["layers"]["wq"], QTensor)
    assert _run(srv) == want
