"""The port's MoE family (`models/moe.py`) against the reference's on the
same float32 weights, crossed as numpy arrays (4 experts, top-2): the
routing's slots, drops and aux stats (dispatch exact, combine and stats
to float32 ulps), the forward (logits within 1e-5), the loss and its
gradients (within 1e-5 relative) on every CE route, the engine, both
servers and speculation token for token (dropless at capacity factor
2.0, and with drops at 1.25 under the same schedule), int8 expert
weights, attention adapters on an MoE base, and training steps.
Mirrors tests/test_moe.py (less its expert-parallel case) and the MoE
cases of test_inference.py, test_paged_server.py, test_multi_lora.py,
test_quantization.py and test_fused_ce.py."""

import dataclasses
import gc
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefPaged)
from cloud_server_tpu.inference.server import InferenceServer as RefServer
from cloud_server_tpu.models import moe as ref_moe
from cloud_server_tpu.models import quantization as ref_q
from cloud_server_tpu.models.lora import LoRAConfig as RefLoRAConfig
from cloud_server_tpu.models.lora import init_lora_params as ref_lora_init
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference import engine, speculative
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.server import InferenceServer
from cloud_server_tpu_torch.models import moe
from cloud_server_tpu_torch.models.lora import LoRAConfig
from cloud_server_tpu_torch.models.quantization import (QTensor,
                                                        quantize_params)
from cloud_server_tpu_torch.models.transformer import params_from_numpy
from cloud_server_tpu_torch.utils import prng

@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the reference's compiled XLA programs when the module ends:
    each holds a few memory maps, and a test worker that runs many
    modules would otherwise reach the kernel's map limit
    (vm.max_map_count), where the next compile fails."""
    yield
    jax.clear_caches()
    gc.collect()


CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none", num_experts=4,
    num_experts_per_token=2, expert_capacity_factor=2.0)
# capacity factor E/k = 2.0 is dropless; 1.25 drops on these prompts
FACTORS = {"dropless": 2.0, "drops": 1.25}
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
SRV_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])
LONG = [(i * 7) % 60 + 1 for i in range(30)]
PROMPTS = [[5, 9, 3], [17, 2, 40, 8, 21], LONG, list(range(1, 14))]


def _cfg(factor=2.0, **kw):
    return dataclasses.replace(CFG, expert_capacity_factor=factor, **kw)


def _tc(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


def _ti(icfg=GREEDY):
    return TInferConfig(**dataclasses.asdict(icfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """The reference's MoE init and its port copy (float32, on the
    CPU)."""
    ref = ref_moe.init_params(CFG, jax.random.key(2))
    return ref, params_from_numpy(_np(ref), _tc(CFG), device="cpu")


def _staggered(srv, prompts=PROMPTS, max_new=8):
    reqs = [srv.submit(p, max_new_tokens=max_new) for p in prompts[:2]]
    for _ in range(3):
        srv.step()
    reqs += [srv.submit(p, max_new_tokens=max_new) for p in prompts[2:]]
    srv.run_until_idle()
    return [r.result() for r in reqs]


def _port_engine(params, cfg, prompt, n_new):
    icfg = _ti(dataclasses.replace(GREEDY, max_decode_len=n_new))
    return engine.generate(params, torch.tensor([prompt]), prng.key(1),
                           cfg=_tc(cfg), infer_cfg=icfg)[0].tolist()


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factor,tokens", [(1.25, 48), (2.0, 48),
                                           (4.0, 8), (1.25, 3)])
def test_capacity_matches_reference(factor, tokens):
    assert (moe._capacity(_tc(_cfg(factor)), tokens)
            == ref_moe._capacity(_cfg(factor), tokens))


def _logits(kind: str) -> np.ndarray:
    rng = np.random.default_rng(1)
    x = rng.normal(size=(48, 4)).astype(np.float32)
    if kind == "drops":
        x[:, 0] += 1.5  # most tokens want expert 0 first
    elif kind == "ties":
        x = np.round(x)  # many exactly equal probabilities
    return x


@pytest.mark.parametrize("kind", ["dropless", "drops", "ties"])
def test_routing_matches_reference(kind):
    """Dispatch slots (and so drops) equal the reference's exactly; the
    combine weights and aux stats agree to float32 ulps (the softmax's
    exp rounds differently in XLA and PyTorch)."""
    x = _logits(kind)
    factor = 1.25 if kind == "drops" else 2.0
    cap = ref_moe._capacity(_cfg(factor), x.shape[0])
    d1, c1, a1 = ref_moe.top_k_routing(jnp.asarray(x), 2, cap)
    d2, c2, a2 = moe.top_k_routing(torch.from_numpy(x), 2, cap)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
    np.testing.assert_allclose(c2.numpy(), np.asarray(c1), rtol=0,
                               atol=1.2e-7)
    for k in a1:
        np.testing.assert_allclose(float(a2[k]), float(a1[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert (float(a2["dropped_frac"]) > 0) == (kind == "drops")
    # the index form: every filled slot names its token and weight
    r = moe.route(torch.from_numpy(x), 2, cap)
    filled = r.token < x.shape[0]
    assert int(filled.sum()) == int(d2.sum())
    assert bool((r.weight[~filled] == 0).all())


def test_routing_respects_capacity():
    t, e, cap = 16, 4, 3
    logits = torch.from_numpy(np.asarray(
        jax.random.normal(jax.random.key(0), (t, e))))
    dispatch, combine, _ = moe.top_k_routing(logits, 2, cap)
    assert dispatch.sum(0).max() <= 1.0 + 1e-6  # no slot double-booked
    assert dispatch.sum((0, 2)).max() <= cap
    assert bool((combine[dispatch == 0] == 0).all())


def test_routing_top1_token_goes_to_argmax_expert():
    logits = torch.tensor([[5.0, 0.0, 0.0, 0.0], [0.0, 5.0, 0.0, 0.0]])
    dispatch, _, _ = moe.top_k_routing(logits, 1, capacity=4)
    assert float(dispatch[0, 0].sum()) == 1.0
    assert float(dispatch[1, 1].sum()) == 1.0


def test_moe_mlp_big_capacity_matches_dense_expert_mix():
    """With capacity >= T (nothing dropped), MoE == weighted expert
    sum."""
    cfg = _tc(_cfg(100.0))
    d, e, f = cfg.embed_dim, cfg.num_experts, cfg.mlp_dim
    rng = np.random.default_rng(0)
    lp = {"router": rng.normal(size=(d, e)) * 0.1,
          "w_gate": rng.normal(size=(e, d, f)) * 0.1,
          "w_up": rng.normal(size=(e, d, f)) * 0.1,
          "w_down": rng.normal(size=(e, f, d)) * 0.1}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    x = rng.normal(size=(2, 8, d)).astype(np.float32)
    out, aux = moe.moe_mlp(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in lp.items()},
                           cfg)
    assert float(aux["dropped_frac"]) == 0.0
    tokens = x.reshape(-1, d)
    z = tokens @ lp["router"]
    probs = np.exp(z - z.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top = np.argsort(-probs, axis=-1)[:, :2]
    ref = np.zeros_like(tokens)
    for t in range(tokens.shape[0]):
        w = probs[t, top[t]] / probs[t, top[t]].sum()
        for j, ei in enumerate(top[t]):
            h = tokens[t] @ lp["w_gate"][ei]
            u = tokens[t] @ lp["w_up"][ei]
            ref[t] += w[j] * (((h / (1 + np.exp(-h))) * u) @ lp["w_down"][ei])
    np.testing.assert_allclose(out.numpy().reshape(-1, d), ref, atol=2e-5)


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(FACTORS))
def test_forward_matches_reference(weights, kind):
    ref, port = weights
    cfg = _cfg(FACTORS[kind])
    tokens = np.asarray([PROMPTS[3] + [0, 0, 0]])
    want, wa = ref_moe.forward(ref, jnp.asarray(tokens), cfg)
    with torch.no_grad():
        got, ga = moe.forward(port, torch.from_numpy(tokens), _tc(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for k in wa:
        np.testing.assert_allclose(float(ga[k]), float(wa[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert (float(ga["dropped_frac"]) > 0) == (kind == "drops")


def _grads_tree(port):
    tree = {g: {k: v.detach().clone().requires_grad_(True)
                for k, v in leaves.items()} for g, leaves in port.items()}
    return tree


LOSS_CASES = {"dense": {}, "vocab_chunk": {"vocab_chunk": 16},
              "pallas": {"ce_impl": "pallas"}}
LOSS_KW = dict(aux_loss_coef=0.01, router_z_coef=1e-3)
# vocab and B*S multiples of 128, as the fused CE needs
LOSS_CFG = _cfg(1.25, vocab_size=128)


@pytest.fixture(scope="module")
def loss_reference():
    """The reference's dense-CE MoE loss, metrics and gradients (drops at
    capacity 1.25), on its own init."""
    ref = ref_moe.init_params(LOSS_CFG, jax.random.key(3))
    tokens = np.random.default_rng(4).integers(0, 128, (2, 64))
    (lr, mr), gr = jax.value_and_grad(ref_moe.next_token_loss, has_aux=True)(
        ref, {"tokens": jnp.asarray(tokens)}, LOSS_CFG, **LOSS_KW)
    return _np(ref), tokens, float(lr), _np(mr), _np(gr)


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_reference(loss_reference, case):
    """moe.next_token_loss with the aux and router-z terms: loss and every
    gradient within 1e-5 relative of the reference's dense-CE loss (the
    reference holds its chunked and Pallas CE equal to that one)."""
    ref, tokens, lr, mr, gr = loss_reference
    cfg = dataclasses.replace(LOSS_CFG, **LOSS_CASES[case])
    kw = LOSS_KW
    port = _grads_tree(params_from_numpy(ref, _tc(cfg), device="cpu",
                                         keep_param_dtype=True))
    loss, metrics = moe.next_token_loss(port, {"tokens": torch.from_numpy(
        tokens)}, _tc(cfg), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(lr), rtol=1e-5)
    for k in ("loss", "accuracy", "load_balance", "router_z",
              "dropped_frac"):
        np.testing.assert_allclose(float(metrics[k]), float(mr[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for group, leaves in port.items():
        for name, p in leaves.items():
            want = np.asarray(gr[group][name])
            scale = max(np.abs(want).max(), 1e-12)
            assert np.abs(p.grad.numpy() - want).max() / scale < 1e-5, (
                group, name)


def test_moe_fused_ce_matches_dense(weights):
    """vocab_chunk > 0 matches the dense MoE loss path (loss, metrics and
    gradients), as the reference's test holds for its own."""
    _, port = weights
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 64, (2, 16)))
    out = []
    for cfg in (_tc(CFG), _tc(_cfg(2.0, vocab_chunk=16))):
        tree = _grads_tree(port)
        loss, metrics = moe.next_token_loss(tree, {"tokens": tokens}, cfg)
        loss.backward()
        out.append((loss, metrics, tree))
    (ld, md, td), (lf, mf, tf) = out
    np.testing.assert_allclose(float(lf), float(ld), rtol=1e-5)
    for k in md:
        np.testing.assert_allclose(float(mf[k]), float(md[k]), rtol=1e-5,
                                   err_msg=k)
    for g in td:
        for n in td[g]:
            np.testing.assert_allclose(tf[g][n].grad.numpy(),
                                       td[g][n].grad.numpy(), atol=1e-5,
                                       rtol=1e-4)


def test_moe_loss_honors_pallas_ce():
    """ce_impl='pallas' is not ignored by the MoE loss: its CE route gives
    the dense loss."""
    cfg = _cfg(4.0, vocab_size=128)
    params = params_from_numpy(_np(ref_moe.init_params(
        cfg, jax.random.key(1))), _tc(cfg), device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, 128, (2, 64)))
    with torch.no_grad():
        ld, _ = moe.next_token_loss(params, {"tokens": tokens}, _tc(cfg))
        lp, _ = moe.next_token_loss(params, {"tokens": tokens},
                                    _tc(dataclasses.replace(
                                        cfg, ce_impl="pallas")))
    np.testing.assert_allclose(float(lp), float(ld), rtol=1e-5)


def test_segment_ids_still_refused(weights):
    """Packed rows, refused before, now run on the MoE model: the
    prompts packed into rows of 32 give the reference's packed loss and
    router stats (1e-5 relative) at both capacity factors (routing
    contended over the packed rows, padding included)."""
    from cloud_server_tpu_torch.data.packing import pack_documents
    ref, port = weights
    toks, segs = pack_documents(PROMPTS, 32)
    for factor in FACTORS.values():
        cfg = _cfg(factor)
        with torch.no_grad():
            got, gm = moe.next_token_loss(
                port, {"tokens": torch.from_numpy(toks),
                       "segment_ids": torch.from_numpy(segs)}, _tc(cfg))
        want, wm = ref_moe.next_token_loss(
            ref, {"tokens": jnp.asarray(toks),
                  "segment_ids": jnp.asarray(segs)}, cfg)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        for key in ("load_balance", "router_z", "dropped_frac"):
            np.testing.assert_allclose(float(gm[key]), float(wm[key]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)


# ---------------------------------------------------------------------------
# Inference: engine, servers, speculation
# ---------------------------------------------------------------------------

def test_prefill_decode_matches_full_forward(weights):
    """Teacher-forced cache decode reproduces the training forward (the
    reference's generous-capacity case; the forward is held to the
    reference's above)."""
    _, port = weights
    cfg = _tc(_cfg(8.0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 64,
                                                                (2, 10)))
    with torch.no_grad():
        full, _ = moe.forward(port, tokens, cfg)
    cache = engine.init_cache(cfg, 2, 16, device="cpu")
    logits, cache = engine.prefill(port, tokens[:, :4], cfg, cache)
    np.testing.assert_allclose(logits.numpy(), full[:, 3].numpy(),
                               atol=2e-4)
    for t in range(4, 10):
        logits, cache = engine.decode_step(port, tokens[:, t], cfg, cache)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   atol=3e-4)


@pytest.fixture(scope="module")
def paged_reference(weights):
    """The reference paged server's tokens on the staggered workload at
    each capacity factor."""
    return {kind: _staggered(RefPaged(weights[0], _cfg(f), GREEDY,
                                      overlap=False, **SRV_KW))
            for kind, f in FACTORS.items()}


@pytest.fixture(scope="module")
def moe_draft():
    """A 1-layer MoE draft model (reference init, crossed as numpy)."""
    dcfg = dataclasses.replace(CFG, num_layers=1)
    ref = ref_moe.init_params(dcfg, jax.random.key(7))
    return ref, params_from_numpy(_np(ref), _tc(dcfg), device="cpu"), dcfg


def test_moe_params_quantize(weights):
    """Expert stacks quantize per (layer, expert, output channel) over D,
    bit for bit as the reference's; the router stays float; the quantized
    forward stays close to the float one (cosine > 0.99, the reference's
    test)."""
    ref, port = weights
    rq = ref_q.quantize_params(ref)
    q = quantize_params(port)
    layers = q["layers"]
    assert isinstance(layers["w_gate"], QTensor)
    assert layers["w_gate"].scale.shape[2] == 1  # (L, E, D, F): D contracted
    assert not isinstance(layers["router"], QTensor)
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(layers[name].q.numpy(),
                                      np.asarray(rq["layers"][name].q))
        np.testing.assert_allclose(layers[name].scale.numpy(),
                                   np.asarray(rq["layers"][name].scale),
                                   rtol=2e-7)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 64,
                                                                (2, 8)))
    with torch.no_grad():
        fp, _ = moe.forward(port, tokens, _tc(CFG))
        got, _ = moe.forward(q, tokens, _tc(CFG))
    a, b = fp.numpy().ravel(), got.numpy().ravel()
    assert np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.99


# ---------------------------------------------------------------------------
# Adapters on an MoE base
# ---------------------------------------------------------------------------

def _attention_adapter(seed):
    lcfg = RefLoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv"))
    lp = ref_lora_init(CFG, lcfg, jax.random.key(seed))
    for name in lp["layers"]:
        b = lp["layers"][name]["b"]
        lp["layers"][name]["b"] = 0.3 * jax.random.normal(
            jax.random.key(seed + 1), b.shape, b.dtype)
    return _np(lp)


def test_moe_adapter_validation(weights):
    """MLP-targeting adapters are refused per request on an MoE base, by
    both servers."""
    ref, port = weights
    mlp = ref_lora_init(CFG, RefLoRAConfig(rank=2, targets=("w_gate",)),
                        jax.random.key(9), base_module=ref_moe)
    for srv, cfg in ((RefPaged(ref, CFG, GREEDY, **SRV_KW),
                      RefLoRAConfig(rank=2, targets=("w_gate",))),
                     (PagedInferenceServer(port, _tc(CFG), _ti(),
                                           device="cpu", **SRV_KW),
                      LoRAConfig(rank=2, targets=("w_gate",)))):
        with pytest.raises(ValueError, match="MoE base"):
            srv.add_adapter("m", _np(mlp), cfg)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def test_train_steps_match_reference():
    """make_train_step on the MoE family (the reference's aux and
    router-z coefficients from TrainConfig) tracks the reference's
    single-device step: losses, router stats and grad norms per step,
    and the parameters after the steps."""
    from cloud_server_tpu.config import MeshConfig, TrainConfig
    from cloud_server_tpu.parallel.mesh import make_mesh
    from cloud_server_tpu.training import init_train_state as ref_init
    from cloud_server_tpu.training import make_train_step as ref_step
    from cloud_server_tpu_torch.config import TrainConfig as TTrainConfig
    from cloud_server_tpu_torch.training.train_step import (
        make_train_step, train_state_from_params)
    cfg = dataclasses.replace(_cfg(1.25), max_seq_len=32)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=8,
                       batch_size=4, seq_len=16, moe_router_z_coef=1e-3)
    mesh = make_mesh(MeshConfig())
    state = ref_init(cfg, tcfg, mesh, jax.random.key(0),
                     loss_fn_module=ref_moe)
    step, bsh = ref_step(cfg, tcfg, mesh, loss_fn_module=ref_moe)
    port = train_state_from_params(
        params_from_numpy(_np(state.params), _tc(cfg), device="cpu",
                          keep_param_dtype=True),
        TTrainConfig(**dataclasses.asdict(tcfg)))
    pstep = make_train_step(_tc(cfg), TTrainConfig(**dataclasses.asdict(
        tcfg)), loss_fn_module=moe)
    tokens = np.random.default_rng(2).integers(0, 64, (4, 16))
    for _ in range(3):
        state, want = step(state, {"tokens": jax.device_put(
            jnp.asarray(tokens), bsh)})
        port, got = pstep(port, {"tokens": torch.from_numpy(tokens)})
        for k in ("loss", "load_balance", "router_z", "dropped_frac",
                  "grad_norm"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    for group, leaves in port.params.items():
        for name, p in leaves.items():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(state.params[group][name]),
                atol=1e-5, rtol=1e-4, err_msg=f"{group}/{name}")


def test_train_cli_logs_router_stats_and_serves_checkpoint(tmp_path,
                                                           capsys):
    """The training CLI picks the MoE family from the config, logs the
    router stats per step and checkpoints; `generate --checkpoint-dir`
    restores the MoE tree and prints the engine's greedy tokens on it."""
    from cloud_server_tpu_torch import generate, train
    from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
    from cloud_server_tpu_torch.training.checkpoint import restore_params
    from cloud_server_tpu_torch.utils.logging import read_jsonl
    model = {k: v for k, v in dataclasses.asdict(_cfg(
        1.25, vocab_size=260)).items()}
    raw = {"model": model,
           "train": {"batch_size": 4, "seq_len": 16, "total_steps": 2,
                     "warmup_steps": 1, "learning_rate": 1e-2},
           "loop": {"log_interval": 1}}
    path = tmp_path / "moe.json"
    path.write_text(json.dumps(raw))
    ck = tmp_path / "ck"
    state = train.main(["--config", str(path), "--synthetic", "16",
                        "--device", "cpu", "--logdir", str(tmp_path / "l"),
                        "--checkpoint-dir", str(ck)])
    assert state.params["layers"]["w_gate"].shape == (2, 4, 32, 64)
    recs = read_jsonl(tmp_path / "l" / "train.jsonl")
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        for key in ("load_balance", "router_z", "dropped_frac"):
            assert np.isfinite(r[key]), key
    capsys.readouterr()
    generate.main(["--config", str(path), "--checkpoint-dir", str(ck),
                   "--prompt", "hi", "--max-new", "6", "--temperature", "0",
                   "--page-size", "8", "--prefill-chunk", "16",
                   "--device", "cpu"])
    text = capsys.readouterr().out
    tcfg = _tc(dataclasses.replace(_cfg(1.25, vocab_size=260)))
    params = restore_params(ck, tcfg, device="cpu")
    tok = ByteTokenizer()
    prompt = tok.encode("hi", add_bos=False)
    icfg = TInferConfig(max_decode_len=6, temperature=0.0,
                        eos_token_id=tok.eos_id, pad_token_id=tok.pad_id)
    out = engine.generate(params, torch.tensor([prompt]), prng.key(0),
                          cfg=tcfg, infer_cfg=icfg)[0].tolist()
    if tok.eos_id in out:
        out = out[:out.index(tok.eos_id)]
    assert text == f"=== 'hi'\n{tok.decode(out)}\n"
