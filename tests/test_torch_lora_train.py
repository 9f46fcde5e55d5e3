"""LoRA training (the training half of `models/lora.py`) against the
reference's on the same float32 weights, crossed as numpy arrays:
zero-init adapters are a no-op, the labels freeze the base (bit for bit
unchanged, no optimizer moments, no gradients formed) and the adapters
track the reference's after the same steps, dense and MoE (per-expert
adapter stacks); the merged export, checkpoints of {"base", "lora"}
trees, and the `--lora-*` / `--init-from` CLI paths. Mirrors
tests/test_lora.py less its sharded case."""

import dataclasses
import gc
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import MeshConfig, ModelConfig, TrainConfig
from cloud_server_tpu.models import lora as ref_lora
from cloud_server_tpu.models import moe as ref_moe
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu.parallel.mesh import make_mesh
from cloud_server_tpu.training import init_train_state as ref_init_state
from cloud_server_tpu.training import make_train_step as ref_make_step
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.config import TrainConfig as TTrainConfig
from cloud_server_tpu_torch.models import lora, moe, transformer
from cloud_server_tpu_torch.models.transformer import params_from_numpy
from cloud_server_tpu_torch.training.optim import flatten
from cloud_server_tpu_torch.training.train_step import (
    make_train_step, train_state_from_params)

@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the reference's compiled XLA programs when the module ends:
    each holds a few memory maps, and a test worker that runs many
    modules would otherwise reach the kernel's map limit
    (vm.max_map_count), where the next compile fails."""
    yield
    jax.clear_caches()
    gc.collect()


TINY = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=32, dtype="float32",
    param_dtype="float32", remat="none")
MOE_TINY = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=32, max_seq_len=32, dtype="float32",
    param_dtype="float32", remat="none", num_experts=4,
    num_experts_per_token=2, expert_capacity_factor=4.0)
TCFG = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=8,
                   batch_size=8, seq_len=16)
FAMILIES = {
    "dense": (TINY, ref_tf, transformer, ("wq", "wv", "w_down")),
    "moe": (MOE_TINY, ref_moe, moe, ("wq", "wv", "w_gate", "w_down")),
}
STEPS = 8


def _tc(cfg):
    return TModelConfig(**dataclasses.asdict(cfg))


def _tt(tcfg=TCFG):
    return TTrainConfig(**dataclasses.asdict(tcfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens():
    return np.asarray(jax.random.randint(jax.random.key(7), (8, 16), 0, 64))


def _modules(family):
    cfg, ref_base, base, targets = FAMILIES[family]
    rcfg = ref_lora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    lcfg = lora.LoRAConfig(rank=4, alpha=8.0, targets=targets)
    return (cfg, ref_lora.make_lora_module(rcfg, base_module=ref_base),
            lora.make_lora_module(lcfg, base_module=base), lcfg)


@pytest.fixture(scope="module")
def reference_runs():
    """Per family: the reference's initial {"base", "lora"} params, its
    per-step losses and its params after STEPS single-device steps."""
    out = {}
    mesh = make_mesh(MeshConfig())
    for family in FAMILIES:
        cfg, ref_module, _, _ = _modules(family)
        state = ref_init_state(cfg, TCFG, mesh, jax.random.key(0),
                               loss_fn_module=ref_module)
        step, bsh = ref_make_step(cfg, TCFG, mesh, loss_fn_module=ref_module)
        p0 = _np(state.params)
        tokens = jax.device_put(jnp.asarray(_tokens()), bsh)
        losses = []
        for _ in range(STEPS):
            state, metrics = step(state, {"tokens": tokens})
            losses.append(float(metrics["loss"]))
        out[family] = (p0, losses, _np(state.params))
    return out


def _port_state(family, p0):
    cfg, _, module, _ = _modules(family)
    params = params_from_numpy(p0, _tc(cfg), device="cpu",
                               keep_param_dtype=True)
    return (train_state_from_params(params, _tt(), _tc(cfg), module),
            make_train_step(_tc(cfg), _tt(), loss_fn_module=module))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_zero_init_matches_base(family):
    """Fresh adapters (B = 0) are an exact no-op on the loss."""
    cfg, _, module, _ = _modules(family)
    base = moe.module_for(_tc(cfg))
    params = module.init_params(_tc(cfg), 0, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens())}
    with torch.no_grad():
        got, _ = module.next_token_loss(params, batch, _tc(cfg))
        want, _ = base.next_token_loss(params["base"], batch, _tc(cfg))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_trains_adapters_only_and_tracks_reference(reference_runs, family):
    """From the reference's initial params: the loss falls, the base stays
    bit for bit, only adapter moments exist and no base gradient is
    formed, and after STEPS steps the losses and adapters match the
    reference's (rtol 1e-4, atol 1e-6)."""
    p0, want_losses, p1 = reference_runs[family]
    state, step = _port_state(family, p0)
    base0 = {k: t.clone() for k, t in flatten(state.params["base"])}
    tokens = torch.from_numpy(_tokens())
    losses = []
    for _ in range(STEPS):
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        assert all(p.grad is None for _, p in flatten(state.params["base"]))
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    for k, t in flatten(state.params["base"]):
        assert torch.equal(t, base0[k]), k
        assert not t.requires_grad
    mu = dict(flatten(state.opt_state.mu))
    assert set(mu) == {k for k, _ in flatten({"lora": p1["lora"]})}
    moved = False
    for k, t in flatten(state.params["lora"]):
        want = dict(flatten(p1["lora"]))[k]
        np.testing.assert_allclose(t.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
        moved |= not np.array_equal(want, dict(flatten(p0["lora"]))[k])
    assert moved


def test_param_labels_and_shapes_match_reference():
    """The label tree (base frozen, adapters trainable) and the adapter
    shapes (per-expert stacks A (L, E, D, r), B (L, E, r, F); attention
    targets unstacked) equal the reference's."""
    for family in FAMILIES:
        cfg, ref_module, module, lcfg = _modules(family)
        want = dict(flatten(jax.tree.map(
            lambda x: x, ref_module.param_labels(cfg))))
        assert dict(flatten(module.param_labels(_tc(cfg)))) == want
        ref_params = jax.eval_shape(
            lambda: ref_module.init_params(cfg, jax.random.key(0)))
        got = module.param_shapes(_tc(cfg))
        for k, s in flatten(got):
            assert tuple(s) == dict(flatten(ref_params))[k].shape, k
    lw = lora.lora_shapes(_tc(MOE_TINY), _modules("moe")[3], moe)
    assert lw["layers"]["w_gate"]["a"] == (2, 4, 32, 4)
    assert lw["layers"]["w_gate"]["b"] == (2, 4, 4, 32)
    assert lw["layers"]["wq"]["a"] == (2, 32, 4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_merged_serves(reference_runs, family):
    """The merged export equals the reference's on the same trained
    params, has the plain base structure, changes only the targets, and
    serves: greedy engine tokens equal the reference engine's on it, and
    its loss equals the LoRA module's own forward."""
    from cloud_server_tpu.config import InferConfig
    from cloud_server_tpu.inference import engine as ref_engine
    from cloud_server_tpu_torch.config import InferConfig as TInferConfig
    from cloud_server_tpu_torch.inference import engine
    from cloud_server_tpu_torch.utils import prng
    cfg, _, module, lcfg = _modules(family)
    p1 = reference_runs[family][2]
    rcfg = ref_lora.LoRAConfig(rank=4, alpha=8.0, targets=lcfg.targets)
    want = ref_lora.export_merged(p1, rcfg, base_module=FAMILIES[family][1])
    params = params_from_numpy(p1, _tc(cfg), device="cpu",
                               keep_param_dtype=True)
    merged = lora.export_merged(params, lcfg)
    assert set(merged) == set(params["base"])
    for k, t in flatten(merged):
        np.testing.assert_allclose(t.numpy(), np.asarray(dict(flatten(
            _np(want)))[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    assert not torch.equal(merged["layers"]["wq"],
                           params["base"]["layers"]["wq"])
    assert torch.equal(merged["layers"]["wk"], params["base"]["layers"]["wk"])
    batch = {"tokens": torch.from_numpy(_tokens())}
    with torch.no_grad():
        a, _ = module.next_token_loss(params, batch, _tc(cfg))
        b, _ = moe.module_for(_tc(cfg)).next_token_loss(merged, batch,
                                                          _tc(cfg))
    np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
    icfg = InferConfig(max_decode_len=4, temperature=0.0)
    ref_out = ref_engine.generate(want, np.asarray([[3, 5, 9]], np.int32),
                                  jax.random.key(0), cfg=cfg, infer_cfg=icfg)
    out = engine.generate(merged, torch.tensor([[3, 5, 9]]), prng.key(0),
                          cfg=_tc(cfg), infer_cfg=TInferConfig(
                              **dataclasses.asdict(icfg)))
    assert out.tolist() == np.asarray(ref_out).tolist()


def test_lora_checkpoint_roundtrip(tmp_path):
    """A {"base", "lora"} TrainState restores bit for bit against its
    abstract target; the base comes back frozen, the adapters as
    autograd leaves, and the optimizer state holds adapter moments
    only."""
    from cloud_server_tpu_torch.training.checkpoint import (
        Checkpointer, abstract_train_state)
    from cloud_server_tpu_torch.training.train_step import init_train_state
    _, _, module, _ = _modules("moe")
    state = init_train_state(_tc(MOE_TINY), _tt(), 0, "cpu", module)
    step = make_train_step(_tc(MOE_TINY), _tt(), loss_fn_module=module)
    state, _ = step(state, {"tokens": torch.from_numpy(_tokens())})
    with Checkpointer(tmp_path / "ck", async_save=False) as ck:
        ck.save(state, force=True)
    with Checkpointer(tmp_path / "ck") as ck:
        got = ck.restore(abstract_train_state(_tc(MOE_TINY), _tt(), module),
                         device="cpu")
    for (k, a), (_, b) in zip(flatten(state.params), flatten(got.params)):
        assert torch.equal(a, b), k
        assert b.requires_grad == k.startswith("lora/"), k
    assert [k for k, _ in flatten(got.opt_state.mu)] == [
        k for k, _ in flatten(state.params) if k.startswith("lora/")]


def test_merge_lora_delta_math():
    """merge = W + (alpha/r)·A@B, reshaped to the stacked weight
    layout."""
    lcfg = lora.LoRAConfig(rank=2, alpha=6.0, targets=("wo",))
    module = lora.make_lora_module(lcfg)
    params = module.init_params(_tc(TINY), 1, device="cpu")
    ab = params["lora"]["layers"]["wo"]
    b = np.random.default_rng(0).normal(size=ab["b"].shape).astype(
        np.float32)
    ab["b"] = torch.from_numpy(b)
    merged = lora.merge_lora(params["base"], params["lora"], lcfg)
    w = params["base"]["layers"]["wo"].numpy()
    want = w + 3.0 * np.einsum("lir,lro->lio", ab["a"].numpy(),
                               b).reshape(w.shape)
    np.testing.assert_allclose(merged["layers"]["wo"].numpy(), want,
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

CLI_MODEL = dict(dataclasses.asdict(TINY), vocab_size=260)


def _config(tmp_path, steps: int) -> str:
    raw = {"model": CLI_MODEL,
           "train": {"batch_size": 4, "seq_len": 16, "total_steps": steps,
                     "warmup_steps": 1, "learning_rate": 1e-2},
           "loop": {"log_interval": 1}}
    path = tmp_path / f"tiny{steps}.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_train_cli_lora_init_from_and_generate(tmp_path, capsys):
    """`train --lora-rank --init-from` adapts a trained checkpoint's
    weights (restored bit for bit, left unchanged) and writes the
    reference's sidecar; `generate --checkpoint-dir` on that run prints
    the text the server gives on the reference's merged export of the
    same params."""
    from cloud_server_tpu_torch import generate, train
    from cloud_server_tpu_torch.config import InferConfig as TInferConfig
    from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
    from cloud_server_tpu_torch.inference.paged_server import (
        PagedInferenceServer)
    from cloud_server_tpu_torch.training.checkpoint import restore_params
    base_dir, lora_dir = tmp_path / "base", tmp_path / "lora"
    train.main(["--config", _config(tmp_path, 2), "--synthetic", "16",
                "--device", "cpu", "--checkpoint-dir", str(base_dir)])
    state = train.main(["--config", _config(tmp_path, 3), "--synthetic",
                        "16", "--device", "cpu", "--lora-rank", "4",
                        "--lora-alpha", "8", "--lora-targets", "wq,wv",
                        "--init-from", str(base_dir),
                        "--checkpoint-dir", str(lora_dir)])
    assert state.step == 3
    base = restore_params(base_dir, TModelConfig(**CLI_MODEL), device="cpu")
    for k, t in flatten(state.params["base"]):
        assert torch.equal(t, dict(flatten(base))[k]), k
    assert any(float(t.abs().max()) > 0
               for k, t in flatten(state.params["lora"]) if k.endswith("/b"))
    assert ref_lora.load_lora_config(lora_dir) == ref_lora.LoRAConfig(
        rank=4, alpha=8.0, targets=("wq", "wv"))
    capsys.readouterr()
    generate.main(["--config", _config(tmp_path, 3), "--checkpoint-dir",
                   str(lora_dir), "--prompt", "hi", "--max-new", "6",
                   "--temperature", "0", "--page-size", "8",
                   "--prefill-chunk", "16", "--device", "cpu"])
    text = capsys.readouterr().out
    tree = {k: t.detach().numpy() for k, t in flatten(state.params)}
    nested: dict = {}
    for k, v in tree.items():
        node = nested
        *heads, last = k.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    merged = _np(ref_lora.export_merged(
        nested, ref_lora.LoRAConfig(rank=4, alpha=8.0,
                                    targets=("wq", "wv"))))
    tok = ByteTokenizer()
    srv = PagedInferenceServer(
        params_from_numpy(merged, _tc(dataclasses.replace(
            TINY, vocab_size=260)), device="cpu"),
        TModelConfig(**CLI_MODEL),
        TInferConfig(max_decode_len=6, temperature=0.0,
                     eos_token_id=tok.eos_id, pad_token_id=tok.pad_id),
        max_slots=1, max_context=32, page_size=8, prefill_chunk=16,
        device="cpu")
    out = srv.generate([tok.encode("hi")], max_new_tokens=6)[0]
    assert text == f"=== 'hi'\n{tok.decode(out)}\n"


def test_cli_lora_refusals_print_the_reference_text(tmp_path):
    """--init-from without --lora-rank (train), and --lora-* flags that
    contradict a checkpoint's sidecar (generate), exit with the
    reference CLI's messages."""
    from cloud_server_tpu import generate as ref_generate
    from cloud_server_tpu import train as ref_train
    from cloud_server_tpu_torch import generate, train
    cfg = _config(tmp_path, 2)
    texts = []
    for main, dev in ((ref_train.main, []), (train.main,
                                             ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(["--config", cfg, "--synthetic", "16", "--init-from",
                  str(tmp_path), *dev])
        texts.append(str(e.value))
    assert texts[0] == texts[1] and "--lora-rank" in texts[0]
    ck = tmp_path / "ck"
    lora.save_lora_config(ck, lora.LoRAConfig(rank=4, alpha=8.0))
    texts = []
    for main, dev in ((ref_generate.main, []),
                      (generate.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(["--config", cfg, "--checkpoint-dir", str(ck),
                  "--lora-rank", "8", "--prompt", "hi", *dev])
        texts.append(str(e.value))
    assert texts[0] == texts[1] and "contradict" in texts[0]
