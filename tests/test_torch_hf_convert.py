"""HF LLaMA interop on the port, case for case with
tests/test_hf_convert.py: logits parity against `transformers` and
against the reference's forward, the round trip, the config mapping, the
llama3 rope case, the reference's refusals, and `generate
--hf-checkpoint`. Beyond it: the port's `load_hf_checkpoint` reads a
directory saved by `save_pretrained` (safetensors, sharded safetensors,
`.bin`) bit-equal to the reference's at float32 without `transformers`
or `safetensors`; a directory written by the port's `convert` loads in
`transformers` with equal logits and reads back bit-equal through
`safetensors`. Every checkpoint is built here from a config; nothing is
downloaded."""

import copy
import dataclasses
import gc
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from cloud_server_tpu import generate as ref_generate  # noqa: E402
from cloud_server_tpu.models import hf_convert as ref_hf  # noqa: E402
from cloud_server_tpu.models import transformer as ref_tf  # noqa: E402
from cloud_server_tpu_torch import convert, generate  # noqa: E402
from cloud_server_tpu_torch.models import transformer  # noqa: E402
from cloud_server_tpu_torch.models import safetensors_io  # noqa: E402
from cloud_server_tpu_torch.models.hf_convert import (  # noqa: E402
    _STRUCTURAL_FIELDS, config_from_hf, hf_config_dict, load_hf_checkpoint,
    params_from_hf, params_to_hf)


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the reference's compiled XLA programs when the module ends:
    each holds a few memory maps, and a test worker that runs many
    modules would otherwise reach the kernel's map limit
    (vm.max_map_count), where the next compile fails."""
    yield
    jax.clear_caches()
    gc.collect()


ATOL = 3e-4  # the reference test's tolerance
TOKENS = np.array([[5, 9, 3, 17, 60, 2, 40, 8]], np.int64)


def _llama(seed=0, **kw):
    args = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64,
                rms_norm_eps=1e-6, rope_theta=10000.0,
                tie_word_embeddings=False, attention_bias=False,
                mlp_bias=False)
    args.update(kw)
    hf_cfg = transformers.LlamaConfig(**args)
    torch.manual_seed(seed)
    return hf_cfg, transformers.LlamaForCausalLM(hf_cfg).eval()


@pytest.fixture(scope="module")
def tiny_llama():
    return _llama()


def _hf_logits(model, tokens):
    with torch.no_grad():
        return model(torch.from_numpy(tokens)).logits.numpy()


def _port_logits(params, cfg, tokens):
    with torch.no_grad():
        return transformer.forward(params, torch.from_numpy(tokens),
                                   cfg).numpy()


def _ref_logits(hf_cfg, model, tokens):
    rcfg = ref_hf.config_from_hf(hf_cfg, dtype="float32",
                                 param_dtype="float32", remat="none")
    rparams = ref_hf.params_from_hf(model.state_dict(), rcfg)
    return np.asarray(ref_tf.forward(
        rparams, jax.numpy.asarray(tokens.astype(np.int32)), rcfg))


F32 = dict(dtype="float32", param_dtype="float32", remat="none")


def test_logits_match_transformers(tiny_llama):
    """Converted weights reproduce the HF logits and the reference's —
    the mapping, the RoPE convention, GQA, SwiGLU and the norms."""
    hf_cfg, model = tiny_llama
    cfg = config_from_hf(hf_cfg, **F32)
    params = params_from_hf(model.state_dict(), cfg, device="cpu")
    ours = _port_logits(params, cfg, TOKENS)
    np.testing.assert_allclose(ours, _hf_logits(model, TOKENS), atol=ATOL)
    np.testing.assert_allclose(ours, _ref_logits(hf_cfg, model, TOKENS),
                               atol=ATOL)


def test_roundtrip_exact(tiny_llama):
    hf_cfg, model = tiny_llama
    cfg = config_from_hf(hf_cfg, dtype="float32", param_dtype="float32")
    params = params_from_hf(model.state_dict(), cfg, device="cpu")
    sd = params_to_hf(params, cfg)
    orig = {k: v.detach() for k, v in model.state_dict().items()
            if "rotary_emb" not in k}
    assert set(sd) == set(orig)
    for k in orig:
        assert sd[k].dtype == torch.float32 and sd[k].is_contiguous()
        assert torch.equal(sd[k], orig[k]), k
    # and the reference's export of the same tree, array for array
    rcfg = ref_hf.config_from_hf(hf_cfg, dtype="float32",
                                 param_dtype="float32")
    rsd = ref_hf.params_to_hf(ref_hf.params_from_hf(model.state_dict(),
                                                    rcfg), rcfg)
    for k in rsd:
        np.testing.assert_array_equal(sd[k].numpy(), rsd[k], err_msg=k)


def test_config_mapping(tiny_llama):
    """The object and its config.json dict map to the reference's
    ModelConfig field for field; a key missing from the dict takes
    LlamaConfig's default."""
    hf_cfg, _ = tiny_llama
    cfg = config_from_hf(hf_cfg)
    assert cfg.vocab_size == 128 and cfg.embed_dim == 32
    assert cfg.num_heads == 4 and cfg.num_kv_heads == 2
    assert cfg.head_dim == 8 and cfg.mlp_dim == 64
    assert cfg.tie_embeddings is False
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        ref_hf.config_from_hf(hf_cfg))
    assert config_from_hf(hf_cfg.to_dict()) == cfg
    sparse = {"hidden_size": 64, "num_attention_heads": 8,
              "vocab_size": 100}
    got = config_from_hf(sparse)
    want = transformers.LlamaConfig(**sparse)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        ref_hf.config_from_hf(want))
    assert got.num_kv_heads == 8 and got.head_dim == 8
    assert got.num_layers == want.num_hidden_layers
    assert got.mlp_dim == want.intermediate_size


def test_llama3_rope_scaling_logits_match():
    """A Llama 3.1-style rope_scaling config converts and reproduces the
    transformers and reference logits."""
    hf_cfg, model = _llama(
        seed=1, max_position_embeddings=256,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32})
    cfg = config_from_hf(hf_cfg, **F32)
    assert cfg.rope_scaling == "llama3" and cfg.rope_scaling_factor == 8.0
    params = params_from_hf(model.state_dict(), cfg, device="cpu")
    tokens = (np.arange(48, dtype=np.int64)[None, :] % 128)
    ours = _port_logits(params, cfg, tokens)
    np.testing.assert_allclose(ours, _hf_logits(model, tokens), atol=ATOL)
    np.testing.assert_allclose(ours, _ref_logits(hf_cfg, model, tokens),
                               atol=ATOL)


@pytest.mark.parametrize("field,value,match", [
    ("rope_scaling", {"rope_type": "yarn", "factor": 4.0}, "rope_scaling"),
    ("attention_bias", True, "attention_bias"),
    ("mlp_bias", True, "mlp_bias"),
    ("hidden_act", "gelu", "hidden_act"),
])
def test_unsupported_variants_raise(tiny_llama, field, value, match):
    """The reference's ValueErrors: exotic rope scaling, biases, a
    non-SiLU activation — on the object and on its dict."""
    hf_cfg, _ = tiny_llama
    bad = copy.deepcopy(hf_cfg)
    setattr(bad, field, value)
    with pytest.raises(ValueError, match=match):
        config_from_hf(bad)
    with pytest.raises(ValueError, match=match):
        config_from_hf(dict(hf_cfg.to_dict(), **{field: value}))


def test_unconsumed_keys_rejected(tiny_llama):
    hf_cfg, model = tiny_llama
    cfg = config_from_hf(hf_cfg)
    sd = dict(model.state_dict())
    sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(32)
    with pytest.raises(ValueError, match="unsupported weight"):
        params_from_hf(sd, cfg, device="cpu")


def test_structural_override_rejected(tiny_llama):
    hf_cfg, _ = tiny_llama
    with pytest.raises(ValueError, match="structural"):
        config_from_hf(hf_cfg, num_layers=4)
    with pytest.raises(ValueError, match="structural"):
        config_from_hf(hf_cfg, num_experts=8)
    cfg = config_from_hf(hf_cfg, dtype="float32", max_seq_len=32)
    assert cfg.max_seq_len == 32
    assert _STRUCTURAL_FIELDS == ref_hf._STRUCTURAL_FIELDS


# -- the directory I/O ------------------------------------------------------

@pytest.fixture(scope="module")
def saved(tiny_llama, tmp_path_factory):
    """The tiny model saved by transformers three ways."""
    _, model = tiny_llama
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for kind, kw in (("safetensors", {}),
                     ("sharded", {"max_shard_size": "20KB"}),
                     ("bin", {"safe_serialization": False})):
        model.save_pretrained(root / kind, **kw)
        out[kind] = str(root / kind)
    assert os.path.exists(os.path.join(out["sharded"],
                                       "model.safetensors.index.json"))
    assert os.path.exists(os.path.join(out["bin"], "pytorch_model.bin"))
    return out


@pytest.mark.parametrize("kind", ["safetensors", "sharded", "bin"])
def test_load_hf_checkpoint_bit_equal_to_the_reference(saved, kind):
    cfg, params = load_hf_checkpoint(saved[kind], device="cpu",
                                     param_dtype="float32")
    rcfg, rparams = ref_hf.load_hf_checkpoint(saved[kind],
                                              param_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert set(params) == set(rparams)
    for g in rparams:
        assert set(params[g]) == set(rparams[g])
        for n, want in rparams[g].items():
            got = params[g][n]
            assert got.dtype == torch.float32, (g, n)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{g}/{n}")


def test_load_needs_neither_transformers_nor_safetensors(saved):
    """The port reads the directory itself: a fresh interpreter loads
    all three layouts with neither package imported."""
    code = (
        "import sys\n"
        "from cloud_server_tpu_torch.models.hf_convert import "
        "load_hf_checkpoint\n"
        f"for p in {sorted(saved.values())!r}:\n"
        "    cfg, params = load_hf_checkpoint(p, device='cpu')\n"
        "    assert params['layers']['wq'].shape == (2, 32, 4, 8)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('transformers', 'safetensors', 'jax', 'cloud_server_tpu')]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(os.path.dirname(
                             os.path.dirname(os.path.abspath(__file__)))))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_safetensors_io_against_the_package(tmp_path, dtype):
    """The port's reader reads the package's files bit-equal, and the
    package reads the port's."""
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=g).to(dtype),
               "b.weight": torch.randn(7, generator=g).to(dtype),
               "c": torch.arange(6, dtype=torch.int32).reshape(2, 3),
               "e": torch.zeros(0, 4, dtype=dtype)}
    theirs = tmp_path / "theirs.safetensors"
    safetensors_torch.save_file(tensors, str(theirs))
    got = safetensors_io.load_file(theirs)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    ours = tmp_path / "ours.safetensors"
    nbytes = safetensors_io.save_file(tensors, ours, {"format": "pt"})
    assert nbytes == os.path.getsize(ours)
    back = safetensors_torch.load_file(str(ours))
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    assert safetensors_io.read_header(ours)[1]["__metadata__"] == {
        "format": "pt"}


# -- convert ----------------------------------------------------------------

MODEL = {"vocab_size": 300, "embed_dim": 32, "num_layers": 2,
         "num_heads": 4, "num_kv_heads": 2, "head_dim": 8, "mlp_dim": 64,
         "max_seq_len": 128, "dtype": "float32", "param_dtype": "float32",
         "rope_scaling": "llama3", "rope_scaling_factor": 8.0,
         "rope_original_max_len": 16, "remat": "none"}


def _checkpoint(tmp_path, model, ema=False):
    from cloud_server_tpu_torch.config import ModelConfig, TrainConfig
    from cloud_server_tpu_torch.training.checkpoint import Checkpointer
    from cloud_server_tpu_torch.training.train_step import init_train_state
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"model": model}))
    state = init_train_state(ModelConfig(**model),
                             TrainConfig(ema_decay=0.9 if ema else 0.0), 3,
                             "cpu")
    with Checkpointer(tmp_path / "run", async_save=False) as ckpt:
        ckpt.save(state)
    return str(cfg_path), str(tmp_path / "run"), state.params


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_convert_loads_in_transformers(tmp_path, tied):
    """`convert` writes config.json + a float32 model.safetensors (no
    lm_head.weight when tied): transformers loads it with the port's
    logits, safetensors reads back exactly `params_to_hf`, and the port
    reads it back bit-equal."""
    from cloud_server_tpu_torch.config import ModelConfig
    model = dict(MODEL, tie_embeddings=tied)
    cfg_path, run, params = _checkpoint(tmp_path, model)
    out = tmp_path / "hf"
    convert.main(["--config", cfg_path, "--checkpoint-dir", run, "--out",
                  str(out), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["config.json", "model.safetensors"]
    cfg = ModelConfig(**model)
    with open(out / "config.json") as f:
        assert json.load(f) == json.loads(json.dumps(hf_config_dict(cfg)))
    sd = safetensors_torch.load_file(str(out / "model.safetensors"))
    want = params_to_hf(params, cfg)
    assert ("lm_head.weight" in sd) is not tied
    assert set(sd) == set(want)
    for k in want:
        assert sd[k].dtype == torch.float32 and torch.equal(sd[k], want[k])
    hf = transformers.AutoModelForCausalLM.from_pretrained(str(out)).eval()
    tokens = np.arange(40, dtype=np.int64)[None, :] * 7 % 300
    np.testing.assert_allclose(_hf_logits(hf, tokens),
                               _port_logits(params, cfg, tokens), atol=ATOL)
    cfg2, back = load_hf_checkpoint(out, device="cpu", **model)
    assert cfg2 == cfg
    for g in params:
        for n in params[g]:
            assert torch.equal(back[g][n], params[g][n]), (g, n)


def test_convert_refusals(tmp_path):
    """The reference's SystemExits: an MoE config, --ema on a run
    without an EMA item."""
    cfg_path, run, _ = _checkpoint(tmp_path, MODEL)
    with pytest.raises(SystemExit, match="no 'ema' item"):
        convert.main(["--config", cfg_path, "--checkpoint-dir", run,
                      "--out", str(tmp_path / "x"), "--ema",
                      "--device", "cpu"])
    moe = tmp_path / "moe.json"
    moe.write_text(json.dumps({"model": dict(MODEL, num_experts=4)}))
    with pytest.raises(SystemExit, match="dense LLaMA family"):
        convert.main(["--config", str(moe), "--checkpoint-dir", run,
                      "--out", str(tmp_path / "x"), "--device", "cpu"])


def test_convert_exports_the_ema_tree(tmp_path):
    from cloud_server_tpu_torch.config import ModelConfig
    from cloud_server_tpu_torch.training.checkpoint import (
        restore_ema_params)
    cfg_path, run, _ = _checkpoint(tmp_path, MODEL, ema=True)
    convert.main(["--config", cfg_path, "--checkpoint-dir", run, "--out",
                  str(tmp_path / "hf"), "--ema", "--device", "cpu"])
    cfg = ModelConfig(**MODEL)
    ema = restore_ema_params(run, cfg, device="cpu")
    _, back = load_hf_checkpoint(tmp_path / "hf", device="cpu", **MODEL)
    for g in ema:
        for n in ema[g]:
            assert torch.equal(back[g][n], ema[g][n].float()), (g, n)


# -- generate ---------------------------------------------------------------

GEN_ARGS = ["--prompt", "ab", "--prompt", "hello", "--max-new", "6",
            "--temperature", "0", "--page-size", "8", "--prefill-chunk",
            "16"]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """vocab 300 covers the byte tokenizer (259)."""
    _, model = _llama(vocab_size=300, max_position_embeddings=128)
    d = tmp_path_factory.mktemp("hfgen")
    model.save_pretrained(d / "hf")
    cfg = d / "cfg.json"
    cfg.write_text(json.dumps({"model": {"dtype": "float32"}}))
    return str(d / "hf"), str(cfg)


def test_generate_cli_serves_hf_checkpoint(hf_dir, capsys):
    """--hf-checkpoint loads a local HF directory and prints the
    reference's text for it."""
    path, cfg = hf_dir
    ref_generate.main(["--config", cfg, "--hf-checkpoint", path,
                       *GEN_ARGS])
    want = capsys.readouterr().out
    generate.main(["--config", cfg, "--hf-checkpoint", path, "--device",
                   "cpu", *GEN_ARGS])
    got = capsys.readouterr().out
    assert "'ab'" in got and want.count("===") == 2
    assert got == want


@pytest.mark.parametrize("extra,message", [
    (["--checkpoint-dir", "CKPT"], "mutually exclusive"),
    (["--step", "3"], "--step does not apply"),
    (["--lora-rank", "4"], "--lora-\\* flags do not apply"),
    (["--params-npz", "x.npz"], "mutually exclusive"),
    (["--ema"], "--ema"),
])
def test_generate_hf_refusals(hf_dir, tmp_path, extra, message):
    path, cfg = hf_dir
    extra = [str(tmp_path) if a == "CKPT" else a for a in extra]
    with pytest.raises(SystemExit, match=message):
        generate.main(["--config", cfg, "--hf-checkpoint", path, "--device",
                       "cpu", *extra, *GEN_ARGS])


def test_generate_hf_keeps_the_vocab_check(tmp_path):
    """A checkpoint whose vocabulary is smaller than the tokenizer's is
    refused, as the reference refuses it."""
    _, model = _llama()  # vocab 128 < the byte tokenizer's 259
    model.save_pretrained(tmp_path / "hf")
    for main in (ref_generate.main, generate.main):
        argv = ["--hf-checkpoint", str(tmp_path / "hf"), *GEN_ARGS]
        if main is generate.main:
            argv += ["--device", "cpu"]
        with pytest.raises(SystemExit, match="exceeds model vocab"):
            main(argv)
