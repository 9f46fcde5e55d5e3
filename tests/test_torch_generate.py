"""The port's batch CLI against the reference's: same config, same
weights (the reference's random init from --seed, handed to the port as
a .npz), greedy — the same text; a training checkpoint of the same
weights (`--checkpoint-dir`) serves the same text as the .npz, and
`--ema` serves its EMA tree; the reference's SystemExits for invalid
combinations. Without a GPU the port's CLI refuses to run unless given
--device cpu."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from cloud_server_tpu import generate as ref_generate
from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch import generate

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

MODEL = {"vocab_size": 300, "embed_dim": 32, "num_layers": 2,
         "num_heads": 4, "num_kv_heads": 2, "head_dim": 8, "mlp_dim": 64,
         "max_seq_len": 128, "dtype": "float32", "param_dtype": "float32",
         "rope_scaling": "llama3", "rope_scaling_factor": 8.0,
         "rope_original_max_len": 16, "decode_attention_impl": "pallas"}
SEED = 3


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gen")
    cfg_path = d / "cfg.json"
    cfg_path.write_text(json.dumps({"model": MODEL}))
    params = ref_tf.init_params(ModelConfig(**MODEL), jax.random.key(SEED))
    flat = {f"{g}/{n}": np.asarray(v) for g, leaves in params.items()
            for n, v in leaves.items()}
    npz = d / "params.npz"
    np.savez(npz, **flat)
    return str(cfg_path), str(npz)


ARGS = ["--prompt", "hello world", "--prompt", "paged", "--max-new", "10",
        "--temperature", "0", "--page-size", "8", "--prefill-chunk", "16",
        "--seed", str(SEED)]


def test_cli_prints_the_reference_text(files, capsys):
    cfg_path, npz = files
    # the reference's own XLA path (its Pallas kernel is held equal to it
    # by its own tests); the port runs the config's kernel path
    ref_generate.main(["--config", cfg_path, "--decode-impl", "xla",
                       *ARGS])
    want = capsys.readouterr().out
    generate.main(["--config", cfg_path, "--params-npz", npz,
                   "--device", "cpu", *ARGS])
    got = capsys.readouterr().out
    assert want.count("===") == 2
    assert got == want


@pytest.mark.parametrize("flags", [
    ["--scheduler", "alternating"], ["--no-overlap"],
    ["--flight-recorder", "4", "--no-iteration-profile"],
    ["--allocation", "reserve"]],
    ids=["alternating", "no_overlap", "recorder_no_profile", "reserve"])
def test_scheduler_flags_print_the_reference_text(files, capsys, flags,
                                                  monkeypatch):
    """The scheduler, overlap, flight-recorder, profiler and allocation
    flags reach the server and change no token: the same text as the
    reference's CLI given the same flags."""
    cfg_path, npz = files
    ref_generate.main(["--config", cfg_path, "--decode-impl", "xla",
                       *ARGS, *flags])
    want = capsys.readouterr().out
    seen = {}
    from cloud_server_tpu_torch.inference import paged_server

    class Spy(paged_server.PagedInferenceServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.update(scheduler=self.scheduler, overlap=self.overlap,
                        flight=self.flight.capacity,
                        allocation=self.allocation,
                        profiled=self._profiler is not None)

    monkeypatch.setattr(paged_server, "PagedInferenceServer", Spy)
    generate.main(["--config", cfg_path, "--params-npz", npz,
                   "--device", "cpu", *ARGS, *flags])
    assert capsys.readouterr().out == want
    assert seen["scheduler"] == (
        "alternating" if "alternating" in flags else "mixed")
    assert seen["overlap"] == ("--no-overlap" not in flags)
    assert seen["allocation"] == (
        "reserve" if "reserve" in flags else "ondemand")
    assert seen["flight"] == (4 if "--flight-recorder" in flags else 256)
    assert seen["profiled"] == ("--no-iteration-profile" not in flags)


@pytest.fixture(scope="module")
def checkpoint(files, tmp_path_factory):
    """A training checkpoint (port's format) whose params are the .npz's
    and whose EMA tree is the reference's init from another seed; that
    tree also as a .npz."""
    from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
    from cloud_server_tpu_torch.config import TrainConfig
    from cloud_server_tpu_torch.models.transformer import params_from_npz
    from cloud_server_tpu_torch.training.checkpoint import Checkpointer
    from cloud_server_tpu_torch.training.optim import EmaState, map_tree
    from cloud_server_tpu_torch.training.train_step import (
        train_state_from_params)
    d = tmp_path_factory.mktemp("ckpt")
    cfg = TModelConfig(**MODEL)
    params = params_from_npz(files[1], cfg, "cpu")
    ema_ref = ref_tf.init_params(ModelConfig(**MODEL), jax.random.key(99))
    ema_npz = d / "ema.npz"
    np.savez(ema_npz, **{f"{g}/{n}": np.asarray(v)
                         for g, leaves in ema_ref.items()
                         for n, v in leaves.items()})
    state = train_state_from_params(params, TrainConfig(ema_decay=0.9))
    adam, _ = state.opt_state
    ema = map_tree(lambda t: t.detach().clone(),
                   params_from_npz(ema_npz, cfg, "cpu"))
    state = state._replace(step=5, opt_state=(adam, EmaState(ema)))
    with Checkpointer(d / "run", async_save=False) as ckpt:
        ckpt.save(state)
    return str(d / "run"), str(ema_npz)


def test_checkpoint_dir_serves_the_trained_params(files, checkpoint,
                                                  capsys):
    cfg_path, npz = files
    ckpt_dir, ema_npz = checkpoint
    outs = []
    for source in (["--params-npz", npz], ["--checkpoint-dir", ckpt_dir],
                   ["--checkpoint-dir", ckpt_dir, "--step", "5"],
                   ["--params-npz", ema_npz],
                   ["--checkpoint-dir", ckpt_dir, "--ema"]):
        generate.main(["--config", cfg_path, "--device", "cpu", *source,
                       *ARGS])
        outs.append(capsys.readouterr().out)
    assert outs[0].count("===") == 2
    assert outs[1] == outs[2] == outs[0]
    assert outs[4] == outs[3] != outs[0]


@pytest.mark.parametrize("extra,message", [
    (["--ema"], "--ema needs --checkpoint-dir"),
    (["--ema", "--checkpoint-dir", "CKPT", "--step", "0"], "no 'ema' item"),
    (["--params-npz", "NPZ", "--checkpoint-dir", "CKPT"],
     "mutually exclusive"),
])
def test_invalid_checkpoint_options_exit(files, tmp_path, extra, message):
    """The reference's SystemExit for --ema without a checkpoint, and for
    --ema on a checkpoint that has no EMA item; --params-npz with
    --checkpoint-dir is refused the same way."""
    from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
    from cloud_server_tpu_torch.config import TrainConfig
    from cloud_server_tpu_torch.training.checkpoint import Checkpointer
    from cloud_server_tpu_torch.training.train_step import init_train_state
    cfg_path, npz = files
    ckpt_dir = tmp_path / "plain"
    with Checkpointer(ckpt_dir, async_save=False) as ckpt:
        ckpt.save(init_train_state(TModelConfig(**MODEL), TrainConfig(), 0,
                                   "cpu"))
    extra = [str(ckpt_dir) if a == "CKPT" else npz if a == "NPZ" else a
             for a in extra]
    with pytest.raises(SystemExit, match=message):
        generate.main(["--config", cfg_path, "--device", "cpu", *extra,
                       *ARGS])


def test_cli_needs_a_gpu_or_device_cpu(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--config", files[0], *ARGS])


@pytest.fixture(scope="module")
def draft_config(tmp_path_factory):
    d = tmp_path_factory.mktemp("draft")
    path = d / "draft.json"
    path.write_text(json.dumps({"model": {
        **MODEL, "embed_dim": 16, "num_layers": 1, "num_heads": 2,
        "num_kv_heads": 2, "mlp_dim": 32,
        # the reference's batch API runs the contiguous engine, which
        # has no kernel path
        "decode_attention_impl": "xla"}}))
    return str(path)


def _reference_draft_params(monkeypatch):
    """The port's draft weights: the reference's random init from the
    seed the CLI asks for, crossed as numpy arrays."""
    def load(cfg, ckpt, step, seed, device):
        from cloud_server_tpu_torch.models.transformer import (
            params_from_numpy)
        ref = ref_tf.init_params(ModelConfig(**{
            k: getattr(cfg, k) for k in MODEL}), jax.random.key(seed))
        return params_from_numpy(jax.tree.map(np.asarray, ref), cfg,
                                 device=device)
    monkeypatch.setattr(generate, "load_params", load)


@pytest.mark.parametrize("flags", [
    ["--spec-drafts", "2"],
    ["--spec-drafts", "3", "--spec-control", "off", "--scheduler",
     "alternating"],
    ["--draft-config", "DRAFT", "--num-draft", "2"],
    ["--top-k", "5", "--top-p", "0.9", "--temperature", "0.7"],
    ["--mixed-token-budget", "24", "--add-bos"]],
    ids=["spec_ngram", "spec_fixed_alternating", "draft_model",
         "top_k_top_p", "budget_bos"])
def test_new_flags_print_the_reference_text(files, draft_config, capsys,
                                            flags, monkeypatch):
    """The speculation, sampling, budget and BOS flags reach the server:
    the same text as the reference's CLI given the same flags. With a
    draft model, batch mode runs the speculative batch API in both CLIs
    (no server is built); both draft models are the reference's init
    from --seed + 1, the port's crossed as numpy arrays."""
    cfg_path, npz = files
    flags = [draft_config if a == "DRAFT" else a for a in flags]
    ref_generate.main(["--config", cfg_path, "--decode-impl", "xla",
                       *ARGS, *flags])
    want = capsys.readouterr().out
    seen = {}
    from cloud_server_tpu_torch.inference import paged_server

    class Spy(paged_server.PagedInferenceServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.update(spec=self.spec_drafts, budget=self.mixed_token_budget,
                        adaptive=self.spec_control is not None,
                        draft=self.draft_cfg is not None,
                        top=(self.infer_cfg.top_k, self.infer_cfg.top_p))

    if "--draft-config" in flags:
        _reference_draft_params(monkeypatch)
    monkeypatch.setattr(paged_server, "PagedInferenceServer", Spy)
    generate.main(["--config", cfg_path, "--params-npz", npz,
                   "--device", "cpu", *ARGS, *flags])
    assert capsys.readouterr().out == want
    if "--draft-config" in flags:
        assert seen == {}
        return
    assert seen["spec"] == (int(flags[1]) if flags[0] == "--spec-drafts"
                            else 0)
    assert not seen["draft"]
    assert seen["adaptive"] == (seen["spec"] > 0 and "off" not in flags)
    if "--mixed-token-budget" in flags:
        assert seen["budget"] == 24
    if "--top-k" in flags:
        assert seen["top"] == (5, 0.9)


SEEDED = ["--temperature", "0.7", "--top-k", "20", "--seed", "3"]


@pytest.mark.parametrize("flags", [
    ["--contiguous"],
    ["--contiguous", "--no-overlap", "--decode-chunk", "4"],
    ["--contiguous", "--prefix", "hello", "--prompt", "hello there"],
    ["--contiguous", *SEEDED],
    ["--contiguous", "--kv-cache-int8", "--add-bos"],
    ["--ngram-draft", "--num-draft", "3"],
    ["--ngram-draft", *SEEDED],
    ["--draft-config", "DRAFT", "--num-draft", "3", *SEEDED],
    ["--draft-config", "DRAFT", "--max-len", "24"],
    ["--quantize"],
    ["--quantize", "--contiguous", *SEEDED],
    ["--quantize", "--prefix", "hello"]],
    ids=["contiguous", "contiguous_chunk_no_overlap", "contiguous_prefix",
         "contiguous_seeded", "contiguous_int8_bos", "ngram_draft",
         "ngram_draft_seeded", "draft_config_seeded", "draft_clamped",
         "quantize", "quantize_contiguous_seeded", "quantize_paged_prefix"])
def test_batch_paths_print_the_reference_text(files, draft_config, capsys,
                                              flags, monkeypatch):
    """The contiguous server (with --prefix caching), the speculative
    batch API (n-gram and draft model, greedy and seeded) and int8
    weight-only params print the reference CLI's text, and its stderr
    notes (the --max-new clamp, the paged server's --prefix note) word
    for word. The seeded --draft-config case draws from the reference's
    key stream through speculative_generate, which the paged server's
    in-server speculation does not (C13, ROADMAP's Queue C)."""
    cfg_path, npz = files
    flags = [draft_config if a == "DRAFT" else a for a in flags]
    if "--draft-config" in flags:
        _reference_draft_params(monkeypatch)
    ref_generate.main(["--config", cfg_path, "--decode-impl", "xla",
                       *ARGS, *flags])
    want = capsys.readouterr()
    generate.main(["--config", cfg_path, "--params-npz", npz,
                   "--device", "cpu", "--decode-impl", "xla", *ARGS,
                   *flags])
    got = capsys.readouterr()
    assert want.out.count("===") >= 2
    assert got.out == want.out
    notes = [ln for ln in want.err.splitlines()
             if "clamping" in ln or "note:" in ln]
    assert notes == [ln for ln in got.err.splitlines()
                     if "clamping" in ln or "note:" in ln]
    if "--max-len" in flags or "--prefix" in flags and "--quantize" in flags:
        assert notes


@pytest.mark.parametrize("extra", [
    ["--ngram-draft", "--quantize"],
    ["--ngram-draft", "--draft-config", "DRAFT"],
    ["--ngram-draft", "--prefix", "hi"],
    ["--draft-config", "DRAFT", "--max-len", "12"],
    ["--contiguous", "--decode-impl", "pallas"],
    ["--contiguous", "--draft-config", "DRAFT", "--serve-http", "0"],
    ["--ngram-draft", "--serve-http", "0"]],
    ids=["quantize", "two_sources", "prefix", "no_room", "pallas",
         "draft_serve", "ngram_serve"])
def test_batch_path_refusals_match_the_reference(files, draft_config,
                                                 extra):
    """The reference's SystemExits for the speculative batch API and the
    contiguous server, word for word."""
    cfg_path, npz = files
    extra = [draft_config if a == "DRAFT" else a for a in extra]
    with pytest.raises(SystemExit) as want:
        ref_generate.main(["--config", cfg_path, "--decode-impl", "xla",
                           *ARGS, *extra])
    with pytest.raises(SystemExit) as got:
        generate.main(["--config", cfg_path, "--params-npz", npz,
                       "--device", "cpu", "--decode-impl", "xla", *ARGS,
                       *extra])
    assert str(got.value) == str(want.value) and str(want.value)


@pytest.mark.parametrize("extra,message", [
    (["--spec-drafts", "2", "--contiguous"], "cannot run with --contiguous"),
    (["--spec-drafts", "2", "--ngram-draft"], "mutually exclusive"),
])
def test_spec_flag_refusals_match_the_reference(files, extra, message):
    """The reference's SystemExits for --spec-drafts with --contiguous
    or with --ngram-draft, word for word."""
    cfg_path, npz = files
    with pytest.raises(SystemExit, match=message) as want:
        ref_generate.main(["--config", cfg_path, *ARGS, *extra])
    with pytest.raises(SystemExit, match=message) as got:
        generate.main(["--config", cfg_path, "--params-npz", npz,
                       "--device", "cpu", *ARGS, *extra])
    assert str(got.value) == str(want.value)


def test_draft_config_is_llama_3_2_1b():
    """The draft config maps Llama-3.2-1B's published config.json onto
    ModelConfig, and speculation compares its vocabulary with the
    Llama-3.1-8B target's element for element."""
    from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
    from cloud_server_tpu_torch.config import from_json
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent / "cloud_server_tpu_torch"
    root = str(root / "configs") + "/"
    with open(root + "llama3_2_1b_draft.json") as f:
        raw = json.load(f)
    assert "Llama-3.2-1B" in raw["_source"] and len(raw["_source"]) <= 200
    cfg = from_json(TModelConfig, raw["model"])
    with open(root + "llama3_1_8b.json") as f:
        target = from_json(TModelConfig, json.load(f)["model"])
    assert (cfg.vocab_size, cfg.embed_dim, cfg.num_layers, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.mlp_dim) == (
        128256, 2048, 16, 32, 8, 64, 8192)
    assert (cfg.rope_theta, cfg.rope_scaling, cfg.rope_scaling_factor,
            cfg.rope_low_freq_factor, cfg.rope_high_freq_factor,
            cfg.rope_original_max_len) == (500000.0, "llama3", 32.0, 1.0,
                                           4.0, 8192)
    assert cfg.tie_embeddings and cfg.dtype == "bfloat16"
    assert cfg.vocab_size == target.vocab_size


POLICY_QOS = ('{"tenants": {"chat": {"priority": "interactive", '
              '"weight": 3}, "bulk": {"priority": "best_effort"}}}')
POLICY_SLO = ('{"windows_s": [60], "classes": {"default": '
              '{"objective": 0.99, "e2e_s": 60.0}}}')


def _policy_state(srv) -> dict:
    """What the policy flags configured on a server."""
    rec = srv.trace_recorder
    return {"tenants": None if srv.qos is None else sorted(srv.qos.tenants()),
            "slo": None if srv.slo is None else sorted(srv.slo.classes),
            "trace": None if rec is None else (
                rec.sample_rate, rec.capacity, rec.tail_capacity),
            "faults": None if srv._faults is None else srv._faults.stats(),
            "brownout": srv._brownout is not None,
            "anomaly": None if srv._anomaly is None else (
                srv._anomaly.warmup, srv._anomaly.hold_s),
            "bundle": srv._bundle_on_anomaly}


@pytest.mark.parametrize("flags", [
    ["--qos-config", POLICY_QOS, "--brownout", '{"hold_s": 1.0}'],
    ["--slo-config", POLICY_SLO, "--trace-sample-rate", "1.0",
     "--trace-capacity", "8", "--trace-tail-capacity", "4"],
    ["--trace-tail-capacity", "2"],
    ["--fault-plan", '{"faults": [{"site": "dispatch", "after": 1000}]}',
     "--anomaly-config", '{"warmup": 4, "hold_s": 2.0}',
     "--bundle-on-anomaly"]],
    ids=["qos_brownout", "slo_tracing", "tail_only", "faults_anomaly"])
def test_policy_flags_wire_like_the_reference(files, capsys, flags,
                                              monkeypatch):
    """The policy-layer flags configure the port's server as the
    reference's CLI configures its own (the same tenants, SLO classes,
    trace rings, fault sites, brownout, watchdog and bundle switch),
    and change no token of the printed text."""
    from cloud_server_tpu.inference import paged_server as ref_ps
    from cloud_server_tpu_torch.inference import paged_server
    seen = []
    for mod in (ref_ps, paged_server):
        base = mod.PagedInferenceServer

        class Spy(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                seen.append(_policy_state(self))

        monkeypatch.setattr(mod, "PagedInferenceServer", Spy)
    cfg_path, npz = files
    ref_generate.main(["--config", cfg_path, "--decode-impl", "xla",
                       *ARGS, *flags])
    want = capsys.readouterr().out
    generate.main(["--config", cfg_path, "--params-npz", npz,
                   "--device", "cpu", *ARGS, *flags])
    assert capsys.readouterr().out == want
    assert len(seen) == 2 and seen[1] == seen[0]
    assert any(v not in (None, False) for v in seen[1].values())


def test_profiler_port_is_refused(files):
    """The reference's profiler server has no PyTorch counterpart: the
    flag is refused before anything is loaded."""
    cfg_path, npz = files
    with pytest.raises(NotImplementedError, match="profiler server"):
        generate.main(["--config", cfg_path, "--params-npz", npz,
                       "--device", "cpu", *ARGS, "--profiler-port", "9999"])


def test_tokenizer_flag_prints_the_reference_text(files, tmp_path, capsys):
    """--tokenizer <local tokenizer.json>: a BPE trained here (its 200
    ids inside the model's 300) encodes the prompts and decodes the
    output; the port prints the reference's text for the same weights."""
    tokenizers = pytest.importorskip("tokenizers")
    bpe = tokenizers.Tokenizer(tokenizers.models.BPE(unk_token="<unk>"))
    bpe.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    bpe.train_from_iterator(
        ["the quick brown fox jumps over the lazy dog"] * 50,
        tokenizers.trainers.BpeTrainer(
            vocab_size=200,
            special_tokens=["<unk>", "<s>", "</s>", "<pad>"]))
    tok_path = str(tmp_path / "tokenizer.json")
    bpe.save(tok_path)
    cfg_path, npz = files
    argv = ["--tokenizer", tok_path, "--prompt", "the quick fox",
            "--prompt", "lazy dog", "--max-new", "10", "--temperature", "0",
            "--page-size", "8", "--prefill-chunk", "16", "--seed", str(SEED)]
    ref_generate.main(["--config", cfg_path, "--decode-impl", "xla", *argv])
    want = capsys.readouterr().out
    generate.main(["--config", cfg_path, "--params-npz", npz, "--device",
                   "cpu", *argv])
    got = capsys.readouterr().out
    assert want.count("===") == 2 and got == want
