"""The port's evaluation harness against the reference's, float32 on the
CPU, from the same numpy weights (tests/test_evaluate.py's cases):
loglikelihood scores (1e-4 absolute of the reference's and of a
hand-rolled numpy reference) and greedy flags, greedy detection, tail
truncation, validation, corpus perplexity (loss 1e-5 relative of the
reference's, token counts exact), and the CLI end to end."""

import gc
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cloud_server_tpu import evaluate as ref_eval
from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch import config as tconfig
from cloud_server_tpu_torch import evaluate
from cloud_server_tpu_torch.models import transformer

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=64, dtype="float32",
    param_dtype="float32", remat="none")
TCFG = tconfig.ModelConfig(**CFG.__dict__)


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the reference's compiled XLA programs when the module ends
    (each holds a few memory maps; see tests/test_torch_moe.py)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def params():
    ref = ref_tf.init_params(CFG, jax.random.key(0))
    port = transformer.params_from_numpy(jax.tree.map(np.asarray, ref),
                                         TCFG, device="cpu")
    return ref, port


def _ref_sum_lp(port, ctx, cont):
    """Hand-rolled reference: the port's full forward, per-token
    log-softmax gather in numpy (float64)."""
    with torch.no_grad():
        logits = transformer.forward(port, torch.tensor([ctx + cont]),
                                     TCFG)[0].double().numpy()
    m = logits.max(-1, keepdims=True)
    lp = logits - m - np.log(np.exp(logits - m).sum(-1, keepdims=True))
    total, greedy = 0.0, True
    for i, t in enumerate(cont):
        pos = len(ctx) + i - 1
        total += lp[pos, t]
        greedy &= int(logits[pos].argmax()) == t
    return total, greedy


def test_loglikelihoods_match_reference(params):
    ref, port = params
    pairs = [([5, 9, 3], [17, 2]),
             ([60, 1], [4]),
             (list(range(1, 20)), [7, 8, 9]),
             ([], [12, 13])]
    out = evaluate.loglikelihoods(port, TCFG, pairs, batch_size=2)
    want = ref_eval.loglikelihoods(ref, CFG, pairs, batch_size=2)
    for (ctx, cont), got, w in zip(pairs, out, want):
        assert got["sum_logprob"] == pytest.approx(w["sum_logprob"],
                                                   abs=1e-4)
        assert got["is_greedy"] == w["is_greedy"]
        assert got["num_tokens"] == w["num_tokens"] == len(cont)
        if ctx:
            hand, hand_greedy = _ref_sum_lp(port, ctx, cont)
            assert got["sum_logprob"] == pytest.approx(hand, abs=1e-4)
            assert got["is_greedy"] == hand_greedy


def test_loglikelihood_greedy_positive_case(params):
    """A continuation that IS the greedy decode gets is_greedy True, a
    perturbed one False."""
    _, port = params
    ctx = [5, 9, 3]
    with torch.no_grad():
        logits = transformer.forward(port, torch.tensor([ctx]), TCFG)
    nxt = int(logits[0, -1].argmax())
    out = evaluate.loglikelihoods(port, TCFG, [(ctx, [nxt]),
                                               (ctx, [(nxt + 1) % 64])])
    assert out[0]["is_greedy"] is True
    assert out[1]["is_greedy"] is False
    assert out[0]["sum_logprob"] > out[1]["sum_logprob"]


def test_loglikelihood_tail_truncation(params):
    """An over-long context keeps its tail; the continuation score equals
    scoring the explicitly truncated pair, and the reference's."""
    ref, port = params
    long_ctx = [(i * 5) % 60 + 1 for i in range(100)]  # > max_seq_len
    cont = [11, 12]
    out_long = evaluate.loglikelihoods(port, TCFG, [(long_ctx, cont)])
    kept = long_ctx[len(long_ctx) + len(cont) - CFG.max_seq_len:]
    out_kept = evaluate.loglikelihoods(port, TCFG, [(kept, cont)])
    assert out_long[0]["sum_logprob"] == pytest.approx(
        out_kept[0]["sum_logprob"], abs=1e-4)
    want = ref_eval.loglikelihoods(ref, CFG, [(long_ctx, cont)])
    assert out_long[0]["sum_logprob"] == pytest.approx(
        want[0]["sum_logprob"], abs=1e-4)


def test_loglikelihood_validation(params):
    _, port = params
    with pytest.raises(ValueError):
        evaluate.loglikelihoods(port, TCFG, [([1], [])])
    with pytest.raises(ValueError):  # continuation alone exceeds S
        evaluate.loglikelihoods(port, TCFG, [([1], list(range(70)))])


def test_perplexity_matches_loss(params, tmp_path):
    """Corpus ppl == exp(mean next-token NLL) over the same full batches,
    and the reference's perplexity."""
    ref, port = params
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 60, size=300, dtype=np.uint16)
    path = tmp_path / "val.bin"
    tokens.tofile(path)
    res = evaluate.perplexity(port, TCFG, str(path), batch_size=2,
                              seq_len=32)
    n_rows = (300 // 32 // 2) * 2
    rows = tokens[:n_rows * 32].reshape(n_rows, 32).astype(np.int64)
    with torch.no_grad():
        lp = torch.log_softmax(transformer.forward(
            port, torch.from_numpy(rows), TCFG), -1)
    tok_lp = torch.gather(lp[:, :-1], -1,
                          torch.from_numpy(rows[:, 1:, None]))[..., 0]
    want = float(-tok_lp.mean())
    assert res["loss"] == pytest.approx(want, abs=1e-4)
    assert res["ppl"] == pytest.approx(math.exp(want), rel=1e-3)
    assert res["tokens"] == n_rows * 31
    ref_res = ref_eval.perplexity(ref, CFG, str(path), batch_size=2,
                                  seq_len=32)
    assert res["loss"] == pytest.approx(ref_res["loss"], rel=1e-5)
    assert (res["tokens"], res["windows"]) == (ref_res["tokens"],
                                               ref_res["windows"])


def test_cli_end_to_end(tmp_path):
    """The CLI scores a corpus and requests in one run (random init) on
    the CPU, and prints the reference's JSON keys."""
    model = {"vocab_size": 300, "embed_dim": 32, "num_layers": 2,
             "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
             "mlp_dim": 64, "max_seq_len": 64, "dtype": "float32",
             "param_dtype": "float32", "remat": "none"}
    (tmp_path / "cfg.json").write_text(json.dumps({"model": model}))
    np.random.default_rng(1).integers(
        0, 255, size=400, dtype=np.uint16).tofile(tmp_path / "val.bin")
    with open(tmp_path / "reqs.jsonl", "w") as f:
        f.write(json.dumps({"context": "ab", "continuation": "cd"}) + "\n")
        f.write(json.dumps({"context_tokens": [1, 2],
                            "continuation_tokens": [3]}) + "\n")
    proc = subprocess.run(
        [sys.executable, "-m", "cloud_server_tpu_torch.evaluate",
         "--config", str(tmp_path / "cfg.json"),
         "--data", str(tmp_path / "val.bin"),
         "--requests", str(tmp_path / "reqs.jsonl"),
         "--tokenizer", "byte", "--batch-size", "2", "--seq-len", "32",
         "--device", "cpu"],
        capture_output=True, text=True, env=dict(os.environ), timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["perplexity"]["tokens"] > 0
    assert out["perplexity"]["ppl"] > 1.0
    assert out["perplexity"]["bits_per_byte"] == pytest.approx(
        out["perplexity"]["loss"] / math.log(2))
    assert len(out["requests"]) == 2
    assert out["summary"]["n"] == 2
    assert all("sum_logprob" in r for r in out["requests"])


def test_load_requests_matches_reference(tmp_path):
    """Text and token requests parse to the reference's pairs; a text
    request without a tokenizer and an empty file are refused."""
    from cloud_server_tpu.data.tokenizer import ByteTokenizer as RefByte
    from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
    path = tmp_path / "reqs.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({"context": "héllo", "continuation": " w"})
                + "\n\n")
        f.write(json.dumps({"continuation_tokens": [3, 4]}) + "\n")
    assert evaluate._load_requests(str(path), ByteTokenizer()) == \
        ref_eval._load_requests(str(path), RefByte())
    with pytest.raises(ValueError, match="--tokenizer"):
        evaluate._load_requests(str(path), None)
    (tmp_path / "empty.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="no requests"):
        evaluate._load_requests(str(tmp_path / "empty.jsonl"), None)
