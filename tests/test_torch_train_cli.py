"""The port's training CLI on the CPU: `--device cpu` trains a tiny model
for 3 steps and writes one JSONL record per step; with `--eval-data` and
`--checkpoint-dir` it evaluates, checkpoints and resumes; without
`--device cpu` (and without a GPU) it refuses; every option that is not
ported yet raises NotImplementedError, and --lora-rank trains adapters."""

import json

import numpy as np
import pytest
import torch

from cloud_server_tpu_torch import train
from cloud_server_tpu_torch.data.dataset import write_token_file
from cloud_server_tpu_torch.training.checkpoint import all_steps
from cloud_server_tpu_torch.utils.logging import read_jsonl

TINY = {"model": {"vocab_size": 64, "embed_dim": 32, "num_layers": 2,
                  "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
                  "mlp_dim": 64, "max_seq_len": 32, "dtype": "float32",
                  "param_dtype": "float32", "attention_impl": "flash",
                  "remat": "full"},
        "train": {"batch_size": 4, "seq_len": 16, "total_steps": 3,
                  "warmup_steps": 1, "learning_rate": 1e-2},
        "loop": {"log_interval": 1}}


def _config(tmp_path, **sections):
    raw = json.loads(json.dumps(TINY))
    raw.update(sections)
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_cli_trains_on_cpu_and_logs_jsonl(tmp_path):
    logdir = tmp_path / "logs"
    state = train.main(["--config", _config(tmp_path), "--synthetic", "16",
                        "--device", "cpu", "--logdir", str(logdir)])
    assert state.step == 3
    recs = read_jsonl(logdir / "train.jsonl")
    assert [r["step"] for r in recs] == [1, 2, 3]
    for r in recs:
        for key in ("loss", "grad_norm", "tokens_per_sec", "mfu"):
            assert key in r and r[key] == r[key]  # present, not NaN
    assert state.params["layers"]["wq"].dtype == torch.float32


def test_cli_runs_on_the_gpu_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--config", _config(tmp_path), "--synthetic", "16"])


def test_cli_eval_data_checkpoint_dir_and_resume(tmp_path, capsys):
    """--eval-data (a uint32 token file with its .meta.json sidecar) with
    no eval interval defaults it to 500 and says so; a second run with
    --eval-interval 1 and more steps resumes from the checkpoint,
    evaluates after each step and checkpoints at its end."""
    eval_path = tmp_path / "eval.bin"
    write_token_file(eval_path, np.random.default_rng(0).integers(
        0, 64, 16 * 8), dtype=np.uint32)
    (tmp_path / "eval.bin.meta.json").write_text(
        json.dumps({"dtype": "uint32"}))
    ckpt = tmp_path / "ckpt"
    common = ["--config", _config(tmp_path), "--synthetic", "16",
              "--device", "cpu", "--eval-data", str(eval_path),
              "--checkpoint-dir", str(ckpt)]
    state = train.main([*common, "--logdir", str(tmp_path / "a")])
    assert state.step == 3
    assert "defaulting loop.eval_interval=500" in capsys.readouterr().out
    assert all_steps(ckpt) == [3]
    assert not any("eval_loss" in r
                   for r in read_jsonl(tmp_path / "a" / "train.jsonl"))

    state = train.main([*common, "--logdir", str(tmp_path / "b"),
                        "--eval-interval", "1", "--steps", "5"])
    assert state.step == 5
    assert "resumed from step 3" in capsys.readouterr().out
    recs = read_jsonl(tmp_path / "b" / "train.jsonl")
    assert [r["step"] for r in recs if "loss" in r] == [4, 5]
    evals = [r for r in recs if "eval_loss" in r]
    assert [r["step"] for r in evals] == [4, 5]
    # eval_batches (16) batches of 4 rows: the eval loader cycles its
    # 2 batches, as the reference's does
    assert all(r["eval_tokens"] == 16 * 4 * 15 for r in evals)
    assert all_steps(ckpt) == [3, 5]


def _run_ranks(cfg_path, argv, logdir, n=2):
    """`train --distributed` in `n` processes in torchrun's environment
    (gloo on the CPU), with the rendezvous store hosted here, as
    torchrun's agent hosts it; returns each rank's output."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    store = torch.distributed.TCPStore("localhost", 0, is_master=True,
                                       wait_for_workers=False)
    procs = []
    for rank in range(n):
        env = {**os.environ, "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(store.port), "RANK": str(rank),
               "WORLD_SIZE": str(n), "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": str(n), "PYTHONPATH": repo,
               "TORCHELASTIC_USE_AGENT_STORE": "True"}
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cloud_server_tpu_torch.train",
             "--device", "cpu", "--config", cfg_path, "--synthetic", "16",
             "--logdir", str(logdir), *argv],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


@pytest.mark.parametrize("argv,sections", [
    (["--distributed"], {"mesh": {"pp": 2}}),
    (["--lora-rank", "4"], {}),
    (["--init-from", "ckpt"], {}),
    (["--distributed"], {"mesh": {"ep": 2},
                         "model": {**TINY["model"], "num_experts": 4}}),
    (["--distributed"], {"dcn_mesh": {"dp": 2}}),
])
def test_unported_options_raise(tmp_path, argv, sections):
    """The options the port once refused now train: a mesh with a pp
    axis (its ranks replicas, as the reference's CLI holds them: the CLI
    never pipelines) and an MoE model with its experts over ep, in two
    processes (--distributed, gloo), and a dcn_mesh section (a hybrid
    mesh, dp across hosts); a mesh's losses are the single process's.
    --lora-rank trains rank-R adapters over a frozen base, and
    --init-from without it exits with the reference's message."""
    def run():
        return train.main(["--config", _config(tmp_path, **sections),
                           "--synthetic", "16", "--device", "cpu", *argv])
    if argv[:1] == ["--lora-rank"]:
        state = run()
        assert state.step == 3 and set(state.params) == {"base", "lora"}
        assert not any(t.requires_grad
                       for t in state.params["base"]["layers"].values())
        assert all(ab["a"].requires_grad
                   for ab in state.params["lora"]["layers"].values())
    elif argv[:1] == ["--init-from"]:
        with pytest.raises(SystemExit, match="requires --lora-rank"):
            run()
    else:
        mesh_dir, one_dir = tmp_path / "mesh", tmp_path / "one"
        mesh_dir.mkdir()
        one_dir.mkdir()
        _run_ranks(_config(mesh_dir, **sections), argv, mesh_dir / "logs")
        model = sections.get("model", TINY["model"])
        train.main(["--config", _config(one_dir, model=model),
                    "--synthetic", "16", "--device", "cpu", "--logdir",
                    str(one_dir / "logs")])
        got = read_jsonl(mesh_dir / "logs" / "train.jsonl")
        want = read_jsonl(one_dir / "logs" / "train.jsonl")
        assert [r["step"] for r in got] == [1, 2, 3]
        np.testing.assert_allclose([r["loss"] for r in got],
                                   [r["loss"] for r in want], rtol=1e-5)
