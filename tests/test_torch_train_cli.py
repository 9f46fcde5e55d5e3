"""The port's training CLI on the CPU: `--device cpu` trains a tiny model
for 3 steps and writes one JSONL record per step; without it (and
without a GPU) it refuses; every option that is not ported yet raises
NotImplementedError."""

import json

import pytest
import torch

from cloud_server_tpu_torch import train
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


@pytest.mark.parametrize("argv,sections", [
    (["--checkpoint-dir", "ckpt"], {}),
    (["--eval-data", "eval.bin"], {}),
    (["--distributed"], {}),
    (["--lora-rank", "4"], {}),
    (["--init-from", "ckpt"], {}),
    ([], {"mesh": {"fsdp": 2}}),
    ([], {"dcn_mesh": {"dp": 2}}),
    ([], {"loop": {"checkpoint_dir": "ckpt"}}),
])
def test_unported_options_raise(tmp_path, argv, sections):
    with pytest.raises(NotImplementedError):
        train.main(["--config", _config(tmp_path, **sections),
                    "--synthetic", "16", "--device", "cpu", *argv])
