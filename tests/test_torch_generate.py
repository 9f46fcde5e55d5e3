"""The port's batch CLI against the reference's: same config, same
weights (the reference's random init from --seed, handed to the port as
a .npz), greedy — the same text. Without a GPU the port's CLI refuses to
run unless given --device cpu."""

import json

import jax
import numpy as np
import pytest
import torch

from cloud_server_tpu import generate as ref_generate
from cloud_server_tpu.config import ModelConfig
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch import generate

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


def test_cli_needs_a_gpu_or_device_cpu(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--config", files[0], *ARGS])
