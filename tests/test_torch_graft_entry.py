"""The port's graft entry (`cloud_server_tpu_torch/graft_entry.py`)
against the repository root's `__graft_entry__.entry`: the same config
field for field, tokens of the same shape, and a forward that gives the
reference's logits shape (the reference's traced abstractly, the port's
run on the CPU)."""

import dataclasses
import gc

import jax
import pytest
import torch

import __graft_entry__
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu_torch.graft_entry import entry


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the reference's traced programs when the module ends (the
    map-limit rule of the other reference-building modules)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def reference(request):
    """The reference entry, its parameters drawn abstractly (shapes
    only): (its config, its logits' shape and dtype, its tokens)."""
    seen = {}
    real = ref_tf.init_params

    def abstract_init(cfg, key):
        seen["cfg"] = cfg
        return jax.eval_shape(lambda k: real(cfg, k), key)

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_tf, "init_params", abstract_init)
    try:
        fn, (params, tokens) = __graft_entry__.entry()
    finally:
        mp.undo()
    out = jax.eval_shape(fn, params, tokens)
    return seen["cfg"], out, tokens


@pytest.fixture(scope="module")
def port_entry():
    return entry(device="cpu")


def test_entry_builds_the_reference_config(reference, port_entry):
    ref_cfg, _, ref_tokens = reference
    fn, (params, tokens) = port_entry
    assert dataclasses.asdict(fn.cfg) == dataclasses.asdict(ref_cfg)
    assert tuple(tokens.shape) == tuple(ref_tokens.shape) == (2, 256)
    assert tokens.dtype == torch.int64 and not tokens.any()
    assert params["layers"]["wq"].shape == (8, 1024, 8, 128)
    assert params["embed"]["tokens"].device.type == "cpu"


def test_entry_forward_gives_the_reference_logits_shape(reference,
                                                        port_entry):
    _, ref_out, _ = reference
    fn, args = port_entry
    with torch.no_grad():
        logits = fn(*args)
    assert tuple(logits.shape) == tuple(ref_out.shape) == (2, 256, 32000)
    assert logits.dtype == torch.float32 and str(ref_out.dtype) == "float32"
    assert torch.isfinite(logits).all()


def test_entry_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
