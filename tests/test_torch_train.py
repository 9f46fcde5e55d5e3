"""The port's training path against the reference's, float32 on the CPU,
from the same numpy weights and batches:

  * `next_token_loss` and its gradients, leaf by leaf, for
    attention_impl "xla" and "flash" (the reference's flash in interpret
    mode), the dense and the vocab-chunked CE, with and without z-loss,
    with and without remat — loss within 1e-5 relative, every gradient
    leaf within 1e-4 of its largest reference entry;
  * the learning-rate schedules against optax's at every step (1e-6
    relative: float32 there, float64 here);
  * `fused_adamw` over 3 updates on identical gradients (the first large
    enough that clipping engages), parameters and moments within 1e-6;
  * one `make_train_step` step: loss and grad_norm within 1e-5
    relative, parameters after the update within 1e-6, with
    microbatch_steps 1 and 2;
  * the losses of a 4-step `train_loop` on SyntheticLMDataset within
    1e-4 relative of the reference loop's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_server_tpu.config import MeshConfig, ModelConfig, TrainConfig
from cloud_server_tpu.models import transformer as ref_tf
from cloud_server_tpu.parallel.mesh import make_mesh
from cloud_server_tpu.training import init_train_state as ref_init_state
from cloud_server_tpu.training import make_train_step as ref_make_step
from cloud_server_tpu.training import optim as ref_optim
from cloud_server_tpu_torch import config as tconfig
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.training import optim, train_step
from cloud_server_tpu_torch.training.loop import LoopConfig, train_loop
from cloud_server_tpu_torch.utils.logging import read_jsonl

TINY = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=32, dtype="float32",
    param_dtype="float32", remat="none")


def _t(cfg):
    """The reference's config as the port's config class."""
    for name in ("ModelConfig", "TrainConfig", "MeshConfig"):
        if type(cfg).__name__ == name:
            return getattr(tconfig, name)(**dataclasses.asdict(cfg))
    raise TypeError(type(cfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_params(np_params, cfg):
    params = transformer.params_from_numpy(np_params, _t(cfg), device="cpu",
                                           keep_param_dtype=True)
    return optim.map_tree(lambda p: p.requires_grad_(True), params)


def _tokens(b, s, vocab, seed=7):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _assert_tree_close(got: dict, want, tol, what=""):
    flat_want = dict(optim.flatten(_np_tree(want)))
    flat_got = dict(optim.flatten(got))
    assert sorted(flat_got) == sorted(flat_want)
    for path, w in flat_want.items():
        g = flat_got[path]
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(
            g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{what}{path}")


LOSS_CASES = {
    "xla": dict(attention_impl="xla"),
    "xla_zloss": dict(attention_impl="xla", z=1e-3),
    "xla_chunked": dict(attention_impl="xla", vocab_chunk=24),
    "flash_fused": dict(attention_impl="flash"),
    "flash_blocked_remat": dict(attention_impl="flash", flash_block_q=8,
                                flash_block_kv=8, remat="full"),
    "flash_chunked_zloss": dict(attention_impl="flash", vocab_chunk=16,
                                z=1e-3),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_next_token_loss_and_grads_match_reference(name):
    opts = dict(LOSS_CASES[name])
    z = opts.pop("z", 0.0)
    cfg = dataclasses.replace(TINY, **opts)
    ref_cfg = dataclasses.replace(cfg, remat="none")
    ref_params = ref_tf.init_params(ref_cfg, jax.random.key(1))
    tokens = _tokens(2, 16, cfg.vocab_size)
    (want_loss, want_m), want_g = jax.value_and_grad(
        ref_tf.next_token_loss, has_aux=True)(
        ref_params, {"tokens": jnp.asarray(tokens)}, ref_cfg, z)
    params = _port_params(_np_tree(ref_params), cfg)
    loss, metrics = transformer.next_token_loss(
        params, {"tokens": torch.from_numpy(tokens)}, _t(cfg), z)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for key in want_m:
        np.testing.assert_allclose(float(metrics[key]), float(want_m[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    _assert_tree_close(optim.map_tree(lambda p: p.grad, params), want_g,
                       1e-4, "grad ")


SCHEDULES = ["warmup_cosine", "constant", "wsd"]


def _tcfg(schedule, **kw):
    base = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                lr_schedule=schedule, weight_decay=0.1, grad_clip_norm=0.5)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_optax(schedule, warmup):
    cfg = _tcfg(schedule, warmup_steps=warmup, total_steps=20)
    want = ref_optim.make_schedule(cfg)
    got = optim.make_schedule(_t(cfg))
    for count in range(cfg.total_steps + 5):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_fused_adamw_matches_reference(schedule):
    cfg = _tcfg(schedule)
    r = np.random.default_rng(3)
    np_params = {"layers": {"w": r.standard_normal((3, 4)).astype(
        np.float32), "attn_norm": np.ones((3,), np.float32)},
        "final_norm": {"scale": np.ones((4,), np.float32)}}
    ref_opt = ref_optim.fused_adamw(cfg)
    ref_params = jax.tree.map(jnp.asarray, np_params)
    ref_state = ref_opt.init(ref_params)
    opt = optim.fused_adamw(_t(cfg))
    params = optim.map_tree(lambda x: torch.from_numpy(x.copy()), np_params)
    state = opt.init(params)
    for i in range(3):
        scale = 100.0 if i == 0 else 0.1
        np_grads = jax.tree.map(
            lambda p: (scale * r.standard_normal(p.shape)).astype(
                np.float32), np_params)
        upd, ref_state = ref_opt.update(
            jax.tree.map(jnp.asarray, np_grads), ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, upd)
        state, gnorm = opt.step_(
            optim.map_tree(lambda g: torch.from_numpy(g.copy()), np_grads),
            state, params)
        np.testing.assert_allclose(float(gnorm), float(
            optax.global_norm(jax.tree.map(jnp.asarray, np_grads))),
            rtol=1e-6)
        _assert_tree_close(params, ref_params, 1e-6, f"step {i} param ")
        _assert_tree_close(state.mu, ref_state.mu, 1e-6, f"step {i} mu ")
        _assert_tree_close(state.nu, ref_state.nu, 1e-6, f"step {i} nu ")
    assert state.count == int(ref_state.count) == 3


def test_ema_of_params_matches_reference():
    cfg = _tcfg("constant", ema_decay=0.9)
    r = np.random.default_rng(4)
    np_params = {"layers": {"w": r.standard_normal((2, 3)).astype(
        np.float32)}, "final_norm": {"scale": np.ones((3,), np.float32)}}
    ref_opt = ref_optim.make_optimizer(cfg)
    ref_params = jax.tree.map(jnp.asarray, np_params)
    ref_state = ref_opt.init(ref_params)
    opt = optim.make_optimizer(_t(cfg))
    params = optim.map_tree(lambda x: torch.from_numpy(x.copy()), np_params)
    state = opt.init(params)
    for _ in range(3):
        np_grads = jax.tree.map(lambda p: r.standard_normal(p.shape).astype(
            np.float32), np_params)
        upd, ref_state = ref_opt.update(
            jax.tree.map(jnp.asarray, np_grads), ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, upd)
        state, _ = opt.step_(optim.map_tree(
            lambda g: torch.from_numpy(g.copy()), np_grads), state, params)
    _assert_tree_close(optim.ema_params(state),
                       ref_optim.ema_params(ref_state), 1e-6, "ema ")
    assert optim.ema_params(opt.adamw.init(params)) is None


@pytest.mark.parametrize("microbatch_steps", [1, 2])
def test_train_step_matches_reference(microbatch_steps):
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                       batch_size=4, seq_len=16,
                       microbatch_steps=microbatch_steps)
    mesh = make_mesh(MeshConfig())
    ref_state = ref_init_state(TINY, tcfg, mesh, jax.random.key(0))
    np_params = _np_tree(ref_state.params)
    ref_step, _ = ref_make_step(TINY, tcfg, mesh)
    tokens = _tokens(4, 16, TINY.vocab_size)
    ref_state, ref_m = ref_step(ref_state, {"tokens": jnp.asarray(tokens)})

    state = train_step.train_state_from_params(
        _port_params(np_params, TINY), _t(tcfg))
    step = train_step.make_train_step(_t(TINY), _t(tcfg))
    state, metrics = step(state, {"tokens": torch.from_numpy(tokens).long()})
    assert state.step == 1
    for key in ("loss", "grad_norm", "accuracy"):
        np.testing.assert_allclose(float(metrics[key]), float(ref_m[key]),
                                   rtol=1e-5, err_msg=key)
    _assert_tree_close(state.params, ref_state.params, 1e-6, "param ")


def test_train_loop_tracks_reference(tmp_path):
    from cloud_server_tpu.data.dataset import SyntheticLMDataset as RefDS
    from cloud_server_tpu.training.loop import LoopConfig as RefLoop
    from cloud_server_tpu.training.loop import train_loop as ref_loop
    from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
    from cloud_server_tpu_torch.training import loop as tloop

    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=4,
                       batch_size=4, seq_len=16)
    ref_loop(TINY, tcfg, RefDS(32, 16, TINY.vocab_size, seed=0),
             loop_cfg=RefLoop(log_interval=1, logdir=str(tmp_path / "ref")))
    want = [r["loss"] for r in read_jsonl(tmp_path / "ref" / "train.jsonl")]

    # the reference loop draws its weights from jax.random.key(seed); the
    # port's loop starts from the same numbers
    mesh = make_mesh(MeshConfig())
    np_params = _np_tree(ref_init_state(TINY, tcfg, mesh,
                                        jax.random.key(tcfg.seed)).params)

    def same_init(model_cfg, train_cfg, seed, device):
        return train_step.train_state_from_params(
            _port_params(np_params, TINY), train_cfg)

    orig = tloop.init_train_state
    tloop.init_train_state = same_init
    try:
        train_loop(_t(TINY), _t(tcfg),
                   SyntheticLMDataset(32, 16, TINY.vocab_size, seed=0),
                   loop_cfg=LoopConfig(log_interval=1,
                                       logdir=str(tmp_path / "port")),
                   device="cpu")
    finally:
        tloop.init_train_state = orig
    got = [r["loss"] for r in read_jsonl(tmp_path / "port" / "train.jsonl")]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("what", ["remat_dots", "ce_pallas", "segments",
                                  "mesh", "checkpoint", "eval"])
def test_unported_options_raise(what, tmp_path):
    cfg = _t(TINY)
    params = transformer.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros((2, 8), dtype=torch.long)}
    with pytest.raises(NotImplementedError):
        if what == "remat_dots":
            transformer.next_token_loss(
                params, batch, dataclasses.replace(cfg, remat="dots"))
        elif what == "ce_pallas":
            transformer.next_token_loss(
                params, batch, dataclasses.replace(cfg, ce_impl="pallas"))
        elif what == "segments":
            transformer.next_token_loss(
                params, {**batch, "segment_ids": torch.zeros((2, 8))}, cfg)
        elif what == "mesh":
            train_step.make_train_step(cfg, _t(TrainConfig()),
                                       tconfig.MeshConfig(fsdp=2))
        elif what == "checkpoint":
            train_loop(cfg, _t(TrainConfig()), [], device="cpu",
                       loop_cfg=LoopConfig(checkpoint_dir=str(tmp_path)))
        else:
            train_loop(cfg, _t(TrainConfig()), [], device="cpu",
                       eval_dataset=[])
