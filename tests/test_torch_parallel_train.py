"""Data-, tensor- and sequence-parallel training of the port (one process
per rank over gloo on the CPU, started by `parallel.spawn_ranks`)
against the reference's sharded training on the conftest's 8 CPU
devices, on the reference's weights and batch crossed as numpy arrays:

* the sharded train step at fsdp 2 x tp 2, two steps (loss, metrics,
  both AdamW moments and the parameters), with the dense CE and with
  the fused CE route (whose tp combine runs over vocabulary shards of 32
  rows, padded to 128);
* `ring_attention_sharded` and `ulysses_attention_sharded`: outputs and
  q/k/v gradients at sp 2 and 4, GQA, the MHA expansion, packed
  segments, and the head-count ValueError;
* the port's mesh step against its own single-device step at dp 2,
  fsdp 4, and tp 2 x sp 2 (ring, Ulysses, packed rows); grad
  accumulation against the full batch; the parameters split per rank by
  the rules; eval's global sums; the loader's rows per rank against the
  reference's ShardedSampler; an fsdp 2 checkpoint restored onto
  fsdp 4 x tp 2 bit for bit; the refusals.

The ranks run `tests/torch_train_ranks.py` (torch only); the spawns run
while this process runs the reference."""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import MeshConfig as RefMeshConfig
from cloud_server_tpu.config import ModelConfig as RefModelConfig
from cloud_server_tpu.config import TrainConfig as RefTrainConfig
from cloud_server_tpu.data.loader import ShardedSampler as RefSampler
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu.parallel.mesh import make_mesh as ref_make_mesh
from cloud_server_tpu.parallel.ring_attention import (
    ring_attention_sharded as ref_ring)
from cloud_server_tpu.parallel.ulysses import (
    ulysses_attention_sharded as ref_ulysses)
from cloud_server_tpu.training import init_train_state as ref_init_state
from cloud_server_tpu.training import make_train_step as ref_make_step
from cloud_server_tpu_torch.config import ModelConfig, TrainConfig
from cloud_server_tpu_torch.data.dataset import SyntheticLMDataset
from cloud_server_tpu_torch.parallel import spawn_ranks
from cloud_server_tpu_torch.training.optim import flatten

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_ranks as ranks  # noqa: E402
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_TINY = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=8, mlp_dim=64, max_seq_len=64,
             dtype="float32", param_dtype="float32", remat="none")
_TRAIN = dict(learning_rate=1e-2, warmup_steps=1, total_steps=6,
              batch_size=8, seq_len=32)
REF_CFG = RefModelConfig(**_TINY)
CFG = ModelConfig(**_TINY)
REF_TCFG = RefTrainConfig(**_TRAIN)
TCFG = TrainConfig(**_TRAIN)
# the fused CE route (its tp combine over 32-row vocabulary shards,
# padded to 128) with the flash attention route, remat "full"
FUSED = dict(ce_impl="pallas", attention_impl="flash", remat="full")

# the port's mesh step against its own single-device step:
# (name, mesh axes, config overrides, packed)
OWN_CASES = [
    ("fsdp4_chunked", {"fsdp": 4}, {"vocab_chunk": 16}, False),
    ("tp2_sp2_ring", {"tp": 2, "sp": 2}, {"attention_impl": "ring"}, False),
    ("tp2_sp2_ulysses", {"tp": 2, "sp": 2},
     {"attention_impl": "ulysses"}, False),
    ("tp2_sp2_ring_packed", {"tp": 2, "sp": 2}, {"attention_impl": "ring"},
     True),
]
# ring / Ulysses against the reference: (impl, sp, kv heads, packed,
# the port's mesh axes). Ulysses at tp 2 x sp 2 holds one kv head a rank
# (the MHA expansion); at sp 4 over 2 kv heads too.
ATTN_CASES = {
    "ring_sp2_gqa": ("ring", 2, 2, False, {"fsdp": 2, "sp": 2}),
    "ring_sp4_packed": ("ring", 4, 2, True, {"sp": 4}),
    "ulysses_sp2_packed_mha": ("ulysses", 2, 2, True, {"tp": 2, "sp": 2}),
    "ulysses_sp4_gqa": ("ulysses", 4, 4, False, {"sp": 4}),
    "ulysses_sp4_mha": ("ulysses", 4, 2, True, {"sp": 4}),
}
DEADLINE_S = 240.0


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    return dict(flatten(_np_tree(tree)))


def _packed(b, s, rng) -> np.ndarray:
    """Packed-row segment ids: a few documents a row, then padding (0)."""
    seg = np.zeros((b, s), np.int32)
    for r in range(b):
        cuts = np.sort(rng.choice(np.arange(2, s - 2), 2, replace=False))
        seg[r, :cuts[0]] = 1
        seg[r, cuts[0]:cuts[1]] = 2
        seg[r, cuts[1]:s - 1] = 3
    return seg


def _attn_inputs(kh, packed, seed):
    r = np.random.default_rng(seed)
    b, s, h, d = 2, 16, 4, 8
    q = r.standard_normal((b, s, h, d)).astype(np.float32)
    k = r.standard_normal((b, s, kh, d)).astype(np.float32)
    v = r.standard_normal((b, s, kh, d)).astype(np.float32)
    cot = r.standard_normal((b, s, h, d)).astype(np.float32)
    seg = _packed(b, s, r) if packed else None
    return q, k, v, cot, seg


def _ref_attention(impl, sp, q, k, v, cot, seg):
    mesh = ref_make_mesh(RefMeshConfig(sp=sp))
    fn = ref_ring if impl == "ring" else ref_ulysses
    s = None if seg is None else jnp.asarray(seg)

    def loss(q, k, v):
        out = fn(q, k, v, mesh, segment_ids=s)
        return (out * cot).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {"out": np.asarray(out),
            **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"), grads)}}


def _reference(np_params, tokens) -> dict:
    """The reference's fsdp 2 x tp 2 step, two steps; its ring / Ulysses
    attention cases."""
    mesh = ref_make_mesh(RefMeshConfig(fsdp=2, tp=2))
    state = ref_init_state(REF_CFG, REF_TCFG, mesh, jax.random.key(0))
    sharded = jax.tree.map(lambda p, x: jax.device_put(jnp.asarray(p),
                                                       x.sharding),
                           np_params, state.params)
    state = state._replace(params=sharded)
    step, batch_sharding = ref_make_step(REF_CFG, REF_TCFG, mesh)
    batch = {"tokens": jax.device_put(jnp.asarray(tokens), batch_sharding)}
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    adam = state.opt_state
    out = {"step": {"metrics": metrics, "params": _flat(state.params),
                    "mu": _flat(adam.mu), "nu": _flat(adam.nu),
                    "count": int(adam.count)}}
    for name, (impl, sp, kh, packed, _) in ATTN_CASES.items():
        out[name] = _ref_attention(impl, sp, *_attn_inputs(kh, packed, 5))
    q, k, v, cot, _ = _attn_inputs(1, False, 6)
    with pytest.raises(ValueError, match="head count divisible") as e:
        _ref_attention("ulysses", 4, q[:, :, :2], k, v, cot[:, :, :2], None)
    out["heads_error"] = str(e.value)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawns (4 ranks: every reference and own case; 2 ranks: dp 2
    and an fsdp 2 checkpoint, then 8 ranks restoring it), run while this
    process runs the reference and the port's single-device steps."""
    np_params = _np_tree(ref_transformer.init_params(REF_CFG,
                                                     jax.random.key(0)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, CFG.vocab_size, (8, 32)).astype(np.int64)
    seg = _packed(8, 32, rng)
    attention = {name: (*_attn_inputs(kh, packed, 5), impl, axes)
                 for name, (impl, _, kh, packed, axes) in ATTN_CASES.items()}
    q, k, v, cot, _ = _attn_inputs(1, False, 6)
    attention["ulysses_heads_error"] = (q[:, :, :2], k, v, cot[:, :, :2],
                                        None, "ulysses", {"sp": 4})
    payload = {"cfg": CFG, "tcfg": TCFG, "params": np_params,
               "tokens": tokens, "seg": seg,
               "own_cases": OWN_CASES, "fused": FUSED,
               "attention": attention}
    ckpt_dir = str(tmp_path_factory.mktemp("ptrain") / "ck")

    def two_then_eight():
        w2 = spawn_ranks(ranks.world2, 2, "gloo", payload, ckpt_dir,
                         deadline_s=DEADLINE_S)
        w8 = spawn_ranks(ranks.world8, 8, "gloo", CFG, TCFG, ckpt_dir,
                         deadline_s=DEADLINE_S)
        return w2, w8

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        f4 = ex.submit(spawn_ranks, ranks.world4, 4, "gloo", payload,
                       deadline_s=DEADLINE_S)
        f28 = ex.submit(two_then_eight)
        ref = _reference(np_params, tokens)
        single = {}
        for name, _, over, packed in OWN_CASES + [("dp2", {}, {}, False)]:
            single[name] = ranks.train(
                dataclasses.replace(CFG, **over), TCFG, np_params, tokens, 2,
                seg=seg if packed else None)
        single["full_batch"] = ranks.train(CFG, TCFG, np_params, tokens, 1)
        w2, w8 = f28.result()
        return {"ref": ref, "single": single, "w4": f4.result(), "w2": w2,
                "w8": w8, "params": np_params, "tokens": tokens,
                "ckpt_dir": ckpt_dir}


# AdamW's step of an element is lr * m / (sqrt(v) + eps): where the
# gradient is small the step turns on its last bits, which a sum over
# ranks reorders (d step / d g = lr eps / (|g| + eps)^2 at the first
# step: 4e-8 of float32 noise in g moves a step at |g| = 1e-6 by 4e-6,
# at |g| >= 1e-5 by under 1e-7). Parameters are compared where
# sqrt(v_hat) >= ADAM_DETERMINED or the gradient is exactly 0 (at least
# ADAM_DETERMINED_SHARE of each leaf), the rest within their steps'
# bound.
ADAM_DETERMINED = 1e-5
ADAM_DETERMINED_SHARE = 0.95


def _assert_run_close(got, want, what, tcfg=TCFG):
    """Each step's loss and metrics within rtol 1e-5 / atol 1e-7 (the
    single-device test's tolerance, tests/test_torch_train.py), both
    AdamW moments of every leaf within that test's gradient tolerance
    (1e-4 of the leaf's largest entry), and every parameter within that
    test's parameter tolerance (1e-6 of the leaf's largest entry) where
    AdamW's step is set by the gradient (the rest within twice the
    learning rate a step)."""
    assert len(got["metrics"]) == len(want["metrics"])
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{what} step {i} {key}")
    assert got["count"] == want["count"]
    for item in ("params", "mu", "nu"):
        assert sorted(got[item]) == sorted(want[item]), item
    steps = want["count"]
    for path, w in want["params"].items():
        for m in ("mu", "nu"):
            wm = want[m][path]
            np.testing.assert_allclose(
                got[m][path], wm, rtol=0,
                atol=1e-4 * max(float(np.abs(wm).max()), 1e-30),
                err_msg=f"{what} {m} {path}")
        v_hat = want["nu"][path] / (1.0 - tcfg.beta2 ** steps)
        set_by_grad = (np.sqrt(v_hat) >= ADAM_DETERMINED) | (v_hat == 0)
        assert set_by_grad.mean() >= ADAM_DETERMINED_SHARE, f"{what} {path}"
        g = got["params"][path]
        np.testing.assert_allclose(
            g[set_by_grad], w[set_by_grad], rtol=0,
            atol=1e-6 * max(float(np.abs(w).max()), 1e-30),
            err_msg=f"{what} {path}")
        assert np.all(np.abs(g - w)[~set_by_grad]
                      <= 2 * tcfg.learning_rate * steps), f"{what} {path}"


@pytest.mark.parametrize("route", ["dense_ce", "fused_ce"])
def test_fsdp2_tp2_step_matches_reference(runs, route):
    """Two steps at fsdp 2 x tp 2 over gloo: the reference's sharded
    step's losses, accuracy, grad norm and every updated parameter, on
    every rank (the dense CE route, and the fused CE and flash routes
    with remat "full", the same function)."""
    key = "fsdp2_tp2" if route == "dense_ce" else "fsdp2_tp2_fused"
    for rank, res in enumerate(runs["w4"]):
        _assert_run_close(res[key], runs["ref"]["step"], f"rank {rank} ")


@pytest.mark.parametrize("name", sorted(ATTN_CASES) + [
    "ulysses_heads_error"])
def test_sequence_parallel_attention_matches_reference(runs, name):
    """Each rank's output block and q/k/v gradient blocks equal the
    reference's shard_map attention over the same global arrays; sp not
    dividing the local head count raises the reference's ValueError."""
    if name == "ulysses_heads_error":
        for res in runs["w4"]:
            assert "head count divisible" in res[name]["error"]
        assert "head count divisible" in runs["ref"]["heads_error"]
        return
    want = runs["ref"][name]
    for res in runs["w4"]:
        got = res[name]
        layout, tp = got["layout"], got["tp"]
        ntp = ATTN_CASES[name][4].get("tp", 1)
        for key in ("out", "dq", "dk", "dv"):
            full = ranks.block(want[key], layout)
            h = full.shape[2] // ntp
            np.testing.assert_allclose(
                got[key], full[:, :, tp * h:(tp + 1) * h], rtol=1e-5,
                atol=1e-6, err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", [c[0] for c in OWN_CASES] + ["dp2"])
def test_mesh_step_matches_single_device(runs, name):
    """The port's mesh step against its own single-device step on the
    same state and batch: dp 2, fsdp 4 (vocab-chunked CE), tp 2 x sp 2
    with ring and with Ulysses attention, and packed rows under the ring
    (positions and masks from the whole rows)."""
    res = runs["w2"] if name == "dp2" else runs["w4"]
    for rank, r in enumerate(res):
        _assert_run_close(r[name], runs["single"][name], f"rank {rank} ")


def test_grad_accumulation_matches_full_batch(runs):
    """Two microbatches at fsdp 2 x tp 2, each split over the batch axes
    like the global batch: one step equals the full batch's step."""
    for rank, r in enumerate(runs["w4"]):
        _assert_run_close(r["accum"], runs["single"]["full_batch"],
                          f"rank {rank} ")


def test_params_sharded_by_the_rules(runs):
    """Each rank holds its slice of every leaf: embed dims over fsdp,
    heads, mlp and vocab over tp, norms replicated."""
    full = dict(flatten(runs["params"]))
    want_dims = {"embed/tokens": {0: "tp", 1: "fsdp"},
                 "final_norm/scale": {},
                 "layers/attn_norm": {}, "layers/mlp_norm": {},
                 "layers/wq": {1: "fsdp", 2: "tp"},
                 "layers/wk": {1: "fsdp", 2: "tp"},
                 "layers/wv": {1: "fsdp", 2: "tp"},
                 "layers/wo": {1: "tp", 3: "fsdp"},
                 "layers/w_gate": {1: "fsdp", 2: "tp"},
                 "layers/w_up": {1: "fsdp", 2: "tp"},
                 "layers/w_down": {1: "tp", 2: "fsdp"},
                 "lm_head/kernel": {0: "fsdp", 1: "tp"}}
    assert sorted(want_dims) == sorted(full)
    seen = set()
    for res in runs["w4"]:
        coords = res["coords"]
        seen.add((coords["fsdp"], coords["tp"]))
        for path, splits in want_dims.items():
            shape, value = res["shards"][path]
            want = full[path]
            for dim, axis in splits.items():
                n = want.shape[dim] // 2
                want = np.take(want, np.arange(coords[axis] * n,
                                               (coords[axis] + 1) * n),
                               axis=dim)
            assert shape == want.shape, path
            np.testing.assert_array_equal(value, want, err_msg=path)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_eval_on_the_mesh_sums_the_global_batch(runs):
    """make_eval_step(mesh=): the global batch's token-weighted sums on
    every rank, as one device computes them."""
    from cloud_server_tpu_torch.training.eval import make_eval_step
    params = ranks.torch_tree(runs["params"])
    want = make_eval_step(CFG)(params, {
        "tokens": torch.from_numpy(runs["tokens"])})
    for res in runs["w4"]:
        for k, v in want.items():
            np.testing.assert_allclose(res["eval"][k], float(v), rtol=1e-5,
                                       err_msg=k)


def test_loader_rows_match_reference_sampler(runs):
    """DataLoader.for_mesh at fsdp 2 x sp 2: each rank's rows are the
    reference ShardedSampler's for its batch index (fsdp coordinate), and
    its sequence block its sp coordinate's."""
    ds = SyntheticLMDataset(16, 8, 64, seed=3)
    for res in runs["w4"]:
        got = res["loader"]
        assert got["count"] == 2
        sampler = RefSampler(16, 4, seed=5, process_index=got["index"],
                             process_count=2)
        it = iter(sampler)
        j, m = got["layout"]
        assert m == 2
        for batch in got["batches"]:
            rows = np.stack([ds[int(i)]["tokens"] for i in next(it)])
            np.testing.assert_array_equal(batch, rows[:, j * 4:(j + 1) * 4])


def test_elastic_restore_fsdp2_to_fsdp4_tp2_is_bit_exact(runs):
    """An fsdp 2 checkpoint (rank 0 wrote the gathered leaves, the atomic
    rename included) restored onto fsdp 4 x tp 2: every rank's slices of
    the parameters and both moments equal the saved leaves bit for bit,
    and restore_params lands the same slices."""
    assert [r["saved"] for r in runs["w2"]] == [True, True]
    root = os.path.join(runs["ckpt_dir"], "2")
    assert sorted(os.listdir(runs["ckpt_dir"])) == ["2"]
    saved = {name: torch.load(os.path.join(root, f"{name}.pt"),
                              weights_only=True) for name in ("params", "opt")}
    dims = {"embed/tokens": {0: ("tp", 2), 1: ("fsdp", 4)},
            "layers/wq": {1: ("fsdp", 4), 2: ("tp", 2)},
            "layers/wo": {1: ("tp", 2), 3: ("fsdp", 4)},
            "layers/w_down": {1: ("tp", 2), 2: ("fsdp", 4)},
            "lm_head/kernel": {0: ("fsdp", 4), 1: ("tp", 2)}}

    def slice_of(x, path, coords):
        for dim, (axis, k) in dims.get(path, {}).items():
            n = x.shape[dim] // k
            x = x.narrow(dim, coords[axis] * n, n)
        return x.numpy()

    assert len(runs["w8"]) == 8
    for res in runs["w8"]:
        assert res["step"] == 2 and res["count"] == 2
        for path in dims:
            want = slice_of(saved["params"][path], path, res["coords"])
            np.testing.assert_array_equal(res["params"][path], want)
            np.testing.assert_array_equal(res["restore_params"][path], want)
            for m in ("mu", "nu"):
                np.testing.assert_array_equal(
                    res[m][path],
                    slice_of(saved["opt"][f"{m}/{path}"], path,
                             res["coords"]))


def test_mesh_checkpoint_gathers_one_leaf_at_a_time(runs):
    """A save on a mesh gathers every leaf (params and both moments)
    and drops each full leaf before it gathers the next, on every rank:
    a rank's device holds its shards plus one full leaf at most. A
    restore maps each file it reads (restore and restore_params alike)
    and copies out the rank's slices."""
    for res in runs["w2"]:
        held = res["held_at_gather"]
        assert len(held) == res["n_leaves"]
        largest = max(n for _, n in held)
        # all the leaves together would be several times one leaf
        assert sum(n for _, n in held) > 4 * largest
        assert max(alive for alive, _ in held) <= largest
    for res in runs["w8"]:
        assert sorted(res["loads"]) == [("opt.pt", True),
                                        ("params.pt", True),
                                        ("params.pt", True)]


def test_refusals_on_a_mesh(runs):
    """MoE models and LoRA adapters, once refused on a mesh, now build
    their train step on it (they train in tests/test_torch_lora_parallel.py
    and test_torch_parallel_mesh8.py); sp > 1 on the flash route still
    raises NotImplementedError naming the sequence-parallel routes."""
    got = runs["w4"][0]["refusals"]
    assert got["moe"] is None
    assert got["lora"] is None
    assert "'ring' or 'ulysses'" in got["sp_flash"]


@pytest.mark.parametrize("section,words", [
    ({"mesh": {"pp": 2}}, "pipeline parallelism"),
    ({"mesh": {"ep": 2}}, "expert parallelism"),
    ({"mesh": {"fsdp": 2}, "model": {"num_experts": 4}}, "MoE"),
    ({"mesh": {"fsdp": 2}}, "LoRA"),
    ({"dcn_mesh": {"dp": 2}}, "dcn_mesh"),
])
def test_train_cli_refusals(tmp_path, section, words):
    """What train.py once refused on a mesh (a pp or ep axis, MoE,
    --lora-rank, a dcn_mesh section) it now takes: in one process it
    gets as far as any mesh does, to the ValueError of a mesh of more
    ranks than the process group holds (the reference's message; they
    train in two processes with `--distributed` in
    tests/test_torch_train_cli.py); a dcn_mesh whose global dp x fsdp
    does not divide the batch exits with the reference's message
    first."""
    from cloud_server_tpu_torch import train
    cfg_path = tmp_path / "cfg.json"
    raw = {"model": {**_TINY, **section.get("model", {})},
           **{k: v for k, v in section.items() if k != "model"}}
    cfg_path.write_text(json.dumps(raw))
    argv = ["--config", str(cfg_path), "--synthetic", "16", "--device",
            "cpu"]
    if words == "LoRA":
        argv += ["--lora-rank", "2"]
    if words == "dcn_mesh":
        with pytest.raises(ValueError, match="hybrid mesh wants"):
            train.main(argv)
        with pytest.raises(SystemExit, match="GLOBAL batch-sharding axes"):
            train.main(argv + ["--batch-size", "3"])
        return
    with pytest.raises(ValueError, match="wants 2 devices but only 1"):
        train.main(argv)


def _run_cli(cfg_path, ckpt, logdir, steps):
    """Two ranks of `train --distributed` in torchrun's environment,
    with the rendezvous store hosted here, as torchrun's agent hosts it
    (TORCHELASTIC_USE_AGENT_STORE): it holds its port from the start and
    outlives both ranks."""
    store = torch.distributed.TCPStore("localhost", 0, is_master=True,
                                       wait_for_workers=False)
    procs = []
    for rank in range(2):
        env = {**os.environ, "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(store.port), "RANK": str(rank),
               "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
               "LOCAL_WORLD_SIZE": "2", "PYTHONPATH": REPO,
               "TORCHELASTIC_USE_AGENT_STORE": "True"}
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "cloud_server_tpu_torch.train",
             "--distributed", "--device", "cpu", "--config", str(cfg_path),
             "--synthetic", "16", "--checkpoint-dir", str(ckpt),
             "--logdir", str(logdir), "--steps", str(steps)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def test_train_cli_two_ranks_trains_and_resumes(tmp_path):
    """`train --distributed` in two processes (torchrun's environment,
    gloo) at fsdp 2: trains, rank 0 alone logs and writes checkpoints,
    and a second launch resumes from the last one."""
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "model": _TINY, "mesh": {"fsdp": 2},
        "train": {"batch_size": 4, "seq_len": 16, "learning_rate": 1e-2},
        "loop": {"log_interval": 1, "checkpoint_interval": 2,
                 "async_checkpoint": False}}))
    ckpt, logdir = tmp_path / "ck", tmp_path / "logs"
    _run_cli(cfg_path, ckpt, logdir, 2)
    assert sorted(os.listdir(ckpt)) == ["2"]
    outs = _run_cli(cfg_path, ckpt, logdir, 3)
    assert "resumed from step 2" in outs[0]
    assert "resumed" not in outs[1]
    assert sorted(os.listdir(ckpt)) == ["2", "3"]
    with open(logdir / "train.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3]
