"""Tensor-parallel paged serving of the port (`PagedInferenceServer(
mesh=...)`, one process per rank over gloo on the CPU, started by
`parallel.spawn_ranks`) against the reference's tp-sharded server (its
`mesh=make_mesh(MeshConfig(fsdp=2, tp=4))` on the conftest's 8 CPU
devices) and its single-device server, on the reference's weights
crossed as numpy arrays: greedy tokens on the XLA route and the kernel
route, under n-gram speculation, on the int8 KV cache, under the
alternating scheduler and with per-request seeds, exact in float32 at
tp 2 and tp 4. The state mirrored outside programs (the penalty state,
the grammar stack), preemption and full reservation against the port's
own single-device server; `paged_attention_tp`'s per-rank shares
against the reference's; the refusals; followers released by stop(),
kept waiting by rank 0's keepalive while it idles past the group's
timeout, and a released server refusing to serve again.
Mirrors the paged cases of tests/test_sharded_serving.py.

The ranks run `tests/torch_tp_ranks.py` (torch only); the spawns run
while this process runs the reference."""

import concurrent.futures
import dataclasses
import gc
import os
import sys

import jax
import numpy as np
import pytest
import torch

from cloud_server_tpu.config import InferConfig as RefInferConfig
from cloud_server_tpu.config import MeshConfig as RefMeshConfig
from cloud_server_tpu.config import ModelConfig as RefModelConfig
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefPaged)
from cloud_server_tpu.inference.sampling import (
    SamplingParams as RefSamplingParams)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu.ops import paged_attention as ref_pa
from cloud_server_tpu.parallel.mesh import make_mesh as ref_make_mesh
from cloud_server_tpu.parallel.sharding import (
    logical_to_sharding as ref_logical_to_sharding)
from cloud_server_tpu_torch.config import InferConfig, ModelConfig
from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
from cloud_server_tpu_torch.inference.sampling import SamplingParams
from cloud_server_tpu_torch.models import transformer
from cloud_server_tpu_torch.ops import paged_attention as pa
from cloud_server_tpu_torch.parallel import spawn_ranks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_ranks as ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the reference's compiled XLA programs when the module ends
    (each holds memory maps; see tests/test_torch_moe.py)."""
    yield
    jax.clear_caches()
    gc.collect()


_TINY = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
             num_kv_heads=4, head_dim=8, mlp_dim=64, max_seq_len=128,
             dtype="float32", param_dtype="float32", remat="none")
REF_TINY = RefModelConfig(**_TINY)
TINY = ModelConfig(**_TINY)
PAGED_KW = dict(max_slots=2, max_context=64, page_size=8, prefill_chunk=16,
                prompt_buckets=[16])
_ICFG = dict(max_decode_len=8, temperature=0.0, eos_token_id=-1,
             pad_token_id=0)
PROMPTS = [[3, 7, 11], [9, 1, 4, 8, 2]]
# per-request seeded draws, top-k and top-p
_SEEDED = [dict(temperature=0.8, top_k=20, top_p=0.9, seed=11),
           dict(temperature=0.7, seed=5)]
# the penalty state and logit_bias / min_tokens (mirrored by message)
_PENALTIES = [dict(presence_penalty=0.5, frequency_penalty=0.3,
                   repetition_penalty=1.2, logit_bias=((7, 2.0),)),
              dict(min_tokens=4, presence_penalty=1.0)]
_GRAMMAR_ICFG = dict(_ICFG, eos_token_id=60)  # "<", inside the vocab

# reference-held cases: (name, config overrides, server kwargs, seeded)
REF_CASES = {
    "xla": ({}, {}, False),
    "pallas": ({"decode_attention_impl": "pallas"}, {}, False),
    "spec": ({}, {"spec_drafts": 2}, False),
    "int8": ({"kv_cache_dtype": "int8"}, {}, False),
    "alternating": ({}, {"scheduler": "alternating"}, False),
    "seeded": ({}, {}, True),
}
# cases held against the port's own single-device server: the state
# mirrored outside programs, preemption and the reserve policy
PORT_CASES = {
    "penalties": ({}, {}, _PENALTIES, 8),
    "grammar": ({}, {"tokenizer": ByteTokenizer(),
                     "_icfg": InferConfig(**_GRAMMAR_ICFG)},
                [dict(regex="[0-9]+"), dict(regex="[0-9]{2,5}")], 8),
    "preempt": ({}, {"num_pages": 5}, None, 20),
    "reserve": ({}, {"allocation": "reserve"}, None, 8),
}
DEADLINE_S = 240.0
# the idle spawn: its groups time out after IDLE_TIMEOUT_S, and rank 0
# neither steps nor sends for longer than that
IDLE_TIMEOUT_S = 15.0
IDLE_S = 18.0


def _port_sampling(rows):
    return None if rows is None else [SamplingParams(**r) for r in rows]


def _tp_cases() -> list:
    cases = [(name, over, kw, _port_sampling(_SEEDED) if seeded else None,
              8) for name, (over, kw, seeded) in REF_CASES.items()]
    cases += [(name, over, kw, _port_sampling(rows), n)
              for name, (over, kw, rows, n) in PORT_CASES.items()]
    return cases + [("refusals", "refusals")]


def _reference(tree) -> dict:
    """The reference's tp-sharded server (fsdp 2 x tp 4) on every
    REF_CASES case, and its single-device server on the XLA and seeded
    ones."""
    params = jax.tree.map(jax.numpy.asarray, tree)
    mesh = ref_make_mesh(RefMeshConfig(fsdp=2, tp=4))
    sharded = jax.tree.map(jax.device_put, params, ref_logical_to_sharding(
        ref_transformer.param_logical_axes(REF_TINY), mesh))
    icfg = RefInferConfig(**_ICFG)

    def run(p, name, m=None):
        over, kw, seeded = REF_CASES[name]
        srv = RefPaged(p, dataclasses.replace(REF_TINY, **over), icfg,
                       mesh=m, **PAGED_KW, **kw)
        reqs = [srv.submit(q, max_new_tokens=8, sampling=(
            RefSamplingParams(**_SEEDED[i]) if seeded else None))
            for i, q in enumerate(PROMPTS)]
        srv.run_until_idle()
        return [r.tokens for r in reqs]

    out = {"tp": {name: run(sharded, name, mesh) for name in REF_CASES}}
    out["single"] = {name: run(params, name) for name in ("xla", "seeded")}
    return out


@pytest.fixture(scope="module")
def runs():
    """The spawns (tp 2: every case; tp 4: the XLA route and the
    indivisible heads; tp 2 with an idle rank 0 and a restart), run
    while this process runs the reference and the port's single-device
    servers."""
    tree = ranks.np_tree(ref_transformer.init_params(REF_TINY,
                                                     jax.random.key(0)))
    tp4_cases = [("xla", {}, {}, None, 8),
                 ("indivisible", "indivisible", {"num_kv_heads": 2})]
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        f2 = ex.submit(spawn_ranks, ranks.serve_cases, 2, "gloo", tree,
                       TINY, InferConfig(**_ICFG), PROMPTS, PAGED_KW,
                       _tp_cases(), deadline_s=DEADLINE_S)
        f4 = ex.submit(spawn_ranks, ranks.serve_cases, 4, "gloo", tree,
                       TINY, InferConfig(**_ICFG), PROMPTS, PAGED_KW,
                       tp4_cases, deadline_s=DEADLINE_S)
        f_idle = ex.submit(spawn_ranks, ranks.idle_then_restart, 2, "gloo",
                           tree, TINY, InferConfig(**_ICFG), PROMPTS,
                           PAGED_KW, IDLE_S, deadline_s=DEADLINE_S,
                           timeout_s=IDLE_TIMEOUT_S)
        ref = _reference(tree)
        params = transformer.params_from_numpy(tree, TINY, "cpu")
        single = {}
        for name, (over, kw, rows, n) in PORT_CASES.items():
            kw = dict(kw)
            icfg = kw.pop("_icfg", InferConfig(**_ICFG))
            single[name] = ranks.serve(
                params, dataclasses.replace(TINY, **over), icfg, PROMPTS, n,
                _port_sampling(rows), **PAGED_KW, **kw)
        return {"ref": ref, "single": single, "tp2": f2.result(),
                "tp4": f4.result(), "idle": f_idle.result()}


@pytest.mark.parametrize("name", list(REF_CASES))
def test_tp2_tokens_match_reference(runs, name):
    """tp 2 over gloo: the reference's tp-sharded tokens (equal to its
    single-device ones on the XLA and seeded routes) on each route."""
    got = runs["tp2"][0][name]
    assert got["tp"]["tp"] == 2 and got["tp"]["backend"] == "gloo"
    assert got["tokens"] == runs["ref"]["tp"][name]
    if name in runs["ref"]["single"]:
        assert got["tokens"] == runs["ref"]["single"][name]


def test_tp4_tokens_match_reference(runs):
    got = runs["tp4"][0]["xla"]
    assert got["tp"]["tp"] == 4
    assert got["tokens"] == runs["ref"]["tp"]["xla"]
    assert got["tokens"] == runs["ref"]["single"]["xla"]


@pytest.mark.parametrize("name", list(PORT_CASES))
def test_tp2_matches_the_single_device_server(runs, name):
    """The penalty state and the grammar stack reach the followers with
    the next dispatch; preemption (a 5-page pool) and full reservation
    schedule on rank 0 alone: the tokens equal one device's."""
    got, want = runs["tp2"][0][name], runs["single"][name]
    assert got["tokens"] == want["tokens"]
    assert got["finish"] == want["finish"]
    assert got["preemptions"] == want["preemptions"]
    if name == "preempt":
        assert got["preemptions"] > 0
    if name == "grammar":
        assert all(t and all(48 <= x <= 57 for x in t if x != 60)
                   for t in got["tokens"])


def test_followers_launch_every_program_and_exit(runs):
    """stop() on rank 0 releases the followers: follow() returns, each
    rank's function returns and its process exits 0 (spawn_ranks checks
    the exit codes); each follower ran the attention of every
    dispatch."""
    for world in ("tp2", "tp4"):
        res = runs[world]
        for follower in res[1:]:
            for name, got in follower.items():
                if name in ("refusals", "indivisible"):
                    continue
                assert got["follower"]["plain_calls"] > 0


def test_followers_outlast_an_idle_rank_0(runs):
    """Rank 0 neither steps nor dispatches for longer than the group's
    timeout: its keepalive thread keeps the followers waiting, and the
    server then serves the reference's tokens (spawn_ranks also checks
    that every rank exited 0)."""
    r0, r1 = runs["idle"]
    assert r1 == {"followed": True}
    assert r0["idle_messages"] >= IDLE_S // IDLE_TIMEOUT_S
    assert r0["tokens"] == runs["ref"]["single"]["xla"]


def test_released_server_refuses_to_serve_again(runs):
    """After stop() has released the followers, rank 0's start() and
    step() raise RuntimeError at once instead of waiting on ranks that
    left."""
    refused = runs["idle"][0]["refused"]
    assert set(refused) == {"start", "step"}
    for name, (msg, seconds) in refused.items():
        assert "every rank must build a new server" in msg, name
        assert "stop()" in msg, name
        assert seconds < 1.0, name


def test_refusals_under_tp(runs):
    """What tensor-parallel serving does not serve yet raises
    NotImplementedError, each naming the feature."""
    got = runs["tp2"][0]["refusals"]
    want = {"draft_model": "draft-model speculation",
            "moe": "MoE models", "int8_weights": "int8 weight-only",
            "contiguous": "contiguous InferenceServer",
            "mesh_axis_fsdp": "fsdp", "embed": "embed()",
            "add_adapter": "add_adapter",
            "migrate_export": "migrate_export",
            "migrate_salvage": "migrate_salvage",
            "migrate_import": "migrate_import",
            "drain_migrate": "drain(migrate", "handoff": "handoff"}
    assert set(got) == set(want)
    for key, words in want.items():
        assert got[key] is not None and words in got[key], key
    follower = runs["tp2"][1]["refusals"]
    assert all(follower[k] == got[k] for k in follower)


def test_indivisible_heads_raise(runs):
    """tp 4 over 2 kv heads: the reference's ValueError naming
    num_kv_heads, from the server and from `paged_attention_tp`."""
    assert "num_kv_heads=2" in runs["tp4"][0]["indivisible"]
    q = torch.zeros((1, 1, 8, 8))
    pools = torch.zeros((1, 3, 1, 8, 8))
    with pytest.raises(ValueError, match="num_kv_heads"):
        pa.paged_attention_tp(q, pools, pools, torch.tensor([1]),
                              torch.zeros((1, 2), dtype=torch.int32), 0,
                              heads=(8, 2), tp=4)


@pytest.mark.parametrize("tp", [2, 4])
def test_paged_attention_tp_shares_concatenate_to_reference(tp):
    """Each rank's `paged_attention_tp` on its own q heads and kv-head
    shard of the pools (no collective), computed here one rank after
    another: the shares concatenate over the head axis to the
    reference's `paged_attention_tp` (its kernel under shard_map over tp,
    interpret mode)."""
    r = np.random.default_rng(3)
    b, w, h, kh, d, ps, n_pages = 2, 3, 8, 4, 8, 8, 6
    q = r.standard_normal((b, w, h, d)).astype(np.float32)
    kp = r.standard_normal((2, n_pages, kh, d, ps)).astype(np.float32)
    vp = r.standard_normal((2, n_pages, kh, d, ps)).astype(np.float32)
    lens = np.array([13, 20], np.int32)
    tabs = np.array([[4, 1, 0], [2, 5, 3]], np.int32)
    mesh = ref_make_mesh(RefMeshConfig(fsdp=8 // tp, tp=tp))
    want = np.asarray(ref_pa.paged_attention_tp(
        jax.numpy.asarray(q), jax.numpy.asarray(kp), jax.numpy.asarray(vp),
        jax.numpy.asarray(lens), jax.numpy.asarray(tabs), 1, mesh=mesh,
        interpret=True))
    hq, hk = h // tp, kh // tp
    shares = [pa.paged_attention_tp(
        torch.from_numpy(q[:, :, i * hq:(i + 1) * hq].copy()),
        torch.from_numpy(kp[:, :, i * hk:(i + 1) * hk].copy()),
        torch.from_numpy(vp[:, :, i * hk:(i + 1) * hk].copy()),
        torch.from_numpy(lens), torch.from_numpy(tabs), 1,
        heads=(h, kh), tp=tp) for i in range(tp)]
    np.testing.assert_allclose(torch.cat(shares, dim=2).numpy(), want,
                               atol=2e-5, rtol=2e-5)
