"""The port's two schedulers (mirroring tests/test_mixed_scheduler.py):
greedy and seeded mixed == alternating token for token, every output
equal to the reference server's, decode never stalled behind a chunked
admission, the token budget's prefill selection, inert rows that never
clobber a mid-admission slot's pages, and preemption fired from inside
the mixed loop. Speculation, grammar and penalties under every schedule
are in test_torch_mixed_scheduler_{spec,seeded,int8,grammar}.py, which
share this module's weights and helpers (one file each, so that the
suite's `--dist loadfile` spreads them over workers)."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

from cloud_server_tpu.config import InferConfig, ModelConfig
from cloud_server_tpu.inference.paged_server import (
    PagedInferenceServer as RefServer)
from cloud_server_tpu.inference.sampling import (
    SamplingParams as RefSamplingParams)
from cloud_server_tpu.models import transformer as ref_transformer
from cloud_server_tpu_torch.config import InferConfig as TInferConfig
from cloud_server_tpu_torch.config import ModelConfig as TModelConfig
from cloud_server_tpu_torch.inference.paged_server import (
    PagedInferenceServer)
from cloud_server_tpu_torch.inference.sampling import SamplingParams
from cloud_server_tpu_torch.models.transformer import params_from_numpy

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_test_setup import release_compiled_programs  # noqa: E402,F401

CFG = ModelConfig(
    vocab_size=64, embed_dim=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=8, mlp_dim=64, max_seq_len=256, dtype="float32",
    param_dtype="float32", remat="none")
GREEDY = InferConfig(max_decode_len=8, temperature=0.0, eos_token_id=-1,
                     pad_token_id=0)
SRV_KW = dict(max_slots=4, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])
LONG = [(i * 7) % 60 + 1 for i in range(30)]
PROMPTS = [[5, 9, 3], [17, 2, 40, 8, 21], LONG, list(range(1, 14))]


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's runs of a module, each made once: get(key, fn)
    returns fn()'s result, computed at the first call with that key (a
    reference run that several cases compare against, such as the
    greedy tokens every schedule must give)."""
    done = {}

    def get(key, fn):
        if key not in done:
            done[key] = fn()
        return done[key]

    return get


@pytest.fixture(scope="module")
def weights():
    ref = ref_transformer.init_params(CFG, jax.random.key(0))
    port = params_from_numpy(jax.tree.map(np.asarray, ref),
                             TModelConfig(**dataclasses.asdict(CFG)),
                             device="cpu")
    return ref, port


def _server(params, icfg=GREEDY, **kw):
    return PagedInferenceServer(
        params, TModelConfig(**dataclasses.asdict(CFG)),
        TInferConfig(**dataclasses.asdict(icfg)), device="cpu",
        **{**SRV_KW, **kw})


def _staggered_run(srv, prompts, max_new):
    reqs = [srv.submit(p, max_new_tokens=max_new) for p in prompts[:2]]
    for _ in range(3):
        srv.step()
    reqs += [srv.submit(p, max_new_tokens=max_new) for p in prompts[2:]]
    srv.run_until_idle()
    return [r.result() for r in reqs]


def _reference(weights, prompts, max_new, **kw):
    """The reference server's tokens, each request alone (the schedule
    cannot move a greedy token)."""
    out = []
    for p in prompts:
        srv = RefServer(weights[0], CFG, GREEDY, overlap=False,
                        **{**SRV_KW, **kw})
        out.append(srv.generate([p], max_new_tokens=max_new)[0])
    return out


def test_mixed_greedy_equals_alternating(weights):
    """Identical token streams under both schedulers, with admissions
    landing mid-decode, and equal to the reference's."""
    out_m = _staggered_run(_server(weights[1], scheduler="mixed"),
                           PROMPTS, 12)
    out_a = _staggered_run(_server(weights[1], scheduler="alternating"),
                           PROMPTS, 12)
    assert out_m == out_a
    assert out_m == _reference(weights, PROMPTS, 12)


def test_mixed_seeded_sampling_equals_alternating(weights):
    """Per-request seeded draws come from (seed, position) keys, so the
    schedule moves no sampled token either."""
    icfg = dataclasses.replace(GREEDY, temperature=1.0)
    sp = [SamplingParams(seed=100 + i, temperature=0.9, top_p=0.9)
          for i in range(len(PROMPTS))]

    def run(sched):
        srv = _server(weights[1], icfg, scheduler=sched)
        reqs = [srv.submit(p, max_new_tokens=10, sampling=s)
                for p, s in zip(PROMPTS[:2], sp[:2])]
        for _ in range(3):
            srv.step()
        reqs += [srv.submit(p, max_new_tokens=10, sampling=s)
                 for p, s in zip(PROMPTS[2:], sp[2:])]
        srv.run_until_idle()
        return [r.result() for r in reqs]

    assert run("mixed") == run("alternating")


def test_mixed_stall_free_itl_bound(weights):
    """While a multi-chunk admission is in flight every live decode slot
    advances on every iteration."""
    srv = _server(weights[1], scheduler="mixed")
    r0 = srv.submit(PROMPTS[0], max_new_tokens=40)
    while not srv.active.any():
        srv.step()
    srv.submit(LONG, max_new_tokens=4)
    steps_with_admission = 0
    while srv._jobs or srv.num_pending:
        before = len(r0.tokens)
        srv.step()
        if r0.done:
            break
        assert len(r0.tokens) > before, "decode stalled during admission"
        steps_with_admission += 1
    assert steps_with_admission >= 2
    srv.run_until_idle()
    assert r0.result() == _reference(weights, [PROMPTS[0]], 40)[0]


def test_mixed_budget_caps_prefill_rows(weights):
    """With room for one decode row plus one chunk, the second admission
    is not selected until the first finishes, and both stay exact."""
    srv = _server(weights[1], scheduler="mixed", mixed_token_budget=17)
    r0 = srv.submit(PROMPTS[0], max_new_tokens=24)
    while not srv.active.any():
        srv.step()
    pb = [(i * 11) % 60 + 1 for i in range(28)]
    ra = srv.submit(LONG, max_new_tokens=6)
    rb = srv.submit(pb, max_new_tokens=6)
    srv.step()
    assert len(srv._jobs) == 2
    planned = [j.planned for j in srv._jobs]
    assert planned[0] > 0 and planned[1] == 0, planned
    srv.step()  # the in-flight chunk commits: done catches up
    assert len(srv._jobs) == 2
    dones = [j.done for j in srv._jobs]
    assert dones[0] > 0 and dones[1] == 0, dones
    srv.run_until_idle()
    want = _reference(weights, [PROMPTS[0], LONG, pb], 24)
    assert r0.result() == want[0]
    assert ra.result() == want[1][:6] and rb.result() == want[2][:6]


def test_mixed_sentinel_safety_mid_admission(weights):
    """Decode rows, selected prefill rows and padding rows share one
    program; a waiting admission's pages are never clobbered."""
    srv = _server(weights[1], scheduler="mixed",
                  mixed_token_budget=SRV_KW["max_slots"] + 16)
    r0 = srv.submit(PROMPTS[0], max_new_tokens=24)
    for _ in range(3):
        srv.step()
    pb = [(i * 13) % 60 + 1 for i in range(28)]
    ra = srv.submit(LONG, max_new_tokens=6)
    rb = srv.submit(pb, max_new_tokens=6)
    srv.run_until_idle()
    want = _reference(weights, [PROMPTS[0], LONG, pb], 24)
    assert r0.result() == want[0]
    assert ra.result() == want[1][:6] and rb.result() == want[2][:6]


@pytest.mark.parametrize("overlap", [True, False])
def test_mixed_preemption_while_dispatching(weights, overlap):
    """Preemption fired from inside the mixed loop keeps every output
    exact: the preempted request re-admits as a continuation through the
    mixed scheduler."""
    prompts = [[(i * 9 + k) % 60 + 1 for k in range(8)] for i in range(6)]
    kw = dict(max_slots=6, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16], decode_chunk=2)
    srv = _server(weights[1], scheduler="mixed", num_pages=12,
                  overlap=overlap, **kw)
    reqs = [srv.submit(p, max_new_tokens=40) for p in prompts]
    srv.run_until_idle()
    assert srv.preemptions > 0
    assert [r.result() for r in reqs] == _reference(weights, prompts, 40,
                                                    **kw)


def test_mixed_rejects_unknown_scheduler(weights):
    with pytest.raises(ValueError, match="scheduler"):
        _server(weights[1], scheduler="fifo")
    with pytest.raises(ValueError, match="scheduler"):
        TInferConfig(scheduler="fifo")


def test_mixed_budget_too_small_rejected(weights):
    with pytest.raises(ValueError, match="mixed_token_budget"):
        _server(weights[1], mixed_token_budget=0.5)


# --------------------------------------------------------------------------
# speculation, grammar and penalties (A10, A11, A12) against the reference
# --------------------------------------------------------------------------

REP = [3, 4, 5, 6] * 5 + [3, 4]  # n-gram and self-similar drafts accept
SCHEDULES = [dict(scheduler="mixed"), dict(scheduler="mixed", overlap=False),
             dict(scheduler="alternating")]
SCHEDULE_IDS = ["mixed", "mixed_sequential", "alternating"]


def _draft_setup():
    draft_cfg = dataclasses.replace(CFG, embed_dim=16, num_layers=1,
                                    num_heads=2, num_kv_heads=2,
                                    mlp_dim=32)
    ref = ref_transformer.init_params(draft_cfg, jax.random.key(9))
    port = params_from_numpy(jax.tree.map(np.asarray, ref),
                             TModelConfig(**dataclasses.asdict(draft_cfg)),
                             device="cpu")
    return (ref, draft_cfg), (port,
                              TModelConfig(**dataclasses.asdict(draft_cfg)))


def _run(srv, prompts, max_new, sampling=None):
    """The staggered run, with per-request sampling and the requests
    kept (tokens and logprobs)."""
    sampling = sampling or [None] * len(prompts)
    reqs = [srv.submit(p, max_new_tokens=max_new, sampling=s)
            for p, s in zip(prompts[:2], sampling[:2])]
    for _ in range(3):
        srv.step()
    reqs += [srv.submit(p, max_new_tokens=max_new, sampling=s)
             for p, s in zip(prompts[2:], sampling[2:])]
    srv.run_until_idle()
    return reqs


def _ref_server(weights, icfg=GREEDY, draft=None, **kw):
    if draft is not None:
        kw.update(draft_params=draft[0], draft_cfg=draft[1])
    return RefServer(weights[0], CFG, icfg, overlap=False,
                     **{**SRV_KW, **kw})


def _port_server(weights, icfg=GREEDY, draft=None, **kw):
    if draft is not None:
        kw.update(draft_params=draft[0], draft_cfg=draft[1])
    return _server(weights[1], icfg, **kw)


INT8_PROMPTS = [REP, PROMPTS[0], LONG]


def _int8_setup(draft: bool):
    """(reference kwargs, port kwargs) of an int8 speculating server:
    the target's pools int8 and, with a draft model, the draft's too."""
    ref_draft, port_draft = _draft_setup()
    ref_kw, port_kw = {}, {}
    if draft:
        dcfg8 = dataclasses.replace(ref_draft[1], kv_cache_dtype="int8")
        ref_kw = dict(draft_params=ref_draft[0], draft_cfg=dcfg8)
        port_kw = dict(draft_params=port_draft[0],
                       draft_cfg=TModelConfig(**dataclasses.asdict(dcfg8)))
    return ref_kw, port_kw


def _grammar_setup():
    from cloud_server_tpu.data.tokenizer import ByteTokenizer as RefTok
    from cloud_server_tpu_torch.data.tokenizer import ByteTokenizer
    gcfg = dataclasses.replace(CFG, vocab_size=300)
    dcfg = dataclasses.replace(gcfg, embed_dim=16, num_layers=1,
                               num_heads=2, num_kv_heads=2, mlp_dim=32)
    ref_p = ref_transformer.init_params(gcfg, jax.random.key(2))
    ref_d = ref_transformer.init_params(dcfg, jax.random.key(3))

    def port(p, c):
        return params_from_numpy(jax.tree.map(np.asarray, p),
                                 TModelConfig(**dataclasses.asdict(c)),
                                 device="cpu")

    tok = ByteTokenizer()
    icfg = InferConfig(max_decode_len=12, temperature=0.0,
                       eos_token_id=tok.eos_id, pad_token_id=0)
    kw = dict(max_slots=4, max_context=128, page_size=8, prefill_chunk=16,
              prompt_buckets=[16, 32])
    ref = dict(params=ref_p, cfg=gcfg, draft=(ref_d, dcfg), tok=RefTok())
    prt = dict(params=port(ref_p, gcfg),
               cfg=TModelConfig(**dataclasses.asdict(gcfg)),
               draft=(port(ref_d, dcfg),
                      TModelConfig(**dataclasses.asdict(dcfg))), tok=tok)
    return ref, prt, icfg, kw
