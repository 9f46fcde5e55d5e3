"""The port's two schedulers (mirroring tests/test_mixed_scheduler.py):
greedy and seeded mixed == alternating token for token, every output
equal to the reference server's, decode never stalled behind a chunked
admission, the token budget's prefill selection, inert rows that never
clobber a mid-admission slot's pages, and preemption fired from inside
the mixed loop. Then speculation (n-gram, draft-model, adaptive),
grammar and penalties under every schedule, each held token for token
against the reference server on the same weights, preemption while a
speculative dispatch is in flight, and the programs a new grammar
pattern releases."""

import dataclasses

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


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
def test_ngram_speculation_greedy_exact(weights, sched):
    """n-gram speculation at W = drafts + 1 under every schedule: each
    request's tokens are the reference server's plain greedy tokens, the
    reference speculating server's logprobs within 1e-4, and drafts
    really accept."""
    prompts = [REP, PROMPTS[0], LONG]
    srv = _port_server(weights, spec_drafts=3, **sched)
    got = _run(srv, prompts, 10)
    want = _run(_ref_server(weights, spec_drafts=3), prompts, 10)
    assert [r.result() for r in got] == _reference(weights, prompts, 10)
    assert [r.result() for r in got] == [r.result() for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
    assert srv.spec_tokens_accepted > 0
    assert srv.decode_tokens_committed > srv.decode_rounds


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
def test_grammar_and_penalties_through_admission(weights, sched):
    """Penalised, biased, min_tokens-bound seeded requests keep their
    per-slot state right when their admission and another slot's decode
    share a program: token for token the reference's."""
    icfg = dataclasses.replace(GREEDY, temperature=1.0, eos_token_id=2)
    sp = [dict(seed=7, temperature=0.8, frequency_penalty=0.5,
               repetition_penalty=1.2),
          dict(seed=9, presence_penalty=0.3, min_tokens=6,
               logit_bias=((2, 4.0), (11, 2.5))),
          dict(seed=11, temperature=0.7, top_p=0.9,
               frequency_penalty=0.4),
          None]

    def run(srv, cls):
        return [r.result() for r in _run(
            srv, PROMPTS, 12,
            [None if kw is None else cls(**kw) for kw in sp])]

    # the last request draws server-global: the reference of its
    # scheduler stages the same dispatches
    want = run(_ref_server(weights, icfg, scheduler=sched["scheduler"]),
               RefSamplingParams)
    got = run(_port_server(weights, icfg, **sched), SamplingParams)
    assert got == want
    assert len(got[1]) >= 6  # min_tokens held EOS back


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
def test_draft_speculation_greedy_exact(weights, sched):
    """Draft-model speculation (its chunk prefill inside the prefill
    half, its G+1 steps a round against its own pools): the reference's
    greedy tokens under every schedule, logprobs within 1e-4."""
    ref_draft, port_draft = _draft_setup()
    prompts = [REP, PROMPTS[0], LONG, list(range(1, 14))]
    srv = _port_server(weights, spec_drafts=2, draft=port_draft, **sched)
    assert srv._mixed_enabled == (sched["scheduler"] == "mixed")
    got = _run(srv, prompts, 12)
    want = _run(_ref_server(weights, spec_drafts=2, draft=ref_draft),
                prompts, 12)
    assert [r.result() for r in got] == _reference(weights, prompts, 12)
    assert [r.result() for r in got] == [r.result() for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
    assert srv.spec_tokens_drafted > 0


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("draft", [True, False], ids=["draft", "ngram"])
def test_seeded_speculation_exact(weights, sched, draft):
    """Seeded sampling through speculation at a fixed draft length: the
    proposal, accept and corrective draws are position-keyed, so every
    schedule gives the reference's tokens, penalties included."""
    ref_draft, port_draft = _draft_setup()
    icfg = dataclasses.replace(GREEDY, temperature=1.0)
    sp = [dict(seed=300 + i, temperature=0.9, top_p=0.9,
               presence_penalty=0.3) for i in range(4)]
    prompts = [REP, PROMPTS[0], LONG, PROMPTS[1]]
    kw = dict(spec_drafts=2, spec_control=False)

    def run(srv, cls):
        return [r.result() for r in _run(srv, prompts, 10,
                                         [cls(**s) for s in sp])]

    want = run(_ref_server(weights, icfg, draft=ref_draft if draft
                           else None, **kw), RefSamplingParams)
    got = run(_port_server(weights, icfg, draft=port_draft if draft
                           else None, **kw, **sched), SamplingParams)
    assert got == want


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
def test_adaptive_speculation_midstream_changes_exact(weights, sched):
    """The adaptive controller walks draft lengths down on a random
    draft (0-length rows ride the window as plain decode, then the
    dispatch drops to plain decode): greedy tokens stay the
    reference's."""
    ref_draft, port_draft = _draft_setup()
    ctl = {"low": 0.45, "high": 0.8, "ewma": 0.5, "cooldown": 1,
           "probe_period": 4}
    prompts = [REP, PROMPTS[0], LONG]
    srv = _port_server(weights, spec_drafts=3, draft=port_draft,
                       spec_control=ctl, **sched)
    got = [r.result() for r in _run(srv, prompts, 14)]
    assert srv.spec_control.length_changes > 0
    assert got == _reference(weights, prompts, 14)


def test_adaptive_ngram_raises_lengths_exact(weights):
    """The controller moves both ways: n-gram drafts on repetitive
    prompts accept, lengths climb from 1, committed tokens per round
    rise above 1.1, and the tokens are the reference's."""
    ctl = {"initial": 1, "low": 0.2, "high": 0.5, "ewma": 0.5,
           "cooldown": 2, "probe_period": 8}
    prompts = [REP, [3, 4, 5, 6] * 6]
    srv = _port_server(weights, spec_drafts=3, spec_control=ctl)
    got = [r.result() for r in _run(srv, prompts, 16)]
    assert srv.spec_control.length_changes > 0
    assert srv.decode_tokens_committed / max(srv.decode_rounds, 1) > 1.1
    assert got == _reference(weights, prompts, 16)
    stats = srv.speculation_stats()
    assert stats["source"] == "ngram" and stats["adaptive"]
    assert stats["tokens_accepted"] == srv.spec_tokens_accepted > 0


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


@pytest.fixture(scope="module")
def int8_reference(weights):
    """The reference int8 speculating server's requests, per draft
    source, run once for both schedules (greedy tokens and their
    logprobs do not depend on the schedule)."""
    cfg8 = dataclasses.replace(CFG, kv_cache_dtype="int8")
    done = {}

    def get(draft: bool):
        if draft not in done:
            ref_kw, _ = _int8_setup(draft)
            done[draft] = _run(RefServer(weights[0], cfg8, GREEDY,
                                         overlap=False, spec_drafts=2,
                                         **ref_kw, **SRV_KW),
                               INT8_PROMPTS, 10)
        return done[draft]

    return get


@pytest.mark.parametrize("draft", [True, False], ids=["draft", "ngram"])
@pytest.mark.parametrize("scheduler", ["mixed", "alternating"])
def test_int8_cache_speculation_exact(weights, int8_reference, scheduler,
                                      draft):
    """The int8 KV cache (target and draft pools int8, their scale
    pages moving with them) under n-gram and draft-model speculation:
    the reference speculating int8 server's tokens, logprobs within
    1e-4."""
    cfg8 = dataclasses.replace(CFG, kv_cache_dtype="int8")
    _, port_kw = _int8_setup(draft)
    srv = PagedInferenceServer(
        weights[1], TModelConfig(**dataclasses.asdict(cfg8)),
        TInferConfig(**dataclasses.asdict(GREEDY)), device="cpu",
        spec_drafts=2, scheduler=scheduler, **port_kw, **SRV_KW)
    assert srv.k_scale_pool is not None
    got = _run(srv, INT8_PROMPTS, 10)
    want = int8_reference(draft)
    assert [r.result() for r in got] == [r.result() for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
    assert srv.spec_tokens_drafted > 0


@pytest.mark.parametrize("draft", [True, False], ids=["draft", "ngram"])
def test_preemption_during_spec_dispatch(weights, draft):
    """The pipeline plans on upper bounds of a speculative dispatch's
    commits; pages run out while one is in flight, the sequential
    iteration preempts, the continuation re-admits (re-prefilling the
    draft pools): every output is the reference's."""
    ref_draft, port_draft = _draft_setup()
    prompts = [[(i * 9 + k) % 60 + 1 for k in range(8)] for i in range(6)]
    kw = dict(max_slots=6, max_context=64, page_size=8, prefill_chunk=16,
              prompt_buckets=[16], decode_chunk=2)
    srv = _port_server(weights, scheduler="mixed", num_pages=14,
                       spec_drafts=2, draft=port_draft if draft else None,
                       **kw)
    assert srv._overlap_enabled
    reqs = [srv.submit(p, max_new_tokens=36) for p in prompts]
    srv.run_until_idle()
    assert srv.preemptions > 0
    assert [r.result() for r in reqs] == _reference(weights, prompts, 36,
                                                    **kw)


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


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("draft", [True, False], ids=["draft", "ngram"])
def test_grammar_through_spec_windows(sched, draft):
    """A regex-constrained, penalised request sharing the batch with a
    free one: the DFA walk through the drafts masks every window
    position; token for token the reference's, and the constrained
    output is all digits."""
    ref, prt, icfg, kw = _grammar_setup()

    def run(srv, cls):
        free = srv.submit(prt["tok"].encode("hello"), max_new_tokens=12)
        for _ in range(2):
            srv.step()
        con = srv.submit(prt["tok"].encode("n:"), max_new_tokens=12,
                         sampling=cls(regex=r"[0-9]+", seed=5,
                                      frequency_penalty=0.3))
        srv.run_until_idle()
        return free.result(), con.result()

    spec = dict(spec_drafts=2)
    want = run(RefServer(
        ref["params"], ref["cfg"], icfg, overlap=False, tokenizer=ref["tok"],
        **({**spec, "draft_params": ref["draft"][0],
            "draft_cfg": ref["draft"][1]} if draft else spec), **kw),
        RefSamplingParams)
    got = run(PagedInferenceServer(
        prt["params"], prt["cfg"], TInferConfig(**dataclasses.asdict(icfg)),
        device="cpu", tokenizer=prt["tok"],
        **({**spec, "draft_params": prt["draft"][0],
            "draft_cfg": prt["draft"][1]} if draft else spec),
        **kw, **sched), SamplingParams)
    assert got == want
    digits = prt["tok"].decode([t for t in got[1]
                                if t != prt["tok"].eos_id])
    assert digits and digits.isdigit(), digits


def test_new_pattern_releases_the_programs_that_read_the_stack():
    """Registering a pattern rebuilds the grammar stack; exactly the
    programs keyed to the old stack are released (a captured graph would
    read the freed one) and made again, the rest are kept."""
    _, prt, icfg, kw = _grammar_setup()
    srv = PagedInferenceServer(
        prt["params"], prt["cfg"], TInferConfig(**dataclasses.asdict(icfg)),
        device="cpu", tokenizer=prt["tok"], overlap=False, **kw)
    tok = prt["tok"]
    srv.generate([tok.encode("hi")], max_new_tokens=3)
    plain = set(srv._programs.keys())
    a = srv.submit(tok.encode("a:"), max_new_tokens=4,
                   sampling=SamplingParams(regex="[0-9]+"))
    srv.run_until_idle()
    assert a.finish_reason in ("eos", "length")
    stack1 = {k for k in srv._programs.keys() if k[1] >= 0}
    assert stack1 and srv._programs.dropped == 0
    b = srv.submit(tok.encode("b:"), max_new_tokens=4,
                   sampling=SamplingParams(regex="[a-z]+"))
    srv.run_until_idle()
    assert b.finish_reason in ("eos", "length")
    assert srv._programs.dropped == len(stack1)
    keys = set(srv._programs.keys())
    assert not stack1 & keys and plain <= keys
    assert {k[1] for k in keys if k[1] >= 0} == {srv._grammar_gen} == {2}
    gn, s_max, v = srv._model.grammar[0].shape
    assert (gn, v) == (3, 300)
    assert srv.grammar_stack_bytes() == gn * s_max * v * 4 + gn * s_max


@pytest.mark.parametrize("draft", [True, False], ids=["draft", "ngram"])
def test_new_pattern_mid_decode_under_overlap(draft):
    """Under the default overlap pipeline a request with a new pattern
    arrives while a constrained request is mid-decode: the stack is
    rebuilt with the dispatch that reads the old one in flight. That
    dispatch still commits (its program is released only after), no
    request fails, and every output is the reference's."""
    ref, prt, icfg, kw = _grammar_setup()
    icfg = dataclasses.replace(icfg, max_decode_len=24)
    spec = dict(spec_drafts=2)
    kw = dict(kw, decode_chunk=2)

    def run(srv, cls, tok):
        a = srv.submit(tok.encode("n:"), max_new_tokens=24,
                       sampling=cls(regex=r"[0-9]{16}"))
        for _ in range(2):
            srv.step()
        if isinstance(srv, PagedInferenceServer):
            # the dispatch in flight reads the stack `b` replaces
            assert srv._inflight is not None and not a._done.is_set()
        b = srv.submit(tok.encode("w:"), max_new_tokens=12,
                       sampling=cls(regex=r"[a-z]{6}", seed=3,
                                    repetition_penalty=1.2))
        srv.run_until_idle()
        return [(r.finish_reason, r.result()) for r in (a, b)]

    want = run(RefServer(
        ref["params"], ref["cfg"], icfg, overlap=False, tokenizer=ref["tok"],
        **({**spec, "draft_params": ref["draft"][0],
            "draft_cfg": ref["draft"][1]} if draft else spec), **kw),
        RefSamplingParams, ref["tok"])
    srv = PagedInferenceServer(
        prt["params"], prt["cfg"], TInferConfig(**dataclasses.asdict(icfg)),
        device="cpu", tokenizer=prt["tok"],
        **({**spec, "draft_params": prt["draft"][0],
            "draft_cfg": prt["draft"][1]} if draft else spec), **kw)
    assert srv._overlap_enabled
    got = run(srv, SamplingParams, prt["tok"])
    assert got == want
    assert srv._programs.dropped_in_flight == 1 and srv._grammar_gen == 2
    assert not srv._retired
    assert all(reason in ("eos", "length") for reason, _ in got)
