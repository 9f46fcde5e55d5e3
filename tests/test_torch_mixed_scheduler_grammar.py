"""Grammar-constrained requests through speculation windows under
every schedule, and the programs a new grammar pattern releases, with
and without a dispatch in flight, against the reference server (shares
tests/test_torch_mixed_scheduler.py's helpers)."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mixed_scheduler import (  # noqa: E402,F401
    SCHEDULE_IDS, SCHEDULES, PagedInferenceServer, RefSamplingParams,
    RefServer, SamplingParams, TInferConfig, _grammar_setup, ref_runs)
from torch_test_setup import release_compiled_programs  # noqa: E402,F401


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("draft", [True, False], ids=["draft", "ngram"])
def test_grammar_through_spec_windows(ref_runs, sched, draft):
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
    want = ref_runs(("grammar", draft), lambda: run(RefServer(
        ref["params"], ref["cfg"], icfg, overlap=False, tokenizer=ref["tok"],
        **({**spec, "draft_params": ref["draft"][0],
            "draft_cfg": ref["draft"][1]} if draft else spec), **kw),
        RefSamplingParams))
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
