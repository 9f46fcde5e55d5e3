"""The port's schedulers under speculation, penalties and the
adaptive controller (the speculation half of
tests/test_torch_mixed_scheduler.py, whose weights and helpers it
shares): n-gram and draft-model speculation, penalised and biased seeded
requests through admission, and the controller's length changes under
every schedule, each held token for token against the reference server
on the same weights (each reference run made once for every schedule
that compares against it)."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mixed_scheduler import (  # noqa: E402,F401
    CFG, GREEDY, LONG, PROMPTS, REP, SCHEDULE_IDS, SCHEDULES, RefSamplingParams,
    SamplingParams, _draft_setup, _port_server, _ref_server, _reference, _run,
    ref_runs, weights)
from torch_test_setup import release_compiled_programs  # noqa: E402,F401


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
def test_ngram_speculation_greedy_exact(weights, ref_runs, sched):
    """n-gram speculation at W = drafts + 1 under every schedule: each
    request's tokens are the reference server's plain greedy tokens, the
    reference speculating server's logprobs within 1e-4, and drafts
    really accept."""
    prompts = [REP, PROMPTS[0], LONG]
    srv = _port_server(weights, spec_drafts=3, **sched)
    got = _run(srv, prompts, 10)
    want = ref_runs("ngram", lambda: _run(
        _ref_server(weights, spec_drafts=3), prompts, 10))
    assert [r.result() for r in got] == ref_runs(
        "ngram_greedy", lambda: _reference(weights, prompts, 10))
    assert [r.result() for r in got] == [r.result() for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
    assert srv.spec_tokens_accepted > 0
    assert srv.decode_tokens_committed > srv.decode_rounds


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
def test_grammar_and_penalties_through_admission(weights, ref_runs, sched):
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
    want = ref_runs(("penalties", sched["scheduler"]), lambda: run(
        _ref_server(weights, icfg, scheduler=sched["scheduler"]),
        RefSamplingParams))
    got = run(_port_server(weights, icfg, **sched), SamplingParams)
    assert got == want
    assert len(got[1]) >= 6  # min_tokens held EOS back


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
def test_draft_speculation_greedy_exact(weights, ref_runs, sched):
    """Draft-model speculation (its chunk prefill inside the prefill
    half, its G+1 steps a round against its own pools): the reference's
    greedy tokens under every schedule, logprobs within 1e-4."""
    ref_draft, port_draft = _draft_setup()
    prompts = [REP, PROMPTS[0], LONG, list(range(1, 14))]
    srv = _port_server(weights, spec_drafts=2, draft=port_draft, **sched)
    assert srv._mixed_enabled == (sched["scheduler"] == "mixed")
    got = _run(srv, prompts, 12)
    want = ref_runs("draft", lambda: _run(
        _ref_server(weights, spec_drafts=2, draft=ref_draft), prompts, 12))
    assert [r.result() for r in got] == ref_runs(
        "draft_greedy", lambda: _reference(weights, prompts, 12))
    assert [r.result() for r in got] == [r.result() for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4)
    assert srv.spec_tokens_drafted > 0


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
def test_adaptive_speculation_midstream_changes_exact(weights, ref_runs,
                                                      sched):
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
    assert got == ref_runs("adaptive_greedy",
                           lambda: _reference(weights, prompts, 14))


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
