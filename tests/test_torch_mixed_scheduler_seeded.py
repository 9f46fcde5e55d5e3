"""Seeded sampling through speculation under every schedule, and
preemption while a speculative dispatch is in flight, against the
reference server (shares tests/test_torch_mixed_scheduler.py's weights
and helpers; each reference run made once for every schedule that
compares against it)."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mixed_scheduler import (  # noqa: E402,F401
    GREEDY, LONG, PROMPTS, REP, SCHEDULE_IDS, SCHEDULES, RefSamplingParams,
    SamplingParams, _draft_setup, _port_server, _ref_server, _reference, _run,
    ref_runs, weights)
from torch_test_setup import release_compiled_programs  # noqa: E402,F401


@pytest.mark.parametrize("sched", SCHEDULES, ids=SCHEDULE_IDS)
@pytest.mark.parametrize("draft", [True, False], ids=["draft", "ngram"])
def test_seeded_speculation_exact(weights, ref_runs, sched, draft):
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

    want = ref_runs(("seeded", draft), lambda: run(_ref_server(
        weights, icfg, draft=ref_draft if draft else None, **kw),
        RefSamplingParams))
    got = run(_port_server(weights, icfg, draft=port_draft if draft
                           else None, **kw, **sched), SamplingParams)
    assert got == want


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
