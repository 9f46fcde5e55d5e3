"""The int8 KV cache under n-gram and draft-model speculation, under
both schedulers, against the reference speculating int8 server (shares
tests/test_torch_mixed_scheduler.py's weights and helpers)."""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_mixed_scheduler import (  # noqa: E402,F401
    CFG, GREEDY, INT8_PROMPTS, SRV_KW, PagedInferenceServer, RefServer,
    TInferConfig, TModelConfig, _int8_setup, _run, weights)
from torch_test_setup import release_compiled_programs  # noqa: E402,F401


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
