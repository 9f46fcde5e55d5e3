"""The port's schedulers against the reference's: the sequential
scheduler's cases of tests/test_torch_overlap.py's
`check_schedulers_match_reference` (the same tokens, logprobs within
1e-4, the same preemptions and flight records, greedy, per-request
seeded and server-global seeded, on the staggered workload and under
preemption), in a file of their own so that `--dist loadfile` spreads
them over workers."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_overlap import (  # noqa: E402,F401
    check_schedulers_match_reference, weights)
from torch_test_setup import release_compiled_programs  # noqa: E402,F401


@pytest.mark.parametrize("workload", ["staggered", "preempt"])
@pytest.mark.parametrize("draw", ["greedy", "seeded_rows", "server_global"])
@pytest.mark.parametrize("sched", ["sequential"])
def test_schedulers_match_reference(weights, sched, draw, workload):
    check_schedulers_match_reference(weights, sched, draw, workload)
