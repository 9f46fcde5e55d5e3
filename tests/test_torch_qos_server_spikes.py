"""Deadline and preemption spikes under every schedule: the port's anomaly
watchdog fires the reference's rules alike (the spike case of
tests/test_torch_qos_server.py, whose weights and helpers it shares, in
a file of its own so that `--dist loadfile` spreads the module over
workers)."""

import dataclasses
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_qos_server import (  # noqa: E402,F401
    ANOMALY, GREEDY, PROMPTS, SCHEDULES, _servers, _submit_all, weights)
from torch_test_setup import release_compiled_programs  # noqa: E402,F401


@pytest.mark.parametrize("sched", SCHEDULES)
def test_deadline_and_preempt_spikes_fire_alike(weights, sched):
    """Requests past their deadline and page-famine preemptions fire
    `deadline_spike` and `preempt_spike` as the reference's watchdog
    does; a bundle lands on each activation edge."""
    icfg = dataclasses.replace(GREEDY, bundle_on_anomaly=True)
    out = []
    for srv in _servers(weights, sched, icfg=icfg, anomaly=ANOMALY):
        reqs, _ = _submit_all(srv, PROMPTS[:6], [None] * 6, 40)
        late, _ = _submit_all(srv, PROMPTS[6:], [None] * 3, 8,
                              deadline_s=1e-6)
        srv.run_until_idle()
        st = srv.anomaly_stats()
        out.append({"fired": st["fired_total"],
                    "rules": [e["rule"] for e in st["events"]],
                    "finish": [r.finish_reason for r in reqs + late],
                    "tokens": [r.tokens for r in reqs],
                    "bundles": [b["trigger"]
                                for b in srv.debug_bundles()]})
    want, got = out
    assert got == want
    assert got["fired"]["deadline_spike"] == 1
    assert got["fired"]["preempt_spike"] == 1
    assert sorted(got["bundles"]) == ["anomaly:deadline_spike",
                                      "anomaly:preempt_spike"]
