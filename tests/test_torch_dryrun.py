"""`graft_entry.dryrun_multichip` on the CPU: four gloo ranks run the
reference's eight families (`__graft_entry__.dryrun_multichip`), one
step each, and print its summary line; on a machine without cards the
default (the cards) raises instead of running on the CPU."""

import re

import pytest
import torch

from cloud_server_tpu_torch.graft_entry import dryrun_multichip

# the reference's family names, in its order
REF_FAMILIES = ["dense", "ring-sp", "ulysses-sp", "moe-ep", "hybrid-dcn",
                "pipeline-pp", "paged-serving-tp", "replicated-serving-dp"]


@pytest.fixture(scope="module")
def four():
    return dryrun_multichip(4, device="cpu")


def test_dryrun_multichip_runs_every_family(four):
    """Every family runs at n = 4, nothing is skipped, each training
    family prints a finite loss and the serving families their tokens."""
    assert four["ran"] == REF_FAMILIES
    assert four["skipped"] == []
    lines = four["lines"]
    assert lines[-1] == f"dryrun_multichip(4): ran {REF_FAMILIES}"
    losses = [float(m.group(1)) for line in lines
              for m in [re.search(r"loss=([0-9.]+)$", line)] if m]
    assert len(losses) == 6 and all(0 < x < 10 for x in losses)
    assert any("mesh={'pp': 2, 'fsdp': 2}" in line for line in lines)
    assert any("mesh={'fsdp': 2, 'ep': 2}" in line for line in lines)
    assert any("paged serving tp" in line and "tokens=8" in line
               for line in lines)
    assert any("parity=exact" in line for line in lines)
    # family 6 ran on every rank (the plain paged attention on the CPU)
    assert len(four["paged_counts"]) == 4
    assert all(c.get("plain_calls", 0) > 0 for c in four["paged_counts"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_dryrun_multichip_needs_the_cards_unless_asked():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
