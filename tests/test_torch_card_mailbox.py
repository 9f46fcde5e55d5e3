"""The same-card transport of the collectives
(`parallel.collectives._CardMailbox`: ranks of a gloo group that share
one card move a collective's data through each other's device buffers).
On the CPU the mailboxes are shared-memory tensors handed to the ranks,
small enough that every collective runs in several pieces; each result
must be bit-equal to gloo's on the same inputs."""

from __future__ import annotations

import os
import sys

import pytest
import torch

from cloud_server_tpu_torch.parallel import spawn_ranks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_ranks as ranks  # noqa: E402


@pytest.mark.parametrize("world", [2, 3])
def test_card_mailbox_matches_gloo(world):
    # 3000 bytes: regions of 768 (one destination) or 256 bytes (three)
    buffers = [torch.zeros(3000, dtype=torch.uint8).share_memory_()
               for _ in range(world)]
    got = spawn_ranks(ranks.card_mailbox_case, world, "gloo", buffers,
                      deadline_s=120.0)
    for rank, res in enumerate(got):
        bad = [k for k, ok in res.items() if not ok]
        assert not bad, (rank, bad)
        assert len(res) == 20
