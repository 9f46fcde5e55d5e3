"""Segment-id helpers for packed sequences (see data/packing.py).

A copy of the reference's `ops/segments.py` on torch tensors.
Convention: segment_ids (B, S) int, 0 = padding, documents numbered
1, 2, ... left-to-right within each row.
"""

from __future__ import annotations

import torch


def positions_from_segments(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) segment ids -> (B, S) int64 RoPE positions restarting at 0
    at every segment boundary (padding positions are counted within their
    run but are masked everywhere downstream, so their values are moot)."""
    b, s = segment_ids.shape
    idx = torch.arange(s, device=segment_ids.device)[None, :].expand(b, s)
    change = torch.ones((b, s), dtype=torch.bool, device=segment_ids.device)
    change[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    start = torch.where(change, idx, torch.zeros_like(idx))
    running_start = torch.cummax(start, dim=1).values
    return idx - running_start


def segment_target_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) segment ids -> (B, S) f32 token mask for the next-token loss:
    token j counts as a target iff it continues its predecessor's segment
    (same id, not padding). Position 0 is never a target (both CE paths
    drop it)."""
    prev_same = torch.zeros(segment_ids.shape, dtype=torch.bool,
                            device=segment_ids.device)
    prev_same[:, 1:] = segment_ids[:, 1:] == segment_ids[:, :-1]
    return (prev_same & (segment_ids > 0)).float()
