"""Sequence packing: multiple documents per training row, separated by
segment ids, so short examples don't burn compute as padding. A copy of
the reference's `data/packing.py` (numpy only).

Packed rows pair a `tokens` row with a same-shape `segment_ids` row:
0 marks padding, documents count 1, 2, ... within each row. Downstream,
the dense transformer uses the ids three ways (all derived, no extra
inputs): attention is masked to same-segment pairs (block-diagonal
causal), RoPE positions restart at each segment start, and the loss masks
targets that would cross a boundary (the last token of one document must
not be trained to predict the first token of the next). The result is
numerically identical to running each document alone — tested in
tests/test_torch_packing.py — while keeping every (B, S) shape static.

Packing is greedy in arrival order: documents are appended to the current
row while they fit; a document longer than seq_len is split into
seq_len-sized pieces, each becoming its own segment (positions restart
per piece — the price of keeping shapes static; shuffle-robust training
is insensitive to this).
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def pack_documents(docs: Iterable[Sequence[int]], seq_len: int,
                   *, pad_id: int = 0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Pack documents into rows.

    Returns (tokens, segment_ids), both (N, seq_len) int32; segment ids
    are 1-based per row, 0 marks padding.
    """
    rows_t: list[np.ndarray] = []
    rows_s: list[np.ndarray] = []
    cur_t: list[int] = []
    cur_s: list[int] = []
    seg = 0

    def flush():
        nonlocal cur_t, cur_s, seg
        if not cur_t:
            return
        pad = seq_len - len(cur_t)
        rows_t.append(np.asarray(cur_t + [pad_id] * pad, np.int32))
        rows_s.append(np.asarray(cur_s + [0] * pad, np.int32))
        cur_t, cur_s, seg = [], [], 0

    for doc in docs:
        doc = list(doc)
        if not doc:
            continue
        for start in range(0, len(doc), seq_len):
            piece = doc[start:start + seq_len]
            if len(cur_t) + len(piece) > seq_len:
                flush()
            seg += 1
            cur_t.extend(piece)
            cur_s.extend([seg] * len(piece))
    flush()
    if not rows_t:
        return (np.zeros((0, seq_len), np.int32),
                np.zeros((0, seq_len), np.int32))
    return np.stack(rows_t), np.stack(rows_s)


def packing_efficiency(segment_ids: np.ndarray) -> float:
    """Fraction of positions holding real tokens (1.0 = no padding)."""
    if segment_ids.size == 0:
        return 1.0
    return float((segment_ids != 0).mean())


class PackedTokenDataset:
    """In-memory packed dataset: {"tokens", "segment_ids"} per example.

    For corpus-scale data, pack offline and memmap the two arrays; this
    class is the reference implementation and the fine-tuning-scale path.
    """

    def __init__(self, docs: Iterable[Sequence[int]], seq_len: int,
                 *, pad_id: int = 0):
        self.tokens, self.segment_ids = pack_documents(
            docs, seq_len, pad_id=pad_id)
        self.seq_len = seq_len

    def __len__(self) -> int:
        return self.tokens.shape[0]

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        return {"tokens": self.tokens[i],
                "segment_ids": self.segment_ids[i]}
