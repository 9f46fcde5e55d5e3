"""Byte-level tokenizer: ids 0..255 are raw bytes, then BOS/EOS/PAD.

A copy of the reference's `ByteTokenizer` (data/tokenizer.py there),
lossless on arbitrary UTF-8. The HuggingFace wrapper and corpus
preparation of that module are not ported yet.
"""

from __future__ import annotations

from typing import Sequence


class ByteTokenizer:
    """Lossless byte-level tokenizer: 0..255 bytes + BOS/EOS/PAD."""

    def __init__(self):
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.vocab_size = 259

    def encode(self, text: str, *, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids.insert(0, self.bos_id)
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")
