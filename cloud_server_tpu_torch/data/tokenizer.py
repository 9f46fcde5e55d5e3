"""Tokenizers + corpus preparation.

A copy of the reference's `data/tokenizer.py`: the byte-level tokenizer
(ids 0..255 are raw bytes, then BOS/EOS/PAD; lossless on arbitrary
UTF-8), `HFTokenizer` (a local HuggingFace `tokenizer.json`, through the
`tokenizers` package, imported when one is built: where the package is
missing it raises the reference's RuntimeError), `get_tokenizer`
("byte" or a local tokenizer path), `token_dtype`, and
`prepare_corpus`, which streams a text file into the flat binary token
format that `data.dataset.MemmapTokenDataset` reads.

CLI: `python -m cloud_server_tpu_torch.data.tokenizer in.txt out.bin`.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator, Sequence

import numpy as np


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


class HFTokenizer:
    """A local HuggingFace fast tokenizer behind the framework interface.

    `path` is a local `tokenizer.json` file or a directory containing one
    (a saved `PreTrainedTokenizerFast`); nothing is fetched remotely.
    """

    def __init__(self, path: str | os.PathLike):
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise RuntimeError(
                "HFTokenizer needs the `tokenizers` package; use "
                "ByteTokenizer where it is unavailable") from e
        path = os.fspath(path)
        if os.path.isdir(path):
            path = os.path.join(path, "tokenizer.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path}: no local tokenizer.json (remote hub loading is "
                "deliberately unsupported — this environment has no egress)")
        self._tok = Tokenizer.from_file(path)
        self.vocab_size = self._tok.get_vocab_size()

        def _tid(*names):
            for n in names:
                t = self._tok.token_to_id(n)
                if t is not None:
                    return t
            return None

        self.bos_id = _tid("<s>", "<bos>", "<|begin_of_text|>", "[CLS]")
        self.eos_id = _tid("</s>", "<eos>", "<|end_of_text|>",
                           "<|endoftext|>", "[SEP]")
        self.pad_id = _tid("<pad>", "[PAD]")
        # provenance matters downstream: grammar.token_bytes bans
        # DECLARED specials only — a fallback pad (eos, else 0) must not
        # make a real vocab id unspellable under a constraint
        self.pad_is_declared = self.pad_id is not None
        if self.pad_id is None:  # fall back to EOS, the common convention
            self.pad_id = self.eos_id if self.eos_id is not None else 0

    def encode(self, text: str, *, add_bos: bool = False,
               add_eos: bool = False) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_bos and self.bos_id is not None:
            ids.insert(0, self.bos_id)
        if add_eos and self.eos_id is not None:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def get_tokenizer(spec: str | os.PathLike = "byte"):
    """"byte" -> ByteTokenizer; anything else is a local HF tokenizer
    path (a tokenizer.json or a directory holding one)."""
    if os.fspath(spec) == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec)


def token_dtype(vocab_size: int) -> np.dtype:
    return np.dtype(np.uint16 if vocab_size <= 0xFFFF else np.uint32)


def _iter_chunks(path: str | os.PathLike,
                 chunk_bytes: int) -> Iterator[str]:
    """Stream a UTF-8 text file in chunks, preferring line boundaries (so
    tokenizers with merges spanning a boundary only ever lose cross-LINE
    merges). A newline-free stretch longer than 4×chunk_bytes is flushed
    mid-line anyway — the bounded-memory contract beats boundary purity
    on single-line corpora."""
    with open(path, encoding="utf-8") as f:
        buf = ""
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                if buf:
                    yield buf
                return
            buf += chunk
            cut = buf.rfind("\n") + 1
            if cut:
                yield buf[:cut]
                buf = buf[cut:]
            elif len(buf) >= 4 * chunk_bytes:
                yield buf
                buf = ""


def prepare_corpus(text_path: str | os.PathLike,
                   out_path: str | os.PathLike, tokenizer=None, *,
                   append_eos_per_chunk: bool = False,
                   chunk_bytes: int = 1 << 20) -> int:
    """Tokenize a text file into the flat binary format; returns #tokens.

    Streams in `chunk_bytes` pieces so corpora never need to fit in
    memory. The output dtype follows the tokenizer's vocab size and is
    recorded in a `<out_path>.meta.json` sidecar, which
    `MemmapTokenDataset` reads (a uint32 file read as uint16 would be
    garbage).
    """
    tokenizer = tokenizer or ByteTokenizer()
    dtype = token_dtype(tokenizer.vocab_size)
    total = 0
    with open(out_path, "wb") as out:
        for text in _iter_chunks(text_path, chunk_bytes):
            ids = tokenizer.encode(text, add_eos=append_eos_per_chunk)
            np.asarray(ids, dtype).tofile(out)
            total += len(ids)
    with open(f"{os.fspath(out_path)}.meta.json", "w") as f:
        json.dump({"dtype": dtype.name, "vocab_size": tokenizer.vocab_size,
                   "num_tokens": total}, f)
    return total


def main(argv: Iterable[str] | None = None) -> None:
    """CLI: `python -m cloud_server_tpu_torch.data.tokenizer in.txt
    out.bin`."""
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m cloud_server_tpu_torch.data.tokenizer",
        description="Tokenize a text file into a flat binary token file.")
    p.add_argument("text", help="input UTF-8 text file")
    p.add_argument("out", help="output .bin token file")
    p.add_argument("--tokenizer", default="byte",
                   help='"byte" or a local tokenizer.json path')
    args = p.parse_args(argv)
    tok = get_tokenizer(args.tokenizer)
    n = prepare_corpus(args.text, args.out, tok)
    print(f"{args.out}: {n} tokens "
          f"(vocab {tok.vocab_size}, dtype {token_dtype(tok.vocab_size)})")


if __name__ == "__main__":
    main()
