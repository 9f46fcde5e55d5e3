"""The port's tokenizer module against the reference's
(tests/test_tokenizer.py's byte-level cases): the byte tokenizer's ids,
`get_tokenizer` dispatch (anything but "byte" is refused: HuggingFace
interop is not ported), `token_dtype`, `_iter_chunks` and
`prepare_corpus` (the token file and its sidecar equal the reference's,
read back by the port's MemmapTokenDataset), and the CLI."""

import json

import numpy as np
import pytest

from cloud_server_tpu.data import tokenizer as ref_tok
from cloud_server_tpu_torch.data.dataset import MemmapTokenDataset
from cloud_server_tpu_torch.data.tokenizer import (ByteTokenizer,
                                                   _iter_chunks,
                                                   get_tokenizer,
                                                   prepare_corpus,
                                                   token_dtype)


def test_byte_roundtrip_unicode():
    tok = ByteTokenizer()
    text = "hello wörld — 日本語 🚀"
    assert tok.encode(text) == ref_tok.ByteTokenizer().encode(text)
    assert tok.decode(tok.encode(text)) == text


def test_byte_specials():
    tok = ByteTokenizer()
    ids = tok.encode("ab", add_bos=True, add_eos=True)
    assert ids[0] == tok.bos_id and ids[-1] == tok.eos_id
    assert tok.decode(ids) == "ab"  # specials dropped on decode
    assert tok.vocab_size == 259


def test_get_tokenizer_dispatch(tmp_path):
    assert isinstance(get_tokenizer("byte"), ByteTokenizer)
    with pytest.raises(NotImplementedError, match="HuggingFace"):
        get_tokenizer(tmp_path / "tokenizer.json")


def test_token_dtype_boundaries():
    for n in (259, 0xFFFF, 0x10000):
        assert token_dtype(n) == ref_tok.token_dtype(n)
    assert token_dtype(0xFFFF) == np.uint16
    assert token_dtype(0x10000) == np.uint32


def test_prepare_corpus_matches_one_shot_and_feeds_dataset(tmp_path):
    text = "\n".join(f"line {i} with some text" for i in range(200)) + "\n"
    src = tmp_path / "corpus.txt"
    src.write_text(text)
    out, ref_out = tmp_path / "tokens.bin", tmp_path / "ref.bin"
    tok = ByteTokenizer()
    # tiny chunk size forces many chunk boundaries
    n = prepare_corpus(src, out, tok, chunk_bytes=64)
    assert n == len(tok.encode(text))
    assert n == ref_tok.prepare_corpus(src, ref_out,
                                       ref_tok.ByteTokenizer(),
                                       chunk_bytes=64)
    assert out.read_bytes() == ref_out.read_bytes()
    assert json.loads((tmp_path / "tokens.bin.meta.json").read_text()) == \
        json.loads((tmp_path / "ref.bin.meta.json").read_text())
    ds = MemmapTokenDataset(out, seq_len=32)
    assert len(ds) == n // 32
    assert tok.decode(ds[0]["tokens"].tolist()).startswith("line 0")


def test_uint32_corpus_autodetected_by_dataset(tmp_path):
    """A large-vocab corpus (uint32) must not be misread as uint16."""
    class BigVocab(ByteTokenizer):
        def __init__(self):
            super().__init__()
            self.vocab_size = 100_000  # forces uint32 storage

    tok = BigVocab()
    src = tmp_path / "c.txt"
    src.write_text("abcdefgh\n" * 32)
    out = tmp_path / "c.bin"
    n = prepare_corpus(src, out, tok, append_eos_per_chunk=True)
    assert token_dtype(tok.vocab_size) == np.uint32
    ds = MemmapTokenDataset(out, seq_len=16)  # dtype from the sidecar
    assert len(ds) == n // 16
    assert tok.decode(ds[0]["tokens"].tolist()).startswith("abcdefgh")
    assert int(np.fromfile(out, np.uint32)[-1]) == tok.eos_id


def test_tokenizer_cli(tmp_path, capsys):
    from cloud_server_tpu_torch.data.tokenizer import main
    src = tmp_path / "in.txt"
    src.write_text("abc\ndef\n")
    main([str(src), str(tmp_path / "out.bin")])
    assert "8 tokens" in capsys.readouterr().out


def test_single_line_corpus_stays_bounded(tmp_path):
    """No newlines at all: chunking flushes mid-line, as the reference's
    does, and the byte tokenizer's output is exact."""
    text = "x" * 5000  # one giant line
    src = tmp_path / "one_line.txt"
    src.write_text(text)
    pieces = list(_iter_chunks(src, chunk_bytes=64))
    assert pieces == list(ref_tok._iter_chunks(src, chunk_bytes=64))
    assert max(len(p) for p in pieces) <= 4 * 64
    assert "".join(pieces) == text
    n = prepare_corpus(src, tmp_path / "o.bin", ByteTokenizer(),
                       chunk_bytes=64)
    assert n == 5000
