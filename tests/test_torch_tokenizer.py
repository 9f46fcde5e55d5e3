"""The port's tokenizer module against the reference's
(tests/test_tokenizer.py's byte-level cases): the byte tokenizer's ids,
`get_tokenizer` dispatch ("byte", else a local HuggingFace tokenizer
path), `token_dtype`, `_iter_chunks` and `prepare_corpus` (the token
file and its sidecar equal the reference's, read back by the port's
MemmapTokenDataset), and the CLI; then tests/test_tokenizer.py's three
HuggingFace tokenizer cases on a BPE trained here, ids and text equal to
the reference's `HFTokenizer`."""

import json

import numpy as np
import pytest

from cloud_server_tpu.data import tokenizer as ref_tok
from cloud_server_tpu_torch.data.dataset import MemmapTokenDataset
from cloud_server_tpu_torch.data.tokenizer import (ByteTokenizer,
                                                   HFTokenizer,
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


def test_get_tokenizer_dispatch(tmp_path, hf_tokenizer_path):
    """"byte" is the byte tokenizer; any other spec is a local HF
    tokenizer path (a missing one raises, as the reference's does)."""
    assert isinstance(get_tokenizer("byte"), ByteTokenizer)
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        get_tokenizer(tmp_path / "tokenizer.json")
    assert isinstance(get_tokenizer(hf_tokenizer_path), HFTokenizer)


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


@pytest.fixture(scope="module")
def hf_tokenizer_path(tmp_path_factory):
    """Train a tiny local BPE so the HF path needs no network."""
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(
        vocab_size=200, special_tokens=["<unk>", "<s>", "</s>", "<pad>"])
    tok.train_from_iterator(
        ["the quick brown fox jumps over the lazy dog"] * 50, trainer)
    path = tmp_path_factory.mktemp("hf") / "tokenizer.json"
    tok.save(str(path))
    return str(path)


def test_hf_tokenizer_local(hf_tokenizer_path):
    tok = HFTokenizer(hf_tokenizer_path)
    ref = ref_tok.HFTokenizer(hf_tokenizer_path)
    assert tok.bos_id is not None and tok.eos_id is not None
    assert tok.pad_id is not None
    assert (tok.bos_id, tok.eos_id, tok.pad_id, tok.pad_is_declared,
            tok.vocab_size) == (ref.bos_id, ref.eos_id, ref.pad_id,
                                ref.pad_is_declared, ref.vocab_size)
    ids = tok.encode("the quick brown fox", add_bos=True, add_eos=True)
    assert ids == ref.encode("the quick brown fox", add_bos=True,
                             add_eos=True)
    assert ids[0] == tok.bos_id and ids[-1] == tok.eos_id
    assert "quick" in tok.decode(ids)
    assert tok.decode(ids) == ref.decode(ids)


def test_hf_tokenizer_from_directory(hf_tokenizer_path):
    import os
    tok = HFTokenizer(os.path.dirname(hf_tokenizer_path))
    assert tok.vocab_size > 0
    assert tok.vocab_size == ref_tok.HFTokenizer(
        os.path.dirname(hf_tokenizer_path)).vocab_size


def test_hf_prepare_corpus(tmp_path, hf_tokenizer_path):
    tok = HFTokenizer(hf_tokenizer_path)
    src = tmp_path / "c.txt"
    src.write_text("the quick brown fox\n" * 20)
    n = prepare_corpus(src, tmp_path / "c.bin", tok, chunk_bytes=32)
    assert n > 0
    stored = np.fromfile(tmp_path / "c.bin", token_dtype(tok.vocab_size))
    assert len(stored) == n
    ref_n = ref_tok.prepare_corpus(src, tmp_path / "r.bin",
                                   ref_tok.HFTokenizer(hf_tokenizer_path),
                                   chunk_bytes=32)
    assert ref_n == n
    assert (np.fromfile(tmp_path / "r.bin", stored.dtype) == stored).all()


def test_hf_tokenizer_without_the_package_raises(hf_tokenizer_path,
                                                monkeypatch):
    """Where `tokenizers` is missing (the GPU machine), building one
    raises the reference's RuntimeError; importing the module does
    not need the package."""
    import builtins
    real = builtins.__import__

    def no_tokenizers(name, *a, **k):
        if name == "tokenizers" or name.startswith("tokenizers."):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.raises(RuntimeError, match="needs the `tokenizers`"):
        HFTokenizer(hf_tokenizer_path)
