"""The port's native C++ shard reader (runtime/) against the numpy path
and the reference's reader (tests/test_runtime_native.py's cases):
windows bit-equal, int32 token files, gathered batch reads, range
errors, the prefetcher's submission order and early stop, and the
DataLoader's gathered route giving the numpy route's batches. Skips
without a C++ toolchain."""

import numpy as np
import pytest

from cloud_server_tpu.data.dataset import \
    MemmapTokenDataset as RefMemmapTokenDataset
from cloud_server_tpu_torch.data import loader
from cloud_server_tpu_torch.data.dataset import (MemmapTokenDataset,
                                                 write_token_file)
from cloud_server_tpu_torch.runtime import native_available

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native runtime unavailable (no g++)")


def _mk(tmp_path, n_tokens=2048, seq_len=32, seed=0, dtype=np.uint16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, np.iinfo(dtype).max, n_tokens, dtype=dtype)
    path = tmp_path / "tokens.bin"
    write_token_file(path, toks, dtype=dtype)
    from cloud_server_tpu_torch.runtime import NativeTokenDataset
    return (NativeTokenDataset(path, seq_len, dtype=dtype),
            MemmapTokenDataset(path, seq_len, dtype=dtype))


def test_native_matches_numpy_reader(tmp_path):
    nat, ref = _mk(tmp_path)
    theirs = RefMemmapTokenDataset(tmp_path / "tokens.bin", 32)
    assert len(nat) == len(ref) == len(theirs)
    for i in [0, 1, 17, len(ref) - 1]:
        np.testing.assert_array_equal(nat[i]["tokens"], ref[i]["tokens"])
        np.testing.assert_array_equal(nat[i]["tokens"],
                                      theirs[i]["tokens"])


def test_native_int32_token_files(tmp_path):
    nat, ref = _mk(tmp_path, dtype=np.int32)
    idx = np.array([3, 0, 5])
    got = nat.read_batch(idx)["tokens"]
    want = np.stack([ref[int(i)]["tokens"] for i in idx])
    np.testing.assert_array_equal(got, want)


def test_native_gathered_batch_read(tmp_path):
    nat, ref = _mk(tmp_path)
    idx = np.array([5, 1, 60, 2, 2])  # shuffled + repeated
    got = nat.read_batch(idx)["tokens"]
    want = np.stack([ref[int(i)]["tokens"] for i in idx])
    np.testing.assert_array_equal(got, want)


def test_native_out_of_range_raises(tmp_path):
    nat, _ = _mk(tmp_path)
    with pytest.raises(IndexError):
        nat.read_batch(np.array([len(nat)]))


def test_prefetcher_preserves_submission_order(tmp_path):
    nat, ref = _mk(tmp_path, n_tokens=64 * 32)
    rng = np.random.default_rng(1)
    stream = rng.permutation(len(nat)).astype(np.uint64)
    batch = 8
    batches = list(nat.prefetch_batches(stream, batch, depth=3, n_threads=4))
    assert len(batches) == len(stream) // batch
    for j, b in enumerate(batches):
        want = np.stack([ref[int(i)]["tokens"]
                         for i in stream[j * batch:(j + 1) * batch]])
        np.testing.assert_array_equal(b["tokens"], want)


def test_prefetcher_early_stop_no_hang(tmp_path):
    nat, _ = _mk(tmp_path, n_tokens=64 * 32)
    it = nat.prefetch_batches(np.arange(64, dtype=np.uint64), 4, depth=2,
                              n_threads=3)
    next(it)
    it.close()  # generator finally -> csr_prefetch_stop; must not deadlock


def test_dataloader_uses_native_read_batch(tmp_path):
    """The DataLoader collates a dataset with `read_batch` through it:
    the same int64 batches as the numpy reader's, per process too."""
    nat, ref = _mk(tmp_path, n_tokens=4096, seq_len=16)
    for pi in range(2):
        kw = dict(seed=9, prefetch=0, process_index=pi, process_count=2)
        a = iter(loader.DataLoader(nat, 8, "cpu", **kw))
        b = iter(loader.DataLoader(ref, 8, "cpu", **kw))
        for _ in range(6):
            x, y = next(a)["tokens"], next(b)["tokens"]
            assert x.dtype == y.dtype and x.shape == (4, 16)
            np.testing.assert_array_equal(x.numpy(), y.numpy())
