"""Token datasets for LM pretraining.

The on-disk format is the standard flat binary token stream (a single
dtype'd array of token ids, as produced by most tokenizer pipelines);
`MemmapTokenDataset` views it zero-copy via np.memmap and slices fixed
seq_len windows, so the host never holds more than the batches in flight.
A copy of the reference package's module (numpy only), so both
implementations read the same examples from the same files and seeds.
"""

from __future__ import annotations

import os

import numpy as np


def write_token_file(path: str | os.PathLike, tokens: np.ndarray,
                     dtype=np.uint16) -> None:
    """Write a flat token array in the binary format the readers expect."""
    np.asarray(tokens, dtype=dtype).tofile(os.fspath(path))


class MemmapTokenDataset:
    """Fixed-window LM dataset over a flat binary token file.

    Example i is tokens[i*seq_len : (i+1)*seq_len]; windows are
    non-overlapping and the tail that doesn't fill one is dropped. The
    train loss shifts within the window (`next_token_loss` drops the last
    position), so windows stay exactly seq_len — which keeps S divisible
    for sp-sharded attention.
    """

    def __init__(self, path: str | os.PathLike, seq_len: int, dtype=None):
        """dtype None => auto-detect from the `<path>.meta.json` sidecar
        written by `tokenizer.prepare_corpus`, falling back to uint16."""
        self.path = os.fspath(path)
        self.seq_len = seq_len
        if dtype is None:
            dtype = np.uint16
            meta_path = self.path + ".meta.json"
            if os.path.exists(meta_path):
                import json
                with open(meta_path) as f:
                    dtype = np.dtype(json.load(f)["dtype"])
        self._tokens = np.memmap(self.path, dtype=dtype, mode="r")
        n = len(self._tokens) // seq_len
        if n <= 0:
            raise ValueError(
                f"{self.path}: {len(self._tokens)} tokens < seq_len "
                f"({seq_len}); no full window fits")
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        if not 0 <= i < self._n:
            raise IndexError(i)
        s = i * self.seq_len
        return {"tokens": np.asarray(self._tokens[s:s + self.seq_len],
                                     np.int32)}


class MixtureDataset:
    """Deterministic weighted mixture over several map-style datasets.

    Pretraining corpora are usually a weighted blend (web + code + books,
    ...). Example i draws its source from a hash-seeded categorical over
    `weights` and then a uniformly random example index WITH REPLACEMENT
    within that source — both pure functions of (seed, i), so the mixture
    composes with the resumable sharded sampler exactly like a plain
    dataset: restoring a step replays the identical blend. I.i.d.
    sampling means there is no per-source epoch traversal or coverage
    guarantee (a pass over len(self) indices repeats some examples and
    misses others — the standard choice for weighted pretraining blends,
    where small high-weight corpora must repeat anyway); the default
    length is just the unweighted example count across sources, a
    bookkeeping convention for "one nominal epoch".
    """

    def __init__(self, datasets, weights, *, num_examples: int | None = None,
                 seed: int = 0):
        if len(datasets) != len(weights) or not datasets:
            raise ValueError("need equally many datasets and weights (>=1)")
        w = np.asarray(weights, np.float64)
        if (w <= 0).any():
            raise ValueError(f"weights must be positive, got {weights}")
        self._datasets = list(datasets)
        self._cum = np.cumsum(w / w.sum())
        for k, d in enumerate(datasets):
            if d.seq_len != datasets[0].seq_len:
                raise ValueError(
                    f"all mixture sources must share seq_len: source {k} "
                    f"has seq_len={d.seq_len} != {datasets[0].seq_len} "
                    "(source 0) — retokenize or drop the mismatched file")
        self.seq_len = datasets[0].seq_len
        self.seed = seed
        if num_examples is not None and num_examples <= 0:
            raise ValueError(f"num_examples must be > 0, got {num_examples}")
        # default "nominal epoch" length: the unweighted example count
        self._n = (num_examples if num_examples is not None
                   else int(sum(len(d) for d in self._datasets)))

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        if not 0 <= i < self._n:
            raise IndexError(i)
        rng = np.random.default_rng((self.seed, 0x6D69, i))
        src = int(np.searchsorted(self._cum, rng.random(), side="right"))
        src = min(src, len(self._datasets) - 1)
        ds = self._datasets[src]
        return ds[int(rng.integers(0, len(ds)))]


class SyntheticLMDataset:
    """Deterministic random tokens — for tests and benches (no disk IO)."""

    def __init__(self, num_examples: int, seq_len: int, vocab_size: int,
                 seed: int = 0):
        self._n = num_examples
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        if not 0 <= i < self._n:
            raise IndexError(i)
        rng = np.random.default_rng((self.seed, i))
        return {"tokens": rng.integers(
            0, self.vocab_size, self.seq_len, dtype=np.int32)}
