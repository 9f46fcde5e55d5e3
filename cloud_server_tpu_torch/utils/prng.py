"""jax.random's default generator (threefry2x32, partitionable bits) on
torch tensors, bit for bit.

A key is a pair of uint32 words held in int64 tensors (any leading batch
shape, last dimension 2), every word masked to 32 bits, so it runs on
whatever device its inputs are on:

  * `key(seed)`       — jax.random.key(seed) for a seed in [0, 2**32):
                        the words (0, seed);
  * `fold_in(k, n)`   — jax.random.fold_in: threefry2x32(k, (0, n));
  * `split(k, n)`     — jax.random.split(k, n): key i is
                        threefry2x32(k, (0, i)), i.e. fold_in(k, i);
  * `bits(k, shape)`  — jax.random.bits(k, shape) with
                        jax_threefry_partitionable (jax's default): the
                        word at flat index i of `shape` is hi ^ lo of
                        threefry2x32(k, (i >> 32, i & 0xFFFFFFFF)), so a
                        (R, V) draw's row r is the flat run
                        [r * V, (r + 1) * V) whatever R is;
  * `uniform(k, shape)` — jax.random.uniform(k, shape) in float32:
                        [0, 1) from the 23 high bits of each word;
  * `gumbel_low(k, shape)` — jax.random.gumbel(k, shape) in float32 (its
                        default "low" mode): uniforms in [tiny, 1) from
                        the 23 high bits, then -log(-log(u));
  * `categorical(k, logits)` — jax.random.categorical(k, logits) over
                        (..., V) logits: argmax(logits +
                        gumbel_low(k, logits.shape)) with one key for the
                        whole draw, or one key per row when `k` carries
                        the logits' batch shape.

`threefry2x32` also takes plain Python ints, which is how a host keeps a
key without a tensor op per split.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block on uint32 words held in int64
    tensors (broadcasting) or Python ints; returns the two output
    words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed) -> torch.Tensor:
    """(..., 2) key words of jax.random.key(seed), seed in [0, 2**32)."""
    seed = torch.as_tensor(seed).long() & _MASK
    return torch.stack([torch.zeros_like(seed), seed], dim=-1)


def fold_in(k: torch.Tensor, n) -> torch.Tensor:
    """jax.random.fold_in(k, n) for n in [0, 2**32): a tensor, or a
    Python int (kept on the host: no copy to the device, which a CUDA
    graph capture refuses)."""
    if isinstance(n, int):
        y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, n & _MASK)
        return torch.stack([y0, y1], dim=-1)
    n = torch.as_tensor(n, device=k.device).long() & _MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(n), n)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n, 2) keys of jax.random.split(k, n)."""
    i = torch.arange(n, device=k.device, dtype=torch.int64)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """(*k.shape[:-1], *shape) uint32 words (in int64) of
    jax.random.bits(k, shape); an int `shape` means (shape,)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    i = torch.arange(math.prod(shape), device=k.device,
                     dtype=torch.int64).reshape(shape)
    tail = (...,) + (None,) * len(shape)
    y0, y1 = threefry2x32(k[..., 0][tail], k[..., 1][tail], i >> 32,
                          i & _MASK)
    return y0 ^ y1


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """(*k.shape[:-1], *shape) float32 draws of jax.random.uniform(k,
    shape) in [0, 1)."""
    mant = (bits(k, shape) >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def gumbel_low(k: torch.Tensor, shape) -> torch.Tensor:
    """(*k.shape[:-1], *shape) float32 draws of jax.random.gumbel(k,
    shape)."""
    u = uniform(k, shape)
    u = torch.clamp(u * (1.0 - _TINY) + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(k, logits) over the last axis -> int64.
    A (2,) key draws the whole (..., V) block as jax does with one key;
    a (B, 2) key draws row b of (B, V) logits with key b, as
    `jax.vmap(jax.random.categorical)` does."""
    shape = tuple(logits.shape) if k.dim() == 1 else logits.shape[-1]
    return torch.argmax(logits + gumbel_low(k, shape), dim=-1)
