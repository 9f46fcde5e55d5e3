"""jax.random's default generator (threefry2x32, partitionable bits) on
torch tensors, bit for bit.

A key is a pair of uint32 words held in int64 tensors (any leading batch
shape, last dimension 2), every word masked to 32 bits, so it runs on
whatever device its inputs are on:

  * `key(seed)`       — jax.random.key(seed) for a seed in [0, 2**32):
                        the words (0, seed);
  * `fold_in(k, n)`   — jax.random.fold_in: threefry2x32(k, (0, n));
  * `bits(k, v)`      — jax.random.bits(k, (v,)) with
                        jax_threefry_partitionable (jax's default): word
                        i is hi ^ lo of threefry2x32(k, (0, i));
  * `gumbel_low(k, v)` — jax.random.gumbel(k, (v,)) in float32 (its
                        default "low" mode): uniforms in [tiny, 1) from
                        the 23 high bits, then -log(-log(u)).

`jax.random.categorical(k, logits)` is argmax(logits + gumbel_low(k, V)).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """The 20-round Threefry-2x32 block on uint32 words held in int64
    tensors (broadcasting); returns the two output words."""
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
    """jax.random.fold_in(k, n) for n in [0, 2**32)."""
    n = torch.as_tensor(n, device=k.device).long() & _MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(n), n)
    return torch.stack([y0, y1], dim=-1)


def bits(k: torch.Tensor, v: int) -> torch.Tensor:
    """(..., v) uint32 words (in int64) of jax.random.bits(k, (v,))."""
    i = torch.arange(v, device=k.device, dtype=torch.int64)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(i), i)
    return y0 ^ y1


def gumbel_low(k: torch.Tensor, v: int) -> torch.Tensor:
    """(..., v) float32 draws of jax.random.gumbel(k, (v,))."""
    mant = (bits(k, v) >> 9) | 0x3F800000
    u = mant.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(u * (1.0 - _TINY) + _TINY, min=_TINY)
    return -torch.log(-torch.log(u))
