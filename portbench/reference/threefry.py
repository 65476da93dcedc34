"""Counter-based random numbers for the plain reference: a frozen copy of
the ``jax.random`` calls that consensus clustering's resample plan, its
k-means++ seeding and its pair sample are defined by.

- A key is an int64 tensor ``(..., 2)`` of two uint32 words; every function
  maps a batch of keys to a batch of results.
- Threefry-2x32 with 20 rounds; the counter layout of JAX's partitionable
  threefry: ``split``/``random_bits`` hash a 64-bit iota as (high, low)
  words, and ``fold_in(key, i)`` hashes ``(0, i)``.
- uint32 arithmetic runs in int64 under a mask.

Plain torch integer and float ops on the keys' device: no kernel of the
measured program, nothing it computed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on broadcastable int64 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & MASK
            b = (((b << r) | (b >> (32 - r))) & MASK) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``PRNGKey(seed)``: (seed >> 32, seed & 0xFFFFFFFF), high word 0 for
    a seed that fits int32."""
    seed = int(seed)
    hi = 0 if -(2**31) <= seed < 2**31 else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def _hash_iota(keys: torch.Tensor, count: int):
    lo = torch.arange(count, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[..., 0, None], keys[..., 1, None], lo >> 32,
                        lo & MASK)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` over broadcastable keys (..., 2) and data (...)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    a, b = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data),
                        data)
    return torch.stack([a, b], dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) -> (..., num, 2)."""
    a, b = _hash_iota(keys, num)
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """32-bit draws (..., *shape) in [0, 2^32)."""
    shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
    a, b = _hash_iota(keys, math.prod(shape))
    return (a ^ b).reshape(keys.shape[:-1] + shape)


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """A permutation of range(n) per key: ceil(3 ln n / ln(2^32 - 1))
    rounds, each a stable sort by fresh 32-bit draws."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=keys.device)
    x = x.expand(keys.shape[:-1] + (n,))
    for _ in range(rounds):
        pair = split(keys)
        keys, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(random_bits(sub, n), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def randint(keys: torch.Tensor, shape, lo: int, hi: int) -> torch.Tensor:
    """int32 draws in [lo, hi): two 32-bit words and the remainder trick."""
    shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
    pair = split(keys)
    higher = random_bits(pair[..., 0, :], shape)
    lower = random_bits(pair[..., 1, :], shape)
    span = (hi - lo) & MASK if hi > lo else 1
    mult = (2**16) % span
    mult = ((mult * mult) & MASK) % span
    off = ((((higher % span) * mult) & MASK) + (lower % span)) & MASK
    return (lo + off % span).to(torch.int32)


def uniform(keys: torch.Tensor, shape, minval: float,
            maxval: float) -> torch.Tensor:
    """float32 uniforms: 23 random mantissa bits under exponent 0, minus 1,
    scaled to [minval, maxval)."""
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def categorical(keys: torch.Tensor, logits: torch.Tensor,
                num: int) -> torch.Tensor:
    """``num`` draws per key from softmax(logits) by Gumbel-max (first
    maximum on ties): keys (..., 2), logits (..., n) -> (..., num)."""
    n = logits.shape[-1]
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(uniform(keys, (num, n), tiny, 1.0)))
    return torch.argmax(g + logits.unsqueeze(-2), dim=-1)
