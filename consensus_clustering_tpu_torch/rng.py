"""Counter-based random numbers: ``jax.random``'s threefry2x32 in torch.

The resample plan and the KMeans seeding of the reference package are pure
functions of a ``jax.random`` key.  This module reproduces the calls that
path makes, bit for bit, with torch integer ops on the keys' device, so the
port draws the same subsamples and the same k-means++ candidates:

- a key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words;
  every function takes a batch of keys and returns a batch of results, which
  is how ``vmap`` over keys is written here;
- the counter layout is the one of ``jax_threefry_partitionable=True``
  (JAX's default): ``split``/``random_bits`` hash a 64-bit iota split into
  (high, low) words, and ``fold_in(key, i)`` equals ``split(key, n)[i]``;
- uint32 arithmetic runs in int64 with a mask, because torch lacks unsigned
  shifts on every backend.

No global torch RNG state is read or written anywhere.  ``log`` differs
between torch and XLA in the last ulp for some inputs, so ``gumbel`` (and
through it ``categorical``) agrees with JAX on almost all draws, not all;
``normal`` shares its uniforms with JAX bit for bit and agrees to ~1e-5
relative (XLA's float32 ``erf_inv`` is coarser in the tails).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_ONE_BITS = 0x3F800000
_F64_ONE_BITS = 0x3FF0000000000000

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & 0xFFFFFFFF).

    A seed that fits int32 has a zero high word, as in JAX without x64.
    """
    seed = int(seed)
    hi = 0 if -(2**31) <= seed < 2**31 else (seed >> 32) & _MASK
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64, device=device)


def _hash_counts(keys: torch.Tensor, count: int):
    """threefry over counters 0..count-1 per key: two (..., count) words."""
    lo = torch.arange(count, dtype=torch.int64, device=keys.device)
    hi = lo >> 32
    lo = lo & _MASK
    return threefry2x32(keys[..., 0, None], keys[..., 1, None], hi, lo)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over broadcastable keys (..., 2) and data (...)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device)
    data = data & _MASK
    a, b = threefry2x32(
        keys[..., 0], keys[..., 1], torch.zeros_like(data), data
    )
    return torch.stack([a, b], dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) keys -> (..., num, 2)."""
    a, b = _hash_counts(keys, num)
    return torch.stack([a, b], dim=-1)


def random_bits(keys: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32-bit ``jax.random.bits``: (..., 2) keys -> (..., *shape) in [0, 2^32)."""
    shape = _shape(shape)
    a, b = _hash_counts(keys, math.prod(shape))
    return (a ^ b).reshape(keys.shape[:-1] + shape)


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` per key: (..., 2) -> (..., n).

    JAX's shuffle: ceil(3 ln n / ln(2^32 - 1)) rounds, each a STABLE sort of
    the running permutation by fresh 32-bit keys.
    """
    uint32max = np.iinfo(np.uint32).max
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(uint32max)))
    batch = keys.shape[:-1]
    x = torch.arange(n, dtype=torch.int64, device=keys.device)
    x = x.expand(batch + (n,))
    for _ in range(rounds):
        pair = split(keys)
        keys, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(random_bits(sub, n), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def randint(
    keys: torch.Tensor, shape: Shape, minval: int, maxval: int
) -> torch.Tensor:
    """int32 ``jax.random.randint`` (two 32-bit draws, remainder trick)."""
    shape = _shape(shape)
    pair = split(keys)
    higher = random_bits(pair[..., 0, :], shape)
    lower = random_bits(pair[..., 1, :], shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + (lower % span)
    offset = (offset & _MASK) % span
    return (minval + offset).to(torch.int32)


def uniform(
    keys: torch.Tensor,
    shape: Shape,
    dtype: torch.dtype = torch.float32,
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform``: random mantissa bits with exponent 0, minus 1."""
    shape = _shape(shape)
    if dtype == torch.float32:
        bits = (random_bits(keys, shape) >> 9) | _F32_ONE_BITS
        floats = bits.to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.float64:
        # 64-bit draws: word a is the high half; keep the top 52 bits.
        a, b = _hash_counts(keys, math.prod(shape))
        bits = (a << 20) | (b >> 12) | _F64_ONE_BITS
        floats = bits.reshape(keys.shape[:-1] + shape).view(torch.float64)
        floats = floats - 1.0
    else:
        raise TypeError(f"uniform supports float32 and float64, not {dtype}")
    lo = torch.tensor(minval, dtype=dtype, device=keys.device)
    hi = torch.tensor(maxval, dtype=dtype, device=keys.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def normal(
    keys: torch.Tensor, shape: Shape, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erfinv(u)`` for ``u`` uniform in
    (-1, 1), drawn as :func:`uniform` from ``nextafter(-1, 0)`` to 1.

    The uniform draws are JAX's bit for bit; ``erfinv`` is torch's, which
    differs from XLA's float32 ``erf_inv`` by up to ~1e-5 relative.
    """
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    lo = float(np.nextafter(np_dtype(-1.0), np_dtype(0.0), dtype=np_dtype))
    u = uniform(keys, shape, dtype, lo, 1.0)
    scale = torch.tensor(math.sqrt(2.0), dtype=dtype, device=keys.device)
    return scale * torch.erfinv(u)


def gumbel(
    keys: torch.Tensor, shape: Shape, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"): -log(-log(uniform(tiny, 1)))."""
    tiny = torch.finfo(dtype).tiny
    return -torch.log(-torch.log(uniform(keys, shape, dtype, tiny, 1.0)))


def categorical(
    keys: torch.Tensor, logits: torch.Tensor, num: int
) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=(num,))`` per key.

    keys (..., 2) and logits (..., n) share their batch dims; returns
    (..., num) int64 draws by the Gumbel-max trick (first maximum on ties).
    """
    n = logits.shape[-1]
    g = gumbel(keys, (num, n), logits.dtype)
    return torch.argmax(g + logits.unsqueeze(-2), dim=-1)
