"""Deterministic pair sampler of the consensus estimator, on the device.

The port of the reference package's ``estimator/sampler.py``, bit for bit
on :mod:`..rng`:

- **Uniform over unordered pairs, with replacement.**  Each draw picks
  ``i ~ U[0, N)`` and an offset ``k ~ U[0, N-1)`` and sets ``j = (i + 1 +
  k) mod N``: every ordered pair (i, j), i != j, has probability
  ``1/(N(N-1))``, so the returned ``(min, max)`` draw is uniform over the
  upper triangle.  With replacement, the M draws are i.i.d. from the pair
  population, the hypothesis of the DKW band (:mod:`.bounds`).
- **int32 draws.**  ``T = N(N-1)/2`` passes 2^31 near N = 2^16.5, so the
  pairs are not drawn as a linear index into the triangle: the offset
  construction stays in int32 for any N < 2^31.
- **Stream-isolated.**  The pair key is ``fold_in(PRNGKey(seed), tag)``
  with a tag no other consumer folds, so the pairs are a pure function of
  (seed, N, M) and independent of the resample plan and clusterer keys.
"""

from __future__ import annotations

from typing import Tuple

import torch

from consensus_clustering_tpu_torch import rng

#: fold_in tag of the pair-sampling stream ("pair" in ASCII).
PAIR_STREAM_TAG = 0x70616972


def pair_key(seed: int, device=None) -> torch.Tensor:
    """The key the pair sample derives from, for a run seed."""
    return rng.fold_in(rng.prng_key(int(seed), device), PAIR_STREAM_TAG)


def sample_pairs(
    key: torch.Tensor, n: int, m: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``m`` i.i.d. uniform upper-triangle pairs of ``range(n)``.

    Returns ``(pair_i, pair_j)``, int64 tensors of shape (m,) on the key's
    device with ``pair_i < pair_j`` elementwise; the values equal the
    reference's int32 draws.
    """
    if n < 2:
        raise ValueError(f"need n >= 2 to form a pair, got {n}")
    if m < 1:
        raise ValueError(f"need m >= 1 pairs, got {m}")
    keys = rng.split(key)
    i = rng.randint(keys[0], (m,), 0, n).to(torch.int64)
    off = rng.randint(keys[1], (m,), 0, n - 1).to(torch.int64)
    j = (i + 1 + off) % n
    return torch.minimum(i, j), torch.maximum(i, j)


def n_pairs_total(n: int) -> int:
    """``T = N(N-1)/2``, the upper-triangle pair population (a Python int,
    exact at any N)."""
    n = int(n)
    return n * (n - 1) // 2
