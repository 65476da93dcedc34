"""The clusterer protocol the sweep calls.

A clusterer labels a batch of subsamples at once: ``keys`` (B, 2) are the
per-resample generator keys (:mod:`..rng`), ``x`` (B, n_sub, d) the
subsamples, ``k`` the cluster count and ``k_max`` the largest K of the
sweep (the one-hot height of the co-association counts).  Labels must be a
pure per-resample function of (key, x, k), so that any grouping of the
resamples gives the same labels.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch


@runtime_checkable
class Clusterer(Protocol):
    """A batched clusterer usable inside the sweep."""

    def fit_predict(
        self, keys: torch.Tensor, x: torch.Tensor, k: int, k_max: int
    ) -> torch.Tensor:
        """(B, n_sub) int64 labels in [0, k) for (B, n_sub, d) subsamples."""
        ...
