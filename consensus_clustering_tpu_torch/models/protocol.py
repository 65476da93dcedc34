"""The clusterer protocols the sweeps call.

Two kinds of inner clusterer, as in the reference package:

- :class:`Clusterer` labels a batch of subsamples at once on the device:
  ``keys`` (B, 2) are the per-resample generator keys (:mod:`..rng`), ``x``
  (B, n_sub, d) the subsamples, ``k`` the cluster count and ``k_max`` the
  largest K of the sweep (the one-hot height of the co-association counts).
  Labels must be a pure per-resample function of (key, x, k), so that any
  grouping of the resamples gives the same labels.
- :class:`HostClusterer` labels one subsample on the host (an sklearn
  estimator, through :class:`.sklearn_adapter.SklearnClusterer`); the
  sweep then runs on the host backend (:mod:`..parallel.host`), where the
  plan, the counts and the analysis stay on the device.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class Clusterer(Protocol):
    """A batched clusterer usable inside the sweep."""

    def fit_predict(
        self, keys: torch.Tensor, x: torch.Tensor, k: int, k_max: int
    ) -> torch.Tensor:
        """(B, n_sub) int64 labels in [0, k) for (B, n_sub, d) subsamples."""
        ...


@runtime_checkable
class HostClusterer(Protocol):
    """A host-side clusterer; engages the host backend."""

    def fit_predict_host(
        self, seed: int, x: np.ndarray, k: int
    ) -> np.ndarray:
        """Cluster one subsample on the host; (n_sub,) int labels."""
        ...
