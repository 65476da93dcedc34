"""Static sweep configuration for the dense, single-device sweep.

The subset of the reference package's ``SweepConfig`` that the dense
``ConsensusClustering.fit`` path reads.  Mesh, streaming, packed and
estimator fields belong to engines this package does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def subsample_size(n_samples: int, subsampling: float) -> int:
    """Rows per resample: ``int(subsampling * N)`` (floor, as the reference)."""
    return int(subsampling * n_samples)


def pac_indices(
    pac_interval: Tuple[float, float], bins: int = 20
) -> Tuple[int, int]:
    """PAC bin indices by the reference's truncating f64 expression.

    ``dbin = bin_edges[1] - bin_edges[0]; u_ind = int(u / dbin)``.
    """
    edges = np.linspace(0.0, 1.0, bins + 1)
    dbin = edges[1] - edges[0]
    u1, u2 = pac_interval
    return int(u1 / dbin), int(u2 / dbin)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Everything shape- or semantics-static about one consensus sweep.

    Attributes:
      n_samples, n_features: N and d of X.
      k_values: the K sweep (reference ``K_range``).
      n_iterations: H, the resample count.
      subsampling: fraction of rows per resample.
      bins: histogram bins of the consensus CDF.
      pac_interval: (u1, u2) of the PAC score.
      parity_zeros: reproduce the reference's zero-inflated histogram
        (N(N+1)/2 structural zeros in bin 0); False counts pairs only.
      store_matrices: return Iij and per-K Mij/Cij.
      chunk_size: resamples per co-association GEMM.
      cluster_batch: resamples per clustering group (None: one group).
        Labels are identical for every value: a converged lane is frozen.
      split_init: with ``cluster_batch``, draw every lane's k-means++ init
        in one batch and group only the Lloyd loop (identical labels).
      reseed_clusterer_per_resample: give each resample its own clusterer
        key (False: every resample re-seeds identically, as the reference).
      dtype: "float32", or "float64" for the CPU parity path.
    """

    n_samples: int
    n_features: int
    k_values: Tuple[int, ...] = (2, 3)
    n_iterations: int = 25
    subsampling: float = 0.8
    bins: int = 20
    pac_interval: Tuple[float, float] = (0.1, 0.9)
    parity_zeros: bool = True
    store_matrices: bool = True
    chunk_size: int = 8
    cluster_batch: Optional[int] = None
    split_init: bool = False
    reseed_clusterer_per_resample: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in ("float32", "float64"):
            raise ValueError(
                f"dtype must be 'float32' or 'float64', got {self.dtype!r}"
            )
        if self.cluster_batch is not None and (
            isinstance(self.cluster_batch, bool)
            or not isinstance(self.cluster_batch, (int, np.integer))
            or self.cluster_batch < 1
        ):
            raise ValueError(
                f"cluster_batch must be an int >= 1, got "
                f"{self.cluster_batch!r}"
            )
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if not self.k_values:
            raise ValueError("k_values must be non-empty")
        if any(k < 1 for k in self.k_values):
            raise ValueError(f"k_values must be >= 1, got {self.k_values}")
        if not 0.0 < self.subsampling <= 1.0:
            raise ValueError(
                f"subsampling must be in (0, 1], got {self.subsampling}"
            )
        if self.n_sub < 1:
            raise ValueError(
                f"subsampling {self.subsampling} of {self.n_samples} samples "
                "leaves an empty subsample"
            )
        if self.k_max > self.n_sub:
            raise ValueError(
                f"max K {self.k_max} exceeds subsample size {self.n_sub}"
            )

    @property
    def n_sub(self) -> int:
        return subsample_size(self.n_samples, self.subsampling)

    @property
    def k_max(self) -> int:
        return max(self.k_values)

    @property
    def pac_idx(self) -> Tuple[int, int]:
        return pac_indices(self.pac_interval, self.bins)

    @property
    def torch_dtype(self):
        import torch

        return torch.float64 if self.dtype == "float64" else torch.float32
