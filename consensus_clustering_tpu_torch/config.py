"""Static sweep configuration for the single-device sweeps.

The subset of the reference package's ``SweepConfig`` that the monolithic,
streaming and estimator ``ConsensusClustering.fit`` paths read, with the
reference's validation.  Mesh fields belong to an engine this package does
not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

#: Exact-mode accumulator representations: int32 (N, N) counts, or
#: resamples packed 32 to a word as bit-planes (:mod:`.ops.bitpack`).
ACCUM_REPRS = ("dense", "packed")

#: Fused-block modes of the packed streaming step: ``auto`` fuses when the
#: clusterer declares ``supports_fused_assign`` and the dtype is float32,
#: ``on`` requires that, ``off`` keeps the label path.  A caller's choice,
#: never a fallback.
FUSE_BLOCK_MODES = ("auto", "on", "off")


def validate_accum_repr(accum_repr: str) -> str:
    """``accum_repr`` if it is one of :data:`ACCUM_REPRS`, else ValueError."""
    if accum_repr not in ACCUM_REPRS:
        raise ValueError(
            f"accum_repr must be one of {list(ACCUM_REPRS)}, got "
            f"{accum_repr!r}"
        )
    return accum_repr


def validate_fuse_block(fuse_block: str) -> str:
    """``fuse_block`` if it is one of :data:`FUSE_BLOCK_MODES`, else
    ValueError."""
    if fuse_block not in FUSE_BLOCK_MODES:
        raise ValueError(
            f"fuse_block must be one of {list(FUSE_BLOCK_MODES)}, got "
            f"{fuse_block!r}"
        )
    return fuse_block


#: ``ConsensusClustering`` modes: the exact sweep, the sampled-pair
#: estimator (:mod:`.estimator`), or ``auto`` (the estimator when the
#: exact job's footprint exceeds the memory budget).
MODES = ("exact", "estimate", "auto")

#: Job modes the serving surface accepts (``config.mode`` in ``POST
#: /jobs``): the library's modes plus ``progressive`` (the estimate now,
#: an exact refinement of its chosen K after) and ``append`` (new
#: resamples over a grown dataset, merged with a stored parent's planes).
#: The scheduler's internal continuation mode ``refine`` is in neither.
SERVING_MODES = MODES + ("progressive", "append")


def autotune_stream_block(n_iterations: int) -> int:
    """Default resamples per block where a path streams and the caller
    set none: ``H // 8`` clamped to [16, 128] (the reference's rule)."""
    if n_iterations < 1:
        raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
    return max(16, min(128, int(n_iterations) // 8))


def not_ported(feature: str, item: str) -> NotImplementedError:
    """The error for a reference feature this package does not have yet,
    naming the ROADMAP item that ports it."""
    return NotImplementedError(
        f"{feature} is not ported to consensus_clustering_tpu_torch yet "
        f"(ROADMAP.md queue A, item {item}); use consensus_clustering_tpu"
    )


def _is_int(value) -> bool:
    return isinstance(value, (int, np.integer)) and not isinstance(value, bool)


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
      k_interleave: with a 'k'-sharded mesh, give the k-groups the K
        values round-robin (group g runs ``k_values[g::k_shards]``) instead
        of in contiguous blocks, so the slow large Ks spread over the
        groups.  Results are identical; no effect without a 'k' axis.
      reseed_clusterer_per_resample: give each resample its own clusterer
        key (False: every resample re-seeds identically, as the reference).
      stream_h_block: resamples per block of the streaming engine
        (:mod:`.parallel.streaming`); None runs the monolithic sweep.  The
        full-H streamed result equals the monolithic one bit for bit.
      adaptive_tol: stop the stream once every K's PAC moved less than
        this for ``adaptive_patience`` consecutive blocks, after
        ``adaptive_min_h`` resamples (None: always run the full H).  Needs
        ``stream_h_block``; incompatible with ``store_matrices``.
      adaptive_patience: consecutive quiet blocks before a stop.
      adaptive_min_h: resamples before a stop may happen.
      accum_repr: ``dense`` int32 (N, N) counts, or ``packed`` bit-planes
        with the counts materialised in row tiles by the popcount kernel;
        the counts are identical.
      use_packed_kernel: None or True; the popcount kernel always serves
        CUDA tensors (False, the plain version on the card, is refused).
      fuse_block: ``auto``, ``on`` or ``off`` (:data:`FUSE_BLOCK_MODES`).
      integrity_check_every: run the accumulator invariant sentinel
        (:mod:`.resilience.integrity`) every that many streamed blocks,
        the final block and, under ``adaptive_tol``, every block (0: off).
        It only reads the state, so results are the same at any cadence.
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
    k_interleave: bool = False
    reseed_clusterer_per_resample: bool = False
    stream_h_block: Optional[int] = None
    adaptive_tol: Optional[float] = None
    adaptive_patience: int = 2
    adaptive_min_h: int = 0
    accum_repr: str = "dense"
    use_packed_kernel: Optional[bool] = None
    fuse_block: str = "auto"
    integrity_check_every: int = 0
    dtype: str = "float32"

    def __post_init__(self):
        validate_accum_repr(self.accum_repr)
        validate_fuse_block(self.fuse_block)
        if self.dtype not in ("float32", "float64"):
            raise ValueError(
                f"dtype must be 'float32' or 'float64', got {self.dtype!r}"
            )
        if self.use_packed_kernel is False:
            raise ValueError(
                "use_packed_kernel=False would run the popcount kernel's "
                "plain version on the card, a fallback the port does not "
                "take: CPU tensors get the plain version, CUDA tensors the "
                "kernel (pass None)"
            )
        if self.fuse_block == "on" and self.accum_repr != "packed":
            raise ValueError(
                "fuse_block='on' requires accum_repr='packed': the fused "
                "assign+pack kernel is a property of the packed block step"
            )
        if self.fuse_block == "on" and self.dtype != "float32":
            raise ValueError(
                "fuse_block='on' requires dtype='float32': the fused "
                "kernel is float32-only"
            )
        if self.cluster_batch is not None and (
            not _is_int(self.cluster_batch) or self.cluster_batch < 1
        ):
            raise ValueError(
                f"cluster_batch must be an int >= 1, got "
                f"{self.cluster_batch!r}"
            )
        if self.stream_h_block is not None and (
            not _is_int(self.stream_h_block) or self.stream_h_block < 1
        ):
            raise ValueError(
                f"stream_h_block must be an int >= 1, got "
                f"{self.stream_h_block!r}"
            )
        if self.adaptive_tol is not None:
            if (not isinstance(self.adaptive_tol, (int, float))
                    or isinstance(self.adaptive_tol, bool)
                    or self.adaptive_tol < 0):
                raise ValueError(
                    f"adaptive_tol must be a number >= 0, got "
                    f"{self.adaptive_tol!r}"
                )
            if self.stream_h_block is None:
                raise ValueError(
                    "adaptive_tol needs stream_h_block: early stopping is "
                    "a property of the streaming driver loop"
                )
            if self.store_matrices:
                raise ValueError(
                    "adaptive_tol is incompatible with store_matrices: an "
                    "early-stopped run's matrices would not match its "
                    "h_effective; pass store_matrices=False"
                )
        if self.adaptive_patience < 1:
            raise ValueError(
                f"adaptive_patience must be >= 1, got "
                f"{self.adaptive_patience}"
            )
        if self.adaptive_min_h < 0:
            raise ValueError(
                f"adaptive_min_h must be >= 0, got {self.adaptive_min_h}"
            )
        if not _is_int(self.integrity_check_every) or (
            self.integrity_check_every < 0
        ):
            raise ValueError(
                f"integrity_check_every must be an int >= 0 (0 = off), "
                f"got {self.integrity_check_every!r}"
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
