"""Agglomerative (hierarchical) clustering over a batch of distance matrices.

The port of the reference package's ``models/agglomerative.py``.  It has
two roles:

- the inner clusterer :class:`AgglomerativeClustering` (the original
  library's agglomerative-on-corr.csv configuration);
- consensus labels from the consensus matrix,
  :func:`consensus_labels_from_cij`: agglomeration of ``1 - Cij`` up to
  :data:`AGGLOMERATION_LIMIT` items, spectral clustering of ``Cij`` above.

:func:`agglomerate` is Lance-Williams agglomeration on (B, n, n) distance
matrices, one per lane: each merge takes the lane's closest live pair (the
lowest flat index among equal distances, as ``jnp.argmin`` over the
flattened matrix), folds the higher index into the lower one and updates
the merged row and column with the linkage's Lance-Williams formula,
rounded as the reference rounds it on the CPU (:func:`_lance_williams`).
After ``n - k`` merges the live clusters, numbered by ascending
representative index, are the labels: the reference's snapshot at ``k``.
Every merge is a handful of tensor ops on all lanes with no read back to
the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_BIG = 3.4e38

# Above this many items the exact path (n - 1 merges over an (n, n)
# matrix, O(n^3) elementwise) stops being a minutes-scale computation;
# "auto" consensus labels switch to the spectral path there.
AGGLOMERATION_LIMIT = 4096

LINKAGES = ("single", "complete", "average", "ward")


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 is exact in float64, and the float64 sum then
    rounds to float32 (a second rounding that can differ from one only at
    an exact float32 midpoint)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _lance_williams(linkage, d_il, d_jl, d_ij, n_i, n_j, n_l):
    """Distance from the merged cluster (i u j) to every cluster l.

    The reference's formulas as XLA's CPU backend compiles them, which
    contracts each ``a * b + c`` into a fused multiply-add: average is
    ``fma(n_i, d_il, n_j * d_jl) / (n_i + n_j)``, ward
    ``fma(-n_l, d_ij, fma(n_i + n_l, d_il, (n_j + n_l) * d_jl)) / tot``.
    Cluster sizes are float32 integers, so their sums are exact.
    """
    if linkage == "single":
        return torch.minimum(d_il, d_jl)
    if linkage == "complete":
        return torch.maximum(d_il, d_jl)
    if linkage == "average":
        return _fma(n_i, d_il, n_j * d_jl) / (n_i + n_j)
    if linkage == "ward":
        tot = n_i + n_j + n_l
        inner = _fma(n_i + n_l, d_il, (n_j + n_l) * d_jl)
        return _fma(-n_l, d_ij, inner) / tot
    raise ValueError(f"unknown linkage {linkage!r}")


def _labels(rep: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Representatives renumbered to [0, n_active) by ascending index."""
    order = torch.cumsum(active.to(torch.int64), dim=-1) - 1
    return torch.gather(order, -1, rep)


def agglomerate(dist: torch.Tensor, k: int,
                linkage: str = "average") -> torch.Tensor:
    """Cut a Lance-Williams agglomeration of each lane at ``k`` clusters.

    Args:
      dist: (B, n, n) or (n, n) symmetric dissimilarities (squared
        Euclidean for ward), computed in float32 as the reference does.
      k: the cluster count, 1 <= k <= n.
      linkage: single, complete, average or ward.

    Returns:
      int64 labels (B, n) (or (n,)) in [0, k), numbered by ascending
      representative index.
    """
    if linkage not in LINKAGES:
        raise ValueError(f"unknown linkage {linkage!r}")
    squeeze = dist.dim() == 2
    if squeeze:
        dist = dist[None]
    bsz, n, _ = dist.shape
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    dev = dist.device
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    d = torch.where(eye, big, dist.to(torch.float32))
    active = torch.ones((bsz, n), dtype=torch.bool, device=dev)
    sizes = torch.ones((bsz, n), dtype=torch.float32, device=dev)
    rep = torch.arange(n, device=dev).expand(bsz, n).clone()
    lanes = torch.arange(bsz, device=dev)
    for _ in range(n - k):
        flat = torch.argmin(d.reshape(bsz, n * n), dim=-1)
        a, b = flat // n, flat % n
        i, j = torch.minimum(a, b), torch.maximum(a, b)
        n_i = sizes[lanes, i][:, None]
        n_j = sizes[lanes, j][:, None]
        d_ij = d[lanes, i, j][:, None]
        new_row = _lance_williams(linkage, d[lanes, i], d[lanes, j], d_ij,
                                  n_i, n_j, sizes)
        active[lanes, j] = False
        new_row = torch.where(active, new_row, big)
        new_row[lanes, i] = _BIG
        d[lanes, i, :] = new_row
        d[lanes, :, i] = new_row
        d[lanes, j, :] = _BIG
        d[lanes, :, j] = _BIG
        sizes[lanes, i] += n_j[:, 0]
        rep = torch.where(rep == rep[lanes, j][:, None],
                          rep[lanes, i][:, None], rep)
    labels = _labels(rep, active)
    return labels[0] if squeeze else labels


def pairwise_sq_euclidean(x: torch.Tensor) -> torch.Tensor:
    """(..., n, n) squared Euclidean distances of (..., n, d) rows, through
    one GEMM and clamped at 0, as the reference computes them."""
    sq = (x * x).sum(-1)
    cross = torch.matmul(x, x.transpose(-1, -2))
    return torch.clamp(sq[..., :, None] - 2.0 * cross + sq[..., None, :],
                       min=0.0)


@dataclasses.dataclass(frozen=True)
class AgglomerativeClustering:
    """Hierarchical clusterer implementing :class:`.protocol.Clusterer`.

    ``linkage`` defaults to ward, as sklearn's estimator does; ward works
    on squared Euclidean distances, the others on Euclidean.  The labels
    do not depend on the keys.
    """

    linkage: str = "ward"

    def fit_predict(self, keys: torch.Tensor, x: torch.Tensor, k: int,
                    k_max: Optional[int] = None) -> torch.Tensor:
        del keys, k_max  # deterministic; shapes do not depend on k_max
        d = pairwise_sq_euclidean(x.to(torch.float32))
        if self.linkage != "ward":
            d = torch.sqrt(d)
        return agglomerate(d, k, self.linkage)


def consensus_labels_from_cij(
    cij,
    k: int,
    linkage: str = "average",
    method: str = "auto",
    seed: int = 0,
    device=None,
) -> np.ndarray:
    """Consensus labels (N,) from the consensus matrix Cij (N, N).

    - ``method="agglomerative"``: agglomerate ``1 - Cij`` exactly; refused
      above :data:`AGGLOMERATION_LIMIT` items (O(N^3), hours at
      N = 20000).
    - ``method="spectral"``: Cij is an affinity matrix, so cluster it
      spectrally (LOBPCG embedding, then KMeans, with
      :class:`~.spectral.SpectralClustering`'s defaults; ``seed`` feeds
      both).
    - ``method="auto"``: agglomerative up to the limit, spectral above.

    ``device`` is where the work runs (None: ``cuda``, see
    :func:`..device.resolve_device`).
    """
    from consensus_clustering_tpu_torch.device import resolve_device

    device = resolve_device(device)
    cij = torch.as_tensor(np.asarray(cij, dtype=np.float32), device=device)
    n = cij.shape[0]
    limit = AGGLOMERATION_LIMIT
    if method == "auto":
        method = "agglomerative" if n <= limit else "spectral"
    if method == "agglomerative":
        if n > limit:
            raise ValueError(
                f"agglomerative consensus labels at N={n} exceed the "
                f"exact-path limit ({limit}): the (N, N) Lance-Williams "
                "loop is O(N^3) and would run for hours.  Use "
                "method='spectral' (or 'auto')."
            )
        return agglomerate(1.0 - cij, k, linkage).cpu().numpy()
    if method == "spectral":
        from consensus_clustering_tpu_torch import rng
        from consensus_clustering_tpu_torch.models.spectral import (
            SpectralClustering,
        )

        sc = SpectralClustering(affinity="precomputed", solver="lobpcg")
        keys = rng.prng_key(seed, device)[None]
        return sc.fit_predict(keys, cij[None], int(k), int(k))[0].cpu().numpy()
    raise ValueError(
        f"unknown method {method!r} (choose 'agglomerative', 'spectral' "
        "or 'auto')"
    )
