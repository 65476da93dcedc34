"""Consensus-matrix analysis: Cij, histogram/CDF, PAC, Delta(K), best K,
and Monti's per-cluster and per-item consensus.

Reference semantics (the reference package's ``ops/analysis.py``):
``Cij = Mij / (Iij + 1e-6)`` in f32 with the diagonal forced to 1.0; a
``bins``-bin histogram over the strict upper triangle, optionally with the
reference's N(N+1)/2 structural zeros in bin 0 (``parity_zeros``); PAC is
``cdf[hi - 1] - cdf[lo]`` with host-computed bin indices.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from consensus_clustering_tpu_torch.config import pac_indices

__all__ = [
    "consensus_matrix", "hist_edges", "device_edges", "device_scalar",
    "masked_histogram_counts",
    "cdf_pac_from_counts", "pac_indices", "bin_edges", "area_under_cdf",
    "delta_k", "select_best_k", "cluster_consensus", "item_consensus",
]


@functools.lru_cache(maxsize=None)
def device_scalar(value: float, device: torch.device) -> torch.Tensor:
    """``value`` rounded to a 0-d f32 tensor on ``device``, copied there once
    per (value, device), not per call (a host-to-device copy is
    synchronous).  A divide keeps its bits only with a tensor divisor: on a
    CUDA tensor PyTorch turns a divide by a Python scalar into a multiply by
    its reciprocal."""
    return torch.tensor(value, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def device_edges(bins: int, device: torch.device) -> torch.Tensor:
    """:func:`hist_edges` on ``device``, copied there once per (bins,
    device)."""
    return torch.tensor(hist_edges(bins), device=device)


def consensus_matrix(
    mij: torch.Tensor, iij: torch.Tensor, row_offset: int = 0
) -> torch.Tensor:
    """``Cij = Mij / (Iij + 1e-6)`` in f32, diagonal 1.0.

    The regulariser is added as an f32 constant, so the add and the divide
    are each one correctly rounded f32 operation, as in the reference
    package.  ``row_offset`` is the global index of row 0 of a row block:
    the diagonal is where the global row equals the column.
    """
    eps = device_scalar(1e-6, mij.device)
    cij = mij.to(torch.float32) / (iij.to(torch.float32) + eps)
    n_rows, n_cols = cij.shape
    first = max(0, -row_offset)
    rows = torch.arange(first, max(first, min(n_rows, n_cols - row_offset)),
                        device=cij.device)
    cij[rows, rows + row_offset] = 1.0
    return cij


def hist_edges(bins: int) -> np.ndarray:
    """The f32-rounded ``linspace(0, 1, bins + 1)`` bin edges.

    Comparing f32 values against these is exact: no f32 value lies strictly
    between an f64 edge and its nearest f32, so every membership test agrees
    with ``np.histogram``'s f64 one.
    """
    return np.linspace(0.0, 1.0, bins + 1).astype(np.float32)


def masked_histogram_counts(
    values: torch.Tensor, mask: torch.Tensor, bins: int
) -> torch.Tensor:
    """(bins,) int32 counts of ``values[mask]`` over [0, 1].

    Membership is ``edges[b] <= v < edges[b + 1]``, the last bin
    right-closed, as ``np.histogram``.  One masked compare-and-sum per bin
    keeps the working set at one (R, C) mask instead of a (bins, R, C) one.
    """
    edges = device_edges(bins, values.device)
    counts = []
    for b in range(bins):
        above = values >= edges[b]
        below = values <= edges[b + 1] if b == bins - 1 else (
            values < edges[b + 1]
        )
        counts.append((above & below & mask).sum())
    return torch.stack(counts).to(torch.int32)


def cdf_pac_from_counts(
    counts: torch.Tensor,
    n_samples: int,
    pac_lo_idx: int,
    pac_hi_idx: int,
    parity_zeros: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hist, cdf, pac_area) in f32 from strict-upper-triangle bin counts."""
    n = n_samples
    bins = counts.shape[0]
    counts = counts.to(torch.int64).clone()
    if parity_zeros:
        # triu(.., k=1).ravel() keeps the zeroed lower triangle and the
        # diagonal: N(N+1)/2 extra zeros in bin 0, density over N^2.
        counts[0] += n * (n + 1) // 2
        total = float(n) * float(n)
    else:
        total = float(n) * (n - 1) / 2.0
    dev = counts.device
    hist = counts.to(torch.float32) / device_scalar(total * (1.0 / bins), dev)
    cdf = torch.cumsum(counts, 0).to(torch.float32) / device_scalar(total, dev)
    pac_area = cdf[pac_hi_idx - 1] - cdf[pac_lo_idx]
    return hist, cdf, pac_area


def bin_edges(bins: int = 20) -> np.ndarray:
    """Histogram bin edges over [0, 1], as ``np.histogram`` returns them."""
    return np.linspace(0.0, 1.0, bins + 1)


def area_under_cdf(cdf: np.ndarray) -> np.ndarray:
    """Monti's A(K): area under the binned consensus CDF, sum(cdf) * dbin."""
    cdf = np.asarray(cdf)
    return np.sum(cdf, axis=-1) / cdf.shape[-1]


def cluster_consensus(cij: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Monti's per-cluster consensus m(k) (Monti et al. 2003, eq. 6).

    The mean of Cij over the distinct pairs (i < j) both labelled k; NaN
    for a cluster with fewer than two members.  Host numpy, after the
    sweep; the result equals the reference package's.
    """
    cij = np.asarray(cij, dtype=np.float64)
    labels = np.asarray(labels)
    ks = np.unique(labels[labels >= 0])
    member = (labels[None, :] == ks[:, None]).astype(np.float64)  # (K, N)
    # Ordered pairs within k minus the diagonal, halved: the distinct pairs.
    ordered = np.einsum("ki,ij,kj->k", member, cij, member)
    diag = member @ np.diagonal(cij)
    pair_sums = (ordered - diag) / 2.0
    sizes = member.sum(axis=1)
    pair_counts = sizes * (sizes - 1) / 2.0
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(pair_counts > 0, pair_sums / pair_counts, np.nan)


def item_consensus(cij: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Monti's item consensus m_i(k) (Monti et al. 2003, eq. 7).

    (N, n_clusters): the mean of Cij[i, j] over the members j != i of
    cluster k; NaN where k has no member other than i.  Host numpy; the
    result equals the reference package's.
    """
    cij = np.asarray(cij, dtype=np.float64)
    labels = np.asarray(labels)
    n = cij.shape[0]
    ks = np.unique(labels[labels >= 0])
    member = labels[None, :] == ks[:, None]  # (K, N)
    sums = cij @ member.T  # (N, K)
    counts = member.sum(axis=1)[None, :].astype(np.float64)  # (1, K)
    self_in_k = member.T[np.arange(n), :]  # (N, K) bool
    sums = sums - np.where(self_in_k, np.diagonal(cij)[:, None], 0.0)
    counts = counts - self_in_k.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(counts > 0, sums / counts, np.nan)


def delta_k(areas: np.ndarray) -> np.ndarray:
    """Monti's Delta(K): A(K_1), then (A(K_m) - A(K_m-1)) / A(K_m-1)."""
    areas = np.asarray(areas, dtype=np.float64)
    out = np.empty_like(areas)
    if areas.size == 0:
        return out
    out[0] = areas[0]
    prev = np.maximum(areas[:-1], 1e-12)
    out[1:] = (areas[1:] - areas[:-1]) / prev
    return out


def select_best_k(
    mode: str,
    k_values,
    pac_areas,
    delta_k_gains=None,
    delta_k_threshold: float = 0.05,
) -> int:
    """Best K by ``'PAC'`` (argmin, near-ties to the largest K) or
    ``'delta_k'`` (the largest K whose gain still exceeds the threshold)."""
    ks = list(k_values)
    if mode == "delta_k":
        if delta_k_gains is None:
            raise ValueError("mode='delta_k' needs delta_k_gains")
        gains = np.maximum(np.asarray(delta_k_gains, np.float64), 0.0)
        chosen = ks[0]
        for i in range(1, len(ks)):
            if gains[i] > delta_k_threshold:
                chosen = ks[i]
        return int(chosen)
    if mode != "PAC":
        raise ValueError(
            f"consensus_matrix_analysis={mode!r} not supported "
            "(choose 'PAC' or 'delta_k')"
        )
    pac = np.asarray(pac_areas, np.float64)
    near_min = pac <= pac.min() + 1e-3
    return int(max(k for k, hit in zip(ks, near_min) if hit))
