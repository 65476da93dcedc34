"""Exact mixing of packed lane generations — numpy only.

A copy of the reference package's ``append/mixing.py``: the store-side
merging (:func:`widen_planes`, :func:`merge_generations`) and the host
oracle of the curves.  The append engine counts the curves on the
planes' device instead (:func:`.engine.curves_for_planes`); the tests
hold the two equal bit for bit.

The append contract ("bit-identical Iij accounting") rests on two
facts about the packed representation (``ops/bitpack.py``):

1. **Lanes are independent bits.**  Resamples occupy disjoint bits of
   the uint32 word axis, so the Mij/Iij counts of a set of lanes are
   plain popcounts — and the counts of a UNION of disjoint lane sets
   are the integer SUM of per-set counts.  Merging an old generation
   (H_old lanes over N_old rows) with a new one (H_new lanes over
   N_new rows) along the word axis therefore yields counts that equal
   old + new exactly, in integer arithmetic — no rounding, no
   approximation.  That is the provable half.
2. **Widening is exact.**  Elements live on the plain last axis at
   identity positions; rows the old generation never sampled hold no
   bits, so zero-padding old planes from N_old to N_new columns is the
   ground truth for those lanes, not an estimate: an old resample's
   indicator for a row that did not exist is identically zero.

What is NOT bit-identical to a from-scratch run at N_new is the
STATISTIC: the old generation's lanes sampled only the old rows, so
pairs touching new rows draw their counts from the new lanes alone —
an Iij-weighted affine mix of two populations, the same family of
correction as ``estimator/bounds.py``'s parity-zeros dilution.  That
part is bound-disclosed by :mod:`.staleness`, never silently papered
over.

Curve semantics are a bit-exact numpy copy of :mod:`..ops.analysis`:
f32 consensus divide with the f32 1e-6 regulariser, edge-comparison
histogram against f32-rounded f64 edges (last bin right-closed, strict
upper triangle), parity-zeros bin-0 inflation, f32 CDF/PAC arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

#: Per-byte popcount table for the no-``np.bitwise_count`` fallback.
_POP8 = np.array(
    [bin(i).count("1") for i in range(256)], dtype=np.int32
)


def popcount_u32(a: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint32 array, as int32."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    fn = getattr(np, "bitwise_count", None)
    if fn is not None:
        return fn(a).astype(np.int32)
    b = a.view(np.uint8).reshape(a.shape + (4,))
    return _POP8[b].sum(axis=-1, dtype=np.int32)


def widen_planes(arr: np.ndarray, n_new: int) -> np.ndarray:
    """Zero-pad the element (last) axis from N_old to ``n_new`` columns.

    Exact by construction (module docstring, fact 2): the padded
    columns are rows the stored lanes never sampled, whose indicator
    bits are identically zero.
    """
    n_old = arr.shape[-1]
    if n_new < n_old:
        raise ValueError(
            f"cannot shrink planes from {n_old} to {n_new} columns"
        )
    if n_new == n_old:
        return np.asarray(arr, dtype=np.uint32)
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, n_new - n_old)]
    return np.pad(
        np.asarray(arr, dtype=np.uint32), pad, mode="constant"
    )


def merge_generations(
    generations: Sequence[Dict[str, np.ndarray]], n_new: int
) -> Dict[str, np.ndarray]:
    """Merge cumulative plane sets along the word axis at ``n_new``.

    Each entry carries ``planes`` (n_ks, k_max, W_g, N_g) and
    ``coplanes`` (W_g, N_g); all must agree on (n_ks, k_max).  The
    result's popcounts equal the integer sum of the per-generation
    popcounts — the bit-identical Iij accounting the append parity
    gate asserts.
    """
    if not generations:
        raise ValueError("merge_generations needs >= 1 generation")
    planes = [widen_planes(g["planes"], n_new) for g in generations]
    coplanes = [widen_planes(g["coplanes"], n_new) for g in generations]
    lead = planes[0].shape[:2]
    for p in planes[1:]:
        if p.shape[:2] != lead:
            raise ValueError(
                f"generation K geometry mismatch: {p.shape[:2]} != {lead}"
            )
    return {
        "planes": np.concatenate(planes, axis=-2),
        "coplanes": np.concatenate(coplanes, axis=-2),
    }


def pair_counts(
    planes_k: np.ndarray, coplanes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact (Mij, Iij) int32 counts for ONE K's planes.

    ``planes_k`` is (k_max, W, N) — per-cluster membership bit-planes;
    ``coplanes`` is (W, N) — the co-sampling plane shared across K.
    ``Mij[i, j] = sum_c sum_w popcount(planes[c, w, i] & planes[c, w, j])``
    — the contraction ``ops.popcount.packed_coassoc_counts`` runs on the
    device, here as a word-at-a-time host loop.
    """
    return mij_counts(planes_k), iij_counts(coplanes)


def mij_counts(planes_k: np.ndarray) -> np.ndarray:
    """Exact Mij int32 counts for one K's (k_max, W, N) planes."""
    k_max, n_words, n = planes_k.shape
    mij = np.zeros((n, n), dtype=np.int32)
    for c in range(k_max):
        for w in range(n_words):
            word = planes_k[c, w]
            mij += popcount_u32(word[:, None] & word[None, :])
    return mij


def iij_counts(coplanes: np.ndarray) -> np.ndarray:
    """Exact Iij int32 counts from the co-sampling plane alone."""
    n = coplanes.shape[-1]
    iij = np.zeros((n, n), dtype=np.int32)
    for w in range(coplanes.shape[0]):
        word = coplanes[w]
        iij += popcount_u32(word[:, None] & word[None, :])
    return iij


def consensus_from_counts(
    mij: np.ndarray, iij: np.ndarray
) -> np.ndarray:
    """``Cij = Mij / (Iij + 1e-6)`` in f32, diagonal forced to 1.0 —
    the numpy spelling of ``ops.analysis.consensus_matrix`` (the f32
    regulariser add, not numpy's f64 habit)."""
    cij = mij.astype(np.float32) / (
        iij.astype(np.float32) + np.float32(1e-6)
    )
    np.fill_diagonal(cij, np.float32(1.0))
    return cij


def histogram_counts(cij: np.ndarray, bins: int) -> np.ndarray:
    """Strict-upper-triangle bin counts with the last bin right-closed.

    Bit-compatible with ``ops.analysis.masked_histogram_counts``:
    membership is tested against f32-rounded f64 edges
    (``edges[b] <= v < edges[b+1]``), never via ``floor(v * bins)`` —
    the f32 product rounds edge-adjacent values into the wrong bin.
    """
    edges = np.linspace(0.0, 1.0, bins + 1).astype(np.float32)
    n = cij.shape[-1]
    i = np.arange(n)
    upper = i[None, :] > i[:, None]
    v = np.asarray(cij, dtype=np.float32)[upper]
    counts = np.zeros(bins, dtype=np.int64)
    for b in range(bins):
        if b == bins - 1:
            hit = (v >= edges[-2]) & (v <= edges[-1])
        else:
            hit = (v >= edges[b]) & (v < edges[b + 1])
        counts[b] = int(np.count_nonzero(hit))
    return counts


def curves_from_counts(
    counts: np.ndarray,
    n_samples: int,
    pac_lo_idx: int,
    pac_hi_idx: int,
    parity_zeros: bool = True,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """(hist, cdf, pac) from raw upper-triangle bin counts — the numpy
    port of ``ops.analysis.cdf_pac_from_counts``, f32 arithmetic
    included (cumsum in integers, ONE f32 divide, f32 PAC subtract)."""
    counts = np.asarray(counts, dtype=np.int64).copy()
    n = int(n_samples)
    bins = counts.shape[0]
    if parity_zeros:
        counts[0] += n * (n + 1) // 2
        total = float(n) * float(n)
    else:
        total = float(n) * (n - 1) / 2.0
    dbin = 1.0 / bins
    hist = counts.astype(np.float32) / np.float32(total * dbin)
    cdf = np.cumsum(counts).astype(np.float32) / np.float32(total)
    pac = float(cdf[pac_hi_idx - 1] - cdf[pac_lo_idx])
    return hist, cdf, pac


def curves_for_planes(
    planes: np.ndarray,
    coplanes: np.ndarray,
    *,
    bins: int,
    pac_lo_idx: int,
    pac_hi_idx: int,
    parity_zeros: bool = True,
) -> Dict[str, List]:
    """Per-K curves for a full (n_ks, k_max, W, N) plane set.

    Returns ``{"pac_area": [...], "cdf": [...], "hist": [...],
    "iij": (N, N) int32, "mij": [per-K (N, N) int32]}`` in k_values
    order.
    """
    iij = iij_counts(coplanes)
    pac_area: List[float] = []
    cdfs: List[np.ndarray] = []
    hists: List[np.ndarray] = []
    mijs: List[np.ndarray] = []
    n = planes.shape[-1]
    for ki in range(planes.shape[0]):
        mij = mij_counts(planes[ki])
        cij = consensus_from_counts(mij, iij)
        counts = histogram_counts(cij, bins)
        hist, cdf, pac = curves_from_counts(
            counts, n, pac_lo_idx, pac_hi_idx, parity_zeros
        )
        pac_area.append(pac)
        cdfs.append(cdf)
        hists.append(hist)
        mijs.append(mij)
    return {
        "pac_area": pac_area,
        "cdf": cdfs,
        "hist": hists,
        "iij": iij,
        "mij": mijs,
    }
