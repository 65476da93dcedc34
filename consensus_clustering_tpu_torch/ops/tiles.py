"""Exact consensus curves of bit-planes, a row tile at a time.

The packed streaming engine's evaluation (:mod:`..parallel.streaming`)
and the counting step of the estimator's exact refinement
(:mod:`..estimator.tiled`), of the append engine's merged curves and of
its staleness verdict (:mod:`..append`).  The reference package computes
these in host numpy (f32 indicator GEMMs a cluster at a time, a
word-at-a-time popcount loop); here they run on the planes' device
through the kernels the streaming engine's evaluation already uses:

- per row tile of ``tile_rows`` rows, one popcount (B3,
  :func:`.popcount.packed_coassoc_counts`) for the Iij tile and one per K
  for its Mij tile, each (tile_rows, N) int32;
- each Mij tile binned through its Cij with the tile's global
  ``row_offset`` (B1's count entry, :func:`.hist.consensus_hist_from_
  counts`) into an int64 row, so the strict upper triangle is counted once
  and no count wraps at N = 10^5 (5·10^9 pairs);
- the tiles are dropped: the peak is the planes plus two tiles.

The counts are exact integers, so the curves equal the reference's numpy
ones bit for bit.  On CPU tensors the wrappers take their plain versions;
``popcount_fn``/``hist_fn`` name other routes (the smoke script holds the
card's kernels against the plain versions on the card this way).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from consensus_clustering_tpu_torch.ops.analysis import cdf_pac_from_counts
from consensus_clustering_tpu_torch.ops.hist import consensus_hist_from_counts
from consensus_clustering_tpu_torch.ops.popcount import packed_coassoc_counts

#: Rows of a tile: two (2048, 10^5) int32 tiles are 1.6 GB.
TILE_ROWS = 2048


def packed_hist_counts(
    words: torch.Tensor,
    cowords: torch.Tensor,
    bins: int,
    tile_rows: int = TILE_ROWS,
    *,
    n_valid: Optional[int] = None,
    rows: Optional[Tuple[int, int]] = None,
    popcount_fn: Optional[Callable[..., torch.Tensor]] = None,
    hist_fn: Optional[Callable[..., torch.Tensor]] = None,
    tile_callback: Optional[Callable[[int, int], None]] = None,
) -> torch.Tensor:
    """(nK, bins) int64 strict-upper-triangle bin counts of each K's Cij
    (or of its rows ``rows = (start, stop)``, a mesh's row shard).

    Args:
      words: (nK, L, C) int32 words, each K's cluster planes stacked along
        L (``pack_label_planes(...).reshape(-1, C)``).
      cowords: (W, C) int32 co-sampling words.
      bins: histogram bins over [0, 1].
      tile_rows: rows of a tile (>= 1).
      n_valid: N, default C; elements >= N are padding.
      rows: the global rows binned, default all C; tiles start at
        ``start``.
      popcount_fn, hist_fn: default :func:`.popcount.packed_coassoc_counts`
        and :func:`.hist.consensus_hist_from_counts`.
      tile_callback: ``cb(tile_index, rows_done)`` after each tile.
    """
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    popcount_fn = popcount_fn or packed_coassoc_counts
    hist_fn = hist_fn or consensus_hist_from_counts
    n_ks, _, n = words.shape
    n_valid = n if n_valid is None else int(n_valid)
    start, stop = (0, n) if rows is None else rows
    counts = torch.zeros((n_ks, bins), dtype=torch.int64, device=words.device)
    for r0 in range(start, stop, tile_rows):
        tile = slice(r0, min(stop, r0 + tile_rows))
        iij_t = popcount_fn(cowords[:, tile], cowords)
        for i in range(n_ks):
            mij_t = popcount_fn(words[i, :, tile], words[i])
            hist_fn(mij_t, iij_t, n_valid, r0, bins, counts[i])
        if tile_callback is not None:
            tile_callback((r0 - start) // tile_rows,
                          min(stop, r0 + tile_rows) - start)
    return counts


def plane_words(a, device) -> torch.Tensor:
    """Plane words (uint32 numpy, int32 numpy bit patterns, or a tensor)
    as an int32 tensor on ``device``, the same 32 bits in every word."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype != np.int32:
        raise ValueError(f"plane words must be uint32 or int32, got {a.dtype}")
    return torch.from_numpy(a).to(device)


def planes_curves(
    planes: torch.Tensor,
    coplanes: torch.Tensor,
    bins: int,
    pac_lo_idx: int,
    pac_hi_idx: int,
    parity_zeros: bool = True,
    n_rows: Optional[int] = None,
    tile_rows: int = TILE_ROWS,
    *,
    popcount_fn: Optional[Callable[..., torch.Tensor]] = None,
    hist_fn: Optional[Callable[..., torch.Tensor]] = None,
) -> Dict[str, np.ndarray]:
    """Per-K curves (:func:`curves_from_hist_counts`) of a packed state:
    ``planes`` (nK, k_max, W, N) and ``coplanes`` (W, N) int32 words,
    restricted to the first ``n_rows`` elements (default all N)."""
    n = planes.shape[-1] if n_rows is None else int(n_rows)
    n_ks = planes.shape[0]
    words = planes[..., :n].reshape(n_ks, -1, n)
    counts = packed_hist_counts(words, coplanes[:, :n], bins, tile_rows,
                                popcount_fn=popcount_fn, hist_fn=hist_fn)
    return curves_from_hist_counts(counts, n, pac_lo_idx, pac_hi_idx,
                                   parity_zeros)


def curves_from_hist_counts(
    counts: torch.Tensor,
    n: int,
    pac_lo_idx: int,
    pac_hi_idx: int,
    parity_zeros: bool = True,
) -> Dict[str, np.ndarray]:
    """Host float32 ``hist``/``cdf`` (nK, bins) and ``pac_area`` (nK,) from
    (nK, bins) bin counts (:func:`.analysis.cdf_pac_from_counts` per K)."""
    hists, cdfs, pacs = [], [], []
    for row in counts:
        hist, cdf, pac = cdf_pac_from_counts(row, n, pac_lo_idx, pac_hi_idx,
                                             parity_zeros)
        hists.append(hist)
        cdfs.append(cdf)
        pacs.append(pac)
    return {"hist": torch.stack(hists).cpu().numpy(),
            "cdf": torch.stack(cdfs).cpu().numpy(),
            "pac_area": torch.stack(pacs).cpu().numpy()}
