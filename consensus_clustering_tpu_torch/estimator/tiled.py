"""Exact consensus curves for one K, a row tile at a time: no N x N state.

The port of the reference package's ``estimator/tiled.py``: the
estimator's exact refinement of the chosen K (``exact_best_k``).

1. **Collect, O(H·n_sub).**  One K's subsample indices and labels over
   all H resamples, blockwise through the engines' own helpers (the plan
   with global resample ids, ``resample_lane_keys``,
   ``fit_resample_lanes``), so they equal what any engine clusters.
2. **Tile, O(H·N/32 + tile_rows·N).**  The labels are packed into
   bit-planes (:func:`..ops.bitpack.pack_label_planes`, one plane a
   cluster) and counted a row tile at a time on their device by the
   popcount and histogram kernels (:func:`..ops.tiles.
   packed_hist_counts`).  The reference runs f32 indicator GEMMs in host
   numpy instead; the counts are the same integers, so the curves are
   the same bits.

The work is still O(N²·H/32) word operations: this refines one K, it does
not run the sweep exactly.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.device import resolve_device
from consensus_clustering_tpu_torch.models.kmeans import (
    lloyd_counts,
    lloyd_since,
)
from consensus_clustering_tpu_torch.models.protocol import Clusterer
from consensus_clustering_tpu_torch.obs.tracing import region
from consensus_clustering_tpu_torch.ops import launch_counts
from consensus_clustering_tpu_torch.ops.bitpack import (
    pack_cosample_planes,
    pack_label_planes,
)
from consensus_clustering_tpu_torch.ops.resample import resample_indices
from consensus_clustering_tpu_torch.ops.tiles import (
    TILE_ROWS,
    curves_from_hist_counts,
    packed_hist_counts,
)
from consensus_clustering_tpu_torch.parallel.sweep import (
    build_kernels,
    fit_resample_lanes,
    launches_since,
    resample_lane_keys,
)
from consensus_clustering_tpu_torch.utils.metrics import (
    device_memory_stats,
    peak_memory_window,
)


def collect_resample_labels(
    clusterer: Clusterer,
    config: SweepConfig,
    x: np.ndarray,
    seed: int,
    k: int,
    h_block: Optional[int] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices, labels) of ONE K over all H resamples: (H, n_sub) int64
    tensors on the device, in global resample order, computed in blocks of
    ``h_block`` (default ``stream_h_block``, else H) resamples."""
    device = resolve_device(device)
    n, n_sub, h_total = config.n_samples, config.n_sub, config.n_iterations
    hb = int(h_block or config.stream_h_block or max(1, h_total))
    xd = torch.as_tensor(np.asarray(x)).to(device=device,
                                           dtype=config.torch_dtype)
    pair = rng.split(rng.prng_key(seed, device))
    key_resample, key_cluster = pair[0], pair[1]
    idx_blocks, lab_blocks = [], []
    for h_start in range(0, h_total, hb):
        take = min(hb, h_total - h_start)
        indices = resample_indices(key_resample, n, hb, n_sub,
                                   h_start=h_start)[:take]
        h_global = h_start + torch.arange(take, dtype=torch.int64,
                                          device=device)
        keys = resample_lane_keys(config, key_cluster, k, h_global)
        labels = fit_resample_lanes(clusterer, config, keys, xd[indices], k,
                                    config.k_max)
        idx_blocks.append(indices)
        lab_blocks.append(labels.to(torch.int64))
    return torch.cat(idx_blocks), torch.cat(lab_blocks)


def tiled_exact_curves(
    indices,
    labels,
    n: int,
    bins: int,
    pac_lo_idx: int,
    pac_hi_idx: int,
    parity_zeros: bool = True,
    tile_rows: int = TILE_ROWS,
    tile_callback: Optional[Callable[[int, int], None]] = None,
    *,
    device=None,
    popcount_fn: Optional[Callable[..., torch.Tensor]] = None,
    hist_fn: Optional[Callable[..., torch.Tensor]] = None,
) -> Dict[str, np.ndarray]:
    """Exact float32 ``hist``, ``cdf`` and ``pac_area`` of one K from its
    per-resample (indices, labels), streaming (tile_rows, N) count tiles.

    ``indices``/``labels`` are (H, n_sub) integer arrays (-1 entries are
    dropped): tensors are counted on their device, numpy arrays on
    ``device`` (default ``cuda``).  ``tile_callback(tile, rows_done)``
    fires after each tile; an exception it raises aborts the loop.
    ``popcount_fn``/``hist_fn``: see :mod:`..ops.tiles`.
    """
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    if not isinstance(indices, torch.Tensor):
        dev = resolve_device(device)
        indices = torch.as_tensor(np.asarray(indices), device=dev)
        labels = torch.as_tensor(np.asarray(labels), device=dev)
    indices = indices.to(torch.int64)
    labels = labels.to(torch.int64)
    valid = (indices >= 0) & (labels >= 0)
    # One plane per cluster id present (empty planes count nothing).
    k_planes = max(1, int(labels[valid].max()) + 1) if bool(valid.any()) \
        else 1
    planes = pack_label_planes(labels, indices, k_planes, n)
    words = planes.reshape(1, -1, n)
    cowords = pack_cosample_planes(indices, n)
    counts = packed_hist_counts(words, cowords, bins, tile_rows,
                                popcount_fn=popcount_fn, hist_fn=hist_fn,
                                tile_callback=tile_callback)
    curves = curves_from_hist_counts(counts, n, pac_lo_idx, pac_hi_idx,
                                     parity_zeros)
    return {"hist": curves["hist"][0], "cdf": curves["cdf"][0],
            "pac_area": curves["pac_area"][0]}


def exact_curves_for_k(
    clusterer: Clusterer,
    config: SweepConfig,
    x: np.ndarray,
    seed: int,
    k: int,
    tile_rows: int = TILE_ROWS,
    tile_callback: Optional[Callable[[int, int], None]] = None,
    device=None,
) -> Dict[str, object]:
    """Collect one K's labels and stream its tiled exact curves: the
    estimator's exactness refinement, end to end.

    Adds ``timing``: ``seconds`` (collect + tiles, after a device
    synchronise), ``collect_seconds``, ``kernel_launches`` and ``lloyd``
    (this call's launches and Lloyd loop counts) and ``device_memory``
    (peak of this call; {} on the CPU).  The two phases are the ranges
    ``cc.refine.labels`` and ``cc.refine.tiles``.
    """
    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    build_kernels(device)
    with peak_memory_window(device):
        launches0, lloyd0 = launch_counts(), lloyd_counts()
        t0 = time.perf_counter()
        with region("refine.labels"):
            indices, labels = collect_resample_labels(
                clusterer, config, x, seed, k, device=device)
            if on_cuda:
                torch.cuda.synchronize(device)
        collect_seconds = time.perf_counter() - t0
        lo, hi = config.pac_idx
        with region("refine.tiles"):
            out = tiled_exact_curves(
                indices, labels, config.n_samples, config.bins, lo, hi,
                parity_zeros=config.parity_zeros, tile_rows=tile_rows,
                tile_callback=tile_callback,
            )
        out["timing"] = {
            "seconds": time.perf_counter() - t0,
            "collect_seconds": collect_seconds,
            "kernel_launches": launches_since(launches0),
            "lloyd": lloyd_since(lloyd0),
            "device_memory": device_memory_stats(device) if on_cuda else {},
        }
        return out
