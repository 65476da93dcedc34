"""The dense K sweep on one device: resample -> cluster -> count -> analyse.

The port of the reference package's ``parallel/sweep.py`` for one device:

- the resample plan is drawn once from ``split(PRNGKey(seed))[0]`` and is
  shared by every K (so Iij is computed once);
- per K, each resample's clusterer key is ``fold_in(key_cluster, k)`` (and
  ``fold_in(., h)`` under ``reseed_clusterer_per_resample``), the lanes are
  clustered in ``cluster_batch`` groups, and Mij, Cij, the histogram
  (the kernel of :mod:`..ops.hist` on the card) and the curves follow;
- ``pac_area`` is re-derived from the assembled CDF, as the reference does.

Where the reference compiles one program, this runs eagerly; the Lloyd loop
checks on the host after each step whether any lane is still running.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.device import resolve_device
from consensus_clustering_tpu_torch.models.protocol import Clusterer
from consensus_clustering_tpu_torch.ops import _build, hist, lloyd
from consensus_clustering_tpu_torch.ops.analysis import (
    cdf_pac_from_counts,
    consensus_matrix,
)
from consensus_clustering_tpu_torch.ops.coassoc import coassociation_counts
from consensus_clustering_tpu_torch.ops.hist import consensus_hist_counts
from consensus_clustering_tpu_torch.ops.resample import (
    cosample_counts,
    resample_indices,
)
from consensus_clustering_tpu_torch.utils.metrics import device_memory_stats


def resample_lane_keys(
    config: SweepConfig, key_cluster: torch.Tensor, k: int,
    h_global: torch.Tensor,
) -> torch.Tensor:
    """(H, 2) clusterer keys for one K over GLOBAL resample ids (H,).

    ``fold_in(key_cluster, k)``, then ``fold_in(., h)`` per resample under
    ``reseed_clusterer_per_resample``; otherwise every resample re-seeds
    identically, as the reference does.
    """
    key_k = rng.fold_in(key_cluster, k)
    if config.reseed_clusterer_per_resample:
        return rng.fold_in(key_k, h_global)
    return key_k.expand(h_global.shape[0], 2)


def fit_resample_lanes(
    clusterer: Clusterer,
    config: SweepConfig,
    keys: torch.Tensor,
    x_sub: torch.Tensor,
    k: int,
    k_max: int,
) -> torch.Tensor:
    """(H, n_sub) labels of every resample for one K.

    ``cluster_batch`` groups the resamples so each group's Lloyd loop stops
    at its own slowest lane; ``split_init`` seeds every lane in one batch
    first.  Labels are identical either way: they are a pure per-lane
    function of (key, x_sub, k).
    """
    h = x_sub.shape[0]
    batch = config.cluster_batch
    if batch is None or batch >= h:
        return clusterer.fit_predict(keys, x_sub, k, k_max)
    groups = [slice(s, min(s + batch, h)) for s in range(0, h, batch)]
    if config.split_init and hasattr(clusterer, "init_centroids"):
        inits = clusterer.init_centroids(keys, x_sub, k, k_max)
        parts = [
            clusterer.fit_predict(
                keys[g], x_sub[g], k, k_max, init_centroids=inits[g]
            )
            for g in groups
        ]
    else:
        parts = [
            clusterer.fit_predict(keys[g], x_sub[g], k, k_max)
            for g in groups
        ]
    return torch.cat(parts)


def build_sweep(
    clusterer: Clusterer, config: SweepConfig, device=None
) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """Return ``sweep(x, key) -> dict`` on ``device`` (default ``cuda``).

    The dict holds, stacked over ``config.k_values``: ``pac_area`` (nK,),
    ``hist`` and ``cdf`` (nK, bins), and with ``store_matrices`` also
    ``iij`` (N, N) and ``mij``/``cij`` (nK, N, N).
    """
    device = resolve_device(device)
    n = config.n_samples
    h_total = config.n_iterations
    k_max = config.k_max
    lo, hi = config.pac_idx
    dtype = config.torch_dtype

    def sweep(x: torch.Tensor, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(device=device, dtype=dtype)
        pair = rng.split(key.to(device))
        key_resample, key_cluster = pair[0], pair[1]
        indices = resample_indices(key_resample, n, h_total, config.n_sub)
        iij = cosample_counts(indices, n)
        x_sub = x[indices]
        h_global = torch.arange(h_total, dtype=torch.int64, device=device)
        per_k = {"hist": [], "cdf": [], "mij": [], "cij": []}
        for k in config.k_values:
            keys = resample_lane_keys(config, key_cluster, k, h_global)
            labels = fit_resample_lanes(
                clusterer, config, keys, x_sub, k, k_max
            )
            mij = coassociation_counts(
                labels, indices, n, k_max, config.chunk_size
            )
            cij = consensus_matrix(mij, iij)
            counts = consensus_hist_counts(cij, n, 0, config.bins)
            hist_k, cdf_k, _ = cdf_pac_from_counts(
                counts, n, lo, hi, config.parity_zeros
            )
            per_k["hist"].append(hist_k)
            per_k["cdf"].append(cdf_k)
            if config.store_matrices:
                per_k["mij"].append(mij)
                per_k["cij"].append(cij)
        out = {"hist": torch.stack(per_k["hist"]),
               "cdf": torch.stack(per_k["cdf"])}
        out["pac_area"] = out["cdf"][:, hi - 1] - out["cdf"][:, lo]
        if config.store_matrices:
            out["iij"] = iij
            out["mij"] = torch.stack(per_k["mij"])
            out["cij"] = torch.stack(per_k["cij"])
        return out

    sweep.device = device
    return sweep


def run_sweep(
    clusterer: Clusterer,
    config: SweepConfig,
    x: np.ndarray,
    seed: int,
    device=None,
) -> Dict[str, Any]:
    """Run a sweep; return host (numpy) results plus a ``timing`` block.

    ``timing``: ``compile_seconds`` (building the CUDA kernels; 0 when
    already built or on the CPU), ``run_seconds`` (wall clock until every
    result is on the host, after ``torch.cuda.synchronize()``),
    ``resamples_per_second`` (H x nK / run_seconds), ``device_memory``
    (peak allocator bytes of this run; {} on the CPU) and
    ``kernel_launches`` (launches of each kernel in this run).
    """
    sweep = build_sweep(clusterer, config, device)
    device = sweep.device
    on_cuda = device.type == "cuda"
    t0 = time.perf_counter()
    if on_cuda:
        _build.build(["hist", "lloyd"])
    compile_seconds = time.perf_counter() - t0
    x_dev = torch.as_tensor(np.asarray(x)).to(device)
    key = rng.prng_key(seed, device)
    if on_cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = (hist.launch_count, lloyd.launch_count)
    r0 = time.perf_counter()
    out = sweep(x_dev, key)
    host = {name: value.cpu().numpy() for name, value in out.items()}
    if on_cuda:
        torch.cuda.synchronize(device)
    run_seconds = time.perf_counter() - r0
    total = config.n_iterations * len(config.k_values)
    host["timing"] = {
        "compile_seconds": compile_seconds,
        "run_seconds": run_seconds,
        "resamples_per_second": total / max(run_seconds, 1e-9),
        "device": (
            torch.cuda.get_device_name(device) if on_cuda else "cpu"
        ),
        "device_memory": device_memory_stats(device) if on_cuda else {},
        "kernel_launches": {
            "hist": hist.launch_count - launches0[0],
            "lloyd": lloyd.launch_count - launches0[1],
        },
    }
    return host
