"""The dense K sweep on one device: resample -> cluster -> count -> analyse.

The port of the reference package's ``parallel/sweep.py`` for one device:

- the resample plan is drawn once from ``split(PRNGKey(seed))[0]`` and is
  shared by every K (so Iij is computed once);
- per K, each resample's clusterer key is ``fold_in(key_cluster, k)`` (and
  ``fold_in(., h)`` under ``reseed_clusterer_per_resample``), the lanes are
  clustered in ``cluster_batch`` groups, and Mij, Cij, the histogram
  (the kernel of :mod:`..ops.hist` on the card) and the curves follow;
- ``pac_area`` is re-derived from the assembled CDF, as the reference does;
- with ``accum_repr="packed"`` Mij and Iij come from bit-planes through the
  popcount kernel (:mod:`..ops.popcount`), the same counts bit for bit.

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
from consensus_clustering_tpu_torch.ops import _build, launch_counts
from consensus_clustering_tpu_torch.ops.analysis import (
    cdf_pac_from_counts,
    consensus_matrix,
)
from consensus_clustering_tpu_torch.ops.bitpack import (
    coassoc_counts_packed,
    cosample_counts_packed,
)
from consensus_clustering_tpu_torch.ops.coassoc import coassociation_counts
from consensus_clustering_tpu_torch.ops.hist import consensus_hist_counts
from consensus_clustering_tpu_torch.ops.popcount import packed_coassoc_counts
from consensus_clustering_tpu_torch.ops.resample import (
    cosample_counts,
    resample_indices,
)
from consensus_clustering_tpu_torch.utils.metrics import (
    device_memory_stats,
    peak_memory_window,
)

#: The CUDA sources every sweep builds before it runs on the card.
KERNELS = ("hist", "lloyd", "popcount", "fused_block")


def build_kernels(device: torch.device) -> float:
    """Build the kernels for a run on ``device`` (nothing on the CPU);
    returns the seconds it took (0 when they are built already)."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        _build.build(KERNELS)
    return time.perf_counter() - t0


def kernel_route(device: torch.device) -> str:
    """``cuda`` where the wrappers launch their kernels, ``plain`` where
    they take their plain versions (CPU tensors)."""
    return "cuda" if device.type == "cuda" else "plain"


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Each kernel's launches since the :func:`..ops.launch_counts`
    snapshot ``before``."""
    return {name: n - before[name] for name, n in launch_counts().items()}


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
    return_centroids: bool = False,
) -> torch.Tensor:
    """(H, n_sub) labels of every resample for one K, or with
    ``return_centroids`` the (H, k_max, d) final centroids of each
    resample's best restart (the clusterer's ``fit(...)[1]``, the fused
    block step's input).

    ``cluster_batch`` groups the resamples so each group's Lloyd loop stops
    at its own slowest lane; ``split_init`` seeds every lane in one batch
    first.  Results are identical either way: they are a pure per-lane
    function of (key, x_sub, k).
    """
    def fit(keys_g, x_g, **kwargs):
        if return_centroids:
            return clusterer.fit(keys_g, x_g, k, k_max, **kwargs)[1]
        return clusterer.fit_predict(keys_g, x_g, k, k_max, **kwargs)

    h = x_sub.shape[0]
    batch = config.cluster_batch
    if batch is None or batch >= h:
        return fit(keys, x_sub)
    groups = [slice(s, min(s + batch, h)) for s in range(0, h, batch)]
    if config.split_init and hasattr(clusterer, "init_centroids"):
        inits = clusterer.init_centroids(keys, x_sub, k, k_max)
        parts = [fit(keys[g], x_sub[g], init_centroids=inits[g])
                 for g in groups]
    else:
        parts = [fit(keys[g], x_sub[g]) for g in groups]
    return torch.cat(parts)


def curves_from_counts(
    config: SweepConfig, counts_per_k
) -> Dict[str, torch.Tensor]:
    """Stacked per-K ``hist`` and ``cdf`` (nK, bins) from each K's strict
    upper-triangle bin counts, and ``pac_area`` (nK,) re-derived from the
    stacked CDF, as the reference does."""
    lo, hi = config.pac_idx
    hists, cdfs = [], []
    for counts in counts_per_k:
        hist_k, cdf_k, _ = cdf_pac_from_counts(
            counts, config.n_samples, lo, hi, config.parity_zeros
        )
        hists.append(hist_k)
        cdfs.append(cdf_k)
    cdf = torch.stack(cdfs)
    return {"hist": torch.stack(hists), "cdf": cdf,
            "pac_area": cdf[:, hi - 1] - cdf[:, lo]}


def build_sweep(
    clusterer: Clusterer, config: SweepConfig, device=None,
    progress_callback: Optional[Callable[[int, float], None]] = None,
) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """Return ``sweep(x, key) -> dict`` on ``device`` (default ``cuda``).

    The dict holds, stacked over ``config.k_values``: ``pac_area`` (nK,),
    ``hist`` and ``cdf`` (nK, bins), and with ``store_matrices`` also
    ``iij`` (N, N) and ``mij``/``cij`` (nK, N, N).

    ``progress_callback(k, pac)``, if given, is called once per K, in K
    order, as soon as that K's curves exist, with the PAC the result
    reports (the same arithmetic on that K's row); each call reads one
    value from the device.  Without it the sweep adds no work.
    """
    device = resolve_device(device)
    n = config.n_samples
    h_total = config.n_iterations
    k_max = config.k_max
    dtype = config.torch_dtype
    packed = config.accum_repr == "packed"

    def sweep(x: torch.Tensor, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(device=device, dtype=dtype)
        pair = rng.split(key.to(device))
        key_resample, key_cluster = pair[0], pair[1]
        indices = resample_indices(key_resample, n, h_total, config.n_sub)
        if packed:
            iij = cosample_counts_packed(
                indices, n, popcount_fn=packed_coassoc_counts
            )
        else:
            iij = cosample_counts(indices, n)
        x_sub = x[indices]
        h_global = torch.arange(h_total, dtype=torch.int64, device=device)
        counts, mijs, cijs = [], [], []
        for k in config.k_values:
            keys = resample_lane_keys(config, key_cluster, k, h_global)
            labels = fit_resample_lanes(
                clusterer, config, keys, x_sub, k, k_max
            )
            if packed:
                mij = coassoc_counts_packed(
                    labels, indices, n, k_max,
                    popcount_fn=packed_coassoc_counts,
                )
            else:
                mij = coassociation_counts(
                    labels, indices, n, k_max, config.chunk_size
                )
            cij = consensus_matrix(mij, iij)
            counts.append(consensus_hist_counts(cij, n, 0, config.bins))
            if progress_callback is not None:
                pac = curves_from_counts(config, counts[-1:])["pac_area"]
                progress_callback(int(k), float(pac[0]))
            if config.store_matrices:
                mijs.append(mij)
                cijs.append(cij)
        out = curves_from_counts(config, counts)
        if config.store_matrices:
            out["iij"] = iij
            out["mij"] = torch.stack(mijs)
            out["cij"] = torch.stack(cijs)
        return out

    sweep.device = device
    return sweep


def run_sweep(
    clusterer: Clusterer,
    config: SweepConfig,
    x: np.ndarray,
    seed: int,
    device=None,
    progress_callback: Optional[Callable[[int, float], None]] = None,
) -> Dict[str, Any]:
    """Run a sweep; return host (numpy) results plus a ``timing`` block
    (``progress_callback``: see :func:`build_sweep`).

    ``timing``: ``compile_seconds`` (building the CUDA kernels; 0 when
    already built or on the CPU), ``run_seconds`` (wall clock until every
    result is on the host, after ``torch.cuda.synchronize()``),
    ``resamples_per_second`` (H x nK / run_seconds), ``device_memory``
    (peak allocator bytes of this run; {} on the CPU),
    ``kernel_launches`` (launches of each kernel in this run) and, for a
    packed sweep, ``packed_kernel`` (``cuda`` or ``plain``).
    """
    sweep = build_sweep(clusterer, config, device, progress_callback)
    device = sweep.device
    on_cuda = device.type == "cuda"
    compile_seconds = build_kernels(device)
    x_dev = torch.as_tensor(np.asarray(x)).to(device)
    key = rng.prng_key(seed, device)
    with peak_memory_window(device):
        launches0 = launch_counts()
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
            "kernel_launches": launches_since(launches0),
        }
        if config.accum_repr == "packed":
            host["timing"]["packed_kernel"] = kernel_route(device)
        return host
