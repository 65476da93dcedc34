"""The host backend: labels on the host, counts and analysis on the device.

For clusterers that run only on the host (sklearn estimators, through
:class:`..models.sklearn_adapter.SklearnClusterer`): the port of the
reference package's ``parallel/host.py``.  The resample plan is the device
plan the other engines draw (so the subsamples are the same), each
resample's subsample is labelled on the host, and Iij, Mij, Cij, the
histogram (the kernel of :mod:`..ops.hist` on the card) and the curves run
on the device, one pass per K.  ``n_jobs`` labels with joblib threads;
each task owns its label row and each fit clones the estimator, so nothing
is shared between threads.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.device import resolve_device
from consensus_clustering_tpu_torch.models.protocol import HostClusterer
from consensus_clustering_tpu_torch.ops import launch_counts
from consensus_clustering_tpu_torch.ops.analysis import consensus_matrix
from consensus_clustering_tpu_torch.ops.coassoc import coassociation_counts
from consensus_clustering_tpu_torch.ops.hist import consensus_hist_counts
from consensus_clustering_tpu_torch.ops.resample import (
    cosample_counts,
    resample_indices,
)
from consensus_clustering_tpu_torch.parallel.sweep import (
    build_kernels,
    curves_from_counts,
    launches_since,
)
from consensus_clustering_tpu_torch.utils.metrics import (
    device_memory_stats,
    peak_memory_window,
)
from consensus_clustering_tpu_torch.utils.progress import progress_iter


def _host_labels(clusterer, config, x, indices, k, seed, progress, n_jobs):
    """(H, n_sub) labels of every resample for one K, fitted on the host.

    Each fit is seeded with ``seed`` (``seed + h`` under
    ``reseed_clusterer_per_resample``), as the reference does.
    """
    def fit_seed(h: int) -> int:
        return seed + h if config.reseed_clusterer_per_resample else seed

    desc = f"Consensus clustering with {k} clusters"
    h_total = config.n_iterations
    if n_jobs != 1:
        from joblib import Parallel, delayed

        # A generator, so that the bar counts finished fits.
        gen = Parallel(n_jobs=n_jobs, prefer="threads",
                       return_as="generator")(
            delayed(clusterer.fit_predict_host)(fit_seed(h), x[indices[h]], k)
            for h in range(h_total)
        )
        return np.asarray(list(progress_iter(gen, desc=desc,
                                             enabled=progress)),
                          dtype=np.int64)
    labels = np.empty(indices.shape, dtype=np.int64)
    for h in progress_iter(range(h_total), desc=desc, enabled=progress):
        labels[h] = clusterer.fit_predict_host(fit_seed(h), x[indices[h]], k)
    return labels


def run_host_sweep(
    clusterer: HostClusterer,
    config: SweepConfig,
    x: np.ndarray,
    seed: int,
    progress: bool = True,
    n_jobs: int = 1,
    device=None,
) -> Dict[str, Any]:
    """The sweep with host labels: the result schema of
    :func:`..parallel.sweep.run_sweep`, whose ``timing`` adds
    ``label_seconds_per_k`` (the host fits) and ``accumulate_seconds_per_k``
    (the device's counts, Cij and histogram).
    ``compile_seconds`` is the kernel build (0 when built or on the CPU).
    """
    device = resolve_device(device)
    on_cuda = device.type == "cuda"
    n = config.n_samples
    x = np.asarray(x)
    compile_seconds = build_kernels(device)
    with peak_memory_window(device):
        launches0 = launch_counts()
        t0 = time.perf_counter()
        key_resample = rng.split(rng.prng_key(seed, device))[0]
        indices_dev = resample_indices(
            key_resample, n, config.n_iterations, config.n_sub
        )
        iij = cosample_counts(indices_dev, n)
        indices = indices_dev.cpu().numpy()

        counts, mijs, cijs = [], [], []
        label_seconds, accumulate_seconds = [], []
        for k in config.k_values:
            t_label = time.perf_counter()
            labels = _host_labels(clusterer, config, x, indices, k, seed,
                                  progress, n_jobs)
            label_seconds.append(time.perf_counter() - t_label)
            t_acc = time.perf_counter()
            mij = coassociation_counts(
                torch.as_tensor(labels, device=device), indices_dev, n,
                config.k_max, config.chunk_size,
            )
            cij = consensus_matrix(mij, iij)
            counts.append(consensus_hist_counts(cij, n, 0, config.bins))
            if config.store_matrices:
                mijs.append(mij.cpu().numpy())
                cijs.append(cij.cpu().numpy())
            if on_cuda:
                torch.cuda.synchronize(device)
            accumulate_seconds.append(time.perf_counter() - t_acc)
        out = curves_from_counts(config, counts)
        host = {name: value.cpu().numpy() for name, value in out.items()}
        if config.store_matrices:
            host["iij"] = iij.cpu().numpy()
            host["mij"] = np.stack(mijs)
            host["cij"] = np.stack(cijs)
        if on_cuda:
            torch.cuda.synchronize(device)
        run_seconds = time.perf_counter() - t0
        total = config.n_iterations * len(config.k_values)
        host["timing"] = {
            "compile_seconds": compile_seconds,
            "run_seconds": run_seconds,
            "resamples_per_second": total / max(run_seconds, 1e-9),
            "label_seconds_per_k": label_seconds,
            "accumulate_seconds_per_k": accumulate_seconds,
            "device": (
                torch.cuda.get_device_name(device) if on_cuda else "cpu"
            ),
            "device_memory": device_memory_stats(device) if on_cuda else {},
            "kernel_launches": launches_since(launches0),
        }
        return host
