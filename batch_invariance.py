#!/usr/bin/env python3
"""Does a lane's result depend on the lanes batched with it, on one GPU?

Run from the repository root on a machine with an NVIDIA GPU:
``python3 batch_invariance.py``.  Two parts, each printing JSON lines:

1. ops: the batched linear algebra the clusterers call (``eigh``, ``svd``,
   ``qr``, ``matmul``) at the shapes they use, on 50 random lanes; for
   each, the batch sizes (of 1, 2, 3, 5, 16) whose results differ in any
   bit from the same lanes inside the batch of 50.
2. clusterers: KMeans (make_blobs N=5000 d=50, H=33), the Gaussian
   mixture (N=2000 d=16, H=33), agglomerative (corr.csv, H=33) and
   spectral (N=2000 d=16, H=9) fitted with ``cluster_batch`` None, 16, 2
   and 1; per K, whether Mij equals the one-batch fit's.  Labels must be a pure
   per-resample function, so every grouping must give the same counts.

The card's name and power limit (nvidia-smi) come first; a machine
without CUDA exits non-zero.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj):
    print(json.dumps(obj), flush=True)


def part_ops(torch):
    g = torch.Generator(device="cuda").manual_seed(0)

    def differing(fn, inputs):
        full = fn(*inputs)
        bad = []
        for b in (1, 2, 3, 5, 16):
            part = fn(*[t[:b] for t in inputs])
            if not all(torch.equal(p, f[:b]) for p, f in zip(part, full)):
                bad.append(b)
        return bad

    for n in (10, 20, 30, 60):
        m = torch.randn(50, n, n, generator=g, device="cuda")
        m = m + m.transpose(1, 2)
        t = torch.randn(50, 2 * n, n, generator=g, device="cuda")
        for name, fn, args in (("eigh", torch.linalg.eigh, [m]),
                               ("svd", torch.linalg.svd, [m]),
                               ("qr", torch.linalg.qr, [t])):
            emit({"part": "ops", "op": name, "shape": list(args[0].shape[1:]),
                  "differing_batch_sizes": differing(fn, args)})
    for n, w in ((1600, 30), (1600, 10), (400, 90)):
        a = torch.randn(50, n, n, generator=g, device="cuda")
        x = torch.randn(50, n, w, generator=g, device="cuda")
        for name, fn, args in (
                (f"{n}x{n} @ {n}x{w}", lambda a, x: (a @ x,), [a, x]),
                (f"{w}x{n} @ {n}x{w}",
                 lambda x: (x.transpose(1, 2) @ x,), [x])):
            emit({"part": "ops", "op": "matmul " + name,
                  "differing_batch_sizes": differing(fn, args)})


def part_clusterers():
    from consensus_clustering_tpu_torch import (
        AgglomerativeClustering,
        ConsensusClustering,
        GaussianMixture,
        KMeans,
        SpectralClustering,
        load_corr,
        make_blobs,
    )

    def blobs(n, d):
        return make_blobs(n_samples=n, n_features=d, centers=8,
                          cluster_std=3.0, random_state=0)[0].astype(
                              np.float32)

    ks = range(2, 11)
    for name, clusterer, x, h in (
            ("kmeans", KMeans(n_init=3), blobs(5000, 50), 33),
            ("gmm", GaussianMixture(n_init=2), blobs(2000, 16), 33),
            ("agglomerative", AgglomerativeClustering("average"),
             load_corr(transform=True), 33),
            ("spectral", SpectralClustering(gamma=0.02, solver="lobpcg"),
             blobs(2000, 16), 9)):
        fits = {batch: ConsensusClustering(
            clusterer=clusterer, clusterer_options={}, K_range=ks,
            n_iterations=h, random_state=23, store_matrices=True,
            cluster_batch=batch, progress=False, plot_cdf=False).fit(x)
            for batch in (None, 16, 2, 1)}
        for batch in (16, 2, 1):
            emit({"part": "clusterers", "clusterer": name, "H": h,
                  "cluster_batch": batch, "mij_equal_to_one_batch_per_k": [
                      bool(np.array_equal(fits[None].cdf_at_K_data[k]["mij"],
                                          fits[batch].cdf_at_K_data[k]["mij"]))
                      for k in ks]})


def main():
    import torch

    if not torch.cuda.is_available():
        print("batch_invariance: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    part_ops(torch)
    part_clusterers()
    return 0


if __name__ == "__main__":
    sys.exit(main())
