"""Consensus clustering in PyTorch with hand-written CUDA kernels for Hopper.

A second implementation of the ``consensus_clustering_tpu`` package's
single-device ``ConsensusClustering`` (``fit``, ``fit_predict``): the same
resample plan (the counter-based generator in :mod:`.rng` reproduces
``jax.random`` bit for bit), the same inner clusterers (KMeans, Gaussian
mixture, agglomerative, spectral, and sklearn estimators on the host
backend), the same exact integer co-association and co-sampling counts,
monolithic or streamed, dense or packed, and the same CDF/PAC analysis.
Its kernels are written by hand in CUDA C++ (``csrc/``) and built with
``nvcc`` at first use: the consensus histogram (:mod:`.ops.hist`), the
Lloyd step (:mod:`.ops.lloyd`), the popcount counts (:mod:`.ops.popcount`)
and the final assignment, alone and fused with packing
(:mod:`.ops.fused_block`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
CPU tensors every kernel wrapper takes its plain PyTorch version.  The
command line is ``python -m consensus_clustering_tpu_torch run | serve |
serve-admin | lint | autotune`` (:mod:`.cli`); figures come from
:mod:`.utils.plotting` (matplotlib, imported when a figure is drawn) and
the static analyser from :mod:`.lint`.  The package imports neither
``jax`` nor ``consensus_clustering_tpu``.

Importing the package pins full-f32 matrix products: every distance GEMM of
the reference runs at ``Precision.HIGHEST``, and TF32 keeps ten mantissa bits.
"""

import importlib

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

_EXPORTS = {
    "ConsensusClustering": "consensus_clustering_tpu_torch.api",
    "SweepConfig": "consensus_clustering_tpu_torch.config",
    "KMeans": "consensus_clustering_tpu_torch.models.kmeans",
    "GaussianMixture": "consensus_clustering_tpu_torch.models.gmm",
    "AgglomerativeClustering":
        "consensus_clustering_tpu_torch.models.agglomerative",
    "SpectralClustering": "consensus_clustering_tpu_torch.models.spectral",
    "load_corr": "consensus_clustering_tpu_torch.data",
    "make_blobs": "consensus_clustering_tpu_torch.data",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(_EXPORTS[name])
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
