"""The sklearn-shaped API: ``ConsensusClustering(...).fit(X)``.

The port of the reference package's ``api.py`` for its single-device
paths: the monolithic sweep and, with ``stream_h_block``, the streaming
H-block engine, each dense or packed (``accum_repr``); the same constructor
arguments for what these paths do, the same ``cdf_at_K_data`` result schema
(``consensus_labels, hist, cdf, bin_edges, pac_area, mij, iij, cij`` per
K), and ``areas_``, ``delta_k_``, ``best_k_`` and ``metrics_`` (with
``streaming`` for a streamed fit).  ``fit`` runs on ``cuda`` unless
``device`` says otherwise, and raises without a GPU when no device is
given.

``checkpoint_dir`` saves each K as it lands and resumes only the missing
Ks (:class:`.utils.checkpoint.SweepCheckpoint`); a streamed fit also keeps
a ring of block checkpoints under ``<checkpoint_dir>/stream`` and resumes
mid-stream, bit for bit.  ``integrity_check_every`` runs the accumulator
sentinel in streamed fits, and ``progress_callback(k, pac)`` is called once
per K, in K order.

Features of the reference package that this package does not have yet
raise ``NotImplementedError`` naming the ROADMAP item that ports them:
host/sklearn clusterers and consensus labels (A8), ``mode`` other than
``exact`` (A9), ``autotune`` (A12), ``mesh`` (A13) and plotting (A15).
Unlike the reference, ``plot_cdf`` defaults to False.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional

import numpy as np

from consensus_clustering_tpu_torch.config import (
    SweepConfig,
    not_ported,
    validate_accum_repr,
    validate_fuse_block,
)
from consensus_clustering_tpu_torch.device import resolve_device
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.ops.analysis import (
    area_under_cdf,
    bin_edges,
    delta_k,
    select_best_k,
)

logger = logging.getLogger(__name__)

_DEFAULT_CLUSTERER_OPTIONS = {"n_init": 3}
_DELTA_K_THRESHOLD = 0.05


class ConsensusClustering:
    """Monti-style consensus clustering on one GPU.

    Parameters
    ----------
    clusterer : optional
        A batched clusterer (``KMeans()``); None selects KMeans.  Host
        (sklearn) clusterers are not ported (ROADMAP A8).
    clusterer_options : dict, optional
        Fields replaced on the clusterer (default ``{'n_init': 3}``).
    K_range, n_iterations, subsampling, random_state, PAC_interval,
    consensus_matrix_analysis, agg_clustering_linkage : as the reference.
    plot_cdf : bool
        Must be False: plotting is not ported (ROADMAP A15).
    n_jobs, parallelization_method, memmap_folder :
        accepted for API compatibility and ignored.
    device : keyword-only
        Torch device; None means ``cuda`` (raises without a GPU).
    store_matrices : bool or 'auto', keyword-only
        Keep per-K ``mij``/``cij`` and ``iij``; 'auto' keeps them while the
        stacked matrices stay under ~2 GB, and never under ``adaptive_tol``.
    stream_h_block : int, keyword-only, optional
        Run the streaming engine over blocks of this many resamples (see
        :mod:`.parallel.streaming`); None runs the monolithic sweep.  The
        full-H result is the same bit for bit.
    accum_repr : {'dense', 'packed'}, keyword-only
        int32 (N, N) counts, or bit-planes counted by the popcount kernel
        (the same counts; with streaming, 1/32 the state).
    fuse_block : {'auto', 'on', 'off'}, keyword-only
        Packed streaming only: fuse the final assignment with the packing.
    adaptive_tol, adaptive_patience, adaptive_min_h : keyword-only
        With ``stream_h_block``: stop once every K's PAC moved less than
        ``adaptive_tol`` for ``adaptive_patience`` blocks, after
        ``adaptive_min_h`` resamples; ``metrics_['streaming']`` reports
        ``h_effective``.
    use_packed_kernel : None or True, keyword-only
        Accepted for compatibility: the popcount kernel always serves the
        card (False raises).
    parity_zeros, bins, chunk_size, cluster_batch, split_init,
    reseed_clusterer_per_resample, delta_k_threshold : keyword-only,
        as the reference (see :class:`~.config.SweepConfig`).
    compute_dtype : keyword-only
        "float32", or "float64" on the CPU (the parity path).
    integrity_check_every : int, keyword-only
        Streamed fits: run the accumulator invariant sentinel every that
        many blocks (0: off); a breach raises ``IntegrityError``.
    checkpoint_dir : str, keyword-only, optional
        Per-K checkpoints (and, streamed, a block ring under ``stream/``):
        a re-fit with the same arguments runs only what is missing.
    progress_callback : keyword-only, optional
        ``cb(k, pac)`` once per computed K, in K order.
    """

    def __init__(
        self,
        clusterer=None,
        clusterer_options: Optional[Dict[str, Any]] = None,
        K_range=(2, 3),
        n_iterations: int = 25,
        subsampling: float = 0.8,
        random_state: Optional[int] = None,
        consensus_matrix_analysis: str = "PAC",
        PAC_interval=(0.1, 0.9),
        plot_cdf: bool = False,
        agg_clustering_linkage: str = "average",
        n_jobs: int = 1,
        parallelization_method: str = "multithreading",
        memmap_folder=None,
        *,
        device=None,
        store_matrices="auto",
        parity_zeros: bool = True,
        bins: int = 20,
        chunk_size: int = 8,
        cluster_batch: Optional[int] = None,
        split_init: bool = False,
        reseed_clusterer_per_resample: bool = False,
        compute_dtype: str = "float32",
        delta_k_threshold: float = _DELTA_K_THRESHOLD,
        compute_consensus_labels: bool = False,
        mesh=None,
        stream_h_block: Optional[int] = None,
        accum_repr: str = "dense",
        use_packed_kernel: Optional[bool] = None,
        fuse_block: str = "auto",
        adaptive_tol: Optional[float] = None,
        adaptive_patience: int = 2,
        adaptive_min_h: int = 0,
        integrity_check_every: int = 0,
        mode: str = "exact",
        checkpoint_dir: Optional[str] = None,
        autotune: bool = False,
        progress_callback=None,
    ):
        if plot_cdf:
            raise not_ported("plot_cdf=True (plotting)", "A15")
        if compute_consensus_labels:
            raise not_ported("compute_consensus_labels", "A8")
        if mesh is not None:
            raise not_ported("mesh (multi-device sweeps)", "A13")
        if mode != "exact":
            raise not_ported(f"mode={mode!r} (the pair estimator)", "A9")
        if autotune:
            raise not_ported("autotune", "A12")
        if consensus_matrix_analysis not in ("PAC", "delta_k"):
            raise ValueError(
                f"consensus_matrix_analysis={consensus_matrix_analysis!r} "
                "not supported (choose 'PAC' or 'delta_k')"
            )
        if delta_k_threshold < 0:
            raise ValueError(
                f"delta_k_threshold must be >= 0, got {delta_k_threshold}"
            )
        self.clusterer = clusterer
        self.clusterer_options = (
            dict(_DEFAULT_CLUSTERER_OPTIONS)
            if clusterer_options is None else dict(clusterer_options)
        )
        self.K_range = K_range
        self.n_iterations = n_iterations
        self.subsampling = subsampling
        self.random_state = random_state
        self.consensus_matrix_analysis = consensus_matrix_analysis
        self.PAC_interval = tuple(PAC_interval)
        self.plot_cdf = plot_cdf
        self.agg_clustering_linkage = agg_clustering_linkage
        self.n_jobs = n_jobs
        self.parallelization_method = parallelization_method
        self.memmap_folder = memmap_folder
        self.device = device
        self.store_matrices = store_matrices
        self.parity_zeros = parity_zeros
        self.bins = bins
        self.chunk_size = chunk_size
        self.cluster_batch = cluster_batch
        self.split_init = split_init
        self.reseed_clusterer_per_resample = reseed_clusterer_per_resample
        self.compute_dtype = compute_dtype
        self.delta_k_threshold = float(delta_k_threshold)
        self.stream_h_block = stream_h_block
        self.accum_repr = validate_accum_repr(accum_repr)
        self.use_packed_kernel = use_packed_kernel
        self.fuse_block = validate_fuse_block(fuse_block)
        self.adaptive_tol = adaptive_tol
        self.adaptive_patience = adaptive_patience
        self.adaptive_min_h = adaptive_min_h
        self.integrity_check_every = integrity_check_every
        self.checkpoint_dir = checkpoint_dir
        self.progress_callback = progress_callback

    def _resolve_clusterer(self):
        c = KMeans() if self.clusterer is None else self.clusterer
        if hasattr(c, "get_params") or not hasattr(c, "fit_predict"):
            raise not_ported(
                f"clusterer {type(c).__name__} (host/sklearn clusterers)",
                "A8",
            )
        options = self.clusterer_options
        if not options:
            return c
        fields = {f.name for f in dataclasses.fields(c)}
        unknown = set(options) - fields
        if unknown:
            raise ValueError(
                f"invalid clusterer option(s) {sorted(unknown)} for "
                f"{type(c).__name__}; valid: {sorted(fields)}"
            )
        return dataclasses.replace(c, **options)

    def _accumulator_dtype(self):
        """The reference's uint8/uint16 rule, uint32 beyond 2^16."""
        if self.n_iterations < 2**8:
            return np.uint8
        if self.n_iterations < 2**16:
            return np.uint16
        return np.uint32

    def _resolve_store_matrices(self, n: int) -> bool:
        if self.store_matrices == "auto":
            if self.adaptive_tol is not None:
                # Adaptive streaming is curves-only; an explicit True still
                # reaches SweepConfig's ValueError.
                return False
            approx_bytes = 2 * len(tuple(self.K_range)) * n * n * 4
            return approx_bytes < 2 * 2**30
        return bool(self.store_matrices)

    def fit(self, X):
        """Run the consensus sweep; fills ``cdf_at_K_data`` and returns
        self."""
        if self.random_state is None:
            raise ValueError(
                "random_state must be an integer seed: the resample plan is "
                "a pure function of it"
            )
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D, got shape {X.shape}")
        from consensus_clustering_tpu_torch.resilience.integrity import (
            check_input_matrix,
        )

        problem = check_input_matrix(X)
        if problem is not None:
            raise ValueError(f"{problem['error']} — {problem['hint']}")
        n, d = X.shape
        config = SweepConfig(
            n_samples=n,
            n_features=d,
            k_values=tuple(self.K_range),
            n_iterations=self.n_iterations,
            subsampling=self.subsampling,
            bins=self.bins,
            pac_interval=self.PAC_interval,
            parity_zeros=self.parity_zeros,
            store_matrices=self._resolve_store_matrices(n),
            chunk_size=self.chunk_size,
            cluster_batch=self.cluster_batch,
            split_init=bool(self.split_init),
            reseed_clusterer_per_resample=self.reseed_clusterer_per_resample,
            stream_h_block=self.stream_h_block,
            adaptive_tol=self.adaptive_tol,
            adaptive_patience=self.adaptive_patience,
            adaptive_min_h=self.adaptive_min_h,
            accum_repr=self.accum_repr,
            use_packed_kernel=self.use_packed_kernel,
            fuse_block=self.fuse_block,
            integrity_check_every=self.integrity_check_every,
            dtype=self.compute_dtype,
        )
        ckpt = None
        loaded: Dict[int, Dict[str, np.ndarray]] = {}
        missing = list(config.k_values)
        if self.checkpoint_dir is not None:
            from consensus_clustering_tpu_torch.utils.checkpoint import (
                SweepCheckpoint,
                backend_tag,
            )

            ckpt = SweepCheckpoint(
                self.checkpoint_dir, config, self.random_state,
                backend_tag(resolve_device(self.device)),
            )
            for k in config.k_values:
                entry = ckpt.load_k(k)
                if entry is not None:
                    loaded[k] = entry
            missing = [k for k in config.k_values if k not in loaded]
        out, entries = None, {}
        if missing:
            out, entries = self._run(X, dataclasses.replace(
                config, k_values=tuple(missing)), ckpt)
        self._build_results(out, entries, config, loaded)
        return self

    def _run(self, X, config: SweepConfig, ckpt):
        """Sweep ``config``'s Ks: the sweep's ``out`` and its per-K
        entries, each saved to ``ckpt`` as soon as the sweep returns (and
        only then is the block ring cleared)."""
        clusterer = self._resolve_clusterer()
        ring = None
        if config.stream_h_block is None:
            from consensus_clustering_tpu_torch.parallel.sweep import (
                run_sweep,
            )

            out = run_sweep(clusterer, config, X, self.random_state,
                            device=self.device,
                            progress_callback=self.progress_callback)
        else:
            from consensus_clustering_tpu_torch.parallel.streaming import (
                run_streaming_sweep,
            )
            from consensus_clustering_tpu_torch.resilience.blocks import (
                StreamCheckpointer,
            )

            if self.checkpoint_dir is not None:
                ring = StreamCheckpointer(
                    os.path.join(self.checkpoint_dir, "stream"))
            try:
                out = run_streaming_sweep(
                    clusterer, config, X, self.random_state,
                    device=self.device, checkpointer=ring,
                )
            finally:
                # Closed whatever happens; cleared only after the per-K
                # save below: a ring that survives a crash is the point.
                if ring is not None:
                    ring.close()
            if self.progress_callback is not None:
                for i, k in enumerate(config.k_values):
                    self.progress_callback(int(k), float(out["pac_area"][i]))
        entries = self._entries(out, config)
        if ckpt is not None:
            for k in config.k_values:
                ckpt.save_k(k, entries[k])
            if ring is not None:
                ring.clear()
        return out, entries

    def _entries(self, out: Dict[str, Any], config: SweepConfig):
        """Per-K result entries (the reference's schema) of one sweep."""
        acc_dtype = self._accumulator_dtype()
        edges = bin_edges(config.bins)
        iij = out["iij"].astype(acc_dtype) if config.store_matrices else None
        entries = {}
        for i, k in enumerate(config.k_values):
            entry = {
                "consensus_labels": [],
                "hist": out["hist"][i].astype(np.float64),
                "cdf": out["cdf"][i].astype(np.float64),
                "bin_edges": edges,
                "pac_area": float(out["pac_area"][i]),
                "mij": None, "iij": None, "cij": None,
            }
            if config.store_matrices:
                entry["mij"] = out["mij"][i].astype(acc_dtype)
                entry["iij"] = iij
                entry["cij"] = out["cij"][i]
            entries[k] = entry
        return entries

    def _build_results(self, out: Optional[Dict[str, Any]],
                       entries: Dict[int, Dict[str, Any]],
                       config: SweepConfig,
                       loaded: Dict[int, Dict[str, np.ndarray]]):
        """``cdf_at_K_data`` in ``config``'s K order from the sweep's
        ``entries`` and the ``loaded`` checkpoints; ``metrics_`` of the
        sweep's ``out``, or of a fit resumed in full (``out`` None)."""
        edges = bin_edges(config.bins)
        entries = dict(entries)
        for k, saved in loaded.items():
            entries[k] = {
                "consensus_labels": [],
                "hist": saved["hist"].astype(np.float64),
                "cdf": saved["cdf"].astype(np.float64),
                "bin_edges": edges,
                "pac_area": float(saved["pac_area"]),
                "mij": saved.get("mij"),
                "iij": saved.get("iij"),
                "cij": saved.get("cij"),
            }
        entries = {k: entries[k] for k in config.k_values}
        self.cdf_at_K_data = entries
        ks = list(config.k_values)
        self.areas_ = np.asarray(
            [area_under_cdf(entries[k]["cdf"]) for k in ks], dtype=np.float64
        )
        self.delta_k_ = delta_k(self.areas_)
        mode = self.consensus_matrix_analysis
        self.best_k_ = select_best_k(
            mode, ks,
            [entries[k]["pac_area"] for k in ks] if mode == "PAC" else None,
            delta_k_gains=self.delta_k_,
            delta_k_threshold=self.delta_k_threshold,
        )
        if out is None:
            # Resumed in full: no compute ran, so there is no rate (None,
            # not inf: json.dumps would write the non-standard Infinity).
            self.metrics_ = {
                "compile_seconds": 0.0, "run_seconds": 0.0,
                "resamples_per_second": None,
                "resumed_from_checkpoint": True,
            }
            return
        timing = out["timing"]
        self.metrics_ = {
            "compile_seconds": timing["compile_seconds"],
            "run_seconds": timing["run_seconds"],
            "resamples_per_second": timing["resamples_per_second"],
            "n_batches": 1,
            "device": timing["device"],
            "kernel_launches": timing["kernel_launches"],
        }
        if loaded:
            self.metrics_["resumed_ks"] = sorted(int(k) for k in loaded)
        if timing["device_memory"]:
            self.metrics_["device_memory"] = timing["device_memory"]
        strategy = {
            key: timing[key]
            for key in ("packed_kernel", "fuse_block", "fused_kernel")
            if key in timing
        }
        if strategy:
            self.metrics_["timing"] = strategy
        if "streaming" in out:
            self.metrics_["streaming"] = out["streaming"]
