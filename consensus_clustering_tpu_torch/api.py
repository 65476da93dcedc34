"""The sklearn-shaped API: ``ConsensusClustering(...).fit(X)``.

The port of the reference package's ``api.py`` for its single-device
paths, with every keyword of the reference constructor (the port adds
``device``):

- device clusterers (:class:`~.models.kmeans.KMeans`,
  :class:`~.models.gmm.GaussianMixture`,
  :class:`~.models.agglomerative.AgglomerativeClustering`,
  :class:`~.models.spectral.SpectralClustering`) run the monolithic sweep
  or, with ``stream_h_block``, the streaming H-block engine, each dense or
  packed (``accum_repr``);
- host clusterers (any sklearn estimator with ``fit_predict`` and
  ``get_params``, or a :class:`~.models.protocol.HostClusterer`) run the
  host backend (:mod:`.parallel.host`): labels on the host, counts and
  analysis on the device;
- ``k_batch_size`` runs K in batches (a checkpoint and a
  ``k_batch_complete`` event after each), ``metrics_path`` writes the
  ``h_block_complete``, ``k_batch_complete`` and ``sweep_complete``
  events, ``profile_dir`` a ``torch.profiler`` trace of the sweep;
- ``compute_consensus_labels`` and :meth:`ConsensusClustering.fit_predict`
  give consensus labels from Cij (:func:`~.models.agglomerative.
  consensus_labels_from_cij`);
- ``autotune=True`` fills the unset performance knobs from the
  calibration store's parity-gated records (:mod:`.autotune`), and
  ``metrics_["autotune"]`` discloses each knob's provenance.

The result schema is the reference's: ``cdf_at_K_data`` (``consensus_labels,
hist, cdf, bin_edges, pac_area, mij, iij, cij`` per K, and with consensus
labels ``cluster_consensus`` and ``item_consensus``), ``areas_``,
``delta_k_``, ``best_k_`` and ``metrics_``.  ``fit`` runs on ``cuda``
unless ``device`` says otherwise, and raises without a GPU when no device
is given.

``checkpoint_dir`` saves each K as its batch lands and resumes only the
missing Ks (:class:`.utils.checkpoint.SweepCheckpoint`); a streamed fit
also keeps a ring of block checkpoints under ``<checkpoint_dir>/stream``
and resumes mid-stream, bit for bit.

``mode="estimate"`` runs the sampled-pair estimator
(:mod:`.estimator`: O(M) state, curves with a disclosed error bound in
``metrics_["estimator"]``) and ``exact_best_k`` refines the chosen K
exactly (:func:`.estimator.tiled.exact_curves_for_k`); ``mode="auto"``
takes the estimator when the exact job's footprint exceeds the memory
budget (:mod:`.serve.preflight`: ``CCTPU_MEMORY_BUDGET``, else the
device's memory).

``mesh`` (:func:`.parallel.resample_mesh`) shards the device engines over
a ('k', 'h', 'n') mesh, with ``k_interleave`` laying the K values out
round-robin over its k-groups; every mesh gives the one-device result bit
for bit.  A mesh across processes (after
:func:`.parallel.distributed.initialize`) takes the same ``fit`` in every
process: each ends with the same results, ``mode="auto"`` runs the
primary's resolution everywhere, only the primary writes
``checkpoint_dir``, and ``metrics_["processes"]`` counts the processes
(``device_memory`` is each process's own).

``plot_cdf`` defaults to True, as in the reference: at the end of every
``fit`` (exact, streamed, resumed, in K batches or estimated) the CDF fan
is drawn with :func:`.utils.plotting.plot_cdf` and shown, after
``sweep_complete`` is emitted.  matplotlib is imported only then, so
without it such a fit raises ``ImportError`` after the sweep, with its
results set.  Under a mesh across processes every process that calls
``fit`` draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import Any, Dict, Optional

import numpy as np

from consensus_clustering_tpu_torch.config import (
    MODES,
    SweepConfig,
    autotune_stream_block,
    validate_accum_repr,
    validate_fuse_block,
)
from consensus_clustering_tpu_torch.device import resolve_device
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.models.protocol import (
    Clusterer,
    HostClusterer,
)
from consensus_clustering_tpu_torch.models.sklearn_adapter import (
    SklearnClusterer,
)
from consensus_clustering_tpu_torch.obs.tracing import (
    recording_ranges,
    region,
)
from consensus_clustering_tpu_torch.ops.analysis import (
    area_under_cdf,
    bin_edges,
    delta_k,
    select_best_k,
)
from consensus_clustering_tpu_torch.parallel.mesh import (
    KSHARD_AXIS,
    Mesh,
    engine_mesh,
)
from consensus_clustering_tpu_torch.utils.metrics import MetricsLogger

logger = logging.getLogger(__name__)

_DEFAULT_CLUSTERER_OPTIONS = {"n_init": 3}
_DELTA_K_THRESHOLD = 0.05


def _apply_options(clusterer: Any, options: Dict[str, Any]) -> Any:
    """``clusterer_options`` on a dataclass clusterer, refusing unknown
    fields as sklearn's ``set_params`` would."""
    if not options:
        return clusterer
    if not dataclasses.is_dataclass(clusterer):
        raise TypeError(
            f"cannot apply clusterer_options to {type(clusterer).__name__}"
        )
    fields = {f.name for f in dataclasses.fields(clusterer)}
    unknown = set(options) - fields
    if unknown:
        raise ValueError(
            f"invalid clusterer option(s) {sorted(unknown)} for "
            f"{type(clusterer).__name__}; valid: {sorted(fields)}"
        )
    return dataclasses.replace(clusterer, **options)


class ConsensusClustering:
    """Monti-style consensus clustering on one GPU.

    Parameters
    ----------
    clusterer : optional
        A device clusterer (``KMeans()``, ``GaussianMixture()``,
        ``AgglomerativeClustering()``, ``SpectralClustering()``), a host
        clusterer, or an sklearn estimator with ``fit_predict`` and an
        ``n_clusters``/``n_components`` attribute (the host backend).
        None selects KMeans.
    clusterer_options : dict, optional
        Fields replaced on the clusterer (default ``{'n_init': 3}``, which
        is dropped for a clusterer without ``n_init``).
    K_range, n_iterations, subsampling, random_state, PAC_interval,
    consensus_matrix_analysis, agg_clustering_linkage : as the reference.
    plot_cdf : bool
        Draw (and show) the per-K CDF fan at the end of ``fit``, as the
        reference does (default True); every process of a mesh across
        processes draws its own.
    n_jobs : int
        Threads for the host backend's labelling loop.
    parallelization_method, memmap_folder :
        accepted for API compatibility and ignored.
    device : keyword-only
        Torch device; None means ``cuda`` (raises without a GPU).
    store_matrices : bool or 'auto', keyword-only
        Keep per-K ``mij``/``cij`` and ``iij``; 'auto' keeps them while the
        stacked matrices stay under ~2 GB, and never under ``adaptive_tol``.
    compute_consensus_labels : bool, keyword-only
        Per-K consensus labels from Cij (agglomeration of ``1 - Cij`` up to
        4096 items, spectral above), with Monti's ``cluster_consensus`` and
        ``item_consensus``; needs the matrices.
    stream_h_block : int, keyword-only, optional
        Run the streaming engine over blocks of this many resamples (see
        :mod:`.parallel.streaming`); None runs the monolithic sweep.  The
        full-H result is the same bit for bit.  Ignored (logged) on the
        host backend, as are ``accum_repr`` and ``progress_callback``.
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
    use_packed_kernel, use_pallas : None or True, keyword-only
        Accepted for compatibility: the card always runs the kernels
        (False raises).
    k_batch_size : int, keyword-only, optional
        Run K in batches of this many values, saving the per-K checkpoint
        and emitting ``k_batch_complete`` after each; the results are the
        one-batch fit's bit for bit.
    metrics_path : str, keyword-only, optional
        Append JSON-lines events (``h_block_complete``,
        ``k_batch_complete``, ``sweep_complete``) to this file.
    progress : bool, keyword-only
        tqdm bars per K on the host backend.
    profile_dir : str, keyword-only, optional
        Write a ``torch.profiler`` trace of the sweep into this directory.
    parity_zeros, bins, chunk_size, cluster_batch, split_init,
    reseed_clusterer_per_resample, delta_k_threshold : keyword-only,
        as the reference (see :class:`~.config.SweepConfig`).
        ``split_init`` None means unset: False unless ``autotune``
        resolves a calibrated verdict.
    compute_dtype : keyword-only
        "float32", or "float64" on the CPU (the parity path).
    integrity_check_every : int, keyword-only
        Streamed fits: run the accumulator invariant sentinel every that
        many blocks (0: off); a breach raises ``IntegrityError``.
    checkpoint_dir : str, keyword-only, optional
        Per-K checkpoints (and, streamed, a block ring under ``stream/``):
        a re-fit with the same arguments runs only what is missing.
    progress_callback : keyword-only, optional
        ``cb(k, pac)`` once per computed K, in K order (device paths).
    mode : {'exact', 'estimate', 'auto'}, keyword-only
        ``estimate`` runs the sampled-pair estimator (needs
        ``store_matrices`` not True, no consensus labels, a device
        clusterer); ``auto`` picks it when the exact job's footprint
        (:func:`.serve.preflight.estimate_job_bytes`) exceeds the budget
        (:func:`.serve.preflight.resolve_memory_budget`), and ``exact``
        where the estimator cannot run.  ``metrics_['mode']`` and
        ``metrics_['estimator']`` (the disclosed bound) report it.
    n_pairs : int, keyword-only, optional
        Pairs the estimator samples (default 2^17, capped at the
        population); only with ``mode`` 'estimate' or 'auto'.
    exact_best_k : bool, keyword-only
        With the estimator: recompute the chosen K's curves exactly over
        the resamples the estimate ran (``metrics_['exact_best_k']``).
    autotune : bool, keyword-only
        Fill UNSET performance knobs (``cluster_batch``, ``split_init``,
        ``stream_h_block``, and the default KMeans clusterer's
        ``max_iter``) from the calibration store's parity-gated records
        for this environment × shape bucket.  Only bit-identical-gated
        knobs are filled — the statistic cannot move — and never a knob
        you set yourself (user pins outrank calibration).  A calibrated
        ``stream_h_block`` is adopted only where its record measured
        streaming faster than the monolithic sweep.
        ``metrics_["autotune"]`` discloses every resolution with its
        provenance tier (``user-pinned`` > ``calibrated`` > ``default``).
        A no-op (logged) for host-backend clusterers, whose labelling
        loop none of these knobs steer.
    calibration_dir : str, keyword-only, optional
        Calibration store for ``autotune=True`` (default:
        ``CCTPU_CALIBRATION_DIR``; without either, every knob resolves
        to its user-pinned or default tier).
    mesh : Mesh, keyword-only, optional
        Device mesh (:func:`.parallel.resample_mesh`) the device engines
        shard resamples, rows and K values over; default the one device
        ``device``.  ``device``, if also given, must be its primary device.
        The host backend ignores it.  The estimator takes a mesh without a
        'k' axis.
    k_interleave : bool, keyword-only
        With a 'k'-sharded mesh, give the k-groups the K values
        round-robin instead of in contiguous blocks; results are
        identical.
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
        plot_cdf: bool = True,
        agg_clustering_linkage: str = "average",
        n_jobs: int = 1,
        parallelization_method: str = "multithreading",
        memmap_folder=None,
        *,
        device=None,
        mesh=None,
        store_matrices="auto",
        parity_zeros: bool = True,
        bins: int = 20,
        chunk_size: int = 8,
        cluster_batch: Optional[int] = None,
        split_init: Optional[bool] = None,
        k_interleave: bool = False,
        compute_consensus_labels: bool = False,
        reseed_clusterer_per_resample: bool = False,
        checkpoint_dir: Optional[str] = None,
        progress: bool = True,
        progress_callback=None,
        profile_dir: Optional[str] = None,
        use_pallas: Optional[bool] = None,
        metrics_path: Optional[str] = None,
        k_batch_size: Optional[int] = None,
        compute_dtype: str = "float32",
        delta_k_threshold: float = _DELTA_K_THRESHOLD,
        stream_h_block: Optional[int] = None,
        accum_repr: str = "dense",
        use_packed_kernel: Optional[bool] = None,
        fuse_block: str = "auto",
        adaptive_tol: Optional[float] = None,
        adaptive_patience: int = 2,
        adaptive_min_h: int = 0,
        integrity_check_every: int = 0,
        autotune: bool = False,
        calibration_dir: Optional[str] = None,
        mode: str = "exact",
        n_pairs: Optional[int] = None,
        exact_best_k: bool = False,
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh must be a consensus_clustering_tpu_torch Mesh "
                f"(parallel.resample_mesh), got {type(mesh).__name__}"
            )
        if mode == "progressive":
            raise ValueError(
                "mode='progressive' is a serving mode (POST /jobs), "
                "not a library mode — use 'estimate' here and refine "
                "the chosen K with estimator.tiled.exact_curves_for_k"
            )
        if mode not in MODES:
            raise ValueError(f"mode must be one of {list(MODES)}, got {mode!r}")
        if n_pairs is not None:
            if (isinstance(n_pairs, bool) or not isinstance(n_pairs, int)
                    or n_pairs < 1):
                raise ValueError(
                    f"n_pairs must be an int >= 1 or None, got {n_pairs!r}"
                )
            if mode == "exact":
                raise ValueError(
                    "n_pairs only applies with mode='estimate' or 'auto'"
                )
        if use_pallas is False:
            raise ValueError(
                "use_pallas=False would run the kernels' plain versions on "
                "the card, a fallback the port does not take (pass None)"
            )
        if consensus_matrix_analysis not in ("PAC", "delta_k"):
            raise ValueError(
                f"consensus_matrix_analysis={consensus_matrix_analysis!r} "
                "not supported (choose 'PAC' or 'delta_k')"
            )
        if delta_k_threshold < 0:
            raise ValueError(
                f"delta_k_threshold must be >= 0, got {delta_k_threshold}"
            )
        if k_batch_size is not None and k_batch_size < 1:
            raise ValueError(f"k_batch_size must be >= 1, got {k_batch_size}")
        if n_jobs != 1 or parallelization_method != "multithreading":
            logger.info(
                "n_jobs=%s applies only to the host backend's labelling "
                "threads; parallelization_method=%r is ignored",
                n_jobs, parallelization_method,
            )
        if memmap_folder is not None:
            logger.info("memmap_folder is ignored: counts stay on the device")
        self.clusterer = clusterer
        self._options_defaulted = clusterer_options is None
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
        self.mesh = mesh
        self.k_interleave = bool(k_interleave)
        self.store_matrices = store_matrices
        self.parity_zeros = parity_zeros
        self.bins = bins
        self.chunk_size = chunk_size
        self.cluster_batch = cluster_batch
        self.split_init = split_init
        self.compute_consensus_labels = compute_consensus_labels
        self.reseed_clusterer_per_resample = reseed_clusterer_per_resample
        self.checkpoint_dir = checkpoint_dir
        self.progress = progress
        self.progress_callback = progress_callback
        self.profile_dir = profile_dir
        self.use_pallas = use_pallas
        self.metrics_path = metrics_path
        self.k_batch_size = k_batch_size
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
        self.autotune = bool(autotune)
        self.calibration_dir = calibration_dir
        self.mode = mode
        self.n_pairs = n_pairs
        self.exact_best_k = bool(exact_best_k)
        # Calibrated clusterer options (the default KMeans' max_iter):
        # set by the fit-time resolution, merged by _effective_options
        # without outranking anything explicit.
        self._autotune_options: Dict[str, Any] = {}
        self.autotune_ = None

    # -- clusterer resolution -------------------------------------------

    def _resolve_clusterer(self):
        """(clusterer, is_host)."""
        c = self.clusterer
        if c is None:
            logger.info("KMeans is set as default clusterer")
            c = KMeans()
        options = self._effective_options(c)
        if isinstance(c, HostClusterer):
            if isinstance(c, SklearnClusterer) and options:
                c = SklearnClusterer(c.estimator, {**c.options, **options})
            return c, True
        # sklearn also spells its entry point fit_predict, so the estimator
        # fingerprint get_params is checked before the device protocol.
        if hasattr(c, "fit_predict") and hasattr(c, "get_params"):
            return SklearnClusterer(c, options), True
        if isinstance(c, Clusterer):
            return _apply_options(c, options), False
        raise TypeError(
            f"clusterer {type(c).__name__} is neither a device Clusterer, a "
            "HostClusterer, nor an sklearn-style estimator with fit_predict"
        )

    def _effective_options(self, c) -> Dict[str, Any]:
        """The options to apply: the defaulted ``{'n_init': 3}`` is dropped
        for a clusterer without ``n_init``; explicit options apply as they
        are and may raise."""
        options = dict(self.clusterer_options)
        if self._options_defaulted and "n_init" in options:
            if dataclasses.is_dataclass(c):
                accepts = any(f.name == "n_init"
                              for f in dataclasses.fields(c))
            elif hasattr(c, "get_params"):
                accepts = "n_init" in c.get_params()
            elif isinstance(c, SklearnClusterer):
                accepts = "n_init" in c.estimator.get_params()
            else:
                accepts = False
            if not accepts:
                options.pop("n_init")
        for name, value in self._autotune_options.items():
            options.setdefault(name, value)
        return options

    # -- fit -------------------------------------------------------------

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

    @region("fit")
    def fit(self, X):
        """Run the consensus sweep; fills ``cdf_at_K_data`` and returns
        self."""
        with region("fit.resolve"):
            if self.random_state is None:
                raise ValueError(
                    "random_state must be an integer seed: the resample "
                    "plan is a pure function of it"
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
            if (self.compute_consensus_labels
                    and not self._resolve_store_matrices(n)):
                raise ValueError(
                    "compute_consensus_labels=True needs the consensus "
                    "matrices (store_matrices is False, or 'auto' disabled "
                    "them for this N); pass store_matrices=True explicitly"
                )
            device = self._device()
            mode, sizing = self._resolve_mode(n, d, device)
            self._autotune_options = {}
            self.autotune_ = None
            if mode != "estimate":
                config = self._exact_config(n, d, device)
        if mode == "estimate":
            return self._fit_estimate(X, n, d, device, sizing)
        ckpt = None
        loaded: Dict[int, Dict[str, np.ndarray]] = {}
        if self.checkpoint_dir is not None and self._writes_checkpoints():
            from consensus_clustering_tpu_torch.utils.checkpoint import (
                SweepCheckpoint,
                backend_tag,
            )

            ckpt = SweepCheckpoint(self.checkpoint_dir, config,
                                   self.random_state, backend_tag(device))
            for k in config.k_values:
                entry = ckpt.load_k(k)
                if entry is not None:
                    loaded[k] = entry
        if self.checkpoint_dir is not None and self._spans_processes():
            # The primary's per-K checkpoints, on every process: they all
            # sweep the same missing Ks.
            from consensus_clustering_tpu_torch.parallel import distributed

            loaded = distributed.broadcast_object(loaded)
        missing = [k for k in config.k_values if k not in loaded]
        metrics_logger = MetricsLogger(self.metrics_path)
        entries: Dict[int, Dict[str, Any]] = {}
        timings, streaming_infos = [], []
        if missing:
            clusterer, is_host = self._resolve_clusterer()
            if is_host:
                self._log_host_ignores()
            batch = self.k_batch_size or len(missing)
            n_batches = -(-len(missing) // batch)
            shared_iij = None
            with self._profiled(device):
                for i0 in range(0, len(missing), batch):
                    chunk = missing[i0:i0 + batch]
                    run_config = dataclasses.replace(
                        config, k_values=tuple(chunk))
                    out, chunk_entries = self._run(
                        X, run_config, clusterer, is_host, ckpt,
                        metrics_logger, shared_iij)
                    if config.store_matrices and shared_iij is None:
                        shared_iij = chunk_entries[chunk[0]]["iij"]
                    entries.update(chunk_entries)
                    timings.append(out["timing"])
                    if "streaming" in out:
                        streaming_infos.append(out["streaming"])
                    metrics_logger.emit(
                        "k_batch_complete",
                        batch=i0 // batch + 1,
                        n_batches=n_batches,
                        k_values=[int(k) for k in chunk],
                        run_seconds=float(out["timing"]["run_seconds"]),
                        resamples_per_second=float(
                            out["timing"]["resamples_per_second"]),
                    )
        with region("fit.assemble"):
            self._build_results(entries, config, loaded, timings)
            if streaming_infos:
                self.metrics_["streaming"] = streaming_infos[-1]
                if len(streaming_infos) > 1:
                    self.metrics_["streaming_batches"] = streaming_infos
            if self.autotune_ is not None:
                self.metrics_["autotune"] = self.autotune_
            metrics_logger.emit("sweep_complete", **{
                **self.metrics_,
                "n_samples": n,
                "k_values": [int(k) for k in config.k_values],
                "n_iterations": config.n_iterations,
                "resumed_ks": sorted(int(k) for k in loaded),
                "pac_area": {int(k): float(v["pac_area"])
                             for k, v in self.cdf_at_K_data.items()},
                "best_k": self.best_k_,
            })
        self._draw_cdf()
        return self

    def _exact_config(self, n: int, d: int, device) -> SweepConfig:
        """The exact engines' configuration of this fit, with the knobs
        ``autotune`` fills (:meth:`_resolve_autotune`)."""
        cluster_batch, split_init, stream_h_block = self._resolve_autotune(
            n, d, device)
        return SweepConfig(
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
            cluster_batch=cluster_batch,
            split_init=bool(split_init),
            k_interleave=self.k_interleave,
            reseed_clusterer_per_resample=self.reseed_clusterer_per_resample,
            stream_h_block=stream_h_block,
            adaptive_tol=self.adaptive_tol,
            adaptive_patience=self.adaptive_patience,
            adaptive_min_h=self.adaptive_min_h,
            accum_repr=self.accum_repr,
            use_packed_kernel=self.use_packed_kernel,
            fuse_block=self.fuse_block,
            integrity_check_every=self.integrity_check_every,
            dtype=self.compute_dtype,
        )

    # -- autotune --------------------------------------------------------

    def _is_host_clusterer(self) -> bool:
        c = self.clusterer
        return isinstance(c, HostClusterer) or (
            c is not None and hasattr(c, "fit_predict")
            and hasattr(c, "get_params")
        )

    def _resolve_autotune(self, n: int, d: int, device):
        """``(cluster_batch, split_init, stream_h_block)`` for this fit:
        the constructor's values, with those left unset filled from the
        calibration store under ``autotune=True`` (user pin > calibrated
        > default), each disclosed in ``autotune_``; the default
        clusterer's calibrated ``max_iter`` goes into
        ``_autotune_options``.  Only bit-identical-gated knobs are
        filled, never ``adaptive_tol``, which trades resamples for
        bounded PAC drift."""
        pinned = (self.cluster_batch, self.split_init, self.stream_h_block)
        if not self.autotune:
            return pinned
        if self._is_host_clusterer():
            # Disclosing "calibrated" values that steered nothing would
            # be worse than silence.
            logger.info(
                "autotune: host-backend clusterer — the resolvable knobs "
                "(cluster_batch/split_init/stream_h_block/max_iter) are "
                "device-path features; nothing to resolve"
            )
            return pinned
        from consensus_clustering_tpu_torch.autotune.policy import (
            AutotunePolicy,
            Resolution,
            default_calibration_dir,
        )
        from consensus_clustering_tpu_torch.autotune.store import (
            CalibrationStore,
            environment,
            shape_bucket,
        )

        directory = self.calibration_dir or default_calibration_dir()
        policy = AutotunePolicy(
            None if directory is None
            else CalibrationStore(directory, env=environment(device)))
        bucket = shape_bucket(n, d, self.n_iterations, tuple(self.K_range))
        r_stream = policy.resolve("stream_h_block", bucket,
                                  pinned=self.stream_h_block)
        if (r_stream.provenance == "calibrated"
                and not (r_stream.record.get("speedup") or 0) > 1.0):
            # The record answers "which block size GIVEN streaming"
            # (serving always streams), but this surface's unset default
            # is the monolithic sweep, and the record's own evidence says
            # streaming lost to it at this bucket.
            logger.info(
                "autotune: calibrated stream_h_block=%s not adopted "
                "(streamed at %.2fx the monolithic rate at this bucket); "
                "keeping the monolithic default",
                r_stream.record.get("value"),
                r_stream.record.get("speedup") or 0.0,
            )
            r_stream = Resolution("stream_h_block", None, "default")
        resolutions = [
            policy.resolve("cluster_batch", bucket,
                           pinned=self.cluster_batch),
            policy.resolve("split_init", bucket, pinned=self.split_init,
                           default=False),
            r_stream,
        ]
        if self.clusterer is None and (
                "max_iter" not in self.clusterer_options):
            # Only the default clusterer's max_iter is provably unset: an
            # explicit clusterer instance is a pin, whatever its fields.
            r = policy.resolve("max_iter", bucket)
            if r.value is not None:
                self._autotune_options = {"max_iter": int(r.value)}
            resolutions.append(r)
        self.autotune_ = {r.knob: r.disclosure() for r in resolutions}
        return tuple(r.value for r in resolutions[:3])

    # -- the estimator ---------------------------------------------------

    def _estimate_infeasible_reason(self) -> Optional[str]:
        """Why the estimator cannot run this configuration, or None;
        ``mode='auto'`` then attempts exact instead of resolving into a
        certain ValueError."""
        if self.store_matrices is True:
            return "store_matrices=True (the estimator never builds them)"
        if self.compute_consensus_labels:
            return "compute_consensus_labels needs the matrices"
        if self.mesh is not None and self.mesh.shape[KSHARD_AXIS] != 1:
            # The pair engine refuses a 'k'-sharded mesh (its per-K state
            # is M-sized; lanes shard over ('h', 'n') only).
            return "k-sharded mesh (the estimator shards over ('h', 'n'))"
        if self._is_host_clusterer():
            return "host-backend clusterer (no device block to stream)"
        return None

    def _spans_processes(self) -> bool:
        """True on a mesh across processes."""
        return self.mesh is not None and self.mesh.process_count > 1

    def _writes_checkpoints(self) -> bool:
        """True where this process writes ``checkpoint_dir``: alone, or
        the primary of a mesh across processes."""
        if not self._spans_processes():
            return True
        from consensus_clustering_tpu_torch.parallel import distributed

        return distributed.is_primary()

    def _ring(self):
        """The block ring under ``checkpoint_dir`` where this process
        writes it, else None (across processes the engine follows the
        primary's)."""
        if self.checkpoint_dir is None or not self._writes_checkpoints():
            return None
        from consensus_clustering_tpu_torch.resilience.blocks import (
            StreamCheckpointer,
        )

        return StreamCheckpointer(os.path.join(self.checkpoint_dir, "stream"))

    def _resolve_mode(self, n: int, d: int, device):
        """``(mode, sizing)``: see :meth:`_resolve_mode_here`.  On a mesh
        across processes the primary's resolution, on every process: the
        budget is each process's own (``CCTPU_MEMORY_BUDGET`` or its
        card), and every process must run the same engine."""
        mode, sizing = self._resolve_mode_here(n, d, device)
        if self.mode == "auto" and self._spans_processes():
            from consensus_clustering_tpu_torch.parallel import distributed

            primary = distributed.broadcast_object((mode, sizing))
            if primary[0] != mode:
                logger.info("mode=auto: this process resolved %s, the "
                            "primary %s — running the primary's", mode,
                            primary[0])
            mode, sizing = primary
        return mode, sizing

    def _resolve_mode_here(self, n: int, d: int, device):
        """``(mode, sizing)``: ``mode='auto'`` against the memory budget,
        exact when the dense footprint fits it (or no budget resolves, or
        the estimator cannot run here), the estimator otherwise; logged
        either way.  ``sizing`` holds the footprint and the budget it was
        held to (None where no comparison ran)."""
        if self.mode != "auto":
            return self.mode, None
        infeasible = self._estimate_infeasible_reason()
        if infeasible is not None:
            logger.info("mode=auto: estimate mode unavailable here (%s) — "
                        "attempting exact", infeasible)
            return "exact", None
        from consensus_clustering_tpu_torch.serve.preflight import (
            estimate_job_bytes,
            resolve_memory_budget,
        )

        budget = resolve_memory_budget(device=device)
        if budget is None:
            logger.info("mode=auto: no memory budget resolvable — exact")
            return "exact", None
        estimate = estimate_job_bytes(
            n, d, tuple(self.K_range), dtype=self.compute_dtype,
            h_block=self.stream_h_block
            or autotune_stream_block(self.n_iterations),
            subsampling=self.subsampling,
            checkpoints=self.checkpoint_dir is not None,
        )
        sizing = {"dense_total_bytes": estimate["total_bytes"],
                  "budget_bytes": int(budget)}
        if estimate["total_bytes"] <= budget:
            logger.info("mode=auto: dense footprint %d bytes fits budget %d "
                        "— exact", estimate["total_bytes"], budget)
            return "exact", sizing
        logger.info(
            "mode=auto: dense footprint %d bytes exceeds budget %d — "
            "running the sampled-pair estimator (disclosed error bound in "
            "metrics_['estimator'])", estimate["total_bytes"], budget,
        )
        return "estimate", sizing

    def _fit_estimate(self, X: np.ndarray, n: int, d: int, device,
                      sizing=None):
        """The estimate-mode fit: the sampled-pair engine instead of a
        dense sweep, curves with a disclosed band in
        ``metrics_['estimator']`` (and ``mode='auto'``'s ``sizing`` in
        ``metrics_['auto']``), and with ``exact_best_k`` the chosen K
        refined exactly at the resamples the estimate ran."""
        from consensus_clustering_tpu_torch.estimator.engine import (
            run_pair_estimate,
        )

        if self.store_matrices is True:
            raise ValueError(
                "store_matrices=True is incompatible with mode='estimate': "
                "the estimator never materialises the N x N matrices — "
                "that is the point; pass store_matrices='auto' or False"
            )
        if self.compute_consensus_labels:
            raise ValueError(
                "compute_consensus_labels=True needs the consensus "
                "matrices, which mode='estimate' never materialises"
            )
        clusterer, is_host = self._resolve_clusterer()
        if is_host:
            raise ValueError(
                "mode='estimate' is a device-path engine: a host-backend "
                "(sklearn) clusterer has no device block to stream — use a "
                "device clusterer or mode='exact'"
            )
        if self.k_batch_size is not None:
            logger.info("k_batch_size is ignored with mode='estimate': the "
                        "pair engine runs every K in one O(M)-state pass")
        config = SweepConfig(
            n_samples=n,
            n_features=d,
            k_values=tuple(self.K_range),
            n_iterations=self.n_iterations,
            subsampling=self.subsampling,
            bins=self.bins,
            pac_interval=self.PAC_interval,
            parity_zeros=self.parity_zeros,
            store_matrices=False,
            chunk_size=self.chunk_size,
            cluster_batch=self.cluster_batch,
            split_init=bool(self.split_init),
            k_interleave=self.k_interleave,
            reseed_clusterer_per_resample=self.reseed_clusterer_per_resample,
            stream_h_block=self.stream_h_block
            or autotune_stream_block(self.n_iterations),
            adaptive_tol=self.adaptive_tol,
            adaptive_patience=self.adaptive_patience,
            adaptive_min_h=self.adaptive_min_h,
            accum_repr=self.accum_repr,
            use_packed_kernel=self.use_packed_kernel,
            fuse_block=self.fuse_block,
            integrity_check_every=self.integrity_check_every,
            dtype=self.compute_dtype,
        )
        metrics_logger = MetricsLogger(self.metrics_path)

        def block_cb(block, h_done, pac):
            metrics_logger.emit("h_block_complete", block=block,
                                h_done=h_done, pac_area=pac)

        # The block ring only, under the estimator's own fingerprint: the
        # per-K files hold EXACT results and are never read or written
        # here.
        ring = self._ring()
        try:
            with self._profiled(device):
                out = run_pair_estimate(
                    clusterer, config, X, self.random_state,
                    n_pairs=self.n_pairs, device=device, mesh=self.mesh,
                    block_callback=block_cb, checkpointer=ring,
                )
        finally:
            if ring is not None:
                ring.close()
        ks = list(config.k_values)
        if self.progress_callback is not None:
            for i, k in enumerate(ks):
                self.progress_callback(int(k), float(out["pac_area"][i]))
        with region("fit.assemble"):
            self._build_results(self._entries(out, config), config, {},
                                [out["timing"]])
            self.metrics_["mode"] = "estimate"
            self.metrics_["streaming"] = out["streaming"]
            self.metrics_["estimator"] = out["estimator"]
            if sizing is not None:
                self.metrics_["auto"] = sizing
        if self.exact_best_k:
            from consensus_clustering_tpu_torch.estimator.tiled import (
                exact_curves_for_k,
            )

            # Refine at the resamples the estimate ran (h_effective): under
            # early stop a full-H curve would be another statistic, whose
            # distance from the estimate the disclosed band does not cover.
            refine_config = dataclasses.replace(
                config, n_iterations=int(out["streaming"]["h_effective"]))
            with region("fit.refine"):
                exact = exact_curves_for_k(clusterer, refine_config, X,
                                           self.random_state, self.best_k_,
                                           device=device)
            entry = self.cdf_at_K_data[self.best_k_]
            pac_estimate = entry["pac_area"]
            entry["hist"] = np.asarray(exact["hist"], np.float64)
            entry["cdf"] = np.asarray(exact["cdf"], np.float64)
            entry["pac_area"] = float(exact["pac_area"])
            self.metrics_["exact_best_k"] = {
                "k": int(self.best_k_),
                "pac_area_exact": float(exact["pac_area"]),
                "pac_area_estimate": float(pac_estimate),
                "timing": exact["timing"],
            }
        with region("fit.assemble"):
            metrics_logger.emit("sweep_complete", **{
                **self.metrics_,
                "n_samples": n,
                "k_values": [int(k) for k in ks],
                "n_iterations": config.n_iterations,
                "resumed_ks": [],
                "pac_area": {int(k): float(v["pac_area"])
                             for k, v in self.cdf_at_K_data.items()},
                "best_k": self.best_k_,
            })
        self._draw_cdf()
        return self

    def _draw_cdf(self):
        """The reference's end of ``fit``: the CDF fan when ``plot_cdf``."""
        if self.plot_cdf:
            from consensus_clustering_tpu_torch.utils.plotting import plot_cdf

            plot_cdf(self.cdf_at_K_data, self.PAC_interval)

    def _device(self):
        """The device results are assembled on: the mesh's primary one,
        else ``device`` (``cuda`` unless named)."""
        if self.mesh is not None:
            return engine_mesh(self.mesh, self.device).primary
        return resolve_device(self.device)

    def _log_host_ignores(self):
        if self.mesh is not None:
            logger.info("mesh is a device-path feature; the host backend "
                        "runs on the mesh's primary device")
        if self.stream_h_block is not None:
            logger.info(
                "stream_h_block is a device-path feature; the host backend "
                "labels resamples in a Python loop — running the host sweep "
                "normally"
            )
        if self.accum_repr != "dense":
            logger.info(
                "accum_repr is a device-path feature; the host backend "
                "accumulates dense counts — running the host sweep normally"
            )
        if self.progress_callback is not None:
            logger.warning(
                "progress_callback is a device-path feature and this "
                "clusterer runs on the host backend: the callback will not "
                "fire (use progress=True for host-side per-K progress bars)"
            )

    @contextlib.contextmanager
    def _profiled(self, device):
        """A ``torch.profiler`` trace into ``profile_dir`` around the
        sweep (nothing without it)."""
        if self.profile_dir is None:
            yield
            return
        from torch.profiler import (
            ProfilerActivity,
            profile,
            tensorboard_trace_handler,
        )

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with recording_ranges(), profile(
                activities=activities,
                on_trace_ready=tensorboard_trace_handler(self.profile_dir)):
            yield

    def _run(self, X, config: SweepConfig, clusterer, is_host: bool, ckpt,
             metrics_logger: MetricsLogger, shared_iij=None):
        """Sweep one batch of ``config``'s Ks: the sweep's ``out`` and its
        per-K entries, each saved to ``ckpt`` as soon as the sweep returns
        (and only then is the block ring cleared)."""
        ring = None
        if is_host:
            from consensus_clustering_tpu_torch.parallel.host import (
                run_host_sweep,
            )

            out = run_host_sweep(clusterer, config, X, self.random_state,
                                 progress=self.progress, n_jobs=self.n_jobs,
                                 device=self._device())
        elif config.stream_h_block is None:
            from consensus_clustering_tpu_torch.parallel.sweep import (
                run_sweep,
            )

            out = run_sweep(clusterer, config, X, self.random_state,
                            device=self.device,
                            progress_callback=self.progress_callback,
                            mesh=self.mesh)
        else:
            from consensus_clustering_tpu_torch.parallel.streaming import (
                run_streaming_sweep,
            )

            def block_cb(block, h_done, pac):
                metrics_logger.emit("h_block_complete", block=block,
                                    h_done=h_done, pac_area=pac)

            ring = self._ring()
            try:
                out = run_streaming_sweep(
                    clusterer, config, X, self.random_state,
                    device=self.device, block_callback=block_cb,
                    checkpointer=ring, mesh=self.mesh,
                )
            finally:
                # Closed whatever happens; cleared only after the per-K
                # save below: a ring that survives a crash is the point.
                if ring is not None:
                    ring.close()
            if self.progress_callback is not None:
                for i, k in enumerate(config.k_values):
                    self.progress_callback(int(k), float(out["pac_area"][i]))
        with region("fit.assemble"):
            entries = self._entries(out, config, shared_iij)
        if ckpt is not None:
            for k in config.k_values:
                ckpt.save_k(k, entries[k])
            if ring is not None:
                ring.clear()
        return out, entries

    def _entries(self, out: Dict[str, Any], config: SweepConfig,
                 shared_iij=None):
        """Per-K result entries (the reference's schema) of one sweep;
        ``shared_iij`` is an earlier batch's host Iij (the same matrix)."""
        acc_dtype = self._accumulator_dtype()
        edges = bin_edges(config.bins)
        iij = None
        if config.store_matrices:
            iij = (shared_iij if shared_iij is not None
                   else out["iij"].astype(acc_dtype))
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

    def _consensus_labels(self, cij, k: int) -> np.ndarray:
        from consensus_clustering_tpu_torch.models.agglomerative import (
            consensus_labels_from_cij,
        )

        return consensus_labels_from_cij(
            cij, k, linkage=self.agg_clustering_linkage, method="auto",
            seed=int(self.random_state), device=self._device(),
        )

    def _build_results(self, entries: Dict[int, Dict[str, Any]],
                       config: SweepConfig,
                       loaded: Dict[int, Dict[str, np.ndarray]],
                       timings: list):
        """``cdf_at_K_data`` in ``config``'s K order from the batches'
        ``entries`` and the ``loaded`` checkpoints, consensus labels if
        asked for, and ``metrics_`` of the batches' ``timings`` (or of a fit
        resumed in full, when there are none)."""
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
        if self.compute_consensus_labels:
            from consensus_clustering_tpu_torch.ops.analysis import (
                cluster_consensus,
                item_consensus,
            )

            for k, entry in entries.items():
                if entry["cij"] is not None:
                    labels = self._consensus_labels(entry["cij"], k)
                    entry["consensus_labels"] = labels
                    entry["cluster_consensus"] = cluster_consensus(
                        entry["cij"], labels)
                    entry["item_consensus"] = item_consensus(
                        entry["cij"], labels)
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
        if not timings:
            # Resumed in full: no compute ran, so there is no rate (None,
            # not inf: json.dumps would write the non-standard Infinity).
            self.metrics_ = {
                "compile_seconds": 0.0, "run_seconds": 0.0,
                "resamples_per_second": None,
                "resumed_from_checkpoint": True,
            }
            return
        run_seconds = sum(t["run_seconds"] for t in timings)
        n_fresh = sum(1 for k in ks if k not in loaded)
        launches, lloyd = {}, {}
        for t in timings:
            for name, count in t["kernel_launches"].items():
                launches[name] = launches.get(name, 0) + count
            for name, count in t["lloyd"].items():
                lloyd[name] = lloyd.get(name, 0) + count
        self.metrics_ = {
            "compile_seconds": sum(t["compile_seconds"] for t in timings),
            "run_seconds": run_seconds,
            "resamples_per_second": (
                config.n_iterations * n_fresh / max(run_seconds, 1e-9)),
            "n_batches": len(timings),
            "device": timings[-1]["device"],
            "kernel_launches": launches,
            "lloyd": lloyd,
        }
        if "processes" in timings[-1]:
            # A mesh's processes; ``device_memory`` is this process's.
            self.metrics_["processes"] = timings[-1]["processes"]
        if loaded:
            self.metrics_["resumed_ks"] = sorted(int(k) for k in loaded)
        memories = [t["device_memory"] for t in timings if t["device_memory"]]
        if memories:
            self.metrics_["device_memory"] = max(
                memories, key=lambda m: m["peak_bytes_in_use"])
        for key in ("label_seconds_per_k", "accumulate_seconds_per_k"):
            if key in timings[-1]:  # the host backend's split, per K
                self.metrics_[key] = [s for t in timings for s in t[key]]
        strategy = {
            key: timings[-1][key]
            for key in ("packed_kernel", "fuse_block", "fused_kernel")
            if key in timings[-1]
        }
        if strategy:
            self.metrics_["timing"] = strategy

    def fit_predict(self, X) -> np.ndarray:
        """Fit, then return the consensus labels at ``best_k_``: exact
        agglomeration of ``1 - Cij`` up to 4096 items, spectral clustering
        of Cij above.  Needs the consensus matrices (``store_matrices``
        must not resolve to False)."""
        X = np.asarray(X)
        if X.ndim == 2 and not self._resolve_store_matrices(X.shape[0]):
            # Fail before the sweep, not after it.
            raise ValueError(
                "fit_predict needs the consensus matrices; pass "
                "store_matrices=True"
            )
        self.fit(X)
        entry = self.cdf_at_K_data[self.best_k_]
        if len(entry["consensus_labels"]):
            return np.asarray(entry["consensus_labels"])
        if entry["cij"] is None:
            raise ValueError(
                "consensus matrices unavailable for the selected K — this "
                "fit was resumed from checkpoints written with "
                "store_matrices=False; use a fresh checkpoint_dir (or "
                "delete the stale per-K files) and refit"
            )
        labels = self._consensus_labels(entry["cij"], self.best_k_)
        entry["consensus_labels"] = labels
        return np.asarray(labels)
