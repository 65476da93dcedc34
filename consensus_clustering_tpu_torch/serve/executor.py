# Ported from consensus_clustering_tpu/serve/executor.py.
"""The sweep executor of the serving stack: validated jobs on the port's
engines, on one device.

A long-lived service builds one engine per *shape bucket*, the tuple of
everything that shapes a job's block program: (N, d, K_range) plus the
semantics-bearing sweep statics (bins, subsampling, dtype, clusterer,
block size, ...) but NOT the seed, the data values or, for dense exact
and estimate jobs, the resample count H, a runtime argument of the
streaming engine (:class:`~consensus_clustering_tpu_torch.parallel.
streaming.StreamingSweep`): two jobs differing only in H share a bucket,
counted by the ``executable_cache_hits``/``_misses`` counters
``/metrics`` exposes.  There is no XLA program to compile here: a
bucket's first job pays the engine's construction and the CUDA kernels'
``nvcc`` build (once per checkout, into ``ops/_build.BUILD_DIR``, which
:attr:`SweepExecutor.compilation_cache_dir` names).

Job modes: ``exact`` on the stream, ``estimate``/``progressive`` on the
sampled-pair estimator (:class:`~consensus_clustering_tpu_torch.
estimator.engine.PairConsensusEngine`), ``refine`` (a progressive job's
continuation) on the tiled exact refinement (:mod:`..estimator.tiled`),
``append`` on :func:`~consensus_clustering_tpu_torch.append.engine.
run_append` over a stored parent's plane store.  Every tensor lives on
the executor's ``device`` (default ``cuda``; without a GPU the caller
must pass ``device="cpu"``, which runs the kernels' plain versions).

Progress events are host-side: the streaming driver owns every block's
curves on the host, so per-block events (``h_block_complete``) and the
once-per-K ``k_batch_complete`` events at completion are plain function
calls.  A generation token guards them: after a job timeout the
abandoned thread's late emissions find a newer generation and are
dropped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.device import resolve_device
from consensus_clustering_tpu_torch.obs.drift import DriftWatchdog
from consensus_clustering_tpu_torch.obs.histograms import LatencyHistogram
from consensus_clustering_tpu_torch.obs.memory import (
    MemoryAccountant,
    attributable_peak_delta,
    judge_measurement,
)
from consensus_clustering_tpu_torch.obs.tracing import (
    Tracer,
    recording_ranges,
)
from consensus_clustering_tpu_torch.utils.checkpoint import backend_tag
from consensus_clustering_tpu_torch.utils.metrics import (
    device_memory_stats,
    peak_memory_window,
)

_CLUSTERERS = ("kmeans", "gmm", "agglomerative", "spectral")

# Every key POST /jobs accepts under "config"; anything else is a 400
# (a typo silently falling back to a default is worse than an error).
_CONFIG_KEYS = frozenset(
    {
        "k", "iterations", "subsampling", "seed", "clusterer",
        "clusterer_options", "bins", "pac_interval", "parity_zeros",
        "analysis", "delta_k_threshold", "dtype", "chunk_size",
        "stream_h_block", "adaptive_tol", "adaptive_patience",
        "adaptive_min_h", "priority", "mode", "n_pairs", "tenant",
        "accum_repr", "append_parent",
    }
)

# Tenant names are lane keys, /metrics labels and JSONL fields; keep
# them to a filename-and-label-safe alphabet.
_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

#: Admission priorities, highest first — the overload shed policy's
#: vocabulary (docs/SERVING.md "Overload & wedge runbook").
PRIORITIES = ("high", "normal", "low")

# Spec fields that never enter the engine bucket: runtime inputs to
# the engine's block step (seed, H) or host-side driver/post-
# processing knobs (analysis selection, adaptive early stop).
_RUNTIME_FIELDS = (
    "seed", "analysis", "delta_k_threshold", "n_iterations",
    "adaptive_tol", "adaptive_patience", "adaptive_min_h",
)


class JobSpecError(ValueError):
    """A submitted job payload failed validation (HTTP 400)."""


class InvalidDataError(JobSpecError):
    """The submitted data matrix is numerically inadmissible (HTTP 400,
    STRUCTURED body — the preflight-413 shape: ``error`` + machine
    fields + ``hint``).

    Raised at ``parse_job_spec`` time, i.e. before admission: a
    NaN-poisoned matrix is rejected before it can persist a payload,
    enter the queue, or burn a warm executable slot on a sweep whose
    counts are garbage by construction.  ``payload`` carries
    ``code="invalid_data"``, the ``reason`` (``non_finite`` |
    ``zero_variance``), the offending ``rows``/``cols``, and a hint —
    see :func:`~consensus_clustering_tpu_torch.resilience.integrity.
    check_input_matrix`.
    """

    def __init__(self, payload: Dict[str, Any]):
        self.payload = dict(payload)
        super().__init__(self.payload.get("error", "invalid data"))


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """Validated, JSON-able sweep request (no data — that rides separately).

    Field semantics match the ``ConsensusClustering`` constructor / the
    CLI ``run`` flags; only the JSON-friendly subset that a serving
    result (curves, no matrices) needs is exposed.
    """

    k_values: Tuple[int, ...]
    n_iterations: int = 25
    subsampling: float = 0.8
    seed: int = 23
    clusterer: str = "kmeans"
    clusterer_options: Tuple[Tuple[str, Any], ...] = ()
    bins: int = 20
    pac_interval: Tuple[float, float] = (0.1, 0.9)
    parity_zeros: bool = True
    analysis: str = "PAC"
    delta_k_threshold: float = 0.05
    dtype: str = "float32"
    chunk_size: int = 8
    # None -> the executor's default block size; the resolved value is
    # part of the executable bucket (it shapes the block program).
    stream_h_block: Optional[int] = None
    adaptive_tol: Optional[float] = None
    adaptive_patience: int = 2
    adaptive_min_h: int = 0
    # Admission priority for the overload shed policy — a scheduling
    # hint, never part of the result: excluded from the fingerprint (a
    # resubmission at another priority must dedup) and from the bucket.
    priority: str = "normal"
    # Fair-share lane identity (docs/SERVING.md "Fair-share & fusion
    # runbook"): which tenant's queue lane this job rides.  Excluded
    # from the fingerprint AND the bucket exactly like priority — the
    # same job submitted by two tenants is the same result and must
    # dedup as such.  The HTTP layer can also inject it from a header
    # (serve --tenant-header), overriding the config field.
    tenant: str = "default"
    # Consensus execution mode (config.MODES): "exact" (the
    # dense engine), "estimate" (the sampled-pair estimator —
    # consensus_clustering_tpu_torch.estimator — O(M) state, disclosed PAC
    # error bound), or "auto" (resolved at admission against the
    # memory budget; a persisted spec always carries the CONCRETE mode
    # — the scheduler resolves before fingerprinting, so identity and
    # dedup are never budget-dependent after the fact).  Both mode and
    # n_pairs change the statistic, so they stay in the fingerprint
    # AND the bucket (they pick and shape the engine).
    mode: str = "exact"
    # Pair-sample size for estimate mode (None: the deterministic
    # default, estimator.bounds.default_n_pairs(N)).
    n_pairs: Optional[int] = None
    # Progressive-serving continuation linkage (docs/SERVING.md
    # "Progressive serving runbook"): the parent job_id when this spec
    # is a scheduler-constructed ``mode="refine"`` continuation, else
    # None.  A scheduling annotation like priority/tenant — excluded
    # from the fingerprint, the persisted payload, and the bucket
    # (identical progressive parents must produce identical
    # continuations that dedup as one result).  The DURABLE linkage is
    # the job records' ``continuation_of``/``continuation_job_id``
    # fields, which survive crash-requeue; this field only threads the
    # parent id through the enqueue call path.
    refine_parent: Optional[str] = None
    # Exact-mode accumulator representation (config.ACCUM_REPRS):
    # "dense" int32 row blocks or "packed" uint32 bit-plane masks
    # (~1/32 the accumulator bytes; results bit-identical — the packed
    # parity gate).  In the bucket (it shapes the engine's block
    # step AND, packed only, pins n_iterations: the packed state is
    # capacity-sized by H, so packed jobs bucket per H while dense
    # jobs keep the H-agnostic bucket).  Kept in the fingerprint like
    # stream_h_block — same-spec jobs at different representations are
    # rare enough that dedup purity loses to plumbing simplicity.
    accum_repr: str = "dense"
    # Append lineage (docs/SERVING.md "Append runbook"): the PARENT
    # job's fingerprint when ``mode="append"`` — the completed packed
    # exact run whose plane store supplies the old lanes' counts.
    # UNLIKE refine_parent this is part of the result's identity and
    # stays in the fingerprint: the same grown data appended against
    # two different parents mixes two different old-lane populations
    # and must never dedup to one result — and an append must never
    # alias a from-scratch job either (mode + parent keep the lineages
    # pairwise distinct, the same discipline as estimate/refine/exact).
    append_parent: Optional[str] = None

    def fingerprint_payload(self) -> Dict[str, Any]:
        """The JSON payload hashed into the job fingerprint.

        Everything that determines the RESULT, including the seed;
        ``chunk_size`` is excluded for the same reason the checkpoint
        fingerprint pops it — it only shapes the accumulation GEMMs,
        counts are exact integers either way.  ``priority`` is excluded
        because it steers only admission: the same job submitted high
        and low is the same result, and must dedup as such.
        """
        payload = dataclasses.asdict(self)
        payload.pop("chunk_size")
        payload.pop("priority")
        payload.pop("tenant")
        payload.pop("refine_parent")
        if self.append_parent is None:
            # Absent, not null: pre-append fingerprints stay stable
            # (an old store's results keep deduping new submissions).
            payload.pop("append_parent")
        payload["k_values"] = list(self.k_values)
        payload["pac_interval"] = list(self.pac_interval)
        payload["clusterer_options"] = dict(self.clusterer_options)
        return payload

    @staticmethod
    def from_payload(payload: Dict[str, Any]) -> "JobSpec":
        """Rebuild a spec from its :meth:`fingerprint_payload` — the
        crash-resume path: the jobstore persists exactly that payload,
        and a restarted scheduler re-queues the orphan from it.

        ``chunk_size`` is absent from the payload (excluded from the
        fingerprint because counts are exact integers at any chunking),
        so the rebuilt spec carries the default — bit-identical results
        either way, by the same argument.
        """
        return JobSpec(
            k_values=tuple(int(k) for k in payload["k_values"]),
            n_iterations=int(payload["n_iterations"]),
            subsampling=float(payload["subsampling"]),
            seed=int(payload["seed"]),
            clusterer=payload["clusterer"],
            clusterer_options=tuple(
                sorted(payload["clusterer_options"].items())
            ),
            bins=int(payload["bins"]),
            pac_interval=(
                float(payload["pac_interval"][0]),
                float(payload["pac_interval"][1]),
            ),
            parity_zeros=bool(payload["parity_zeros"]),
            analysis=payload["analysis"],
            delta_k_threshold=float(payload["delta_k_threshold"]),
            dtype=payload["dtype"],
            stream_h_block=payload.get("stream_h_block"),
            adaptive_tol=payload.get("adaptive_tol"),
            adaptive_patience=int(payload["adaptive_patience"]),
            adaptive_min_h=int(payload["adaptive_min_h"]),
            # Pre-estimator payloads (old stores) load as exact jobs.
            mode=payload.get("mode", "exact"),
            n_pairs=(
                None if payload.get("n_pairs") is None
                else int(payload["n_pairs"])
            ),
            # Pre-packed payloads load as dense jobs.
            accum_repr=payload.get("accum_repr", "dense"),
            append_parent=payload.get("append_parent"),
        )

    def bucket(self, n: int, d: int, h_block: Optional[int] = None) -> str:
        """The engine-cache key: fingerprint payload minus every
        runtime field — the seed and, because the executor streams the
        sweep in H-blocks, ``iterations`` itself (H is a runtime
        argument of the engine, so jobs differing only in H share one
        engine) — minus the fields that only steer the
        host-side driver or post-processing (adaptive early stop;
        ``analysis``/``delta_k_threshold`` feed ``select_best_k`` after
        the sweep returns), plus the data shape and the RESOLVED block
        size (``h_block`` overrides an unset ``stream_h_block``; the
        block size shapes the block step)."""
        payload = self.fingerprint_payload()
        for field in _RUNTIME_FIELDS:
            payload.pop(field)
        if self.mode == "append":
            # An append runs the same packed exact block step family
            # over the grown data — the parent and the mode change the
            # STATISTIC (and therefore the fingerprint), not the
            # engine's shape.  Normalising the bucket keeps append
            # jobs in the packed exact engine/SLO vocabulary
            # instead of forking a parallel bucket per parent.
            payload["mode"] = "exact"
            payload.pop("append_parent", None)
        if payload["stream_h_block"] is None:
            payload["stream_h_block"] = h_block
        if self.accum_repr == "packed" and self.mode not in (
            "estimate", "progressive"
        ):
            # The packed plane state is capacity-sized by H at build
            # time (StreamingSweep's h_cap), so packed EXACT jobs
            # cannot ride the H-agnostic engine: H goes back into
            # the bucket and jobs differing only in iterations build
            # their own engines.  The estimator's packed pair path has no such
            # cap (its planes are block-sized temps, the O(M) state is
            # representation-independent), so packed ESTIMATE jobs keep
            # the H-agnostic bucket.
            payload["n_iterations"] = int(self.n_iterations)
        payload["shape"] = [int(n), int(d)]
        return json.dumps(payload, sort_keys=True)


def _parse_k(spec: str) -> Tuple[int, ...]:
    """A K list spelled ``lo:hi`` (inclusive) or ``a,b,...`` (the
    reference CLI's ``_parse_k``; the port's CLI is ROADMAP A14)."""
    if ":" in spec:
        lo, hi = spec.split(":")
        return tuple(range(int(lo), int(hi) + 1))
    return tuple(int(v) for v in spec.split(","))


def parse_job_spec(body: Dict[str, Any]) -> Tuple[JobSpec, np.ndarray]:
    """Validate a ``POST /jobs`` body into (spec, data matrix).

    Raises :class:`JobSpecError` with a user-facing message on any
    malformed field — the service maps it to HTTP 400.
    """
    if not isinstance(body, dict):
        raise JobSpecError("body must be a JSON object")
    data = body.get("data")
    if data is None:
        raise JobSpecError("missing 'data': a 2-D array of numbers")
    cfg = body.get("config", {})
    if not isinstance(cfg, dict):
        raise JobSpecError("'config' must be a JSON object")
    unknown = set(cfg) - _CONFIG_KEYS
    if unknown:
        # A typo ("iteration") silently running with the default would
        # hand back a statistically different result with no warning.
        raise JobSpecError(
            f"unknown config key(s) {sorted(unknown)}; "
            f"valid keys: {sorted(_CONFIG_KEYS)}"
        )

    # dtype first: the data matrix is materialised at the working dtype
    # (parsing at float32 then widening would quantise a float64 job).
    dtype = cfg.get("dtype", "float32")
    if dtype not in ("float32", "float64"):
        raise JobSpecError(
            f"config.dtype must be 'float32' or 'float64', got {dtype!r}"
        )
    try:
        x = np.asarray(data, dtype=np.dtype(dtype))
    except (TypeError, ValueError) as e:
        raise JobSpecError(f"'data' is not a numeric array: {e}")
    if x.ndim != 2 or 0 in x.shape:
        raise JobSpecError(
            f"'data' must be a non-empty 2-D array, got shape {x.shape}"
        )
    from consensus_clustering_tpu_torch.resilience.integrity import (
        check_input_matrix,
    )

    problem = check_input_matrix(x)
    if problem is not None:
        # Structured 400 (the preflight-413 body shape): the offending
        # row/col indices and a hint, not a bare "contains NaN".
        raise InvalidDataError(problem)

    def _int(name, default, lo, hi):
        v = cfg.get(name, default)
        if not isinstance(v, int) or isinstance(v, bool) or not lo <= v <= hi:
            raise JobSpecError(
                f"config.{name} must be an integer in [{lo}, {hi}], got {v!r}"
            )
        return v

    k_spec = cfg.get("k", [2, 3])
    if isinstance(k_spec, str):
        try:
            k_values = _parse_k(k_spec)
        except ValueError:
            raise JobSpecError(f"config.k spec {k_spec!r} is not lo:hi or a,b")
    elif isinstance(k_spec, list) and k_spec:
        k_values = tuple(k_spec)
    else:
        raise JobSpecError("config.k must be a non-empty list or 'lo:hi'")
    for k in k_values:
        if not isinstance(k, int) or isinstance(k, bool) or not 2 <= k <= 256:
            raise JobSpecError(f"config.k entries must be ints in [2, 256], got {k!r}")
    if max(k_values) >= x.shape[0]:
        raise JobSpecError(
            f"config.k max ({max(k_values)}) must be < n_samples ({x.shape[0]})"
        )

    subsampling = cfg.get("subsampling", 0.8)
    if not isinstance(subsampling, (int, float)) or not 0.0 < subsampling <= 1.0:
        raise JobSpecError(
            f"config.subsampling must be in (0, 1], got {subsampling!r}"
        )
    clusterer = cfg.get("clusterer", "kmeans")
    if clusterer not in _CLUSTERERS:
        raise JobSpecError(
            f"config.clusterer {clusterer!r} unknown (choose from "
            f"{sorted(_CLUSTERERS)})"
        )
    options = cfg.get("clusterer_options", {})
    if not isinstance(options, dict):
        raise JobSpecError("config.clusterer_options must be an object")
    analysis = cfg.get("analysis", "PAC")
    if analysis not in ("PAC", "delta_k"):
        raise JobSpecError(
            f"config.analysis must be 'PAC' or 'delta_k', got {analysis!r}"
        )
    parity_zeros = cfg.get("parity_zeros", True)
    if not isinstance(parity_zeros, bool):
        raise JobSpecError("config.parity_zeros must be a boolean")
    threshold = cfg.get("delta_k_threshold", 0.05)
    if (
        not isinstance(threshold, (int, float))
        or isinstance(threshold, bool)
        or not 0.0 <= threshold
    ):
        raise JobSpecError(
            f"config.delta_k_threshold must be a number >= 0, "
            f"got {threshold!r}"
        )
    pac_interval = cfg.get("pac_interval", [0.1, 0.9])
    if (
        not isinstance(pac_interval, (list, tuple))
        or len(pac_interval) != 2
        or not all(isinstance(v, (int, float)) and not isinstance(v, bool)
                   for v in pac_interval)
        or not 0.0 <= pac_interval[0] < pac_interval[1] <= 1.0
    ):
        raise JobSpecError(
            f"config.pac_interval must be [lo, hi] with 0 <= lo < hi <= 1, "
            f"got {pac_interval!r}"
        )
    stream_h_block = cfg.get("stream_h_block")
    if stream_h_block is not None and (
        not isinstance(stream_h_block, int)
        or isinstance(stream_h_block, bool)
        or not 1 <= stream_h_block <= 100_000
    ):
        raise JobSpecError(
            f"config.stream_h_block must be an int in [1, 100000], got "
            f"{stream_h_block!r}"
        )
    adaptive_tol = cfg.get("adaptive_tol")
    if adaptive_tol is not None and (
        not isinstance(adaptive_tol, (int, float))
        or isinstance(adaptive_tol, bool)
        or adaptive_tol < 0
    ):
        raise JobSpecError(
            f"config.adaptive_tol must be a number >= 0, got "
            f"{adaptive_tol!r}"
        )
    priority = cfg.get("priority", "normal")
    if priority not in PRIORITIES:
        raise JobSpecError(
            f"config.priority must be one of {list(PRIORITIES)}, got "
            f"{priority!r}"
        )
    tenant = cfg.get("tenant", "default")
    if not isinstance(tenant, str) or not _TENANT_RE.match(tenant):
        raise JobSpecError(
            "config.tenant must be 1-64 chars of [A-Za-z0-9._-], got "
            f"{tenant!r}"
        )
    # SERVING_MODES, not MODES: the serving surface also
    # accepts "progressive" (estimate now, exact refinement in the
    # background — docs/SERVING.md "Progressive serving runbook").
    # The internal continuation mode "refine" is in neither tuple, so
    # it stays unreachable over HTTP by construction.
    from consensus_clustering_tpu_torch.config import SERVING_MODES

    mode = cfg.get("mode", "exact")
    if mode not in SERVING_MODES:
        raise JobSpecError(
            f"config.mode must be one of {list(SERVING_MODES)}, got "
            f"{mode!r}"
        )
    from consensus_clustering_tpu_torch.config import ACCUM_REPRS

    accum_repr = cfg.get("accum_repr", "dense")
    if accum_repr not in ACCUM_REPRS:
        raise JobSpecError(
            f"config.accum_repr must be one of {list(ACCUM_REPRS)}, "
            f"got {accum_repr!r}"
        )
    n_pairs = cfg.get("n_pairs")
    if n_pairs is not None:
        if mode in ("exact", "append"):
            raise JobSpecError(
                "config.n_pairs only applies to mode 'estimate', "
                "'auto' or 'progressive' (the exact engine has no "
                "pair sample)"
            )
        if (
            not isinstance(n_pairs, int)
            or isinstance(n_pairs, bool)
            or not 16 <= n_pairs <= 2**24
        ):
            raise JobSpecError(
                f"config.n_pairs must be an integer in [16, {2**24}], "
                f"got {n_pairs!r}"
            )
    append_parent = cfg.get("append_parent")
    if mode == "append":
        if (
            not isinstance(append_parent, str)
            or not re.fullmatch(r"[0-9a-f]{16}", append_parent)
        ):
            raise JobSpecError(
                "config.append_parent is required for mode 'append' "
                "and must be the parent job's 16-hex-char fingerprint, "
                f"got {append_parent!r}"
            )
        if accum_repr != "packed":
            raise JobSpecError(
                "mode 'append' requires accum_repr 'packed' — the "
                "plane store persists packed bit-planes"
            )
        if adaptive_tol is not None:
            raise JobSpecError(
                "mode 'append' is incompatible with adaptive_tol: "
                "generation H accounting requires the full marginal "
                "lane budget to run"
            )
    elif append_parent is not None:
        raise JobSpecError(
            "config.append_parent only applies to mode 'append'"
        )
    spec = JobSpec(
        k_values=tuple(int(k) for k in k_values),
        n_iterations=_int("iterations", 25, 2, 100_000),
        subsampling=float(subsampling),
        seed=_int("seed", 23, 0, 2**31 - 1),
        clusterer=clusterer,
        clusterer_options=tuple(sorted(options.items())),
        bins=_int("bins", 20, 2, 10_000),
        pac_interval=(float(pac_interval[0]), float(pac_interval[1])),
        parity_zeros=parity_zeros,
        analysis=analysis,
        delta_k_threshold=float(threshold),
        dtype=dtype,
        chunk_size=_int("chunk_size", 8, 1, 4096),
        stream_h_block=stream_h_block,
        adaptive_tol=(
            None if adaptive_tol is None else float(adaptive_tol)
        ),
        adaptive_patience=_int("adaptive_patience", 2, 1, 1000),
        adaptive_min_h=_int("adaptive_min_h", 0, 0, 100_000),
        priority=priority,
        tenant=tenant,
        mode=mode,
        n_pairs=n_pairs,
        accum_repr=accum_repr,
        append_parent=append_parent,
    )
    return spec, x


def ring_keep(integrity_check_every: int, checkpoint_every: int) -> int:
    """Checkpoint-ring retention that outlasts the sentinel's lag.

    With a sentinel check every C blocks and a checkpoint every W, up
    to ``ceil(C / W)`` generations can be written from already-corrupt
    state before the breach is detected (the corruption lands right
    after a check, every later block accumulates on it, detection
    raises just before the next due block's write).  The ring must
    reach one generation PAST that window, or a detected corruption
    would refuse every retained frame at resume and restart from zero
    — instead of the documented last-verified generation.  Without the
    sentinel the historical 2 suffices (resume-time verification still
    guards the ring, but there is no systematic detection lag to
    outlast).
    """
    if integrity_check_every <= 0:
        return 2
    return max(2, -(-integrity_check_every // max(checkpoint_every, 1)) + 1)


class SweepExecutor:
    """Runs validated jobs on the port's engines on one device, caching
    one engine per bucket.

    ``device`` (default ``cuda``; :func:`..device.resolve_device` raises
    without a GPU unless the caller passes ``"cpu"``) holds every tensor
    of every job.  ``run_count`` counts actual sweep executions — the
    jobstore-dedup test asserts it does NOT advance when a duplicate
    submission is served from the store.
    ``executable_cache_hits``/``_misses`` count bucket lookups (a miss
    builds the bucket's engine; H is not in the bucket of dense exact and
    estimate jobs, so those differing only in ``iterations`` hit), and
    ``h_requested_total``/``h_effective_total`` accumulate, over
    SUCCESSFUL executions, each job's resample budget vs what the
    adaptive driver actually ran — the ``/metrics`` view of both
    streaming wins (their difference is the adaptive saving, which is
    why failed attempts advance neither).
    """

    # Capability flag the scheduler duck-types on before passing the
    # plane-store kwargs (``plane_dir``/``parent_plane_dir``): narrow
    # test stubs that satisfy only the streaming surface don't accept
    # them, and must keep working unchanged.
    supports_plane_store = True

    def __init__(
        self,
        device=None,
        default_h_block: Optional[int] = None,
        calibration_store=None,
        integrity_check_every: int = 0,
        drift_watchdog: Optional[DriftWatchdog] = None,
        memory_accountant: Optional[MemoryAccountant] = None,
    ):
        if default_h_block is not None and default_h_block < 1:
            raise ValueError(
                f"default_h_block must be >= 1 or None (autotune), "
                f"got {default_h_block}"
            )
        if integrity_check_every < 0:
            raise ValueError(
                f"integrity_check_every must be >= 0 (0 = off), got "
                f"{integrity_check_every}"
            )
        # None: resolve per job through the autotune policy (a
        # calibrated record for this environment × shape bucket when
        # ``calibration_store`` has one, else the H/8-clamped-[16,128]
        # heuristic as the default tier — autotune/policy.py).  An
        # integer pins one block size for every job that doesn't set
        # stream_h_block itself (user-pinned tier, never overridden).
        self.default_h_block = default_h_block
        self.calibration_store = calibration_store
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # Pinned to an index: worker threads make it current by it.
            self.device = torch.device("cuda", torch.cuda.current_device())
        # Accumulator-sentinel cadence for every executed job (serve
        # --integrity-every): a RUNTIME knob of the streaming driver —
        # never part of the executable bucket, results identical at any
        # value (the sentinel only reads state).
        self.integrity_check_every = integrity_check_every
        # Resolutions by provenance tier over EXECUTED jobs — the
        # /metrics autotune_provenance_total satellite: an operator can
        # see live whether calibration actually steers traffic or
        # everything still lands on the heuristic default.  PRE-SEEDED
        # with every tier so the key set never changes after
        # construction: the scheduler's metrics() dict-copies this
        # without holding our lock, and a key insertion racing that
        # iteration would 500 the /metrics endpoint.
        from consensus_clustering_tpu_torch.autotune.policy import (
            PROVENANCE_CALIBRATED,
            PROVENANCE_DEFAULT,
            PROVENANCE_USER,
        )

        self.autotune_provenance: Dict[str, int] = {
            PROVENANCE_USER: 0,
            PROVENANCE_CALIBRATED: 0,
            PROVENANCE_DEFAULT: 0,
        }
        # Memoized block-size resolutions (same lifetime rule as the
        # engine cache: calibration records are read once per process;
        # a record added mid-flight applies after a restart).
        self._resolutions: Dict[Any, Any] = {}
        # Observed per-bucket block wall-clock (EWMA over evaluated
        # blocks), the hang watchdog's expectation source: the deadline
        # for "no block completed" scales off what blocks at this
        # bucket actually cost on this box.  Guarded by _lock.
        self._block_seconds: Dict[str, float] = {}
        self.run_count = 0
        self.executable_cache_hits = 0
        self.executable_cache_misses = 0
        self.h_requested_total = 0
        self.h_effective_total = 0
        # Sampled-pair estimator accounting (docs/SERVING.md "The 413
        # -> mode=estimate admission path"): successful estimate-mode
        # executions, and the cumulative pair count they sampled (the
        # /metrics pair-count gauge feed — pairs ARE the estimator's
        # working-set unit the way resamples are the sweep's).
        self.estimator_runs_total = 0
        self.estimator_pairs_total = 0
        # Append subsystem accounting (docs/SERVING.md "Append
        # runbook"): successful append-mode executions, how many of
        # them fell back to a full recompute (store missing / torn /
        # incompatible — each one disclosed in its result), and plane
        # stores written (generation 0 captures by packed exact runs
        # PLUS merged generations written by appends).
        self.append_runs_total = 0
        self.append_fallback_total = 0
        self.plane_stores_written_total = 0
        self.checkpoint_writes_total = 0
        self.checkpoint_resume_total = 0
        # Generations the verified-resume gate REFUSED (digest mismatch
        # or invariant breach — resilience.integrity): each one is a
        # corrupt frame that recovery correctly fell back past.
        self.checkpoint_verify_rejects_total = 0
        # Observability layer (docs/OBSERVABILITY.md): fixed-bucket
        # latency histograms for the two distributions this class
        # observes first-hand — evaluated H-block wall-clock (fed by
        # the same callback as the wedge EWMA) and checkpoint-write
        # seconds (fed from the writer thread) — plus the per-bucket
        # perf-drift watchdog over live resamples/s vs the calibrated
        # (or self-observed) anchor.  The scheduler surfaces all three
        # in /metrics.
        self.hist_block_seconds = LatencyHistogram()
        self.hist_checkpoint_write_seconds = LatencyHistogram()
        self.drift = (
            drift_watchdog if drift_watchdog is not None
            else DriftWatchdog()
        )
        # Memory accounting (docs/OBSERVABILITY.md "Memory accounting"):
        # per-bucket preflight-estimate vs measured reality (the CUDA
        # allocator's high-water; the CPU has none, and then nothing is
        # measured), fed once per successful execution.  The scheduler
        # surfaces the snapshot in /metrics, binds the
        # preflight_inaccurate emitter, and feeds the correction factor
        # back into the admission gate.
        self.memory_accounting = (
            memory_accountant if memory_accountant is not None
            else MemoryAccountant()
        )
        self._engines: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # Serialises engine builds (and the kernels' nvcc build behind
        # them) per process, separate from _lock: a timed-out job's
        # abandoned thread and the next job can reach _get_engine
        # concurrently, and holding _lock for a build would stall the
        # event emission of whatever is still running.
        self._compile_lock = threading.Lock()
        # Generation counter for host-side event emission: an abandoned
        # (timed-out) execution's late block/K events must find a newer
        # generation and drop themselves.
        self._cb_gen = 0
        # The kernels' build directory: the port's one cache across
        # process restarts (there is no XLA compilation cache).
        from consensus_clustering_tpu_torch.ops import _build

        self.compilation_cache_dir = _build.BUILD_DIR

    # -- backend label ---------------------------------------------------

    def backend(self) -> str:
        """The port's backend tag of the executor's device,
        ``torch-cuda`` or ``torch-cpu``: a CPU executor is never labelled
        as an accelerator, so no metrics consumer can read a CPU number
        as a card's."""
        return backend_tag(self.device)

    # -- device ----------------------------------------------------------

    def _enter_device(self) -> None:
        """Make the executor's card current on the calling thread: the
        scheduler runs each job on a worker thread of its own, and the
        kernels launch on the current device's current stream."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _profile(self, profile_dir: Optional[str]):
        """A ``torch.profiler`` context that writes its chrome trace
        under ``profile_dir`` on exit (CUDA activity on the card, and the
        ``cc.*`` ranges of :func:`..obs.tracing.region`), or a null
        context."""
        if profile_dir is None:
            return contextlib.nullcontext()
        import os

        from torch.profiler import ProfilerActivity, profile

        os.makedirs(profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)

        def on_ready(prof) -> None:
            prof.export_chrome_trace(os.path.join(
                profile_dir, f"trace-{int(time.time() * 1000)}.json"))

        @contextlib.contextmanager
        def profiled():
            with recording_ranges(), profile(activities=activities,
                                             on_trace_ready=on_ready):
                yield

        return profiled()

    # -- executable cache ------------------------------------------------

    def _resolve_h_block(self, spec: JobSpec, n: int, d: int):
        """The block size this job actually streams with, as a
        :class:`~consensus_clustering_tpu_torch.autotune.policy.Resolution`:
        the job's own ``stream_h_block`` or the executor's pinned
        default (both ``user-pinned``), else a ``calibrated`` record
        for this environment × shape bucket, else the original
        heuristic (H/8 clamped to [16, 128]) as the ``default`` tier.
        The tier is disclosed in the job result and counted in
        ``/metrics`` (``autotune_provenance_total``).  Memoized per
        (pin, shape, H, K) key so warm-cache jobs stay free of the
        calibration store's disk read (resolution inputs are immutable
        for the process lifetime, like the compiled engine itself)."""
        key = (
            spec.stream_h_block, self.default_h_block, n, d,
            spec.n_iterations, spec.k_values,
        )
        hit = self._resolutions.get(key)
        if hit is not None:
            return hit
        from consensus_clustering_tpu_torch.autotune.policy import AutotunePolicy
        from consensus_clustering_tpu_torch.autotune.store import shape_bucket

        policy = AutotunePolicy(self.calibration_store)
        resolution = policy.resolve_stream_block(
            shape_bucket(n, d, spec.n_iterations, spec.k_values),
            job_pin=spec.stream_h_block,
            operator_pin=self.default_h_block,
            n_iterations=spec.n_iterations,
        )
        # Benign race: two threads resolving the same key compute the
        # same immutable value; last write wins.
        self._resolutions[key] = resolution
        return resolution

    def _config_for(
        self, spec: JobSpec, n: int, d: int, h_block: int
    ) -> SweepConfig:
        # n_iterations sizes only the packed state's capacity (and is
        # in a packed exact job's bucket for that reason): the streaming
        # engine takes H at run() time.  The adaptive knobs live in the
        # driver, outside the engine — both are why the bucket can drop
        # them.
        return SweepConfig(
            n_samples=n,
            n_features=d,
            k_values=spec.k_values,
            n_iterations=spec.n_iterations,
            subsampling=spec.subsampling,
            bins=spec.bins,
            pac_interval=spec.pac_interval,
            parity_zeros=spec.parity_zeros,
            store_matrices=False,  # serving results are curves-only JSON
            chunk_size=spec.chunk_size,
            stream_h_block=h_block,
            accum_repr=spec.accum_repr,
            # Adaptive knobs deliberately NOT baked: the cached engine
            # is shared by every job in the bucket, and run() takes them
            # as per-job overrides.
            dtype=spec.dtype,
        )

    def _clusterer_for(self, spec: JobSpec):
        from consensus_clustering_tpu_torch.models.agglomerative import (
            AgglomerativeClustering,
        )
        from consensus_clustering_tpu_torch.models.gmm import GaussianMixture
        from consensus_clustering_tpu_torch.models.kmeans import KMeans
        from consensus_clustering_tpu_torch.models.spectral import SpectralClustering

        base = {
            "kmeans": KMeans,
            "gmm": GaussianMixture,
            "agglomerative": AgglomerativeClustering,
            "spectral": SpectralClustering,
        }[spec.clusterer]()
        options = dict(spec.clusterer_options)
        if not options:
            return base
        from consensus_clustering_tpu_torch.api import _apply_options

        try:
            return _apply_options(base, options)
        except (TypeError, ValueError) as e:
            raise JobSpecError(str(e))

    def _get_engine(self, spec: JobSpec, n: int, d: int):
        """(engine, build_compile_seconds, cached, resolution) for the
        bucket.

        Reachable from two threads at once (a timed-out job's abandoned
        thread plus the next job's fresh one), so the whole
        check-build-insert runs under ``_compile_lock``: the loser of
        the race blocks and then hits the cache instead of building a
        second engine.
        """
        resolution = self._resolve_h_block(spec, n, d)
        key = spec.bucket(n, d, resolution.value)
        with self._compile_lock:
            hit = self._engines.get(key)
            if hit is not None:
                with self._lock:
                    self.executable_cache_hits += 1
                return hit, 0.0, True, resolution
            t0 = time.perf_counter()
            if spec.mode in ("estimate", "progressive"):
                # The O(M) sampled-pair engine (consensus_clustering_
                # tpu_torch.estimator): same bucket discipline — mode and
                # n_pairs are in the bucket string, so estimator and
                # dense engines never collide in this cache.  A
                # progressive job's FIRST phase IS an estimate run —
                # it admits, executes, and is accounted exactly like
                # one; only the scheduler's continuation enqueue
                # distinguishes it.
                from consensus_clustering_tpu_torch.estimator.engine import (
                    PairConsensusEngine,
                )

                engine = PairConsensusEngine(
                    self._clusterer_for(spec),
                    self._config_for(spec, n, d, resolution.value),
                    n_pairs=spec.n_pairs,
                    device=self.device,
                )
            else:
                from consensus_clustering_tpu_torch.parallel.streaming import (
                    StreamingSweep,
                )

                engine = StreamingSweep(
                    self._clusterer_for(spec),
                    self._config_for(spec, n, d, resolution.value),
                    device=self.device,
                )
            # warmup() builds the CUDA kernels (nvcc, once per checkout;
            # nothing on the CPU).  A failed build raises and fails the
            # job: nothing falls back to the plain versions.
            engine.warmup()
            seconds = time.perf_counter() - t0
            self._engines[key] = engine
            with self._lock:
                self.executable_cache_misses += 1
            return engine, seconds, False, resolution

    def warmup(self, spec: JobSpec, n: int, d: int) -> float:
        """Build the engine of a shape bucket and its CUDA kernels;
        returns the build wall-clock (0.0 when already warm).

        One warmup covers every H at the shape **that resolves to the
        same block size** (and, for packed exact jobs, the same H, which
        sizes their state): every H under a pinned ``default_h_block`` or
        an explicit ``spec.stream_h_block``, but under the autotune
        default the spec's ``n_iterations`` and shape pick the block (a
        calibrated record for the bucket, else H/8 clamped to [16, 128])
        — an H that resolves to a different block is a different bucket
        and builds its own engine."""
        _, seconds, _, _ = self._get_engine(spec, n, d)
        return seconds

    def cancel_events(self) -> None:
        """Invalidate the current job's event generation (called on job
        timeout — and by the hang watchdog on a wedge verdict — so an
        abandoned execution's late block/K events are dropped, not
        attributed to a newer job)."""
        with self._lock:
            self._cb_gen += 1

    def expected_block_seconds(
        self, spec: JobSpec, n: int, d: int
    ) -> Optional[float]:
        """What one evaluated H-block at this job's bucket is expected
        to cost, for the hang watchdog's deadline.

        Observed first (the EWMA this process's own blocks feed —
        ground truth for this box under this load), else derived from
        the bucket's calibrated record (``rate`` is resamples/s over
        all K, so one block ≈ ``h_block · nK / rate``), else ``None``
        (cold bucket: the watchdog falls back to its floor).
        """
        resolution = self._resolve_h_block(spec, n, d)
        key = spec.bucket(n, d, resolution.value)
        with self._lock:
            observed = self._block_seconds.get(key)
        if observed is not None:
            return observed
        record = getattr(resolution, "record", None)
        if record and record.get("rate"):
            try:
                return (
                    float(resolution.value)
                    * len(spec.k_values)
                    / float(record["rate"])
                )
            except (TypeError, ValueError, ZeroDivisionError):
                return None
        return None

    def _observe_block_seconds(self, bucket_key: str, dt: float) -> None:
        with self._lock:
            prev = self._block_seconds.get(bucket_key)
            self._block_seconds[bucket_key] = (
                dt if prev is None else 0.7 * prev + 0.3 * dt
            )

    # -- execution -------------------------------------------------------

    def run(
        self,
        spec: JobSpec,
        x: np.ndarray,
        progress_cb: Optional[Callable[[int, float], None]] = None,
        block_cb: Optional[Callable[[int, int, list], None]] = None,
        checkpoint_dir: Optional[str] = None,
        heartbeat=None,
        tracer: Optional[Tracer] = None,
        profile_dir: Optional[str] = None,
        plane_dir: Optional[str] = None,
        parent_plane_dir: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Execute one streamed sweep; returns the JSON-able result.

        ``plane_dir`` (the jobstore's per-fingerprint plane-store
        directory) arms the append subsystem: a packed exact run
        captures its final bit-plane state and persists it there as
        generation 0 — the reusable artifact later ``mode="append"``
        jobs build on.  ``parent_plane_dir`` is the PARENT's store for
        an append job (``spec.append_parent``); append execution is
        dispatched to :meth:`_run_append`.

        ``progress_cb(k, pac)`` fires once per K when the sweep
        completes (the curves are host-side in the streaming driver — no
        staged debug callback, no per-device dedup); ``block_cb(block,
        h_done, pac_list)`` fires per streamed H-block.  Both are
        generation-guarded: after a timeout's :meth:`cancel_events`, an
        abandoned execution's stragglers are silently dropped.

        ``checkpoint_dir`` (the scheduler passes the jobstore's per-
        fingerprint ring directory) makes the execution preemption-safe:
        block state is checkpointed as it streams, and a re-run — same
        process after a transient failure, or a restarted process after
        a crash — continues from the newest valid generation instead of
        from zero.  The result's ``resumed_from_block`` records which.

        ``heartbeat`` (a :class:`~consensus_clustering_tpu_torch.serve.
        watchdog.Heartbeat`) is beaten at engine-ready and on every
        evaluated block — the liveness signal the scheduler's hang
        watchdog reads.  Block completions also feed the per-bucket
        block-time EWMA (:meth:`expected_block_seconds`) regardless of
        callbacks, so the watchdog's deadline tightens as the bucket
        warms — plus, via the observability layer, the block-seconds
        latency histogram and the perf-drift watchdog's per-bucket
        resamples/s ledger (docs/OBSERVABILITY.md).

        ``tracer`` (an :class:`~consensus_clustering_tpu_torch.obs.tracing.
        Tracer` the scheduler binds to its event log, trace_id=job_id)
        makes the execution emit timed spans — ``compile`` (the engine
        build), ``execute`` and ``checkpoint_write``, and under
        ``execute`` the engine's ``resume_restore``, ``h_block``,
        ``host_evaluate`` and ``integrity_check``.  Spans from an
        abandoned (timed-out/wedged) attempt are generation-guarded like
        every other late emission.  ``profile_dir`` wraps THIS execution
        in a ``torch.profiler`` trace written under it.

        A failed kernel build or launch raises out of the engine and
        fails the job; nothing falls back to the plain versions.
        """
        from consensus_clustering_tpu_torch.serve.watchdog import (
            PHASE_ENGINE_READY,
        )

        if spec.mode == "refine":
            # A progressive continuation: tiled exact refinement of the
            # parent's chosen K (estimator/tiled.py), not a streamed
            # sweep — no StreamingSweep engine, no checkpoint ring (a
            # takeover recomputes; the label collection dominates).
            return self._run_refine(
                spec, x,
                progress_cb=progress_cb,
                block_cb=block_cb,
                heartbeat=heartbeat,
                tracer=tracer,
            )
        if spec.mode == "append":
            # Incremental consensus over a grown dataset: old lanes
            # from the parent's plane store, ONLY the marginal lanes on
            # device, exact integer merge + staleness verdict — or a
            # disclosed full-recompute fallback when the store fails
            # verification (docs/SERVING.md "Append runbook").
            return self._run_append(
                spec, x,
                progress_cb=progress_cb,
                block_cb=block_cb,
                heartbeat=heartbeat,
                tracer=tracer,
                plane_dir=plane_dir,
                parent_plane_dir=parent_plane_dir,
            )
        self._enter_device()
        n, d = x.shape
        engine, compile_seconds, cached, resolution = self._get_engine(
            spec, n, d
        )
        bucket_key = spec.bucket(n, d, resolution.value)
        if heartbeat is not None:
            heartbeat.beat(PHASE_ENGINE_READY)

        # Memory accounting (docs/OBSERVABILITY.md): the allocator view
        # at attempt start — the peak delta around the run is measured
        # against it (obs.memory.attributable_peak_delta).  The CPU
        # reports {} (no allocator), and then nothing is measured.  With
        # accounting disabled (--no-memory-accounting) the allocator is
        # not read; results then carry the (free) model estimate with
        # measured fields null.
        accounting_on = getattr(self.memory_accounting, "enabled", True)

        with self._lock:
            self._cb_gen += 1
            gen = self._cb_gen

        def _live() -> bool:
            with self._lock:
                return self._cb_gen == gen

        # Spans from an abandoned attempt must drop exactly like its
        # block/K events: the executor-side tracer re-checks the
        # generation at every emission (the scheduler's tracer itself
        # cannot — it outlives attempts).
        span_tracer = None
        if tracer is not None:
            parent_sink = tracer.sink

            def _guarded_sink(payload):
                if _live():
                    parent_sink(payload)

            span_tracer = Tracer(
                _guarded_sink, tracer.trace_id, tracer.parent_span_id
            )
            span_tracer.record(
                "compile", compile_seconds, cached=cached,
                stream_h_block=resolution.value,
            )

        checkpointer = None
        if checkpoint_dir is not None:
            from consensus_clustering_tpu_torch.resilience.blocks import (
                StreamCheckpointer,
            )

            def on_ckpt_write(seconds, block):
                # Writer-thread feed: real disk-write latency whatever
                # the attempt's fate (the write happened), but the span
                # is generation-guarded via the tracer's sink.
                self.hist_checkpoint_write_seconds.observe(seconds)
                if span_tracer is not None:
                    span_tracer.record(
                        "checkpoint_write", seconds, block=block
                    )

            checkpointer = StreamCheckpointer(
                checkpoint_dir,
                # Retention sized to the sentinel's worst-case
                # detection lag (see ring_keep; the ring is written
                # every block): a caught corruption must always find a
                # verified generation behind it.
                keep=ring_keep(self.integrity_check_every, 1),
                on_write=on_ckpt_write,
            )

        # The drift watchdog keys on the CALIBRATION bucket string
        # (exact-match with any stream_h_block record for this shape),
        # and its anchor comes from the resolution's record when one
        # steered this bucket — the calibration-anchored half; buckets
        # with no record self-anchor on their own warmed-up EWMA.
        from consensus_clustering_tpu_torch.autotune.policy import (
            PROVENANCE_CALIBRATED,
        )
        from consensus_clustering_tpu_torch.autotune.store import shape_bucket

        drift_bucket = shape_bucket(n, d, spec.n_iterations, spec.k_values)
        if spec.mode in ("estimate", "progressive"):
            # Estimate-mode traffic gets its own ledger bucket: its
            # throughput anchors and its preflight model are DIFFERENT
            # quantities from the dense engine's at the same shape, and
            # sharing the key would corrupt the exact gate's correction
            # EWMA and fire false drift against dense calibration.
            drift_bucket = f"{drift_bucket}-estimate"
        elif spec.accum_repr == "packed":
            # The same rule for the packed representation: its own
            # footprint model and throughput, so its own ledger bucket
            # (the scheduler's dense gate reads the unsuffixed one).
            drift_bucket = f"{drift_bucket}-packed"
        calibrated_rate = None
        if spec.mode not in ("estimate", "progressive") and (
            resolution.provenance == PROVENANCE_CALIBRATED
        ) and (
            resolution.record or {}
        ).get("rate"):
            try:
                calibrated_rate = float(resolution.record["rate"])
            except (TypeError, ValueError):
                calibrated_rate = None
        n_k = len(spec.k_values)

        # One internal per-block hook, always installed: the EWMA and
        # the heartbeat must advance even for callers that didn't ask
        # for block events (a wedge is a wedge whether or not anyone
        # subscribed to progress).
        last_block_at = [time.monotonic()]
        last_h_done = [None]

        def guarded_block_cb(block, h_done, pac_list):
            if not _live():
                # An abandoned (timed-out/wedged) attempt's device call
                # finally returned: its dt is the whole stall, and one
                # 0.3-weighted sample of hours would inflate the wedge
                # deadline for this bucket — blinding the watchdog the
                # stall proved necessary.  Nothing from a dead
                # generation may feed the EWMA, the heartbeat, the
                # histograms, the drift ledger, or the event stream.
                return
            now = time.monotonic()
            dt = now - last_block_at[0]
            self._observe_block_seconds(bucket_key, dt)
            self.hist_block_seconds.observe(dt)
            # Credit the drift ledger with the block's ACTUAL resamples
            # (its h_done advance): H values that don't divide the
            # block size truncate the final block, and crediting it a
            # full block would read as a phantom speedup every job.
            # First observed block of a resumed run: h_done includes
            # the restored prefix, so fall back to one full block.
            prev_h = last_h_done[0]
            # First callback of a RESUMED run: h_done already includes
            # the restored prefix, and dt includes the checkpoint
            # scan/verify/restore — neither a block's work nor a
            # block's time, so it must not feed the drift ledger (a
            # restore stall is recovery, not a regression).
            resumed_first = (
                prev_h is None and h_done > int(resolution.value)
            )
            delta_h = (
                h_done - prev_h if prev_h is not None
                else min(int(resolution.value), int(h_done))
            )
            last_h_done[0] = h_done
            if delta_h > 0 and not resumed_first:
                self.drift.observe(
                    drift_bucket, dt, float(delta_h) * n_k,
                    calibrated_rate=calibrated_rate,
                )
            last_block_at[0] = now
            if heartbeat is not None:
                heartbeat.beat(f"block:{block}")
            if block_cb is not None:
                block_cb(block, h_done, pac_list)

        execute_span = None
        stream_tracer = None
        if span_tracer is not None:
            execute_span = span_tracer.span(
                "execute", h_requested=int(spec.n_iterations),
            )
            stream_tracer = span_tracer.child(execute_span.span_id)
        profile_ctx = self._profile(profile_dir)
        # Arm the plane-store capture for packed EXACT runs only: the
        # captured bit-planes ARE the sufficient statistic the append
        # subsystem reuses; dense/estimate state isn't it, and the
        # kwarg is passed conditionally because only StreamingSweep's
        # run() knows it.
        capture_planes = (
            plane_dir is not None
            and spec.accum_repr == "packed"
            and spec.mode not in ("estimate", "progressive")
        )
        capture_kwargs = (
            {"capture_state": True} if capture_planes else {}
        )
        try:
            # The allocator's view at the run's start and end, inside one
            # window (utils.metrics.peak_memory_window): the high-water
            # is reset only when no other run is executing, and the
            # engine's own window nests in this one.  The CPU reads {}.
            with peak_memory_window(self.device):
                mem_before = (
                    device_memory_stats(self.device) if accounting_on
                    else {}
                )
                t0 = time.perf_counter()
                with profile_ctx:
                    # Clock from AFTER profiler startup (seconds of stall
                    # on first use): it would otherwise land in the first
                    # block's dt and fire a false perf_drift on a warm
                    # bucket every profiled job.
                    last_block_at[0] = time.monotonic()
                    host = engine.run(
                        x, spec.seed, spec.n_iterations,
                        block_callback=guarded_block_cb,
                        adaptive_tol=spec.adaptive_tol,
                        adaptive_patience=spec.adaptive_patience,
                        adaptive_min_h=spec.adaptive_min_h,
                        checkpointer=checkpointer,
                        integrity_check_every=self.integrity_check_every,
                        tracer=stream_tracer,
                        **capture_kwargs,
                    )
                # engine.run synchronises the device before it returns.
                run_seconds = time.perf_counter() - t0
                mem_after = (
                    device_memory_stats(self.device) if accounting_on
                    else {}
                )
            if execute_span is not None:
                execute_span.end(
                    h_effective=int(host["streaming"]["h_effective"]),
                )
        except BaseException as e:
            if execute_span is not None:
                execute_span.end(
                    status="error", error_type=type(e).__name__
                )
            raise
        finally:
            with self._lock:
                self.run_count += 1
                if checkpointer is not None:
                    # Counted in the finally: a run interrupted by a
                    # fault/preemption still wrote its checkpoints, and
                    # /metrics must show them (that is the whole story
                    # of a retry-from-checkpoint).
                    self.checkpoint_writes_total += (
                        checkpointer.writes_total
                    )
                    self.checkpoint_resume_total += (
                        checkpointer.resumes_total
                    )
                    self.checkpoint_verify_rejects_total += (
                        checkpointer.verify_rejects
                    )
            if checkpointer is not None:
                checkpointer.close()

        streaming = host["streaming"]

        # Persist the captured packed state as the job's plane store
        # (generation 0) — absent on an adaptive early stop (the live
        # state was the discarded speculative block's).  Best-effort:
        # the result is valid without the artifact, so a failed write
        # is DISCLOSED in the result, never fatal to the job.
        plane_store_block = None
        final_state = host.pop("final_state", None)
        if capture_planes and final_state is not None:
            from consensus_clustering_tpu_torch.append.engine import (
                write_generation_zero,
            )
            from consensus_clustering_tpu_torch.append.store import PlaneStore

            try:
                manifest = write_generation_zero(
                    PlaneStore(plane_dir), x,
                    config=self._config_for(
                        spec, n, d, int(resolution.value)
                    ),
                    seed=int(spec.seed),
                    final_state=final_state,
                    h_done=int(streaming["h_effective"]),
                    backend=self.backend(),
                    clusterer_meta={
                        "name": spec.clusterer,
                        "options": dict(spec.clusterer_options),
                    },
                )
                plane_store_block = {
                    "generation": 0,
                    "h_done": int(manifest["h_done"]),
                    "n": int(n),
                }
                with self._lock:
                    self.plane_stores_written_total += 1
            except (OSError, ValueError) as e:
                plane_store_block = {"error": str(e)}

        # Memory accounting: estimate (the preflight model, at the
        # block size this job actually streamed with) vs measured
        # reality — the allocator high-water delta on the card; there
        # is no compiled plan to fall back on, so the CPU measures
        # nothing.  Fed to the per-bucket accountant, whose correction
        # flows back into the admission 413 gate, and disclosed per
        # result below.
        from consensus_clustering_tpu_torch.serve.preflight import (
            estimate_estimator_bytes,
            estimate_job_bytes,
            estimate_packed_bytes,
        )

        if spec.mode in ("estimate", "progressive"):
            # The model the admission gate priced THIS job with: the
            # estimator's O(M) footprint, not the dense O(N²) one —
            # the accountant's accuracy judgement must compare like
            # with like or every estimate-mode job would read as a
            # massive model over-count and pollute the correction EWMA.
            estimate = estimate_estimator_bytes(
                n, d, spec.k_values,
                n_pairs=spec.n_pairs,
                dtype=spec.dtype,
                h_block=int(resolution.value),
                subsampling=spec.subsampling,
                checkpoints=checkpointer is not None,
                accum_repr=spec.accum_repr,
            )
        elif spec.accum_repr == "packed":
            # The model the admission gate priced a packed job with (the
            # reference prices it with the dense model here, which reads
            # as a ~30x over-count at the headline).
            estimate = estimate_packed_bytes(
                n, d, spec.k_values,
                n_iterations=spec.n_iterations,
                dtype=spec.dtype,
                h_block=int(resolution.value),
                subsampling=spec.subsampling,
                checkpoints=checkpointer is not None,
            )
        else:
            estimate = estimate_job_bytes(
                n, d, spec.k_values,
                dtype=spec.dtype,
                h_block=int(resolution.value),
                subsampling=spec.subsampling,
                checkpoints=checkpointer is not None,
            )
        # High-water minus occupancy at start, attributable to THIS
        # attempt only when the high-water advanced during it — a
        # masked reading (an earlier larger job's peak) is disclosed
        # but never measured, or the correction EWMA would permanently
        # inflate the bucket's 413 gate (docs/OBSERVABILITY.md).
        peak_delta, peak_masked = attributable_peak_delta(
            mem_before, mem_after
        )
        measured_bytes, mem_source, accuracy = judge_measurement(
            estimate["total_bytes"],
            peak_delta_bytes=peak_delta,
        )
        self.memory_accounting.observe(
            drift_bucket,
            estimate["total_bytes"],
            peak_delta_bytes=peak_delta,
        )

        with self._lock:
            # Both totals advance together, on SUCCESSFUL executions
            # only: if requested were counted per attempt (retries,
            # timeouts) while effective counted per success, their
            # difference would read as adaptive savings that never
            # happened (/metrics documents exactly that difference).
            self.h_requested_total += int(spec.n_iterations)
            self.h_effective_total += int(streaming["h_effective"])
            # Same successful-executions-only rule for the provenance
            # counters: a retried job must not double-count its tier.
            self.autotune_provenance[resolution.provenance] = (
                self.autotune_provenance.get(resolution.provenance, 0) + 1
            )
            if spec.mode in ("estimate", "progressive"):
                # Estimator accounting, successful executions only
                # like the H totals: runs, and the cumulative pair
                # count (the /metrics pair gauge).
                self.estimator_runs_total += 1
                self.estimator_pairs_total += int(
                    host["estimator"]["n_pairs"]
                )

        memory_block = {
            "estimated_bytes": int(estimate["total_bytes"]),
            # The gating model's breakdown — keys differ by mode
            # (the estimator model has pair terms, no N² workspace).
            "estimate": {
                key: value
                for key, value in estimate.items()
                if key not in ("total_bytes", "model")
            },
            "compiled": {},
            "device_before": mem_before,
            "device_after": mem_after,
            "peak_delta_bytes": peak_delta,
            "peak_masked": peak_masked,
            "measured_bytes": measured_bytes,
            "measurement_source": mem_source,
            "preflight_accuracy": accuracy,
        }
        result = self._shape_result(
            spec, n, d, host, resolution, compile_seconds, cached,
            run_seconds, memory_block,
        )
        if plane_store_block is not None:
            # Production metadata, never identity: whether this run's
            # packed state was persisted as a reusable append parent
            # (or why not) changes nothing about the answer.
            result["plane_store"] = plane_store_block
        if progress_cb is not None and _live():
            for k in result["K"]:
                progress_cb(int(k), float(result["pac_area"][str(k)]))
        return result

    def _run_refine(
        self,
        spec: JobSpec,
        x: np.ndarray,
        progress_cb: Optional[Callable[[int, float], None]] = None,
        block_cb: Optional[Callable[[int, int, list], None]] = None,
        heartbeat=None,
        tracer: Optional[Tracer] = None,
    ) -> Dict[str, Any]:
        """Execute one progressive CONTINUATION: tiled exact curves for
        the parent's chosen K (``estimator/tiled.py``), shaped by the
        same ``_shape_result`` as every other path so the refined
        answer's semantic block — and its distinct ``mode="refine"``
        fingerprint lineage — is computed by exactly the code the solo
        paths use.

        ``block_cb(tile_idx, H, [])`` fires per consensus row tile
        (there are no H-blocks here; tiles are this path's unit of
        progress): the scheduler's guarded callback turns each into a
        lease beat, a cooperative cancel check, and an SSE
        signs-of-life frame.  No checkpoint ring — a takeover
        recomputes from scratch (the label collection dominates; ring
        plumbing would buy at most one tile).  The labels are collected
        and the tiles counted on the executor's device (B2, the final
        assignment, B3 and B1's count entry on the card).  The drift
        ledger, block EWMA and memory accountant stay unfed: the
        refinement shares no expectation with the streamed paths keyed
        by the same shape.
        """
        from consensus_clustering_tpu_torch.estimator.tiled import (
            collect_resample_labels,
            tiled_exact_curves,
        )
        from consensus_clustering_tpu_torch.parallel.sweep import (
            build_kernels,
        )
        from consensus_clustering_tpu_torch.serve.watchdog import (
            PHASE_ENGINE_READY,
        )

        if len(spec.k_values) != 1:
            raise JobSpecError(
                f"mode='refine' takes exactly one K (the parent's "
                f"chosen best_k), got {list(spec.k_values)}"
            )
        self._enter_device()
        n, d = (int(v) for v in x.shape)
        k = int(spec.k_values[0])
        resolution = self._resolve_h_block(spec, n, d)
        config = self._config_for(spec, n, d, int(resolution.value))
        clusterer = self._clusterer_for(spec)
        if heartbeat is not None:
            heartbeat.beat(PHASE_ENGINE_READY)

        with self._lock:
            self._cb_gen += 1
            gen = self._cb_gen

        def _live() -> bool:
            with self._lock:
                return self._cb_gen == gen

        h = int(spec.n_iterations)
        n_tiles = [0]

        def tile_cb(tile_idx, rows_done):
            del rows_done
            n_tiles[0] += 1
            if not _live():
                # Same dead-generation rule as the streamed paths:
                # nothing from an abandoned attempt may beat the
                # heartbeat or reach the event stream.  The cancel
                # check lives in the scheduler's block_cb, which a
                # dead generation no longer owns either.
                return
            if heartbeat is not None:
                heartbeat.beat(f"tile:{tile_idx}")
            if block_cb is not None:
                block_cb(tile_idx, h, [])

        t0 = time.perf_counter()
        build_kernels(self.device)
        indices, labels = collect_resample_labels(
            clusterer, config, x, spec.seed, k,
            h_block=int(resolution.value), device=self.device,
        )
        if heartbeat is not None:
            heartbeat.beat("labels_collected")
        lo, hi = config.pac_idx
        curves = tiled_exact_curves(
            indices, labels, n, spec.bins, lo, hi,
            parity_zeros=spec.parity_zeros,
            tile_callback=tile_cb,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        run_seconds = time.perf_counter() - t0

        # The host dict _shape_result expects, with the refine path's
        # honest streaming metadata: tiles as the block unit, full H
        # always (no adaptive stop — the parent already decided H).
        host = {
            "pac_area": [float(curves["pac_area"])],
            "cdf": [np.asarray(curves["cdf"])],
            "streaming": {
                "h_block": int(resolution.value),
                "h_requested": h,
                "h_effective": h,
                "n_blocks_run": int(n_tiles[0]),
                "stopped_early": False,
                "pac_trajectory": [],
                "accum_repr": "dense",
            },
        }
        from consensus_clustering_tpu_torch.serve.preflight import (
            estimate_refine_bytes,
        )

        estimate = estimate_refine_bytes(
            n, d, k, h,
            dtype=spec.dtype,
            h_block=int(resolution.value),
            subsampling=spec.subsampling,
        )
        # Model estimate only, measured fields null — the reference's
        # rule for this path (its tile loop is host numpy there), kept
        # so the accountant's per-bucket correction stays the stream's.
        memory_block = {
            "estimated_bytes": int(estimate["total_bytes"]),
            "estimate": {
                key: value
                for key, value in estimate.items()
                if key not in ("total_bytes", "model")
            },
            "compiled": {},
            "device_before": {},
            "device_after": {},
            "peak_delta_bytes": None,
            "peak_masked": False,
            "measured_bytes": None,
            "measurement_source": None,
            "preflight_accuracy": None,
        }
        with self._lock:
            self.run_count += 1
            self.h_requested_total += h
            self.h_effective_total += h
            self.autotune_provenance[resolution.provenance] = (
                self.autotune_provenance.get(resolution.provenance, 0) + 1
            )
        result = self._shape_result(
            spec, n, d, host, resolution, 0.0, False,
            run_seconds, memory_block,
        )
        if progress_cb is not None and _live():
            for kk in result["K"]:
                progress_cb(int(kk), float(result["pac_area"][str(kk)]))
        return result

    def _run_append(
        self,
        spec: JobSpec,
        x: np.ndarray,
        progress_cb: Optional[Callable[[int, float], None]] = None,
        block_cb: Optional[Callable[[int, int, list], None]] = None,
        heartbeat=None,
        tracer: Optional[Tracer] = None,
        plane_dir: Optional[str] = None,
        parent_plane_dir: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Execute one ``mode="append"`` job (docs/SERVING.md "Append
        runbook").

        Happy path: the parent's plane store verifies, is compatible
        with this request's statistic fields and the grown data's
        prefix, and :func:`~consensus_clustering_tpu_torch.append.engine.
        run_append` runs ONLY the marginal lanes on device, merges the
        generations with exact integer accounting, writes the next
        cumulative generation into the parent's store, and returns the
        combined curves plus the DKW staleness verdict.

        Fallback path (the chaos contract): ANY verification failure —
        store missing, torn write (digest mismatch), schema skew,
        data-prefix or config mismatch — degrades to a FULL
        from-scratch recompute via :func:`~consensus_clustering_tpu_torch.
        append.engine.bootstrap_generation`, with the failure reason
        disclosed in the result's ``append`` block and a fresh
        generation-0 store written under THIS job's fingerprint.
        Generations are never silently mixed with unverified bytes.

        Results are shaped by the same ``_shape_result`` as every
        other path; the ``mode="append"`` semantic field keeps the
        fingerprint lineage pairwise-distinct from from-scratch exact,
        estimate and refine results.
        """
        from consensus_clustering_tpu_torch.append.engine import (
            bootstrap_generation,
            run_append,
        )
        from consensus_clustering_tpu_torch.append.store import (
            PlaneStore,
            PlaneStoreError,
        )
        from consensus_clustering_tpu_torch.serve.preflight import (
            estimate_append_bytes,
        )
        from consensus_clustering_tpu_torch.serve.watchdog import (
            PHASE_ENGINE_READY,
        )

        self._enter_device()
        n, d = (int(v) for v in x.shape)
        resolution = self._resolve_h_block(spec, n, d)
        clusterer = self._clusterer_for(spec)
        if heartbeat is not None:
            heartbeat.beat(PHASE_ENGINE_READY)

        with self._lock:
            self._cb_gen += 1
            gen = self._cb_gen

        def _live() -> bool:
            with self._lock:
                return self._cb_gen == gen

        def guarded_block_cb(block, h_done, pac_list):
            # Same dead-generation rule as every other path: nothing
            # from an abandoned attempt may beat the heartbeat or
            # reach the event stream.
            if not _live():
                return
            if heartbeat is not None:
                heartbeat.beat(f"block:{block}")
            if block_cb is not None:
                block_cb(block, h_done, pac_list)

        h = int(spec.n_iterations)
        t0 = time.perf_counter()
        host = None
        fallback_reason = None
        if parent_plane_dir is None:
            # The scheduler didn't plumb a store location (store-less
            # embedding, narrow stub): nothing to verify, recompute.
            fallback_reason = "no_plane_store_dir"
        else:
            try:
                host = run_append(
                    PlaneStore(parent_plane_dir), x,
                    h_new=h,
                    clusterer=clusterer,
                    stream_h_block=int(resolution.value),
                    block_callback=guarded_block_cb,
                    k_values=spec.k_values,
                    subsampling=spec.subsampling,
                    bins=spec.bins,
                    pac_interval=spec.pac_interval,
                    parity_zeros=spec.parity_zeros,
                    dtype=spec.dtype,
                    clusterer_name=spec.clusterer,
                    clusterer_options=dict(spec.clusterer_options),
                    device=self.device,
                )
            except PlaneStoreError as e:
                fallback_reason = e.reason
        if host is None:
            # Full-recompute fallback at the grown N, seeding a fresh
            # generation-0 store under THIS job's fingerprint so the
            # lineage can restart from it.
            store = (
                PlaneStore(plane_dir) if plane_dir is not None
                else None
            )
            host = bootstrap_generation(
                x,
                config=self._config_for(
                    spec, n, d, int(resolution.value)
                ),
                clusterer=clusterer,
                seed=int(spec.seed),
                n_iterations=h,
                store=store,
                block_callback=guarded_block_cb,
                clusterer_meta={
                    "name": spec.clusterer,
                    "options": dict(spec.clusterer_options),
                },
                device=self.device,
            )
            host.pop("final_state", None)
            h_eff = int(host["streaming"]["h_effective"])
            host["append"] = {
                "fallback": True,
                "fallback_reason": fallback_reason,
                "generation": 0,
                "n_new": n,
                "h_new": h_eff,
                "h_total": h_eff,
                "marginal_lane_fraction": 1.0,
                "store_written": bool(host.pop("store_written", False)),
            }
        run_seconds = time.perf_counter() - t0
        streaming = host["streaming"]

        estimate = estimate_append_bytes(
            n, d, spec.k_values,
            n_iterations=h,
            dtype=spec.dtype,
            h_block=int(resolution.value),
            subsampling=spec.subsampling,
        )
        # Model estimate only, measured fields null — the refine-path
        # precedent: the merge half is host-side numpy, so a device
        # allocator reading would measure part of the job at most and
        # poison the accountant's correction EWMA.
        memory_block = {
            "estimated_bytes": int(estimate["total_bytes"]),
            "estimate": {
                key: value
                for key, value in estimate.items()
                if key not in ("total_bytes", "model")
            },
            "compiled": {},
            "device_before": {},
            "device_after": {},
            "peak_delta_bytes": None,
            "peak_masked": False,
            "measured_bytes": None,
            "measurement_source": None,
            "preflight_accuracy": None,
        }
        with self._lock:
            self.run_count += 1
            self.h_requested_total += h
            self.h_effective_total += int(streaming["h_effective"])
            self.autotune_provenance[resolution.provenance] = (
                self.autotune_provenance.get(resolution.provenance, 0)
                + 1
            )
            self.append_runs_total += 1
            if host["append"].get("fallback"):
                self.append_fallback_total += 1
            if host["append"].get("store_written"):
                self.plane_stores_written_total += 1
        result = self._shape_result(
            spec, n, d, host, resolution, 0.0, False,
            run_seconds, memory_block,
        )
        if progress_cb is not None and _live():
            for kk in result["K"]:
                progress_cb(int(kk), float(result["pac_area"][str(kk)]))
        return result

    def _shape_result(
        self,
        spec: JobSpec,
        n: int,
        d: int,
        host: Dict[str, Any],
        resolution,
        compile_seconds: float,
        cached: bool,
        run_seconds: float,
        memory_block: Dict[str, Any],
        fused_k: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Shape one engine host dict into the JSON-able job result.

        The ONE implementation for both the solo and the fused paths —
        fusion's parity gate (per-job results bit-identical to solo,
        docs/SERVING.md "Fair-share & fusion runbook") rests on the
        semantic block and its fingerprint being computed by exactly
        this code whatever the execution vehicle.  ``fused_k`` (the
        batch width) discloses how the result was produced; it rides
        OUTSIDE the semantic block, like timings, because fusion never
        changes an answer.
        """
        from consensus_clustering_tpu_torch.ops.analysis import (
            area_under_cdf,
            delta_k,
            select_best_k,
        )

        streaming = host["streaming"]
        ks = list(spec.k_values)
        pac = [float(v) for v in host["pac_area"]]
        areas = np.asarray(
            [float(area_under_cdf(host["cdf"][i])) for i in range(len(ks))]
        )
        gains = delta_k(areas)
        best_k = select_best_k(
            spec.analysis, ks, pac,
            delta_k_gains=gains,
            delta_k_threshold=spec.delta_k_threshold,
        )
        # The SEMANTIC result identity: every field a resumed run must
        # reproduce bit for bit, none of the fields that legitimately
        # differ between an interrupted-then-resumed run and an
        # uninterrupted one (timings, resumed_from_block, cache flags).
        # The kill-and-resume acceptance test compares exactly this.
        semantic = {
            "shape": [int(n), int(d)],
            "K": [int(k) for k in ks],
            "pac_area": {str(k): p for k, p in zip(ks, pac)},
            "areas": [float(a) for a in areas],
            "delta_k": [float(g) for g in gains],
            "best_k": int(best_k),
            "analysis": spec.analysis,
            "h_effective": int(streaming["h_effective"]),
        }
        if spec.mode in ("estimate", "progressive"):
            # Mode and pair count are part of WHAT was computed — a
            # resumed estimate must reproduce both (exact-mode
            # fingerprints keep their historical field set).  A
            # progressive parent's first phase IS an estimate run, so
            # it reuses the estimate semantic lineage verbatim.
            semantic["mode"] = "estimate"
            semantic["n_pairs"] = int(host["estimator"]["n_pairs"])
        elif spec.mode == "refine":
            # The continuation's OWN lineage (docs/SERVING.md
            # "Progressive serving runbook"): the counts are
            # bit-identical to a dense exact run of the same K, but the
            # semantic mode field keeps its fingerprint distinct from
            # both the parent estimate AND a from-scratch exact result
            # — an exactness upgrade is disclosed, never aliased.
            semantic["mode"] = "refine"
        elif spec.mode == "append":
            # The append lineage: the counts mix the parent's old-lane
            # population with fresh marginal lanes over the grown data
            # — a different statistic from a from-scratch run at the
            # same shape, so the semantic mode field keeps append
            # fingerprints pairwise-distinct from exact, estimate AND
            # refine results: an appended result never aliases a
            # from-scratch one.
            semantic["mode"] = "append"
        result_fingerprint = hashlib.sha256(
            json.dumps(semantic, sort_keys=True).encode()
        ).hexdigest()[:16]
        if spec.mode in ("estimate", "progressive"):
            result_mode = "estimate"
        elif spec.mode == "append":
            # Honest labelling: appended counts are exact integers,
            # but the STATISTIC mixes two lane populations and carries
            # a staleness bound — "exact" would oversell it.
            result_mode = "append"
        else:
            result_mode = "exact"
        return {
            **semantic,
            # Which engine produced this result — "exact" or
            # "estimate"; estimate results ALSO carry the "estimator"
            # error-bound block (never an estimated PAC without its
            # band in the same payload).  A refine continuation reports
            # "exact" (its counts ARE the dense statistic) with the
            # "refined" production flag alongside.
            "mode": result_mode,
            **(
                {"estimator": dict(host["estimator"])}
                if spec.mode in ("estimate", "progressive") else {}
            ),
            **(
                # Production metadata like "fused": this exact result
                # was computed as a progressive continuation (tiled
                # refinement of one chosen K), not a from-scratch
                # sweep.
                {"refined": True}
                if spec.mode == "refine" else {}
            ),
            **(
                # The append disclosure block: generation lineage,
                # marginal-cost accounting, the DKW staleness verdict,
                # and — on fallback — why the store couldn't be used.
                # Production metadata outside the semantic block (the
                # semantic mode field already carries the lineage).
                {"append": dict(host["append"])}
                if spec.mode == "append" and "append" in host else {}
            ),
            **(
                # How the result was produced, never what it is: the
                # batch width of the fused device program this job rode
                # (docs/SERVING.md "Fair-share & fusion runbook").
                {"fused": {"batch": int(fused_k)}}
                if fused_k else {}
            ),
            "backend": self.backend(),
            "result_fingerprint": result_fingerprint,
            # How the block size was chosen (ROADMAP's never-silent
            # rule): user-pinned (job/operator), calibrated (with the
            # record's parity evidence), or default (the H/8 heuristic).
            "autotune": {"stream_h_block": resolution.disclosure()},
            # Satellite metric: 0 = ran from scratch; > 0 = this many
            # leading blocks were restored from the checkpoint ring.
            "resumed_from_block": int(
                streaming.get("resumed_from_block", 0)
            ),
            # Memory accounting (docs/OBSERVABILITY.md "Memory
            # accounting"): what the preflight model predicted for this
            # job vs what was measured — the per-job spelling of the
            # /metrics memory_accounting section.  preflight_accuracy =
            # estimated / measured (1.0 = the model is exact; the model
            # deliberately over-counts, so healthy values sit above 1
            # once N² dominates — tiny shapes sit below, the lanes'
            # temporaries being the part the model ignores).
            "memory": memory_block,
            "streaming": {
                "h_block": int(streaming["h_block"]),
                "h_requested": int(streaming["h_requested"]),
                "h_effective": int(streaming["h_effective"]),
                "n_blocks_run": int(streaming["n_blocks_run"]),
                "stopped_early": bool(streaming["stopped_early"]),
                "pac_trajectory": streaming["pac_trajectory"],
                "resumed_from_block": int(
                    streaming.get("resumed_from_block", 0)
                ),
                "checkpoint_writes": int(
                    streaming.get("checkpoint_writes", 0)
                ),
                # Sentinel evaluations this run (0 when --integrity-
                # every is off); the scheduler rolls these into
                # /metrics integrity_checks_total.
                "integrity_checks": int(
                    streaming.get("integrity_checks", 0)
                ),
                # Which accumulator representation ran (dense |
                # packed) — production metadata, never identity: the
                # packed parity gate keeps the semantic block (and so
                # result_fingerprint) byte-identical across reprs.
                "accum_repr": streaming.get("accum_repr", "dense"),
            },
            "timings": {
                "compile_seconds": compile_seconds,
                "run_seconds": run_seconds,
                # Packed jobs disclose which popcount path ran:
                # "cuda" (the kernel, on the card) or "plain" (its
                # PyTorch version, on the CPU).
                **(
                    {"packed_kernel": host["timing"]["packed_kernel"]}
                    if "packed_kernel" in host.get("timing", {})
                    else {}
                ),
                # Rate over resamples actually RUN: an adaptive job's
                # r/s stays a true throughput, not budget-skipped
                # inflation.
                "resamples_per_second": streaming["h_effective"]
                * len(ks) / max(run_seconds, 1e-9),
                "executable_cached": cached,
            },
        }

    def run_fused(
        self,
        specs: List[JobSpec],
        xs: List[np.ndarray],
        block_cbs: Optional[List[Optional[Callable]]] = None,
        checkpoint_dirs: Optional[List[Optional[str]]] = None,
        heartbeat=None,
        pad_to: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        """Execute k same-bucket jobs as one fused batch
        (docs/SERVING.md "Fair-share & fusion runbook").

        The caller (the scheduler's fusion path, planned by
        serve/sched/fusion.py) guarantees eligibility: equal buckets,
        equal ``n_iterations``, exact mode, no adaptive stop, distinct
        fingerprints, empty checkpoint rings.  This method validates
        the invariants cheaply and delegates to
        :meth:`StreamingSweep.run_fused` on the bucket's warm engine, which
        runs the jobs one after another through its solo ``run`` (the
        looping design, ``PERF.md`` §6) — per-job results are shaped by
        the SAME ``_shape_result`` the solo path uses, so fused and solo
        answers cannot drift.

        Per-job checkpoint rings receive the frames a solo run writes
        (bit-identical state — the parity gate), so any failure
        degrades to solo retries that resume the fused attempt's
        progress.  The drift ledger, block-seconds EWMA and memory
        accountant are deliberately NOT fed from a batch: its jobs
        wait on one another, so a batch's walls would skew the
        solo-derived expectations keyed by the same bucket;
        ``hist_block_seconds`` observes every job's block completions.
        ``pad_to`` is the scheduler's interface: it sizes the
        reference's ballast lanes, and a loop of solo runs has none.
        """
        k = len(specs)
        if k < 2:
            raise ValueError(f"run_fused needs >= 2 jobs, got {k}")
        if len(xs) != k:
            raise ValueError("specs and xs must align")
        if block_cbs is not None and len(block_cbs) != k:
            raise ValueError("block_cbs must align with specs")
        if checkpoint_dirs is not None and len(checkpoint_dirs) != k:
            raise ValueError("checkpoint_dirs must align with specs")
        self._enter_device()
        n, d = (int(v) for v in xs[0].shape)
        first = specs[0]
        resolution = self._resolve_h_block(first, n, d)
        bucket_key = first.bucket(n, d, resolution.value)
        for spec, x in zip(specs, xs):
            if tuple(int(v) for v in x.shape) != (n, d):
                raise ValueError("fused jobs must share one data shape")
            if spec.mode != "exact" or spec.adaptive_tol is not None:
                raise ValueError(
                    "fused jobs must be exact-mode, non-adaptive"
                )
            if spec.n_iterations != first.n_iterations:
                raise ValueError("fused jobs must share n_iterations")
            if spec.bucket(n, d, resolution.value) != bucket_key:
                raise ValueError("fused jobs must share one bucket")
        engine, compile_seconds, cached, resolution = self._get_engine(
            first, n, d
        )
        if not hasattr(engine, "run_fused"):
            raise ValueError(
                "the bucket's engine does not support fusion"
            )
        from consensus_clustering_tpu_torch.serve.watchdog import (
            PHASE_ENGINE_READY,
        )

        if heartbeat is not None:
            heartbeat.beat(PHASE_ENGINE_READY)

        with self._lock:
            self._cb_gen += 1
            gen = self._cb_gen

        def _live() -> bool:
            with self._lock:
                return self._cb_gen == gen

        checkpointers: List[Optional[Any]] = [None] * k
        if checkpoint_dirs is not None:
            from consensus_clustering_tpu_torch.resilience.blocks import (
                StreamCheckpointer,
            )

            def on_ckpt_write(seconds, block):
                del block
                self.hist_checkpoint_write_seconds.observe(seconds)

            for i, ckpt_dir in enumerate(checkpoint_dirs):
                if ckpt_dir is None:
                    continue
                checkpointers[i] = StreamCheckpointer(
                    ckpt_dir,
                    keep=ring_keep(self.integrity_check_every, 1),
                    on_write=on_ckpt_write,
                )

        del pad_to
        last_block_at = [time.monotonic()]

        def fused_block_cb(job_idx, block, h_done, pac_list):
            if not _live():
                return
            # Heartbeat + the block-latency histogram per completed
            # block; the EWMA and drift ledger stay unfed — see the
            # docstring.
            now = time.monotonic()
            self.hist_block_seconds.observe(now - last_block_at[0])
            last_block_at[0] = now
            if heartbeat is not None:
                heartbeat.beat(f"block:{block}")
            if block_cbs is not None and block_cbs[job_idx] is not None:
                block_cbs[job_idx](block, h_done, pac_list)

        try:
            t0 = time.perf_counter()
            hosts = engine.run_fused(
                xs,
                seeds=[int(spec.seed) for spec in specs],
                n_iterations=int(first.n_iterations),
                block_callback=fused_block_cb,
                checkpointers=checkpointers,
                integrity_check_every=self.integrity_check_every,
            )
            run_seconds = time.perf_counter() - t0
        finally:
            with self._lock:
                self.run_count += k
                for ckpt in checkpointers:
                    if ckpt is None:
                        continue
                    self.checkpoint_writes_total += ckpt.writes_total
                    self.checkpoint_resume_total += ckpt.resumes_total
                    self.checkpoint_verify_rejects_total += (
                        ckpt.verify_rejects
                    )
            for ckpt in checkpointers:
                if ckpt is not None:
                    ckpt.close()

        from consensus_clustering_tpu_torch.serve.preflight import (
            estimate_job_bytes,
            estimate_packed_bytes,
        )

        results: List[Dict[str, Any]] = []
        for spec, host in zip(specs, hosts):
            if spec.accum_repr == "packed":
                estimate = estimate_packed_bytes(
                    n, d, spec.k_values,
                    n_iterations=spec.n_iterations,
                    dtype=spec.dtype,
                    h_block=int(resolution.value),
                    subsampling=spec.subsampling,
                    checkpoints=checkpoint_dirs is not None,
                )
            else:
                estimate = estimate_job_bytes(
                    n, d, spec.k_values,
                    dtype=spec.dtype,
                    h_block=int(resolution.value),
                    subsampling=spec.subsampling,
                    checkpoints=checkpoint_dirs is not None,
                )
            # The model estimate is free; measured fields are null —
            # a fused attempt's allocator delta covers k jobs, and a
            # per-job attribution would be invented, not measured.
            memory_block = {
                "estimated_bytes": int(estimate["total_bytes"]),
                "estimate": {
                    key: value
                    for key, value in estimate.items()
                    if key not in ("total_bytes", "model")
                },
                "compiled": {},
                "device_before": {},
                "device_after": {},
                "peak_delta_bytes": None,
                "peak_masked": False,
                "measured_bytes": None,
                "measurement_source": None,
                "preflight_accuracy": None,
            }
            results.append(self._shape_result(
                spec, n, d, host, resolution, compile_seconds, cached,
                run_seconds, memory_block, fused_k=k,
            ))
        with self._lock:
            for spec, host in zip(specs, hosts):
                self.h_requested_total += int(spec.n_iterations)
                self.h_effective_total += int(
                    host["streaming"]["h_effective"]
                )
                self.autotune_provenance[resolution.provenance] = (
                    self.autotune_provenance.get(
                        resolution.provenance, 0
                    ) + 1
                )
        return results
