# Ported from consensus_clustering_tpu/serve/scheduler.py; two edits: the job fingerprint and _device_count (the executor's CUDA cards).
"""Bounded job scheduler: fair-share admission, timeout, retry.

The service's backpressure layer.  A single worker thread drains a
bounded admission queue — weighted-fair DRR lanes over tenant ×
priority by default (:mod:`~consensus_clustering_tpu_torch.serve.sched.
fairshare`; ``schedule="fifo"`` keeps the historical FIFO as the
measurable control arm) — and a full queue rejects the submission at
admission time (the HTTP layer maps :class:`QueueFull` to 429) instead
of buffering unboundedly — on a box where one sweep can take minutes,
an unbounded queue is an OOM with extra steps.  With ``fusion_max >=
2`` the worker fuses runnable same-bucket jobs into one device program
(docs/SERVING.md "Fair-share & fusion runbook"), and every job's
per-block progress is fanned out live over the SSE bus with client
cancel as a terminal state.

Each job runs with:

- **dedup**: the jobstore is consulted at submission; an identical
  (config, data) fingerprint completes instantly from the stored result
  (``cache_hits``), never entering the queue;
- **per-job timeout**: the executor call runs on a per-job thread and is
  abandoned (status ``timeout``) when it exceeds ``job_timeout`` —
  a compiled XLA program cannot be interrupted, so the thread is left
  to finish in the background with its progress events dropped;
- **retry with exponential backoff, from checkpoint**: failures are
  triaged by :func:`~consensus_clustering_tpu_torch.resilience.faults.
  classify_error` — deterministic programming/validation errors (and
  :class:`~consensus_clustering_tpu_torch.serve.executor.JobSpecError`, the
  caller's fault) fail the job immediately, while the transient
  device/runtime class (the preemption class) re-runs after
  ``backoff_base * 2**attempt`` seconds, up to ``max_retries`` times —
  and each re-run hands the executor the job's checkpoint ring, so a
  retry continues from the last completed block instead of from zero.
  ``retry_total`` counts retries by triage reason;
- **crash-resume**: the submitted (config, data) payload is persisted
  in the jobstore for the job's whole non-terminal life, so the startup
  reconciliation of a RESTARTED process re-queues orphaned jobs (they
  then resume from their checkpoint ring) instead of failing them; only
  orphans whose payload is missing (pre-durability stores) are failed;
- **fenced leases** (docs/SERVING.md "Multi-worker runbook"): with
  ``leases=True`` (the default) every job is owned by exactly one
  worker via :mod:`~consensus_clustering_tpu_torch.serve.leases` — claimed at
  admission, renewed from the per-block heartbeat path and a
  wall-clock maintenance thread, released (tombstoned) on the terminal
  transition.  Reconciliation becomes *takeover*: an orphan is claimed
  only when its lease is absent/expired/released/torn (a live peer's
  lease is left alone and is NOT counted as a restart — the solo
  fast-restart race that used to push healthy jobs toward quarantine
  is closed by the same rule), the taker bumps the fencing token and
  resumes from the checkpoint ring, and a periodic sweep makes
  dead-worker takeover happen while the survivor is RUNNING, not just
  at its next boot.  Every state-mutating jobstore write is fenced
  against the token, so a zombie worker's late write is refused
  (``lease_refused`` event) instead of clobbering the successor's
  result.

Hostile-path hardening (docs/SERVING.md "Overload & wedge runbook"):

- **hang watchdog**: with ``watchdog=True`` the per-job thread's
  liveness heartbeat (beaten by the executor on engine-ready and every
  evaluated H-block) is supervised; silence past
  ``max(wedge_floor, wedge_scale × expected_block_seconds)`` (compile
  grace before the first beat) declares the job *wedged* — the thread
  is abandoned, the attempt triaged ``wedged:<point>``, and the retry
  resumes from the checkpoint ring.  The r02-r05 10-22 h backend wedges
  become one deadline of lost time;
- **crash-loop quarantine**: reconciliation reads the monotonically
  increasing restart counter persisted in the job payload; a job
  re-queued more than ``quarantine_after`` times is marked
  ``quarantined`` — payload and checkpoint ring RETAINED for offline
  debugging, never auto-requeued, released only by an explicit
  ``serve-admin release`` — so one poison job cannot take the service
  down N times;
- **memory preflight**: with a ``memory_budget_bytes``, admission
  estimates the job's accumulator/state footprint
  (:mod:`~consensus_clustering_tpu_torch.serve.preflight`) and rejects
  over-budget jobs with a structured 413 instead of an OOM that kills
  every in-flight job;
- **overload shedding**: with a :class:`ShedPolicy`, low-priority
  admissions are refused (429 + Retry-After) once queue depth or the
  recent wedge rate crosses thresholds, so high-priority traffic still
  lands under stress.

Job records live in memory for speed and are mirrored to the jobstore on
every transition, so ``GET /jobs/<id>`` survives a restart.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from consensus_clustering_tpu_torch.autotune.store import shape_bucket
from consensus_clustering_tpu_torch.obs.drift import DriftWatchdog
from consensus_clustering_tpu_torch.obs.histograms import LatencyHistogram
from consensus_clustering_tpu_torch.obs.memory import MemoryAccountant
from consensus_clustering_tpu_torch.obs.slo import SLOMonitor
from consensus_clustering_tpu_torch.obs.tracing import Tracer
from consensus_clustering_tpu_torch.resilience.faults import (
    IntegrityError,
    classify_error,
)
from consensus_clustering_tpu_torch.resilience.integrity import INTEGRITY_POINTS
from consensus_clustering_tpu_torch.serve.events import EventLog
from consensus_clustering_tpu_torch.serve.executor import (
    PRIORITIES,
    JobSpec,
    JobSpecError,
    SweepExecutor,
)
from consensus_clustering_tpu_torch.serve.fleet.heartbeat import (
    read_fleet,
    write_heartbeat,
)
from consensus_clustering_tpu_torch.serve.fleet.signal import scale_signal
from consensus_clustering_tpu_torch.serve.fleet.steal import plan_steal
from consensus_clustering_tpu_torch.serve.jobstore import JobStore
from consensus_clustering_tpu_torch.serve.leases import (
    LeaseLost,
    LeaseManager,
    lease_state_name,
)
from consensus_clustering_tpu_torch.serve.preflight import (
    PreflightReject,
    check_admission,
    estimate_append_bytes,
    estimate_estimator_bytes,
    estimate_estimator_sharded,
    estimate_job_bytes,
    estimate_packed_bytes,
    estimate_refine_bytes,
)
from consensus_clustering_tpu_torch.serve.sched.fairshare import (
    FairShareQueue,
)
from consensus_clustering_tpu_torch.serve.sched.progressive import (
    band_fields,
    plan_continuation,
)
from consensus_clustering_tpu_torch.serve.sched.fusion import (
    MAX_FUSE_HARD_CAP,
    fusion_key,
    partition_batch,
    ring_is_empty,
)
from consensus_clustering_tpu_torch.serve.sched.stream import (
    JobCancelled,
    JobEventBus,
)
from consensus_clustering_tpu_torch.serve.watchdog import (
    Heartbeat,
    JobWedged,
    wedge_deadline,
)

logger = logging.getLogger(__name__)


class QueueFull(Exception):
    """Admission rejected: the job queue is at capacity (HTTP 429)."""


class QueueShed(Exception):
    """Admission refused by the overload shed policy (HTTP 429 +
    ``Retry-After``): the service is protecting higher-priority
    traffic, not full — retrying after the hint is expected to land."""

    def __init__(
        self,
        priority: str,
        reason: str,
        retry_after: float,
        basis: Optional[Dict[str, Any]] = None,
    ):
        self.priority = priority
        self.reason = reason
        self.retry_after = retry_after
        # How the Retry-After was derived (docs/SERVING.md "Fair-share
        # & fusion runbook"): the live queue-drain arithmetic, disclosed
        # in the 429 body so a client can see the hint is evidence, not
        # a constant.
        self.basis = dict(basis or {})
        super().__init__(
            f"shedding {priority}-priority admission ({reason}); "
            f"retry after {retry_after:.0f}s"
        )


class ShedPolicy:
    """When to refuse admissions to protect higher-priority traffic.

    Two pressure signals, both cheap to read at admission time:

    - **queue depth** — ``low`` sheds at ``low_frac`` of capacity,
      ``normal`` at ``normal_frac``; ``high`` is never shed by policy
      (a genuinely full queue still 429s everyone via ``QueueFull``).
    - **wedge rate** — ``wedge_threshold`` wedge verdicts inside
      ``wedge_window`` seconds shed ``low`` at ANY depth: a backend
      that keeps wedging is about to stop clearing the queue, and
      admitting more best-effort work into it only deepens the hole.
    """

    def __init__(
        self,
        low_frac: float = 0.5,
        normal_frac: float = 0.85,
        wedge_window: float = 300.0,
        wedge_threshold: int = 3,
        retry_after: float = 15.0,
    ):
        if not 0.0 < low_frac <= normal_frac <= 1.0:
            raise ValueError(
                f"need 0 < low_frac <= normal_frac <= 1, got "
                f"{low_frac}/{normal_frac}"
            )
        self.low_frac = low_frac
        self.normal_frac = normal_frac
        self.wedge_window = wedge_window
        self.wedge_threshold = wedge_threshold
        self.retry_after = retry_after

    def decide(
        self, priority: str, depth: int, capacity: int, recent_wedges: int
    ) -> Optional[str]:
        """A shed reason, or None to admit."""
        if priority == "high":
            return None
        # capacity <= 0 is queue.Queue's "unbounded" spelling (a valid
        # --queue-size 0 deployment): there is no fraction to be "at",
        # so depth-based shedding is off and only a wedge storm sheds.
        frac = depth / capacity if capacity > 0 else 0.0
        if priority == "low" and recent_wedges >= self.wedge_threshold:
            return (
                f"wedge storm: {recent_wedges} wedges in the last "
                f"{self.wedge_window:.0f}s"
            )
        if priority == "low" and frac >= self.low_frac:
            return f"queue at {depth}/{capacity} (low watermark)"
        if priority == "normal" and frac >= self.normal_frac:
            return f"queue at {depth}/{capacity} (normal watermark)"
        return None


# Duck-typed executor counters surfaced by metrics(): /metrics key ->
# SweepExecutor attribute name.  getattr keeps stub executors valid,
# but a getattr default also means a RENAMED executor attribute would
# silently report 0 forever — so tests/test_serve.py asserts every
# attribute here exists on the real SweepExecutor class.
_EXECUTOR_COUNTER_ATTRS = {
    "executable_cache_hits": "executable_cache_hits",
    "executable_cache_misses": "executable_cache_misses",
    "h_requested_total": "h_requested_total",
    "h_effective_total": "h_effective_total",
    "checkpoint_writes_total": "checkpoint_writes_total",
    "checkpoint_resume_total": "checkpoint_resume_total",
    "checkpoint_verify_rejects_total": "checkpoint_verify_rejects_total",
    # Sampled-pair estimator (docs/SERVING.md "The 413 -> mode=estimate
    # admission path"): successful estimate-mode executions, and the
    # cumulative pair-sample gauge.
    "estimator_runs_total": "estimator_runs_total",
    "estimator_pairs_total": "estimator_pairs_total",
    # Append subsystem (docs/SERVING.md "Append runbook"): successful
    # append executions, disclosed full-recompute fallbacks among
    # them, and plane stores written (gen-0 captures + merged
    # generations).
    "append_runs_total": "append_runs_total",
    "append_fallback_total": "append_fallback_total",
    "plane_stores_written_total": "plane_stores_written_total",
}

# Executor-owned observability OBJECTS metrics() snapshots (same
# rename-risk contract as the counter map above): the two histograms
# the executor feeds first-hand, the drift watchdog, and the memory
# accountant.
_EXECUTOR_OBJECT_ATTRS = (
    "hist_block_seconds",
    "hist_checkpoint_write_seconds",
    "drift",
    "memory_accounting",
)

# Stub-safe zero sources: a duck-typed executor without the obs layer
# still yields the full, fixed /metrics key set (never observed into —
# snapshot-only).
_ZERO_HISTOGRAM = LatencyHistogram()
_ZERO_DRIFT = DriftWatchdog(enabled=False)
_ZERO_MEMORY = MemoryAccountant(enabled=False)

# Statuses that never transition again: once mirrored to the jobstore,
# records in these states are served from disk and evicted from memory.
# "quarantined" is terminal for the SCHEDULER (never auto-requeued) but
# deliberately keeps its payload + checkpoint ring — see _update and
# the jobstore's orphan-payload sweep.
_TERMINAL = frozenset(
    {"done", "failed", "timeout", "quarantined", "cancelled"}
)


class JobTimeout(Exception):
    """The executor exceeded the per-job wall-clock budget."""


class Scheduler:
    """FIFO queue + worker loop in front of a :class:`SweepExecutor`."""

    #: How often the lease maintenance thread runs the store's
    #: tombstone GC (the grace window that spares fence-able leases is
    #: the store's own; this just bounds how long a long-lived service
    #: lets terminal jobs' lease dirs accumulate between boots).
    _LEASE_GC_EVERY_SECONDS = 600.0

    def __init__(
        self,
        executor: SweepExecutor,
        store: JobStore,
        max_queue: int = 16,
        job_timeout: Optional[float] = None,
        max_retries: int = 2,
        backoff_base: float = 0.5,
        events: Optional[EventLog] = None,
        sleep=time.sleep,
        checkpoints: bool = True,
        quarantine_after: int = 3,
        watchdog: bool = False,
        wedge_floor: float = 30.0,
        wedge_scale: float = 8.0,
        wedge_compile_grace: float = 600.0,
        wedge_poll: float = 0.25,
        shed_policy: Optional[ShedPolicy] = None,
        memory_budget_bytes: Optional[int] = None,
        slo: Optional[SLOMonitor] = None,
        worker_id: Optional[str] = None,
        leases: bool = True,
        lease_ttl: float = 60.0,
        lease_sweep: Optional[float] = None,
        schedule: str = "fair",
        fusion_max: int = 1,
        priority_weights: Optional[Dict[str, float]] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        starvation_seconds: float = 30.0,
        fleet: bool = True,
        fleet_target_drain_seconds: float = 60.0,
        emulate_device_seconds: float = 0.0,
    ):
        if quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {quarantine_after}"
            )
        if lease_ttl <= 0:
            raise ValueError(f"lease_ttl must be > 0, got {lease_ttl}")
        if schedule not in ("fair", "fifo"):
            raise ValueError(
                f"schedule must be 'fair' or 'fifo', got {schedule!r}"
            )
        if not 1 <= int(fusion_max) <= MAX_FUSE_HARD_CAP:
            raise ValueError(
                f"fusion_max must be in [1, {MAX_FUSE_HARD_CAP}], got "
                f"{fusion_max}"
            )
        if fusion_max > 1 and schedule != "fair":
            # Fusion plans over the fair queue's take_matching; the
            # FIFO control arm exists to MEASURE what fair-share buys,
            # and fusing inside it would blur exactly that comparison.
            raise ValueError(
                "fusion requires schedule='fair' (the FIFO arm is the "
                "unfused control)"
            )
        self.executor = executor
        self.store = store
        self.events = events or EventLog(None)
        self.job_timeout = job_timeout
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        # False disables per-job block checkpointing (the executor runs
        # without a ring); payload persistence and restart re-queue stay
        # on — they cost one small write per job, not one per block.
        self.checkpoints = checkpoints
        # Crash-loop cap: an orphan re-queued more than this many times
        # across restarts is quarantined instead of re-queued again.
        self.quarantine_after = quarantine_after
        # Hang watchdog knobs (serve/watchdog.py): enabled, the floor /
        # scale for the per-block silence deadline, the pre-first-block
        # compile grace, and the supervisor's poll cadence.
        self.watchdog = watchdog
        self.wedge_floor = wedge_floor
        self.wedge_scale = wedge_scale
        self.wedge_compile_grace = wedge_compile_grace
        self.wedge_poll = wedge_poll
        self.shed_policy = shed_policy
        self.memory_budget_bytes = memory_budget_bytes
        # Fenced-lease layer (docs/SERVING.md "Multi-worker runbook").
        # The worker_id must be RESTART-STABLE and unique per worker
        # over a shared store: stability is what lets a restarted
        # worker reclaim its dead former self's leases instantly
        # instead of waiting out the ttl; uniqueness is what makes a
        # peer's lease mean "leave this job alone".  The default
        # (hostname) suits one worker per host — co-hosted workers
        # must set --worker-id themselves.  The effective ttl never
        # sits below twice the wedge floor: expiry inherits the wedge
        # model's "no healthy silence is shorter than this" bound, and
        # renewal is wall-clock (maintenance thread + heartbeat path),
        # so a slow block or long compile can never read as death.
        self.worker_id = str(worker_id) if worker_id else (
            socket.gethostname() or "worker"
        )
        ttl = max(float(lease_ttl), 2.0 * float(wedge_floor))
        self.leases: Optional[LeaseManager] = (
            LeaseManager(store.leases_dir, self.worker_id, ttl=ttl)
            if leases else None
        )
        if lease_sweep is not None and float(lease_sweep) <= 0:
            raise ValueError(
                f"lease_sweep must be > 0, got {lease_sweep}"
            )
        self.lease_sweep = (
            float(lease_sweep) if lease_sweep
            else max(0.5, ttl / 4.0)
        )
        self._lease_thread: Optional[threading.Thread] = None
        # Fleet layer (docs/SERVING.md "Fleet runbook"): gated on the
        # lease layer, because a steal IS a lease claim — without
        # fencing there is no safe way to move a queued job between
        # live workers.  The heartbeat/steal/signal round rides the
        # lease maintenance thread's cadence.
        self.fleet = bool(fleet) and self.leases is not None
        self.fleet_target_drain_seconds = float(
            fleet_target_drain_seconds
        )
        # Device-latency emulation (benchmarks/fleet_scaling.py): sleep
        # this long after every dispatched set, standing in for a
        # fixed-latency remote accelerator program on CPU-starved
        # boxes where N worker processes cannot otherwise show a
        # wall-clock scheduling win.  0.0 (the default) is a no-op on
        # every production path.
        if float(emulate_device_seconds) < 0:
            raise ValueError(
                "emulate_device_seconds must be >= 0, got "
                f"{emulate_device_seconds}"
            )
        self.emulate_device_seconds = float(emulate_device_seconds)
        # Steal-policy knobs (attributes, not ctor params: policy
        # details the fleet tests tune, with defaults derived from the
        # fusion ceiling).  head_skip is the tail-stealing rule — skip
        # the entries the victim will pick up before its next renewal
        # round can even tell it it was robbed.
        self._steal_head_skip = max(2, int(fusion_max))
        self._steal_max_sets_per_round = 4
        self._fleet_backlog_limit = 512
        # A heartbeat older than this never steers a steal or the
        # scale signal: two missed write rounds plus the lease ttl —
        # by then the worker's leases are expiring and its jobs are
        # the takeover sweep's, not the steal planner's.
        self._fleet_stale_after = 2.0 * self.lease_sweep + (
            ttl if leases else 60.0
        )
        self._last_scale_recommendation: Optional[str] = None
        self._sleep = sleep  # injectable so retry tests need not wait
        # The admission queue: weighted-fair DRR lanes over tenant ×
        # priority by default (docs/SERVING.md "Fair-share & fusion
        # runbook"), or the historical bounded FIFO as the measurable
        # control arm (--schedule fifo).  Both enforce the same global
        # capacity at admission.
        self.schedule = schedule
        self.fusion_max = int(fusion_max)
        if schedule == "fair":
            self._queue: Any = FairShareQueue(
                maxsize=max_queue,
                priority_weights=priority_weights,
                tenant_weights=tenant_weights,
                starvation_seconds=starvation_seconds,
            )
        else:
            self._queue = queue.Queue(maxsize=max_queue)
        # Fusion-eligibility keys per queued job (serve/sched/fusion.py)
        # — computed at admission, popped with the rest of the per-job
        # state.  Only maintained when fusion can actually trigger.
        self._fusion_keys: Dict[str, Optional[str]] = {}
        # Live SSE fan-out (serve/sched/stream.py): per-block progress
        # + terminal transitions, published from the worker's callback
        # paths; the HTTP layer subscribes per stream.
        self.bus = JobEventBus()
        # Client-cancel state: flags checked from the per-block
        # callback of a RUNNING attempt (the cancel lands at the next
        # block boundary — a compiled block cannot be interrupted).
        self._cancel_flags: Dict[str, threading.Event] = {}
        # Worker-terminal timestamps inside the drain window — the
        # evidence the dynamic Retry-After derives from.
        self._drain_times: List[float] = []
        self._jobs: Dict[str, Dict[str, Any]] = {}
        # Spec + data ride outside the job record: records mirror to the
        # jobstore as JSON and must stay serialisable.
        self._specs: Dict[str, JobSpec] = {}
        self._data: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        # Counters for GET /metrics; guarded by _lock.  Every counter —
        # including each jobs_shed_total priority key — is PRE-SEEDED
        # here: metrics() dict-copies these without coordination, and a
        # first-key insertion racing that copy would 500 the /metrics
        # endpoint (the PR-5 dict-copy-races-first-insert class).
        self.jobs_completed = 0
        self.jobs_failed = 0
        self.jobs_retried = 0
        self.jobs_timed_out = 0
        self.jobs_requeued = 0
        self.jobs_wedged_total = 0
        self.jobs_quarantined = 0
        self.preflight_rejects_total = 0
        # Auto-mode admissions resolved onto the sampled-pair
        # estimator because the dense footprint was over budget — the
        # admission-path half of the estimator story (the executor
        # counts the execution half).
        self.estimator_selected_total = 0
        self.jobs_shed_total: Dict[str, int] = {p: 0 for p in PRIORITIES}
        # Lease-layer counters (docs/SERVING.md "Multi-worker runbook"),
        # pre-seeded like everything /metrics dict-copies: orphan leases
        # this worker claimed (absent/expired/released/torn/
        # self_restart), writes the fence refused (we were the zombie),
        # and leases of OURS that expired and were superseded by a peer
        # (discovered at renewal — the other half of the zombie story).
        self.lease_takeovers_total = 0
        self.lease_refused_writes_total = 0
        self.lease_expired_total = 0
        # Fleet-layer counters (docs/SERVING.md "Fleet runbook"),
        # pre-seeded like everything /metrics dict-copies: steal SETS
        # this worker executed and the jobs that rode them, jobs of
        # OURS a peer stole (healthy rebalancing, counted apart from
        # lease_expired_total — expiry is pathology, a steal is the
        # fleet working), heartbeats written / rejected at read
        # (torn, bit-flipped, stale), and scale-signal changes.
        self.steals_total = 0
        self.stolen_jobs_total = 0
        self.jobs_lost_to_steal_total = 0
        self.fleet_heartbeats_written_total = 0
        self.fleet_heartbeats_rejected_total = 0
        self.fleet_scale_signals_total = 0
        # The /metrics "fleet" section: FIXED key set (schema-tested),
        # refreshed by every fleet round; the pre-seeded shape is what
        # a fleet-disabled or not-yet-rounded scheduler reports.
        self._fleet_snapshot: Dict[str, Any] = {
            "enabled": self.fleet,
            "workers_seen": 0,
            "fleet_backlog": 0,
            "peer_backlog": 0,
            "fleet_running": 0,
            "fleet_drain_rate_per_s": None,
            "est_drain_seconds": None,
            "slo_burn_active": 0,
            "recommendation": None,
        }
        # Silent-corruption defense counters (docs/SERVING.md
        # "Integrity runbook"): sentinel evaluations across executed
        # jobs, and breaches by detection point — pre-seeded with every
        # point so the /metrics key set never changes.
        self.integrity_checks_total = 0
        self.integrity_violations_total: Dict[str, int] = {
            p: 0 for p in INTEGRITY_POINTS
        }
        # Fair-share / fusion / streamed-results counters (docs/
        # SERVING.md "Fair-share & fusion runbook"), pre-seeded like
        # everything /metrics dict-copies: fused device programs run,
        # jobs completed by riding one, fused attempts degraded to
        # solo, client cancels, and the SSE surface.
        self.fused_executions_total = 0
        self.fused_jobs_total = 0
        self.fusion_degraded_total = 0
        self.jobs_cancelled_total = 0
        self.sse_streams_total = 0
        self.sse_cancels_total = 0
        self.cache_hits = 0
        # Progressive serving (docs/SERVING.md "Progressive serving
        # runbook"), pre-seeded: progressive parents admitted, and the
        # continuation lifecycle — enqueued after the parent's estimate
        # completed, refined to done, cancelled (client hung up or
        # forwarded parent cancel), or shed/refused at enqueue.
        self.progressive_jobs_total = 0
        # Append serving (docs/SERVING.md "Append runbook"),
        # pre-seeded: append jobs admitted against a parent's plane
        # store (execution-side counters — runs, fallbacks, stores
        # written — live on the executor).
        self.append_jobs_total = 0
        self.continuations_enqueued_total = 0
        self.continuations_completed_total = 0
        self.continuations_cancelled_total = 0
        self.continuations_shed_total = 0
        # Retries by classify_error reason ({"injected": 1, "oom": 2,
        # ...}) — the /metrics retry_total{reason} satellite.
        self.retry_total: Dict[str, int] = {}
        # Wedge verdict timestamps inside the shed policy's window —
        # the wedge-rate pressure signal.  Guarded by _lock.
        self._recent_wedges: List[float] = []
        # Observability layer (docs/OBSERVABILITY.md), all pre-seeded:
        # the two latency distributions this class observes first-hand
        # (end-to-end job seconds over executed jobs, admission-to-
        # pickup queue wait), the perf_drift event counter, and the
        # profile-next one-shots consumed.  The executor owns the
        # block/checkpoint-write histograms and the drift ledger;
        # metrics() composes all of it into one snapshot.
        self.hist_job_seconds = LatencyHistogram()
        self.hist_queue_wait_seconds = LatencyHistogram()
        self.perf_drift_events_total = 0
        self.profile_requests_total = 0
        # SLO layer (docs/OBSERVABILITY.md "SLO layer"): per-bucket
        # latency/error objectives over rolling windows, fed per
        # executed job / per attempt below; breaches surface as
        # slo_breach events + the pre-seeded counter.  The scheduler
        # owns the monitor the way the executor owns the drift
        # watchdog: it is where the signals live.
        self.slo = slo if slo is not None else SLOMonitor()
        self.slo.set_emitter(self._on_slo_breach)
        self.slo_breach_events_total = 0
        self.preflight_inaccurate_events_total = 0
        # Wire the executor's drift watchdog (when it has one) to this
        # scheduler's event log + counter: the watchdog computes the
        # verdicts, the scheduler owns the operator surfaces.
        drift = getattr(self.executor, "drift", None)
        if drift is not None and hasattr(drift, "set_emitter"):
            drift.set_emitter(self._on_perf_drift)
        # Same wiring for the executor's memory accountant: the
        # accountant judges the preflight model per bucket, the
        # scheduler emits preflight_inaccurate and feeds the correction
        # back into the admission gate (_preflight).
        accountant = getattr(self.executor, "memory_accounting", None)
        if accountant is not None and hasattr(accountant, "set_emitter"):
            accountant.set_emitter(self._on_preflight_inaccurate)

    def _on_perf_drift(self, **payload) -> None:
        """Drift-watchdog emitter: one JSONL event + counter per
        excursion (docs/OBSERVABILITY.md "Drift watchdog")."""
        with self._lock:
            self.perf_drift_events_total += 1
        self.events.emit("perf_drift", **payload)

    def _on_slo_breach(self, **payload) -> None:
        """SLO-monitor emitter: one JSONL event + counter per breach
        excursion (docs/OBSERVABILITY.md "SLO layer")."""
        with self._lock:
            self.slo_breach_events_total += 1
        self.events.emit("slo_breach", **payload)

    def _on_preflight_inaccurate(self, **payload) -> None:
        """Memory-accountant emitter: the preflight model left its
        accuracy band at a bucket (docs/OBSERVABILITY.md "Memory
        accounting")."""
        with self._lock:
            self.preflight_inaccurate_events_total += 1
        self.events.emit("preflight_inaccurate", **payload)

    @staticmethod
    def _job_bucket(spec: JobSpec, n: int, d: int) -> str:
        """The calibration-store bucket string for a job — the key the
        drift watchdog, SLO monitor, and memory accountant all share,
        so one bucket name means the same traffic on every surface.
        Estimate-mode jobs get a ``-estimate`` suffix: their latency,
        throughput and footprint are different quantities from the
        dense engine's at the same shape, and one bucket name must
        keep meaning one kind of traffic.  A progressive parent IS an
        estimate run (same engine, same footprint) so it shares the
        estimate bucket; its continuation is a third kind of traffic —
        host-tiled exact refinement — and gets ``-refine``."""
        bucket = shape_bucket(n, d, spec.n_iterations, spec.k_values)
        mode = getattr(spec, "mode", "exact")
        if mode in ("estimate", "progressive"):
            bucket = f"{bucket}-estimate"
        elif mode == "refine":
            bucket = f"{bucket}-refine"
        elif mode == "append":
            # Appends run only the MARGINAL lanes plus host-side
            # mixing — a fourth kind of traffic whose latency and
            # footprint share nothing with a from-scratch run at the
            # same shape.
            bucket = f"{bucket}-append"
        return bucket

    def _span_sink(self, payload: Dict[str, Any]) -> None:
        self.events.emit("span", **payload)

    #: Seconds of worker-terminal history the dynamic Retry-After
    #: derives its drain rate from.
    _DRAIN_WINDOW_SECONDS = 120.0

    def _enqueue(self, job_id: str, spec: JobSpec) -> None:
        """Queue a runnable job on its fair-share lane (tenant ×
        priority) — or the FIFO, under the control schedule."""
        if self.schedule == "fair":
            self._queue.put_nowait(
                job_id,
                tenant=getattr(spec, "tenant", "default"),
                priority=spec.priority,
            )
        else:
            self._queue.put_nowait(job_id)

    def _note_drain(self) -> None:
        """One job left the worker (any terminal outcome): the drain
        evidence behind the dynamic Retry-After."""
        now = time.time()
        with self._lock:
            self._drain_times.append(now)
            cutoff = now - self._DRAIN_WINDOW_SECONDS
            if self._drain_times and self._drain_times[0] < cutoff:
                self._drain_times = [
                    t for t in self._drain_times if t >= cutoff
                ]

    def _retry_after(self) -> tuple:
        """(seconds, basis) for a shed 429's Retry-After: current
        backlog over the measured drain rate, floored at the static
        ``--shed-retry-after`` (the cold-start answer when nothing has
        drained yet), capped at 600 s.  The basis dict is disclosed in
        the 429 body — the hint is evidence, not a constant."""
        floor = (
            self.shed_policy.retry_after
            if self.shed_policy is not None else 15.0
        )
        now = time.time()
        with self._lock:
            drained = [
                t for t in self._drain_times
                if now - t <= self._DRAIN_WINDOW_SECONDS
            ]
        depth = self._queue.qsize()
        basis: Dict[str, Any] = {
            "queue_depth": depth,
            "floor_seconds": floor,
            "window_seconds": self._DRAIN_WINDOW_SECONDS,
            "drained_in_window": len(drained),
        }
        if not drained:
            basis["drain_rate_per_s"] = None
            basis["derived"] = False
            return float(floor), basis
        rate = len(drained) / self._DRAIN_WINDOW_SECONDS
        value = min(600.0, max(float(floor), depth / rate))
        basis["drain_rate_per_s"] = round(rate, 4)
        basis["derived"] = True
        return value, basis

    def note_sse_stream(self) -> None:
        with self._lock:
            self.sse_streams_total += 1

    def cancel(
        self, job_id: str, reason: str = "client_cancel"
    ) -> Optional[Dict[str, Any]]:
        """Client cancel (docs/SERVING.md "Fair-share & fusion
        runbook"): a QUEUED job terminalises immediately; a RUNNING
        one gets its cancel flag set and terminalises at the next
        block boundary (a compiled block cannot be interrupted — one
        block is the cancel latency).  Terminal like ``done``: lease
        released, checkpoint ring cleared, payload dropped, the worker
        slot freed.  Returns the job's record (possibly already
        terminal), or None for an unknown id."""
        with self._lock:
            record = self._jobs.get(job_id)
            queued = job_id in self._specs
            if record is not None and not queued:
                # Picked up: flag the running attempt; the per-block
                # callback raises JobCancelled at the next boundary.
                flag = self._cancel_flags.get(job_id)
                if flag is None:
                    flag = self._cancel_flags[job_id] = threading.Event()
                flag.set()
            if queued:
                # Take the spec/data now, under the lock: the worker's
                # pickup pops the same keys, so exactly one of us wins.
                self._specs.pop(job_id, None)
                self._data.pop(job_id, None)
                self._fusion_keys.pop(job_id, None)
        if record is None:
            stored = self.store.load_job(job_id)
            # Cancel forwarding (docs/SERVING.md "Progressive serving
            # runbook"): a cancel on a DONE progressive parent is the
            # client saying the estimate was enough — forward it to a
            # still-pending continuation so the abandoned refinement
            # refunds its fair-share slot instead of burning idle
            # capacity on an answer nobody is waiting for.
            if stored is not None and stored.get("status") == "done":
                cont_id = stored.get("continuation_job_id")
                if cont_id:
                    cont = self.get(cont_id)
                    if (
                        cont is not None
                        and cont.get("status") not in _TERMINAL
                    ):
                        self.cancel(cont_id, reason=reason)
            return stored
        if queued:
            # Free the admission slot too: the queue entry would
            # otherwise keep counting against the global capacity
            # (429-ing fresh work) until the worker eventually pops
            # the ghost.  Fair queue only — the FIFO control arm has
            # no removal primitive, and its worker skips the terminal
            # ghost at pickup either way.
            if self.schedule == "fair":
                self._queue.take_matching(
                    lambda queued_id: queued_id == job_id, 1
                )
            with self._lock:
                self.jobs_cancelled_total += 1
                if reason == "sse_disconnect":
                    self.sse_cancels_total += 1
            snapshot = self._update(
                job_id, status="cancelled",
                error=f"cancelled before execution ({reason})",
                finished_at=round(time.time(), 3),
            )
            self.events.emit(
                "job_cancelled", job_id=job_id, reason=reason,
                stage="queued", worker_id=self.worker_id,
            )
            return snapshot
        if reason == "sse_disconnect":
            with self._lock:
                self.sse_cancels_total += 1
        return self.get(job_id)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._worker is not None:
            return
        self._reconcile_orphans()
        self._worker = threading.Thread(
            target=self._worker_loop, name="serve-worker", daemon=True
        )
        self._worker.start()
        if self.leases is not None:
            # Lease maintenance: renew everything we own (wall-clock,
            # so compile phases / idle queue slots stay alive) and
            # sweep the store for dead peers' orphans — dead-worker
            # takeover must happen while the survivor is RUNNING, not
            # at its next boot.
            self._lease_thread = threading.Thread(
                target=self._lease_loop, name="serve-leases", daemon=True
            )
            self._lease_thread.start()

    def _lease_loop(self) -> None:
        last_gc = time.time()
        while not self._stop.wait(self.lease_sweep):
            try:
                self._note_lost_leases(self.leases.renew_owned())
            except Exception:  # noqa: BLE001 — renewal must not die
                logger.exception("lease renewal round failed")
            try:
                self._reconcile_orphans(boot=False)
            except Exception:  # noqa: BLE001 — the sweep must not die
                logger.exception("lease takeover sweep failed")
            if self.fleet:
                try:
                    # Heartbeat + steal + scale signal, one round per
                    # sweep (docs/SERVING.md "Fleet runbook").  Any
                    # failure degrades to the solo behaviour the
                    # service had before the fleet layer existed.
                    self._fleet_round()
                except Exception:  # noqa: BLE001 — degrade, never die
                    logger.exception("fleet round failed")
            # Periodic tombstone GC (grace-windowed inside the store):
            # without it a long-lived service keeps one released lease
            # dir per terminal job forever, and the takeover sweep
            # above re-reads every one of them each round.
            if time.time() - last_gc >= self._LEASE_GC_EVERY_SECONDS:
                last_gc = time.time()
                try:
                    self.store.gc_stale_leases()
                except Exception:  # noqa: BLE001 — GC must not die
                    logger.exception("stale-lease GC failed")

    def _lease_beat(self) -> None:
        """The per-block heartbeat renewal path: every beat the
        executor lands also keeps our leases fresh (rate-limited and
        non-blocking inside the manager — it never stalls a block
        loop).  Failures are swallowed: renewal is liveness telemetry,
        and a hiccup here must not fail a healthy job."""
        if self.leases is None:
            return
        try:
            lost = self.leases.maybe_renew()
        except Exception:  # noqa: BLE001 — see docstring
            logger.exception("heartbeat lease renewal failed")
            return
        if lost:
            self._note_lost_leases(lost)

    def _note_lost_leases(self, lost: List[str]) -> None:
        """Leases of OURS a peer superseded (we are a zombie for these
        jobs): count them, drop the local state so ``get()`` falls back
        to the successor's on-disk record, and leave any still-running
        thread to be refused by the fence at its next write."""
        for job_id in lost:
            # A superseded lease has two healths: EXPIRY (we went
            # silent and a peer took over — pathology) and a STEAL (a
            # hungry peer claimed our queued backlog — the fleet layer
            # working as designed).  The stolen record carries
            # ``stolen_by``, so the two are countable apart; lumping
            # steals into lease_expired_total would make healthy
            # rebalancing read as worker death on every dashboard.
            stolen_by = None
            try:
                rec = self.store.load_job(job_id)
                if rec is not None:
                    stolen_by = rec.get("stolen_by")
            except Exception:  # noqa: BLE001 — accounting best-effort
                pass
            with self._lock:
                if stolen_by:
                    self.jobs_lost_to_steal_total += 1
                else:
                    self.lease_expired_total += 1
                self._jobs.pop(job_id, None)
                self._specs.pop(job_id, None)
                self._data.pop(job_id, None)
                self._fusion_keys.pop(job_id, None)
                self._cancel_flags.pop(job_id, None)
            if stolen_by:
                logger.info(
                    "job %s was stolen by peer %s; local state dropped "
                    "(its queue entry stands down quietly at pickup)",
                    job_id, stolen_by,
                )
            else:
                logger.warning(
                    "lease for job %s expired and was taken over by a "
                    "peer; local state dropped (any in-flight attempt "
                    "will be fenced at its next write)", job_id,
                )
        # Purge the lost jobs' QUEUE entries too.  Without this they
        # sit as ghosts until the worker thread dequeues each one just
        # to stand down at the pickup fence — and until then they are
        # counted by ``queued_ids`` into the advertised backlog, so a
        # heavily-stolen-from victim keeps reporting phantom depth:
        # peers aim steals at jobs that are already gone and the scale
        # signal reads ``scale_out`` long after the real drain.  A
        # ghost that was already dequeued before this runs still
        # stands down quietly at the fence, as before.
        if lost and hasattr(self._queue, "take_matching"):
            lost_set = set(lost)
            self._queue.take_matching(
                lambda jid: jid in lost_set, len(lost_set)
            )

    def _fence(self, job_id: str, op: str, quiet: bool = False) -> None:
        """The write-side lease gate: every state-mutating jobstore
        write for a job runs through here first.  A newer token means
        the job was taken over — we are the zombie — so the write is
        REFUSED: counted, logged as ``lease_refused``, local state
        dropped (the successor's record is the record), and
        :class:`LeaseLost` raised to unwind the caller.

        ``quiet=True`` is the STOLEN-AT-PICKUP spelling (docs/
        SERVING.md "Fleet runbook"): a failed fence on a write that
        precedes any execution — the pickup pre-check and the
        attempt-0 "running" transition — means a peer stole the job
        out of our queue while it waited.  Nothing ran, nothing is
        lost, the thief owns the job's whole story; that is a healthy
        stand-down, not a zombie refusal, so it unwinds without the
        counter or the ``lease_refused`` event (which keeps "zero
        fenced-write refusals" a meaningful health assertion for a
        fleet that steals constantly).  Every post-execution write
        stays LOUD."""
        if self.leases is None:
            return
        if self.leases.check_fence(job_id):
            return
        mine, newest = self.leases.fence_info(job_id)
        self.leases.forget(job_id)
        with self._lock:
            if not quiet:
                self.lease_refused_writes_total += 1
            self._jobs.pop(job_id, None)
            self._specs.pop(job_id, None)
            self._data.pop(job_id, None)
            self._fusion_keys.pop(job_id, None)
            self._cancel_flags.pop(job_id, None)
        if quiet:
            logger.info(
                "job %s was claimed by a peer before pickup (%s): held "
                "token %s, newest %s — standing down", job_id, op,
                mine, newest,
            )
            raise LeaseLost(job_id, op, mine, newest)
        self.events.emit(
            "lease_refused", job_id=job_id, op=op,
            worker_id=self.worker_id, token=mine, newer_token=newest,
        )
        logger.warning(
            "fenced write refused for job %s (%s): held token %s, "
            "newest %s — the job was taken over", job_id, op, mine,
            newest,
        )
        raise LeaseLost(job_id, op, mine, newest)

    def _dead_lease_candidates(self):
        """Candidate ``(job_id, record)`` pairs for the PERIODIC
        takeover sweep: jobs whose newest lease looks dead.

        The boot pass walks every job record — it must also see
        pre-lease ``absent`` orphans and ``serve-admin release``'d
        work — but doing that every ``lease_sweep`` interval would
        re-parse the store's whole (unbounded, result-embedding)
        terminal history every few seconds forever.  A dead WORKER's
        jobs are exactly the ones whose leases stop being renewed, so
        the running sweep reads the tiny token files instead and
        touches a job record only when its lease is actually expired
        or torn: released tombstones are terminal jobs' normal end
        state and are skipped at the cost of one tiny token-file read
        (the lease loop's periodic tombstone GC bounds how many
        accumulate — which also keeps ``serve-admin release``'s
        documented takes-effect-at-next-start semantics), and
        ``absent`` only exists in pre-lease stores, which the boot
        pass owns."""
        try:
            names = sorted(os.listdir(self.store.leases_dir))
        except OSError:
            return
        now = time.time()
        for job_id in names:
            cur = self.leases.current(job_id)
            if cur is None or lease_state_name(cur, now) not in (
                "expired", "torn",
            ):
                # Absent, released, or live (a healthy peer's, or our
                # own, renewed): not a dead worker's leaving.
                continue
            record = self.store.load_job(job_id)
            if record is not None:
                yield job_id, record

    def _fresh_or_stand_down(self, job_id):
        """Post-claim freshness gate, shared by both taker paths: re-
        read the record, and if a peer terminalised the job while we
        were claiming, re-tombstone the token we just burned and
        return None — proceeding on the stale queued/running snapshot
        would overwrite a terminal record with a failure (the zombie
        clobber, spelled by the taker).  Returns the fresh record when
        the takeover is still real."""
        fresh = self.store.load_job(job_id)
        if fresh is None or fresh.get("status") not in (
            "queued", "running",
        ):
            self.leases.release(
                job_id, (fresh or {}).get("status") or "done"
            )
            return None
        return fresh

    def _reconcile_orphans(self, boot: bool = True) -> None:
        """Re-queue, quarantine, or fail over jobs no live worker owns.

        The jobstore persists every job's (config, data) payload for its
        non-terminal life, so a ``queued``/``running`` orphan from a
        dead process is RE-QUEUED here: the worker re-runs it, and the
        executor resumes from the job's checkpoint ring — the crash
        costs at most one block of work plus the re-queue.

        The payload also carries the job's monotonically increasing
        restart counter.  Unconditional re-queueing is how one poison
        job (one that deterministically kills the process — a real XLA
        abort, or the ``CCTPU_FAULTS`` kill class) crash-loops the
        service forever: every restart re-queues it, it kills the
        process again.  So the counter is bumped — and PERSISTED —
        before the job becomes runnable, and an orphan past
        ``quarantine_after`` re-queues is marked ``quarantined``
        instead: payload and checkpoint ring retained for offline
        debugging, never auto-requeued, released only by an explicit
        ``serve-admin release``.

        Orphans whose payload is missing (stores written before
        durability, or a crash inside the admission window) are failed
        as before — a client polling from before the restart must
        terminate either way.  Jobs this scheduler tracks in memory are
        skipped (a stop()/start() cycle within one process must not
        touch live work).

        **Leases make "orphan" mean something over a SHARED store**
        (docs/SERVING.md "Multi-worker runbook"): a non-terminal record
        is only ours to touch after :meth:`LeaseManager.claim_orphan`
        wins its fencing token — absent/expired/released/torn leases
        (and, at ``boot=True``, a live-looking lease held by our own
        restart-stable worker_id: the dead former self) are claimable;
        a LIVE PEER's lease skips the job entirely, so a booting worker
        neither double-queues a running peer's job nor counts it as a
        restart toward quarantine (the solo fast-restart race closed by
        the same rule).  With ``boot=False`` this is the periodic
        takeover sweep the lease maintenance thread runs: a SIGKILLed
        peer's jobs are claimed by a survivor within ~ttl + one sweep,
        token bumped, resumed from the checkpoint ring.
        """
        if boot or self.leases is None:
            candidates = self.store.iter_jobs()
        else:
            candidates = self._dead_lease_candidates()
        for job_id, record in candidates:
            with self._lock:
                if job_id in self._jobs:
                    continue
            if record.get("status") not in ("queued", "running"):
                continue
            lease_token = None
            lease_reason = prior_worker = None
            if self.leases is not None:
                claimed = self.leases.claim_orphan(job_id, boot=boot)
                if claimed is None:
                    # A live peer's lease (or a lost claim race): not an
                    # orphan — leave it alone, bump NOTHING.
                    continue
                lease_token, lease_reason, prior_worker = claimed
                # Re-read AFTER winning the claim: a peer may have
                # terminalised the job between our record read and the
                # claim (its released tombstone is exactly what made
                # the lease claimable).
                record = self._fresh_or_stand_down(job_id)
                if record is None:
                    continue
                with self._lock:
                    self.lease_takeovers_total += 1
                self.events.emit(
                    "lease_takeover", job_id=job_id,
                    fingerprint=record.get("fingerprint"),
                    worker_id=self.worker_id,
                    prior_worker=prior_worker,
                    token=lease_token, reason=lease_reason,
                )
            elif not boot:
                # The periodic sweep exists only for the lease world;
                # without leases there is no safe way to distinguish a
                # peer's live job from a dead one's.
                continue
            requeued = False
            reason = "interrupted by service restart"
            payload = self.store.load_payload(job_id)
            if payload is not None:
                spec_payload, x, prior_requeues = payload
                try:
                    spec = JobSpec.from_payload(spec_payload)
                except (KeyError, TypeError, ValueError) as e:
                    # Schema drift (a payload written before a JobSpec
                    # field existed): name the real cause — the operator
                    # must not be sent chasing queue capacity.
                    reason = (
                        "interrupted by service restart (persisted "
                        f"payload unusable: {e!r})"
                    )
                    logger.warning(
                        "orphan %s payload unusable (%s); failing it",
                        job_id, e,
                    )
                else:
                    requeues = int(prior_requeues) + 1
                    if requeues > self.quarantine_after:
                        record.update(
                            status="quarantined",
                            error=(
                                "crash-looped: interrupted by "
                                f"{requeues} service restarts (cap "
                                f"{self.quarantine_after}); payload and "
                                "checkpoint ring retained — inspect and "
                                "release with `python -m "
                                "consensus_clustering_tpu_torch serve-admin "
                                "release`"
                            ),
                            restart_requeues=requeues - 1,
                            quarantined_at=round(time.time(), 3),
                        )
                        self.store.save_job(record)
                        # Payload + ring deliberately NOT deleted: the
                        # exact poison (config, data, partial state) is
                        # the debugging artefact.
                        if self.leases is not None:
                            self.leases.release(job_id, "quarantined")
                        with self._lock:
                            self.jobs_quarantined += 1
                        self.events.emit(
                            "job_quarantined", job_id=job_id,
                            fingerprint=record.get("fingerprint"),
                            restarts=requeues - 1,
                            worker_id=self.worker_id,
                        )
                        logger.error(
                            "quarantined crash-looping job %s after %d "
                            "restarts (release with serve-admin)",
                            job_id, requeues - 1,
                        )
                        continue
                    # Persist the bumped counter BEFORE the job becomes
                    # runnable: if it kills the process again before (or
                    # during) its run, the NEXT reconciliation must see
                    # this restart counted — that ordering is what makes
                    # the quarantine threshold reachable at all.
                    self.store.set_payload_attempts(
                        job_id, spec_payload, requeues
                    )
                    record.update(
                        status="queued",
                        requeued_after_restart=True,
                        restart_requeues=requeues,
                        requeued_at=round(time.time(), 3),
                    )
                    record.pop("error", None)
                    with self._lock:
                        self._jobs[job_id] = record
                        self._specs[job_id] = spec
                        self._data[job_id] = x
                    # Mirror BEFORE enqueueing (submit()'s rule): once
                    # the worker can see the id it starts writing
                    # "running"/"done" transitions, and this "queued"
                    # snapshot must never land after them.
                    self.store.save_job(dict(record))
                    try:
                        self._enqueue(job_id, spec)
                        requeued = True
                    except queue.Full:
                        # More orphans than queue slots: the overflow
                        # fails over — bounded admission outranks
                        # recovery completeness.  Undo the requeue
                        # claim the record briefly carried.
                        reason = (
                            "interrupted by service restart (queue "
                            "full on requeue)"
                        )
                        with self._lock:
                            del self._jobs[job_id]
                            del self._specs[job_id]
                            del self._data[job_id]
                        record.pop("requeued_after_restart", None)
                        record.pop("requeued_at", None)
                    if requeued:
                        with self._lock:
                            self.jobs_requeued += 1
                        self.events.emit(
                            "job_requeued", job_id=job_id,
                            fingerprint=record.get("fingerprint"),
                            restart_requeues=record["restart_requeues"],
                            worker_id=self.worker_id,
                        )
                        continue
            if self.leases is not None:
                # Last freshness check before failing over.  The one
                # interleaving the post-claim re-read above cannot see:
                # the previous owner passed its fence check BEFORE our
                # claim, then its terminal save_job + delete_payload
                # landed AFTER our re-read — the missing payload that
                # sent us down this fail path IS its completion, and we
                # hold the newest token so nothing fences THIS write.
                record = self._fresh_or_stand_down(job_id)
                if record is None:
                    continue
            record.update(
                status="failed",
                error=reason,
                finished_at=round(time.time(), 3),
            )
            self.store.save_job(record)
            self.store.delete_payload(job_id)
            if self.leases is not None:
                self.leases.release(job_id, "failed")
            self.events.emit(
                "job_failed", job_id=job_id, error=reason, kind="restart",
                worker_id=self.worker_id,
            )

    # -- fleet -----------------------------------------------------------

    def _warm_buckets(self) -> set:
        """Executable buckets this worker has a warm engine for —
        duck-typed off the executor's engine cache (stub executors
        simply have no warm set), used for the steal planner's
        prefer-warm rule and the heartbeat advertisement."""
        engines = getattr(self.executor, "_engines", None)
        if not isinstance(engines, dict):
            return set()
        try:
            return set(engines)
        except RuntimeError:  # resized mid-iteration by a compile
            return set()

    def _fleet_heartbeat_payload(self, now: float) -> Dict[str, Any]:
        """This worker's capacity advertisement (serve/fleet/
        heartbeat.py): backlog entries carry the EXECUTABLE bucket
        (``spec.bucket`` — the engine-cache key, what a thief's
        prefer-warm rule matches against) and the admission-time
        fusion key (what makes a stolen set fusable on arrival)."""
        with self._lock:
            running = sorted(
                j for j in self._jobs if j not in self._specs
            )
            specs = dict(self._specs)
            shapes = {j: x.shape for j, x in self._data.items()}
            fusion_keys = dict(self._fusion_keys)
            drained = [
                t for t in self._drain_times
                if now - t <= self._DRAIN_WINDOW_SECONDS
            ]
        queued = (
            self._queue.queued_ids(limit=self._fleet_backlog_limit)
            if self.schedule == "fair" else []
        )
        backlog: List[Dict[str, Any]] = []
        for job_id in queued:
            spec = specs.get(job_id)
            shape = shapes.get(job_id)
            if spec is None or shape is None:
                continue  # cancelled/taken between snapshot and here
            n, d = (int(v) for v in shape)
            backlog.append({
                "job_id": job_id,
                "bucket": spec.bucket(
                    n, d, self._resolved_h_block(spec, n, d)
                ),
                "fuse_key": fusion_keys.get(job_id),
                "priority": getattr(spec, "priority", "normal"),
            })
        rate = (
            round(len(drained) / self._DRAIN_WINDOW_SECONDS, 4)
            if drained else None
        )
        active = self.slo.snapshot().get("active") or {}
        burn_active = sum(
            1
            for per_bucket in active.values()
            if isinstance(per_bucket, dict)
            for flag in per_bucket.values()
            if flag
        )
        return {
            "worker_id": self.worker_id,
            "ts": round(now, 3),
            "capacity": int(self._queue.maxsize),
            "queue_depth": int(self._queue.qsize()),
            "running": running,
            "backlog": backlog,
            "drain_rate_per_s": rate,
            "warm_buckets": sorted(self._warm_buckets()),
            "slo_burn_active": burn_active,
            "schedule": self.schedule,
            "fusion_max": self.fusion_max,
        }

    def _fleet_round(self) -> None:
        """One fleet beat, riding the lease maintenance cadence
        (docs/SERVING.md "Fleet runbook"): publish our heartbeat, read
        the peers' (digest-verified, staleness-gated — torn or absent
        adverts degrade to the solo behaviour), refresh the autoscale
        signal (event on recommendation CHANGE only), and steal a
        same-bucket set when we are hungry and a peer is drowning."""
        now = time.time()
        payload = self._fleet_heartbeat_payload(now)
        try:
            write_heartbeat(self.store.fleet_dir, payload)
            with self._lock:
                self.fleet_heartbeats_written_total += 1
            self.events.emit(
                "fleet_heartbeat_written", worker_id=self.worker_id,
                queue_depth=payload["queue_depth"],
                running=len(payload["running"]),
                drain_rate_per_s=payload["drain_rate_per_s"],
                slo_burn_active=payload["slo_burn_active"],
            )
        except OSError:
            logger.exception("fleet heartbeat write failed")
        peers, rejected = read_fleet(
            self.store.fleet_dir, now=now,
            stale_after=self._fleet_stale_after,
            skip_worker=self.worker_id,
        )
        if rejected:
            with self._lock:
                self.fleet_heartbeats_rejected_total += rejected
        fleet_view = dict(peers)
        fleet_view[self.worker_id] = payload
        sig = scale_signal(
            fleet_view,
            target_drain_seconds=self.fleet_target_drain_seconds,
        )
        basis = sig["basis"]
        recommendation = sig["recommendation"]
        with self._lock:
            self._fleet_snapshot = {
                "enabled": True,
                "workers_seen": basis["workers_seen"],
                "fleet_backlog": basis["fleet_backlog"],
                "peer_backlog": (
                    basis["fleet_backlog"] - payload["queue_depth"]
                ),
                "fleet_running": basis["fleet_running"],
                "fleet_drain_rate_per_s":
                    basis["fleet_drain_rate_per_s"],
                "est_drain_seconds": basis["est_drain_seconds"],
                "slo_burn_active": basis["slo_burn_active"],
                "recommendation": recommendation,
            }
            changed = recommendation != self._last_scale_recommendation
            if changed:
                self._last_scale_recommendation = recommendation
                self.fleet_scale_signals_total += 1
        if changed:
            self.events.emit(
                "fleet_scale_signal", worker_id=self.worker_id,
                recommendation=recommendation, **basis,
            )
        if peers:
            self._maybe_steal(peers)

    def _maybe_steal(self, peers: Dict[str, Dict[str, Any]]) -> None:
        """Steal same-bucket sets while WE are hungry (queue at or
        below one fusion batch) and free capacity exists.  Bounded per
        round so one beat never floods the local queue — the next beat
        re-plans over fresh adverts."""
        if self.leases is None:
            return
        taken_this_round: set = set()
        for _ in range(self._steal_max_sets_per_round):
            depth = self._queue.qsize()
            free = self._queue.maxsize - depth
            if depth > max(1, self.fusion_max) or free < 1:
                return
            with self._lock:
                known = set(self._jobs)
            plan = plan_steal(
                peers,
                max_jobs=min(free, max(1, self.fusion_max)),
                head_skip=self._steal_head_skip,
                warm_buckets=self._warm_buckets(),
                exclude=known | taken_this_round,
            )
            if plan is None:
                return
            taken_this_round.update(plan["job_ids"])
            if not self._execute_steal_plan(plan):
                return

    def _execute_steal_plan(self, plan: Dict[str, Any]) -> List[str]:
        """Walk one steal plan: claim each job's next fencing token
        over the victim's LIVE lease, adopt it (payload → local state
        → our queue), and disclose the set with one ``work_stolen``
        event.  Every adoption re-reads record and lease — a stale
        advert costs a skipped claim, never a double execution."""
        victim = plan["victim"]
        executed: List[str] = []
        for job_id in plan["job_ids"]:
            record = self.store.load_job(job_id)
            if record is None or record.get("status") != "queued":
                continue
            with self._lock:
                if job_id in self._jobs:
                    continue
            # Only steal from the lease's CURRENT live owner, and only
            # when that owner is the advertising victim: a job another
            # thief already claimed (record still "queued", lease now
            # the thief's) must not ping-pong on a stale advert.
            cur = self.leases.current(job_id)
            if (
                cur is None
                or lease_state_name(cur, time.time()) != "live"
                or cur.get("worker_id") != victim
            ):
                continue
            claimed = self.leases.claim_steal(job_id)
            if claimed is None:
                continue
            try:
                if self._adopt_stolen_job(job_id, victim):
                    executed.append(job_id)
            except LeaseLost:
                continue  # out-stolen while adopting — their story now
            except Exception:  # noqa: BLE001 — isolate per job
                logger.exception(
                    "adopting stolen job %s failed", job_id
                )
                # The burned token is deliberately NOT released:
                # forget() lets it expire unrenewed, and the ordinary
                # takeover sweep (ours or a peer's) re-queues the job
                # from its persisted payload within ~ttl + one sweep.
                self.leases.forget(job_id)
        if executed:
            with self._lock:
                self.steals_total += 1
                self.stolen_jobs_total += len(executed)
            self.events.emit(
                "work_stolen", worker_id=self.worker_id,
                stolen_from=victim, job_ids=executed,
                count=len(executed), bucket=plan.get("bucket"),
                warm=bool(plan.get("warm")),
                peer_backlog=plan.get("peer_backlog"),
            )
        return executed

    def _adopt_stolen_job(self, job_id: str, victim: str) -> bool:
        """Post-claim adoption: freshness gate, payload load, local
        registration, fenced record write (the ``stolen_by`` mark that
        turns the victim's lost lease into a counted steal instead of
        an expiry), enqueue.  Returns False — leaving recovery to the
        lease-expiry path — when the job moved on or cannot be
        adopted."""
        fresh = self.store.load_job(job_id)
        if fresh is None or fresh.get("status") not in (
            "queued", "running",
        ):
            # Terminalised while we claimed: tombstone the token we
            # burned (the claim-orphan rule — _fresh_or_stand_down).
            self.leases.release(
                job_id, (fresh or {}).get("status") or "done"
            )
            return False
        payload = self.store.load_payload(job_id)
        if payload is None:
            self.leases.forget(job_id)  # expiry → takeover sweep
            return False
        spec_payload, x, _requeues = payload
        try:
            spec = JobSpec.from_payload(spec_payload)
        except (KeyError, TypeError, ValueError):
            self.leases.forget(job_id)
            return False
        fuse_key = None
        if self.fusion_max >= 2 and hasattr(self.executor, "run_fused"):
            n, d = (int(v) for v in x.shape)
            fuse_key = fusion_key(
                spec, n, d, self._resolved_h_block(spec, n, d)
            )
        fresh["status"] = "queued"
        with self._lock:
            self._jobs[job_id] = fresh
            self._specs[job_id] = spec
            self._data[job_id] = x
            self._fusion_keys[job_id] = fuse_key
        # Mirror BEFORE enqueueing (submit()'s rule).  We hold the
        # newest token, so this fenced write lands; quiet_fence covers
        # the tiny window where a third thief out-claims us.
        self._update(
            job_id, quiet_fence=True, status="queued",
            stolen_by=self.worker_id, stolen_from=victim,
            stolen_at=round(time.time(), 3),
        )
        try:
            self._enqueue(job_id, spec)
        except queue.Full:
            # Raced a local admission flood: drop the local state and
            # let the token expire unrenewed — the takeover sweep
            # re-queues the job from its payload.  Never strand it.
            with self._lock:
                self._jobs.pop(job_id, None)
                self._specs.pop(job_id, None)
                self._data.pop(job_id, None)
                self._fusion_keys.pop(job_id, None)
            self.leases.forget(job_id)
            return False
        return True

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        try:
            # Wake a worker blocked on an empty queue; when the queue is
            # full the worker is busy anyway and will see _stop after the
            # current job.
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None
        if self._lease_thread is not None:
            self._lease_thread.join(timeout)
            self._lease_thread = None

    # -- submission ------------------------------------------------------

    def submit(self, spec: JobSpec, x: np.ndarray) -> Dict[str, Any]:
        """Admit a job; returns its (already jobstore-mirrored) record.

        Identical (config, data) submissions dedup: if the fingerprint's
        result is stored, the job is born ``done`` with that result and
        never queues.  Raises :class:`QueueFull` when the queue is at
        capacity, :class:`PreflightReject` (413) when the job's
        estimated memory footprint exceeds the budget, and
        :class:`QueueShed` (429 + Retry-After) when the shed policy
        refuses this priority under current pressure.  The gates run in
        that order, after the dedup check — a stored result is served
        whatever the pressure, it costs one disk read.
        """
        # Resolve mode=auto FIRST: the fingerprint (identity, dedup,
        # checkpoint ring key) must always be taken over a CONCRETE
        # mode — an "auto" that resolved differently under a different
        # budget must be a different job, not the same fingerprint
        # with two possible answers.
        spec = self._resolve_mode(spec, x)
        # The payload carries the executor's backend tag (torch-cuda or
        # torch-cpu): card and CPU results differ, so in a store shared
        # by several workers neither may answer the other's job.
        fp = self.store.fingerprint(
            dict(spec.fingerprint_payload(), backend=self.executor.backend()),
            x,
        )
        job_id = uuid.uuid4().hex
        record: Dict[str, Any] = {
            "job_id": job_id,
            "fingerprint": fp,
            "status": "queued",
            "shape": [int(v) for v in x.shape],
            "submitted_at": round(time.time(), 3),
            "attempt": 0,
            "priority": spec.priority,
            "tenant": getattr(spec, "tenant", "default"),
        }
        if getattr(spec, "refine_parent", None):
            # Durable lineage for a progressive continuation: the spec
            # field is a scheduling annotation (never fingerprinted);
            # the RECORDS carry the linkage both ways — this side here,
            # the parent's continuation_job_id at enqueue time.
            record["continuation_of"] = spec.refine_parent
        if getattr(spec, "append_parent", None):
            # Append lineage is part of the spec's IDENTITY (it is
            # fingerprinted, unlike refine_parent), but the record
            # carries it too so the ops surfaces (serve-admin report,
            # JSONL queries) can follow the lineage without decoding
            # fingerprint payloads.
            record["append_parent"] = spec.append_parent
        cached = self.store.get_result(fp)
        if cached is not None:
            record["status"] = "done"
            record["result"] = cached
            record["from_cache"] = True
            with self._lock:
                self.cache_hits += 1
            # Born terminal: mirrored to the jobstore only — GET serves
            # it from disk, and _jobs never holds it (see _update's
            # eviction rationale).  NOTE: a progressive parent served
            # from cache gets NO continuation — the cached estimate's
            # refined twin either already exists under the
            # continuation's own fingerprint (dedup served it too) or
            # was never asked for; re-deriving it here would re-run
            # admission on a job the client was told is done.
            self.store.save_job(record)
            self.events.emit(
                "job_submitted", job_id=job_id, fingerprint=fp,
                shape=record["shape"], cached=True, mode=spec.mode,
                worker_id=self.worker_id,
            )
            return record

        self._preflight(spec, x, fp)
        self._shed_gate(spec, fp)
        record["from_cache"] = False
        # Fusion eligibility is decided at admission (serve/sched/
        # fusion.py): the key is what the worker's planner matches
        # queued jobs on.  Only computed when fusion can trigger.
        fuse_key = None
        if self.fusion_max >= 2 and hasattr(self.executor, "run_fused"):
            n, d = (int(v) for v in x.shape)
            fuse_key = fusion_key(
                spec, n, d, self._resolved_h_block(spec, n, d)
            )
        with self._lock:
            self._jobs[job_id] = record
            self._specs[job_id] = spec
            self._data[job_id] = x
            self._fusion_keys[job_id] = fuse_key
        # Persist the payload FIRST: from the moment the record is
        # visible as "queued", a crash must leave everything a restarted
        # process needs to re-queue the job (config + data), or the
        # reconciliation sweep falls back to failing it.
        try:
            self.store.save_payload(job_id, spec.fingerprint_payload(), x)
        except Exception:
            # Disk full / unwritable store: without this rollback the
            # job would sit in _jobs as "queued" forever — never
            # enqueued, never reconciled (reconciliation skips
            # in-memory ids), data matrix pinned in _data.
            with self._lock:
                del self._jobs[job_id]
                del self._specs[job_id]
                del self._data[job_id]
                self._fusion_keys.pop(job_id, None)
            self.store.delete_payload(job_id)  # any half-written part
            raise
        # Claim the job's lease BEFORE the record is mirrored: from the
        # moment a peer's takeover sweep can see the "queued" record,
        # the live lease is what tells it a healthy worker owns this
        # job (renewed by the maintenance thread even while the job
        # waits behind a long one).  The other order would publish a
        # disk-write-wide window where the record exists lease-less and
        # a peer's sweep could legitimately claim it as an orphan.
        if self.leases is not None:
            token = self.leases.claim_new(job_id)
            if token is None:
                # Unreachable for a fresh uuid barring store tampering;
                # admitting an unclaimable job would strand it (every
                # fenced write would refuse), so reject loudly instead.
                with self._lock:
                    del self._jobs[job_id]
                    del self._specs[job_id]
                    del self._data[job_id]
                    self._fusion_keys.pop(job_id, None)
                self.store.delete_payload(job_id)
                raise RuntimeError(
                    f"could not claim a lease for new job {job_id} — "
                    "another worker holds its token (store tampering?)"
                )
        # Mirror to the jobstore BEFORE enqueueing: once the worker can see
        # the job it starts writing "running"/"done" transitions, and the
        # admission-time "queued" snapshot must never land after (and
        # clobber) them.  Snapshot now for the same reason: the live record
        # is the worker's to mutate the moment the id enters the queue, and
        # the caller's HTTP response must serialise a stable "queued" view.
        self.store.save_job(record)
        snapshot = dict(record)
        try:
            self._enqueue(job_id, spec)
        except queue.Full:
            with self._lock:
                del self._jobs[job_id]
                del self._specs[job_id]
                del self._data[job_id]
                self._fusion_keys.pop(job_id, None)
            self.store.delete_job(job_id)
            self.store.delete_payload(job_id)
            if self.leases is not None:
                self.leases.drop(job_id)
            raise QueueFull(
                f"queue full ({self._queue.maxsize} jobs); retry later"
            )
        if spec.mode == "progressive":
            with self._lock:
                self.progressive_jobs_total += 1
        if spec.mode == "append":
            with self._lock:
                self.append_jobs_total += 1
            # The admission-side append event (docs/SERVING.md "Append
            # runbook"): the job passed validation + the marginal-cost
            # preflight and entered the queue against this parent.
            self.events.emit(
                "append_admitted", job_id=job_id, fingerprint=fp,
                append_parent=spec.append_parent,
                n_iterations=int(spec.n_iterations),
                shape=record["shape"],
                worker_id=self.worker_id,
            )
        self.events.emit(
            "job_submitted", job_id=job_id, fingerprint=fp,
            shape=record["shape"], cached=False, mode=spec.mode,
            priority=spec.priority,
            tenant=getattr(spec, "tenant", "default"),
            worker_id=self.worker_id,
        )
        return snapshot

    def _resolved_h_block(self, spec: JobSpec, n: int, d: int) -> int:
        h_block = 16
        if hasattr(self.executor, "_resolve_h_block"):
            try:
                h_block = int(
                    self.executor._resolve_h_block(spec, n, d).value
                )
            except Exception:  # noqa: BLE001 — the estimate survives a
                pass  # resolution hiccup; 16 is the heuristic floor
        return h_block

    def _packed_estimate(
        self, spec: JobSpec, n: int, d: int, h_block: int
    ) -> Dict[str, Any]:
        """The packed-representation footprint model (uint32 bit-plane
        masks, ~1/32 the dense accumulator bytes, exact counts) — the
        admission gate for ``accum_repr="packed"`` jobs and the third
        disclosure block on every dense 413."""
        return estimate_packed_bytes(
            n, d, spec.k_values,
            n_iterations=spec.n_iterations,
            dtype=spec.dtype,
            h_block=h_block,
            subsampling=spec.subsampling,
            checkpoints=self.checkpoints,
        )

    def _exact_estimate(
        self, spec: JobSpec, n: int, d: int, h_block: int
    ) -> Dict[str, Any]:
        """The (correction-tightened) dense-engine footprint model —
        the admission gate for exact-mode jobs.  Packed-representation
        jobs gate on THEIR model instead (that asymmetry is the whole
        admission story: an exact job that 413s dense can resubmit
        packed and fit) — uncorrected, because the memory accountant's
        EWMA ledger is fed by dense executions of this shape bucket
        and must not tighten a representation it never measured."""
        if getattr(spec, "accum_repr", "dense") == "packed":
            return self._packed_estimate(spec, n, d, h_block)
        estimate = estimate_job_bytes(
            n, d, spec.k_values,
            dtype=spec.dtype,
            h_block=h_block,
            subsampling=spec.subsampling,
            checkpoints=self.checkpoints,
        )
        # Measured-reality feedback (docs/OBSERVABILITY.md "Memory
        # accounting"): when this bucket's executed jobs have shown the
        # model under-counting, scale the estimate UP by the observed
        # correction before judging the budget.  The factor is >= 1 by
        # construction — live evidence only ever tightens the gate, it
        # never relaxes the model's own lower bound.  (The bucket key
        # is the EXACT-mode one: estimate-mode jobs feed a separate
        # suffixed ledger and never touch this correction.)
        accountant = getattr(self.executor, "memory_accounting", None)
        if accountant is not None and hasattr(accountant, "correction"):
            try:
                correction = float(
                    accountant.correction(
                        shape_bucket(
                            n, d, spec.n_iterations, spec.k_values
                        )
                    )
                )
            except Exception:  # noqa: BLE001 — the gate survives an
                correction = 1.0  # accounting hiccup; the model stands
            if correction > 1.0:
                estimate = dict(estimate)
                estimate["model_total_bytes"] = estimate["total_bytes"]
                estimate["correction_factor"] = round(correction, 4)
                estimate["total_bytes"] = int(
                    estimate["total_bytes"] * correction
                )
        return estimate

    def _estimator_estimate(
        self, spec: JobSpec, n: int, d: int, h_block: int
    ) -> Dict[str, Any]:
        return estimate_estimator_bytes(
            n, d, spec.k_values,
            n_pairs=spec.n_pairs,
            dtype=spec.dtype,
            h_block=h_block,
            subsampling=spec.subsampling,
            checkpoints=self.checkpoints,
            # Price the representation the job would actually run —
            # the packed pair path's live planes are ~1/32 the dense
            # scatter's bytes.
            accum_repr=getattr(spec, "accum_repr", "dense"),
        )

    def _device_count(self) -> int:
        """Local device count for the sharded-footprint disclosure: the
        visible CUDA cards for an executor on CUDA (the port's estimator
        runs on an ('h', 'n') mesh over them), else 1, and the disclosure
        is then omitted — a mesh hint over zero extra devices helps
        nobody."""
        import torch

        device = getattr(self.executor, "device", None)
        if device is None or torch.device(device).type != "cuda":
            return 1
        return torch.cuda.device_count()

    def _sharded_disclosure(
        self, estimator_est: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """The per-device mesh-sharded estimator footprint + mesh hint
        (serve/preflight.estimate_estimator_sharded) when this worker
        has >= 2 devices, with its own ``fits_budget`` verdict — the
        413 body's "refused solo, fits sharded" disclosure."""
        devices = self._device_count()
        if devices < 2:
            return None
        sharded = estimate_estimator_sharded(estimator_est, devices)
        sharded["fits_budget"] = (
            int(sharded["per_device_bytes"]) <= self.memory_budget_bytes
        )
        return sharded

    def _resolve_mode(self, spec: JobSpec, x: np.ndarray) -> JobSpec:
        """Resolve ``mode=auto`` to a concrete engine at admission:
        exact when the dense footprint fits the budget (or no budget
        is configured), the sampled-pair estimator when only IT fits —
        the 413-becomes-admission path, taken silently for auto jobs
        and disclosed via the ``estimator_selected`` event + counter.
        An auto job neither engine can fit stays exact, so the 413 the
        preflight then raises discloses both footprints honestly."""
        if getattr(spec, "mode", "exact") != "auto":
            return spec
        if self.memory_budget_bytes is None:
            return dataclasses.replace(spec, mode="exact", n_pairs=None)
        n, d = (int(v) for v in x.shape)
        h_block = self._resolved_h_block(spec, n, d)
        exact = self._exact_estimate(spec, n, d, h_block)
        if int(exact["total_bytes"]) <= self.memory_budget_bytes:
            return dataclasses.replace(spec, mode="exact", n_pairs=None)
        estimator = self._estimator_estimate(spec, n, d, h_block)
        if int(estimator["total_bytes"]) > self.memory_budget_bytes:
            # Neither engine fits: stay exact so the preflight's 413
            # tells the whole story — and KEEP the user's n_pairs pin,
            # so the 413's estimator block prices the configuration
            # they actually asked for (advertising the default pair
            # count's fits_budget for a discarded pin would send the
            # client into the second round-trip this body exists to
            # prevent).
            return dataclasses.replace(spec, mode="exact")
        resolved = dataclasses.replace(spec, mode="estimate")
        with self._lock:
            self.estimator_selected_total += 1
        from consensus_clustering_tpu_torch.estimator.bounds import (
            pac_error_bound,
        )

        self.events.emit(
            "estimator_selected",
            shape=[n, d],
            exact_bytes=int(exact["total_bytes"]),
            estimator_bytes=int(estimator["total_bytes"]),
            budget_bytes=int(self.memory_budget_bytes),
            n_pairs=int(estimator["n_pairs"]),
            pac_error_bound=pac_error_bound(
                int(estimator["n_pairs"]), n, spec.parity_zeros
            ),
            worker_id=self.worker_id,
        )
        return resolved

    def _preflight(self, spec: JobSpec, x: np.ndarray, fp: str) -> None:
        """Reject an over-budget job with a structured 413 BEFORE it
        can compile/admit and OOM every in-flight job.  No-op without
        a configured budget.  The 413 body carries BOTH footprint
        models — the dense one that gated (or would gate) the job and
        the estimator's O(M) one — plus the error bound a
        ``mode=estimate`` resubmission would disclose, so the client
        decides without a second round-trip."""
        if self.memory_budget_bytes is None:
            return
        n, d = (int(v) for v in x.shape)
        h_block = self._resolved_h_block(spec, n, d)
        estimator_est = self._estimator_estimate(spec, n, d, h_block)
        # Packed-representation disclosure (ROADMAP item 1): priced for
        # every job that is not already packed, so a dense 413 carries
        # the exact-mode escape hatch next to the estimator's — the
        # three-way choice, decided from one response.
        mode = getattr(spec, "mode", "exact")
        packed_info = None
        if (
            mode not in ("estimate", "progressive", "refine")
            and getattr(spec, "accum_repr", "dense") != "packed"
        ):
            packed_est = self._packed_estimate(spec, n, d, h_block)
            packed_info = {
                "estimated_bytes": int(packed_est["total_bytes"]),
                "fits_budget": (
                    int(packed_est["total_bytes"])
                    <= self.memory_budget_bytes
                ),
                "estimate": dict(packed_est),
                "hint": (
                    "resubmit with config.accum_repr = 'packed' to "
                    "run EXACT consensus on bit-plane accumulators at "
                    "this footprint (results bit-identical to dense)"
                ),
            }
        sharded = self._sharded_disclosure(estimator_est)
        continuation_info = None
        if mode in ("estimate", "progressive"):
            # Estimate-mode jobs are gated on their own O(M) model
            # (uncorrected: the correction EWMA belongs to the dense
            # model's bucket).  A reject here has no cheaper mode to
            # point at — the estimator IS the cheap mode — but the
            # sharded per-device footprint still rides the body: a job
            # refused solo may fit mesh-sharded, bit-identically.  A
            # progressive parent gates identically (its first phase IS
            # an estimate run); its SECOND phase is priced below as a
            # pure disclosure — the continuation is admitted by the
            # gate when it is actually submitted, but the 413/202 body
            # must tell the client both phases' footprints up front.
            estimate = dict(estimator_est)
            if sharded is not None:
                estimate["sharded"] = sharded
            estimator_info = None
            if mode == "progressive":
                refine_est = estimate_refine_bytes(
                    n, d, max(spec.k_values), spec.n_iterations,
                    dtype=spec.dtype, h_block=h_block,
                    subsampling=spec.subsampling,
                )
                continuation_info = {
                    # Pessimistic by construction: priced at the FULL
                    # requested H and the LARGEST candidate K — the
                    # actual continuation runs h_effective and best_k,
                    # both <= these.
                    "estimated_bytes": int(refine_est["total_bytes"]),
                    "fits_budget": (
                        int(refine_est["total_bytes"])
                        <= self.memory_budget_bytes
                    ),
                    "estimate": dict(refine_est),
                }
        elif mode == "refine":
            # The continuation itself: gated on the host tiled-
            # refinement model — (H, N) indicators plus one row tile,
            # linear in N where the dense engine is quadratic.
            estimate = estimate_refine_bytes(
                n, d, max(spec.k_values), spec.n_iterations,
                dtype=spec.dtype, h_block=h_block,
                subsampling=spec.subsampling,
            )
            estimator_info = None
        elif mode == "append":
            # Append jobs are priced by their MARGINAL lanes: the
            # packed sweep over only the new resamples, plus the plane
            # store (old + new + merged generations at merge peak) and
            # the host mixing workspace.  That is the whole point of
            # the mode — admission must reflect the marginal cost, not
            # the from-scratch footprint the append avoids.
            estimate = estimate_append_bytes(
                n, d, spec.k_values,
                n_iterations=spec.n_iterations,
                dtype=spec.dtype, h_block=h_block,
                subsampling=spec.subsampling,
            )
            estimator_info = None
        else:
            estimate = self._exact_estimate(spec, n, d, h_block)
            from consensus_clustering_tpu_torch.estimator.bounds import (
                pac_error_bound,
            )

            estimator_info = {
                "estimated_bytes": int(estimator_est["total_bytes"]),
                "n_pairs": int(estimator_est["n_pairs"]),
                "fits_budget": (
                    int(estimator_est["total_bytes"])
                    <= self.memory_budget_bytes
                ),
                "pac_error_bound": pac_error_bound(
                    int(estimator_est["n_pairs"]), n, spec.parity_zeros
                ),
                "estimate": dict(estimator_est),
                "hint": (
                    "resubmit with config.mode = 'estimate' (or "
                    "'auto') to run the sampled-pair estimator at "
                    "this footprint with the disclosed PAC error "
                    "bound"
                ),
            }
            if sharded is not None:
                # The mesh hint next to the single-device model: the
                # estimator shards its lanes/pair slots over ('h',
                # 'n') with bit-identical output, so "fits sharded"
                # is a pure capacity statement.
                estimator_info["sharded"] = sharded
        try:
            check_admission(
                estimate, self.memory_budget_bytes, x.shape,
                estimator=estimator_info,
                packed=packed_info,
                continuation=continuation_info,
            )
        except PreflightReject as e:
            with self._lock:
                self.preflight_rejects_total += 1
            self.events.emit(
                "job_preflight_reject", fingerprint=fp,
                shape=[n, d],
                estimated_bytes=e.payload["estimated_bytes"],
                budget_bytes=e.payload["budget_bytes"],
                worker_id=self.worker_id,
            )
            raise

    def _shed_gate(self, spec: JobSpec, fp: str) -> None:
        """Apply the overload shed policy to this admission; raises
        :class:`QueueShed` when the policy refuses.  No-op without a
        policy."""
        if self.shed_policy is None:
            return
        now = time.time()
        with self._lock:
            self._recent_wedges = [
                t for t in self._recent_wedges
                if now - t <= self.shed_policy.wedge_window
            ]
            wedges = len(self._recent_wedges)
        reason = self.shed_policy.decide(
            spec.priority, self._queue.qsize(), self._queue.maxsize,
            wedges,
        )
        if reason is None:
            return
        with self._lock:
            self.jobs_shed_total[spec.priority] = (
                self.jobs_shed_total.get(spec.priority, 0) + 1
            )
        # Retry-After from the LIVE queue drain rate (floored at the
        # static --shed-retry-after): a hint derived from evidence, and
        # the basis rides the 429 body so the client can see it.
        retry_after, basis = self._retry_after()
        self.events.emit(
            "job_shed", fingerprint=fp, priority=spec.priority,
            tenant=getattr(spec, "tenant", "default"),
            reason=reason, queue_depth=self._queue.qsize(),
            retry_after_seconds=round(retry_after, 3),
            worker_id=self.worker_id,
            **(
                {"continuation_of": spec.refine_parent}
                if getattr(spec, "refine_parent", None) else {}
            ),
        )
        raise QueueShed(spec.priority, reason, retry_after, basis=basis)

    def get(self, job_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            record = self._jobs.get(job_id)
            if record is not None:
                return dict(record)
        return self.store.load_job(job_id)  # pre-restart jobs

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def metrics(self) -> Dict[str, Any]:
        # Executor-side reads go through _EXECUTOR_COUNTER_ATTRS /
        # _EXECUTOR_OBJECT_ATTRS (one table, schema-tested against the
        # real SweepExecutor) so a renamed attribute fails a test
        # instead of silently reporting 0 forever.
        executor_counters = {
            key: getattr(self.executor, attr, 0)
            for key, attr in _EXECUTOR_COUNTER_ATTRS.items()
        }
        hist_block = getattr(
            self.executor, "hist_block_seconds", _ZERO_HISTOGRAM
        )
        hist_ckpt = getattr(
            self.executor, "hist_checkpoint_write_seconds",
            _ZERO_HISTOGRAM,
        )
        drift = getattr(self.executor, "drift", _ZERO_DRIFT)
        accountant = getattr(
            self.executor, "memory_accounting", _ZERO_MEMORY
        )
        # Queue reads BEFORE taking our own lock: the fair queue has
        # its own condition lock, and the fusion planner's
        # take_matching holds it while reading pre-captured snapshots —
        # never calling back into scheduler state — so the only safe
        # lock order is queue-then-scheduler or neither-nested.
        queue_depth = self._queue.qsize()
        fair_lanes = (
            self._queue.snapshot() if self.schedule == "fair" else {}
        )
        starvation_grants = (
            self._queue.starvation_grants_total
            if self.schedule == "fair" else 0
        )
        with self._lock:
            return {
                "queue_depth": queue_depth,
                "queue_capacity": self._queue.maxsize,
                # Fair-share scheduling (docs/SERVING.md "Fair-share &
                # fusion runbook"): the active schedule, per-lane
                # depths (lane keys are traffic-dynamic like
                # retry_total), and starvation-clock grants.
                "schedule": self.schedule,
                "fair_lanes": fair_lanes,
                "fair_starvation_grants_total": starvation_grants,
                # Same-bucket fusion: fused device programs run, jobs
                # that rode one, and fused attempts degraded to solo.
                "fused_executions_total": self.fused_executions_total,
                "fused_jobs_total": self.fused_jobs_total,
                "fusion_degraded_total": self.fusion_degraded_total,
                # Streamed partial results: SSE streams opened, client
                # cancels (disconnect-triggered), jobs cancelled.
                "jobs_cancelled_total": self.jobs_cancelled_total,
                "sse_streams_total": self.sse_streams_total,
                "sse_cancels_total": self.sse_cancels_total,
                # Progressive serving (docs/SERVING.md "Progressive
                # serving runbook"): parents admitted and the
                # continuation lifecycle — enqueued / refined to done /
                # cancelled / shed at enqueue.
                "progressive_jobs_total": self.progressive_jobs_total,
                # Append serving (docs/SERVING.md "Append runbook"):
                # admissions here; runs/fallbacks/stores written ride
                # in via the executor counter map.
                "append_jobs_total": self.append_jobs_total,
                "continuations_enqueued_total":
                    self.continuations_enqueued_total,
                "continuations_completed_total":
                    self.continuations_completed_total,
                "continuations_cancelled_total":
                    self.continuations_cancelled_total,
                "continuations_shed_total":
                    self.continuations_shed_total,
                "jobs_completed": self.jobs_completed,
                "jobs_failed": self.jobs_failed,
                "jobs_retried": self.jobs_retried,
                "jobs_timed_out": self.jobs_timed_out,
                "cache_hits": self.cache_hits,
                # The H-agnostic bucket win (hits/misses: jobs
                # differing only in H sharing one warm executable),
                # adaptive savings (h_requested vs h_effective), and
                # the resilience counters — all duck-typed reads via
                # the schema-tested attribute table above.
                **executor_counters,
                "retry_total": dict(self.retry_total),
                "jobs_requeued": self.jobs_requeued,
                # Hostile-path counters (docs/SERVING.md "Overload &
                # wedge runbook"): wedge verdicts, crash-loop
                # quarantines, admissions shed by priority, and
                # preflight 413s.  All pre-seeded at construction.
                "jobs_wedged_total": self.jobs_wedged_total,
                "jobs_quarantined": self.jobs_quarantined,
                "jobs_shed_total": dict(self.jobs_shed_total),
                "preflight_rejects_total": self.preflight_rejects_total,
                # Sampled-pair admission path (docs/SERVING.md "The
                # 413 -> mode=estimate admission path"): auto jobs the
                # resolver routed onto the estimator because only its
                # O(M) footprint fit the budget.
                "estimator_selected_total": self.estimator_selected_total,
                "memory_budget_bytes": self.memory_budget_bytes,
                # Fenced-lease layer (docs/SERVING.md "Multi-worker
                # runbook"): who this worker is, how many leases it
                # holds right now, orphans it claimed, writes the fence
                # refused (we were the zombie), and leases of ours a
                # peer superseded.  All pre-seeded / always-present.
                "worker_id": self.worker_id,
                "active_leases": (
                    self.leases.owned_count()
                    if self.leases is not None else 0
                ),
                "lease_takeovers_total": self.lease_takeovers_total,
                "lease_refused_writes_total":
                    self.lease_refused_writes_total,
                "lease_expired_total": self.lease_expired_total,
                # Fleet layer (docs/SERVING.md "Fleet runbook"): steal
                # sets executed / jobs ridden / jobs of ours a peer
                # stole (healthy rebalancing, counted apart from
                # expiry), heartbeat writes and rejected reads, scale-
                # signal changes, and the fixed-key fleet snapshot the
                # last round refreshed.  All pre-seeded.
                "steals_total": self.steals_total,
                "stolen_jobs_total": self.stolen_jobs_total,
                "jobs_lost_to_steal_total":
                    self.jobs_lost_to_steal_total,
                "fleet_heartbeats_written_total":
                    self.fleet_heartbeats_written_total,
                "fleet_heartbeats_rejected_total":
                    self.fleet_heartbeats_rejected_total,
                "fleet_scale_signals_total":
                    self.fleet_scale_signals_total,
                "fleet": dict(self._fleet_snapshot),
                # Silent-corruption defense (docs/SERVING.md "Integrity
                # runbook"): sentinel evaluations and breaches by
                # detection point (retried as corrupt:<point>).  All
                # pre-seeded.
                "integrity_checks_total": self.integrity_checks_total,
                "integrity_violations_total": dict(
                    self.integrity_violations_total
                ),
                # Block-size resolution tiers over executed jobs
                # (docs/AUTOTUNE.md "Provenance"): whether calibration
                # actually steers traffic, or jobs pin their own block,
                # or everything falls to the heuristic default.
                "autotune_provenance_total": dict(getattr(
                    self.executor, "autotune_provenance", {}
                ) or {}),
                # Observability layer (docs/OBSERVABILITY.md): fixed-
                # bucket latency histograms (key set and bucket bounds
                # never change at runtime — every bucket pre-seeded),
                # the per-bucket perf-drift snapshot, and the two
                # scalar obs counters.  Histogram snapshots copy under
                # each histogram's own lock; the drift snapshot under
                # the watchdog's.
                "latency_histograms": {
                    "job_seconds": self.hist_job_seconds.snapshot(),
                    "queue_wait_seconds":
                        self.hist_queue_wait_seconds.snapshot(),
                    "block_seconds": hist_block.snapshot(),
                    "checkpoint_write_seconds": hist_ckpt.snapshot(),
                },
                "perf_drift": drift.snapshot(),
                "perf_drift_events_total": self.perf_drift_events_total,
                "profile_requests_total": self.profile_requests_total,
                # Resource accounting + SLO layer (docs/OBSERVABILITY.md
                # "Memory accounting" / "SLO layer"): both snapshots
                # carry FIXED top-level keys (schema-tested) with
                # per-bucket sub-dicts that grow with traffic, copied
                # under each object's own lock.
                "memory_accounting": accountant.snapshot(),
                "slo": self.slo.snapshot(),
                "slo_breach_events_total": self.slo_breach_events_total,
                "preflight_inaccurate_events_total":
                    self.preflight_inaccurate_events_total,
                "sweeps_executed": self.executor.run_count,
                "backend": self.executor.backend(),
            }

    # -- worker ----------------------------------------------------------

    def _update(
        self, job_id: str, quiet_fence: bool = False, **fields
    ) -> Dict[str, Any]:
        # The fence: a record write for a job whose lease a peer
        # superseded must not land — the successor owns this job's
        # story now.  Raises LeaseLost (handled by the worker loop)
        # after emitting lease_refused — except under ``quiet_fence``,
        # the attempt-0 pickup spelling where a refusal means the job
        # was STOLEN while queued and the stand-down is healthy
        # (see _fence).
        self._fence(
            job_id, f"update:{fields.get('status') or 'fields'}",
            quiet=quiet_fence,
        )
        with self._lock:
            record = self._jobs.get(job_id)
            if record is None:
                # A takeover raced between the fence check and here:
                # _note_lost_leases already dropped the local state.
                raise LeaseLost(job_id, "update", None, None)
            record.update(fields)
            snapshot = dict(record)
        self.store.save_job(snapshot)
        if snapshot.get("status") in _TERMINAL:
            # Terminal records (which embed the full result JSON) are
            # served from the jobstore from here on; keeping every
            # finished job in process memory forever would grow RSS
            # monotonically on a long-lived service.  get() already
            # falls back to store.load_job, so eviction is invisible.
            with self._lock:
                self._jobs.pop(job_id, None)
            # The payload exists to survive a crash of a NON-terminal
            # job; past this point it is dead weight — EXCEPT for a
            # quarantined job, whose payload (the exact poison) is the
            # debugging artefact the quarantine retains by contract.
            # The checkpoint ring goes only on success: a failed/
            # timed-out/quarantined job's ring lets a resubmission or a
            # released job resume the lost progress.
            if snapshot.get("status") != "quarantined":
                self.store.delete_payload(job_id)
            # The ring goes on success AND on client cancel (the client
            # walked away from the partial state — a cancelled job's
            # ring is dead weight by the cancel contract, docs/
            # SERVING.md "Fair-share & fusion runbook"); a failed/
            # timed-out job's ring still survives for resubmission.
            if snapshot.get("status") in ("done", "cancelled") and (
                snapshot.get("fingerprint")
            ):
                self.store.clear_checkpoints(snapshot["fingerprint"])
            # Terminal = release: the lease is tombstoned (token KEPT)
            # so a zombie's write after this still finds a newer-or-
            # released token and is refused — released, not deleted.
            if self.leases is not None:
                self.leases.release(job_id, snapshot["status"])
            with self._lock:
                self._cancel_flags.pop(job_id, None)
                self._fusion_keys.pop(job_id, None)
            # Live SSE subscribers get the terminal record as their
            # final frame (best-effort fan-out; the JSONL log is the
            # durable story).  One exception: a progressive parent
            # whose continuation is still pending keeps its channel
            # OPEN — the frame says done + upgrade_pending so the
            # client has its banded answer now, and the terminal frame
            # arrives when the continuation settles (result_upgraded
            # or continuation_settled, published on THIS channel by
            # _settle_continuation — on whichever worker terminalises
            # the continuation, takeover included).
            cont_id = snapshot.get("continuation_job_id")
            upgrade_pending = (
                snapshot.get("status") == "done" and bool(cont_id)
            )
            frame: Dict[str, Any] = {
                "event": f"job_{snapshot['status']}",
                "terminal": not upgrade_pending,
                "record": snapshot,
            }
            if upgrade_pending:
                frame["upgrade_pending"] = True
                frame["continuation_job_id"] = cont_id
            self.bus.publish(job_id, frame)
            if upgrade_pending:
                cont = self.get(cont_id)
                if (
                    cont is not None
                    and cont.get("status") in _TERMINAL
                ):
                    # Dedup edge: the continuation was born done from
                    # cache (its refined twin already in the store), so
                    # its own terminal _update never ran — settle the
                    # parent's story here instead.
                    self._settle_continuation(job_id, cont)
            parent_id = snapshot.get("continuation_of")
            if parent_id:
                self._settle_continuation(parent_id, snapshot)
        return snapshot

    def _settle_continuation(
        self, parent_id: str, cont_record: Dict[str, Any]
    ) -> None:
        """A progressive continuation reached a terminal state: tell
        the PARENT's story.  ``done`` → the exactness upgrade: counted,
        disclosed durably as a JSONL ``result_upgraded`` event (what
        serve-admin trace reconstructs), and pushed as a terminal
        ``result_upgraded`` frame on the parent's SSE channel — the
        DKW band collapses to zero and the refined
        ``result_fingerprint`` rides the frame, a DISCLOSED upgrade,
        never a silent swap (the continuation's fingerprint lineage is
        its own: semantic ``mode="refine"``).  Any other terminal
        outcome → the refinement will never arrive: count cancels, and
        close the parent's channel with a bus-only
        ``continuation_settled`` frame so a watching client is not
        left hanging."""
        status = cont_record.get("status")
        cont_id = cont_record.get("job_id")
        if status == "done":
            result = cont_record.get("result") or {}
            with self._lock:
                self.continuations_completed_total += 1
            self.events.emit(
                "result_upgraded", job_id=parent_id,
                continuation_job_id=cont_id,
                fingerprint=result.get("result_fingerprint"),
                best_k=result.get("best_k"),
                pac_error_bound=0.0,
                worker_id=self.worker_id,
            )
            self.bus.publish(parent_id, {
                "event": "result_upgraded", "terminal": True,
                "job_id": parent_id,
                "continuation_job_id": cont_id,
                "pac_error_bound": 0.0,
                "record": dict(cont_record),
            })
        else:
            if status == "cancelled":
                with self._lock:
                    self.continuations_cancelled_total += 1
            self.bus.publish(parent_id, {
                "event": "continuation_settled", "terminal": True,
                "job_id": parent_id,
                "continuation_job_id": cont_id,
                "status": status,
            })

    def _enqueue_continuation(
        self, job_id: str, spec: JobSpec, x, result: Dict[str, Any]
    ) -> Optional[str]:
        """Enqueue a completed progressive parent's refinement
        continuation through the ORDINARY submit path (preflight on
        the tiled model, shed gate, fair-share lane, lease, payload —
        every serving guarantee for free), at ``priority="low"`` on
        the parent's tenant lane so it consumes only idle capacity.
        Returns the continuation's job id, or None when admission
        refused it (counted as shed; the parent is still DONE — the
        banded estimate IS the answer, exactness was best-effort)."""
        try:
            cont_spec = plan_continuation(spec, result, job_id)
            cont = self.submit(cont_spec, x)
        except (QueueShed, QueueFull, PreflightReject):
            # submit already emitted the job_shed / preflight_reject
            # event (with continuation_of lineage for the shed case).
            with self._lock:
                self.continuations_shed_total += 1
            return None
        except Exception as e:  # noqa: BLE001 — the parent's answer
            # must not fail because its best-effort refinement could
            # not be planned (e.g. a duck-typed stub's result dict
            # lacking best_k/h_effective).
            logger.warning(
                "could not plan continuation for %s: %s", job_id, e
            )
            with self._lock:
                self.continuations_shed_total += 1
            return None
        cont_id = cont["job_id"]
        with self._lock:
            self.continuations_enqueued_total += 1
        self.events.emit(
            "continuation_enqueued", job_id=job_id,
            continuation_job_id=cont_id,
            fingerprint=cont["fingerprint"],
            k=int(cont_spec.k_values[0]),
            priority=cont_spec.priority,
            tenant=getattr(cont_spec, "tenant", "default"),
            worker_id=self.worker_id,
        )
        self.bus.publish(job_id, {
            "event": "continuation_enqueued", "job_id": job_id,
            "continuation_job_id": cont_id,
            "k": int(cont_spec.k_values[0]),
            "priority": cont_spec.priority,
        })
        return cont_id

    def _run_with_timeout(
        self,
        spec: JobSpec,
        x,
        progress_cb,
        heartbeat: Optional[Heartbeat] = None,
        expected_block_fn=None,
        **kwargs,
    ):
        """Run the executor on a supervised per-job thread.

        Two independent verdicts can abandon the thread (a compiled XLA
        program has no cancellation point, so "abandon" is the only
        cancel: daemon thread, event generation invalidated — see the
        executor docstring for the attribution corner this accepts):

        - **timeout** — total wall-clock exceeded ``job_timeout``
          (terminal, as before);
        - **wedged** — the liveness heartbeat (``heartbeat``, beaten by
          the executor on engine-ready and every evaluated block) went
          silent past the phase's deadline
          (:func:`~consensus_clustering_tpu_torch.serve.watchdog.
          wedge_deadline` over ``expected_block_fn()``, the bucket's
          observed/calibrated block time).  Raises
          :class:`~consensus_clustering_tpu_torch.serve.watchdog.JobWedged`,
          which the retry loop triages as retryable — the retry resumes
          from the checkpoint ring.
        """
        supervise_wedge = self.watchdog and heartbeat is not None
        if heartbeat is not None:
            # Only set for streaming executors (which accept the
            # kwarg); stub executors never see it.
            kwargs["heartbeat"] = heartbeat
        if self.job_timeout is None and not supervise_wedge:
            result = self.executor.run(spec, x, progress_cb, **kwargs)
            self._emulate_device_latency()
            return result

        def call():
            return self.executor.run(spec, x, progress_cb, **kwargs)

        result = self._supervised_call(call, heartbeat, expected_block_fn)
        self._emulate_device_latency()
        return result

    def _emulate_device_latency(self) -> None:
        """Benchmark-only (``--emulate-device-seconds``): sleep once per
        EXECUTOR PROGRAM that actually ran, so fleet benchmarks on a
        small host can model device-bound sets without charging the
        latency to dispatches that never reach the device (quiet
        stand-downs for stolen jobs, terminal-state skips).  0.0 — a
        no-op — on every production path."""
        if self.emulate_device_seconds > 0:
            self._sleep(self.emulate_device_seconds)

    def _supervised_call(self, call, heartbeat, expected_block_fn):
        """The supervision core shared by the solo and fused execution
        paths: run ``call()`` on an abandonable daemon thread, watching
        the wall clock (``job_timeout``) and — when the watchdog is on
        and a heartbeat exists — the per-block liveness deadline."""
        supervise_wedge = self.watchdog and heartbeat is not None
        box: Dict[str, Any] = {}

        def _target():
            try:
                box["result"] = call()
            except BaseException as e:  # noqa: BLE001 — reraised below
                box["error"] = e

        t = threading.Thread(target=_target, daemon=True)
        t.start()
        started = time.monotonic()
        # Poll fast relative to the smallest deadline in play so a
        # wedge is detected well inside the 2×-deadline acceptance
        # bound (chaos_soak asserts it).
        poll = (
            min(self.wedge_poll, max(self.wedge_floor / 4, 0.01))
            if supervise_wedge
            else self.job_timeout
        )
        while True:
            t.join(poll)
            if not t.is_alive():
                break
            if (
                self.job_timeout is not None
                and time.monotonic() - started >= self.job_timeout
            ):
                self.executor.cancel_events()
                raise JobTimeout(
                    f"job exceeded {self.job_timeout}s wall-clock budget"
                )
            if supervise_wedge:
                silent, phase = heartbeat.read()
                expected = (
                    expected_block_fn() if expected_block_fn else None
                )
                allowed = wedge_deadline(
                    phase, expected,
                    floor=self.wedge_floor,
                    scale=self.wedge_scale,
                    compile_grace=self.wedge_compile_grace,
                )
                if silent > allowed:
                    self.executor.cancel_events()
                    raise JobWedged(phase, silent, allowed)
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _plan_fusion_batch(self, job_id: str) -> List[str]:
        """The worker's fusion raid (serve/sched/fusion.py): after the
        fair order picked ``job_id``, pull up to ``fusion_max - 1``
        more queued jobs with the SAME fusion key to ride one device
        program.  The match predicate is pure over snapshots captured
        here — it runs under the queue's lock, and must never reach
        back into scheduler state (lock-order discipline, see
        ``metrics``)."""
        if self.fusion_max < 2 or self.schedule != "fair":
            return [job_id]
        with self._lock:
            key = self._fusion_keys.get(job_id)
            keys = dict(self._fusion_keys)
        if key is None:
            return [job_id]
        mates = self._queue.take_matching(
            lambda jid: keys.get(jid) == key,
            self.fusion_max - 1,
        )
        return [job_id, *mates]

    def _worker_loop(self) -> None:
        while not self._stop.is_set():
            job_id = self._queue.get()
            if job_id is None or self._stop.is_set():
                break
            batch = self._plan_fusion_batch(job_id)
            try:
                if len(batch) >= 2:
                    self._execute_fused(batch)
                else:
                    self._execute(job_id)
            except LeaseLost as e:
                # A fenced write was refused mid-execution: the job was
                # taken over and the successor's record is the record.
                # NOT a job failure — the fence already counted and
                # emitted lease_refused, the local state is dropped,
                # and writing "failed" here would be exactly the zombie
                # clobber the fence exists to stop.
                logger.warning(
                    "worker stood down from job %s: %s", job_id, e
                )
                # Checkpoint-ring writes are NOT fenced (they are
                # idempotent per-generation files, and fencing every
                # block write would put a disk read on the hot path) —
                # so blocks this zombie completed AFTER the successor's
                # terminal clear_checkpoints have re-created gen-* files
                # in a ring nobody will ever clear again.  If the
                # record is already done, re-run the terminal clear.
                try:
                    rec = self.store.load_job(job_id)
                    if (
                        rec is not None
                        and rec.get("status") == "done"
                        and rec.get("fingerprint")
                    ):
                        self.store.clear_checkpoints(rec["fingerprint"])
                except OSError:  # noqa: BLE001 — best-effort GC
                    pass
            except Exception as e:  # noqa: BLE001 — keep the loop alive
                # _execute handles job failures itself; anything escaping
                # is a scheduler bug, and one bad job must not kill the
                # worker and strand every queued job behind it.
                self._fail_internal(job_id, e)

    def _fail_internal(self, job_id: str, e: Exception) -> None:
        """Last-resort terminalisation for a scheduler bug: the job must
        not stay 'running' forever.  Shared by the worker loop and the
        fused path's per-job solo fallback — one recovery, no drift."""
        with self._lock:
            self.jobs_failed += 1
        try:
            self._update(
                job_id, status="failed",
                error=f"internal scheduler error: {e}",
                finished_at=round(time.time(), 3),
            )
        except Exception:  # noqa: BLE001
            pass
        self.events.emit(
            "job_failed", job_id=job_id, error=str(e),
            kind="internal",
        )
        self._note_drain()

    def _execute(self, job_id: str, preloaded=None) -> None:
        if preloaded is not None:
            # The fused path already popped this job's state and is
            # falling it back to the solo path (degrade, never block).
            record, spec, x = preloaded
        else:
            with self._lock:
                record = self._jobs.get(job_id)
                spec = self._specs.pop(job_id, None)
                x = self._data.pop(job_id, None)
        if record is None or spec is None or x is None:
            stored = self.store.load_job(job_id)
            if stored is not None and stored.get("status") in _TERMINAL:
                # Cancelled (or otherwise terminalised) while queued:
                # the queue entry outlived the job — nothing to run.
                return
            # A lease takeover (note-lost sweep) evicted the job between
            # dequeue and pickup: the successor owns it — stand down.
            raise LeaseLost(job_id, "pickup", None, None)
        if preloaded is None:
            # Pickup pre-check (docs/SERVING.md "Fleet runbook"): a
            # peer may have STOLEN this queued job since we admitted
            # it — our queue entry is then a ghost.  Checking the
            # fence before any write or SLO observation makes the
            # stand-down free and QUIET: nothing executed, nothing
            # lost, no refusal counted (no write was even attempted).
            self._fence(job_id, "pickup", quiet=True)
        with self._lock:
            fp = record["fingerprint"]
            submitted_at = float(record.get("submitted_at") or time.time())
            # The cancel flag a client may set mid-run; checked at every
            # block boundary below.
            cancel_flag = self._cancel_flags.get(job_id)
            if cancel_flag is None:
                cancel_flag = self._cancel_flags[job_id] = (
                    threading.Event()
                )

        # Observability (docs/OBSERVABILITY.md): one trace per job,
        # trace_id = job_id, spans ride the JSONL event stream.  The
        # queue wait — admission to worker pickup — is the span whose
        # start predates this method, so it is recorded retroactively.
        tracer = Tracer(self._span_sink, trace_id=job_id)
        # The shared per-bucket key for the SLO ledger and the forensic
        # report's grouping (job_done carries it — the JSONL log must
        # be able to tell buckets apart offline, long-tail big-N jobs
        # are not a small bucket's regression).
        bucket = self._job_bucket(spec, *(int(v) for v in x.shape))
        if preloaded is None:
            # Queue wait feeds its SLO ledger HERE, outcome-blind: an
            # admission backlog whose jobs then fail or time out must
            # still burn the objective (the wedged-backend overload is
            # exactly when it pages; end-to-end latency stays
            # success-only in the terminal path below).  A PRELOADED
            # job already observed its wait at the FUSED pickup — a
            # second sample here, inflated by the degraded fused
            # attempt's runtime, would double-burn the objective.
            queue_wait = max(0.0, time.time() - submitted_at)
            self.hist_queue_wait_seconds.observe(queue_wait)
            tracer.record("queue_wait", queue_wait)
            self.slo.observe_queue_wait(bucket, queue_wait)

        # Late dedup: submission-time dedup misses a twin that was
        # still RUNNING (its result not yet stored), and a restart can
        # re-queue an orphan whose twin completed before the crash —
        # either way, if the byte-exact result landed in the store by
        # now, serve it instead of re-running a whole sweep.
        cached = self.store.get_result(fp)
        if cached is not None:
            self._update(
                job_id, status="done", result=cached, from_cache=True,
                finished_at=round(time.time(), 3),
            )
            # Counted only AFTER the fenced terminal write: a zombie
            # whose job was taken over unwinds on LeaseLost above, and
            # must not report a completion the store refused.
            with self._lock:
                self.cache_hits += 1
                self.jobs_completed += 1
            self.events.emit(
                "job_done", job_id=job_id, fingerprint=fp, cached=True,
                bucket=bucket, worker_id=self.worker_id,
            )
            self._note_drain()
            return

        # DKW band fields for estimator-backed runs (docs/SERVING.md
        # "Progressive serving runbook"): computed ONCE per job — pure
        # arithmetic over estimator/bounds.py — and merged into every
        # k_batch_complete frame, so any estimate/progressive client
        # can watch convergence live without waiting for the terminal
        # record's estimator block.
        band = None
        if getattr(spec, "mode", "exact") in ("estimate", "progressive"):
            band = band_fields(
                int(x.shape[0]), spec.n_pairs, spec.parity_zeros
            )

        def progress_cb(k: int, pac: float) -> None:
            # The per-K signal api.py's progress plumbing already emits,
            # surfaced as a service event (name kept aligned with the
            # batch path's k_batch_complete metrics event).
            self.events.emit(
                "k_batch_complete", job_id=job_id, k=k, pac=pac,
                **(band or {}),
            )
            self.bus.publish(job_id, {
                "event": "k_batch_complete", "job_id": job_id,
                "k": int(k), "pac": float(pac),
                **(band or {}),
            })

        def block_cb(block: int, h_done: int, pac_list) -> None:
            # Per-streamed-block progress from the H-block driver: the
            # signs-of-life signal for a long job, at block resolution.
            # The same beat renews this worker's leases (rate-limited,
            # non-blocking inside the manager) — the heartbeat→renewal
            # path of docs/SERVING.md "Multi-worker runbook".  Client
            # cancel lands HERE: the next block boundary after the flag
            # is the first interruptible point of a compiled sweep.
            if cancel_flag.is_set():
                raise JobCancelled(job_id)
            self._lease_beat()
            self.events.emit(
                "h_block_complete", job_id=job_id, block=block,
                h_done=h_done, pac_area=pac_list,
            )
            self.bus.publish(job_id, {
                "event": "h_block_complete", "job_id": job_id,
                "block": int(block), "h_done": int(h_done),
                "pac_area": list(pac_list),
            })

        # Duck-typed executors (test stubs) may not stream; only a real
        # streaming executor gets the per-block callback, the
        # checkpoint ring (the resume surface), and the hang watchdog's
        # heartbeat/expectation plumbing.  The observability kwargs
        # (tracer, profile_dir) gate on the obs layer specifically —
        # pre-obs streaming-shaped stubs keep their narrower run()
        # signatures.
        run_kwargs: Dict[str, Any] = {}
        streaming_executor = hasattr(self.executor, "default_h_block")
        obs_executor = hasattr(self.executor, "hist_block_seconds")
        profile_dir = None
        if obs_executor:
            # serve-admin profile-next: a one-shot arm traces the next
            # executed job.  Claimed (consumed) here, attached to the
            # FIRST attempt only — a retry under the profiler would
            # overwrite the trace the operator asked for.
            profile_dir = self.store.claim_profile()
            if profile_dir is not None:
                with self._lock:
                    self.profile_requests_total += 1
        expected_block_fn = None
        if streaming_executor:
            run_kwargs["block_cb"] = block_cb
            if self.checkpoints:
                run_kwargs["checkpoint_dir"] = self.store.checkpoint_dir(
                    fp
                )
            if getattr(self.executor, "supports_plane_store", False):
                # Persistent plane store (append subsystem): a packed
                # exact run captures its final bit-planes under
                # planes/<fingerprint>/ so a later mode="append" job
                # can widen them instead of recomputing from scratch.
                # Append jobs additionally receive their PARENT's
                # store directory to read from; everyone else ignores
                # the kwargs (the executor gates capture on
                # accum_repr).  Duck-typed: narrow stubs without the
                # capability flag keep their existing signatures.
                run_kwargs["plane_dir"] = self.store.plane_dir(fp)
                if getattr(spec, "append_parent", None):
                    run_kwargs["parent_plane_dir"] = (
                        self.store.plane_dir(spec.append_parent)
                    )
            if self.watchdog and hasattr(
                self.executor, "expected_block_seconds"
            ):
                n, d = (int(v) for v in x.shape)

                def expected_block_fn():
                    try:
                        return self.executor.expected_block_seconds(
                            spec, n, d
                        )
                    except Exception:  # noqa: BLE001 — an expectation
                        return None  # hiccup must not fail a live job

        for attempt in range(self.max_retries + 1):
            heartbeat = None
            if self.watchdog and streaming_executor:
                # Fresh per attempt: a retry's deadline clock must not
                # inherit the wedged attempt's silence.
                heartbeat = Heartbeat()
            # Attempt 0's "running" write fences QUIETLY: a refusal
            # there means the job was stolen between the pre-check
            # and this write (nothing ran — a healthy stand-down).
            # Retries and every later write stay loud: by then this
            # worker has executed, and a refusal is the real zombie
            # signal.
            self._update(
                job_id, status="running", attempt=attempt,
                started_at=round(time.time(), 3),
                quiet_fence=(attempt == 0),
            )
            self.events.emit(
                "job_started", job_id=job_id, attempt=attempt,
                worker_id=self.worker_id,
            )
            attempt_kwargs = dict(run_kwargs)
            attempt_span = tracer.span("attempt", attempt=attempt)
            if obs_executor:
                # Executor/driver spans parent under this attempt, so
                # a retried job's two execution trees stay separable.
                attempt_kwargs["tracer"] = tracer.child(
                    attempt_span.span_id
                )
                if profile_dir is not None and attempt == 0:
                    attempt_kwargs["profile_dir"] = profile_dir
            t0 = time.perf_counter()
            try:
                try:
                    with attempt_span:
                        result = self._run_with_timeout(
                            spec, x, progress_cb,
                            heartbeat=heartbeat,
                            expected_block_fn=expected_block_fn,
                            **attempt_kwargs,
                        )
                finally:
                    if profile_dir is not None and attempt == 0:
                        # The arm was consumed by this attempt; point
                        # the operator at the directory whatever the
                        # outcome.  (On a wedge/timeout the abandoned
                        # thread still owns the profiler context and
                        # flushes the trace whenever it finally
                        # returns — docs/OBSERVABILITY.md caveat.)
                        self.events.emit(
                            "profile_captured", job_id=job_id,
                            profile_dir=profile_dir,
                        )
            except JobCancelled as e:
                # The client walked away (docs/SERVING.md "Fair-share
                # & fusion runbook"): terminal, NOT a failure — no
                # retry, no SLO error-budget burn (the service did
                # nothing wrong), ring cleared and lease released by
                # the terminal update, slot freed for the next job.
                with self._lock:
                    self.jobs_cancelled_total += 1
                self._update(
                    job_id, status="cancelled",
                    error=f"cancelled mid-run ({e.reason})",
                    finished_at=round(time.time(), 3),
                )
                self.events.emit(
                    "job_cancelled", job_id=job_id, reason=e.reason,
                    stage="running", bucket=bucket,
                    worker_id=self.worker_id,
                )
                self._note_drain()
                return
            except JobTimeout as e:
                # A timed-out attempt burned error budget like any
                # other failed one (the SLO's error_rate signal).
                self.slo.observe_attempt(bucket, ok=False)
                with self._lock:
                    self.jobs_timed_out += 1
                    self.jobs_failed += 1
                self._update(
                    job_id, status="timeout", error=str(e),
                    finished_at=round(time.time(), 3),
                )
                self.events.emit(
                    "job_failed", job_id=job_id, error=str(e),
                    kind="timeout", bucket=bucket,
                    worker_id=self.worker_id,
                )
                self._note_drain()
                return
            except JobSpecError as e:
                # The caller's fault, deterministic: retrying cannot help.
                with self._lock:
                    self.jobs_failed += 1
                self._update(
                    job_id, status="failed", error=str(e),
                    finished_at=round(time.time(), 3),
                )
                self.events.emit(
                    "job_failed", job_id=job_id, error=str(e),
                    kind="bad_request", bucket=bucket,
                    worker_id=self.worker_id,
                )
                self._note_drain()
                return
            except Exception as e:
                # Every failed attempt — retried or terminal — is one
                # bad event for the SLO error_rate objective: a job
                # that completes after two retries still burned budget.
                self.slo.observe_attempt(bucket, ok=False)
                # Triage before burning the retry budget: deterministic
                # errors re-raise identically on every attempt, while
                # the transient class (preemptions, device/runtime/IO
                # faults) re-runs after backoff and — because the
                # executor keeps the checkpoint ring — resumes from the
                # last completed block, not from zero.  A wedge verdict
                # is retryable by construction (the watchdog already
                # abandoned the silent thread; the backend may well
                # serve the retry fine) and carries its own triage
                # label, ``wedged:<point>``.
                if isinstance(e, JobWedged):
                    kind, reason = "retryable", e.reason
                    with self._lock:
                        self.jobs_wedged_total += 1
                        self._recent_wedges.append(time.time())
                    self.events.emit(
                        "job_wedged", job_id=job_id, attempt=attempt,
                        point=e.point,
                        silent_seconds=round(e.silent_seconds, 3),
                        deadline_seconds=round(e.deadline, 3),
                        worker_id=self.worker_id,
                    )
                elif isinstance(e, IntegrityError):
                    # Silent corruption caught: count the breach by
                    # detection point, keep the checks counter honest
                    # for the violated run (its streaming stats never
                    # arrive), and emit the operator signal.  Triage
                    # stays classify_error's (retryable,
                    # corrupt:<point>) — the retry abandons the corrupt
                    # state and resumes from the last VERIFIED
                    # checkpoint generation.
                    kind, reason = classify_error(e)
                    with self._lock:
                        self.integrity_violations_total[e.point] = (
                            self.integrity_violations_total.get(
                                e.point, 0
                            ) + 1
                        )
                        self.integrity_checks_total += getattr(
                            e, "checks_run", 0
                        )
                    self.events.emit(
                        "integrity_violation", job_id=job_id,
                        attempt=attempt, point=e.point,
                        block=getattr(e, "block", None),
                        details=getattr(e, "details", {}),
                    )
                else:
                    kind, reason = classify_error(e)
                    # Sentinel checks run by an attempt that died of
                    # something ELSE (OOM, injected fault, runtime
                    # error) still happened: the streaming driver
                    # attaches the count to the exception so the
                    # /metrics counter stays honest across the chaos
                    # mix, not just for integrity verdicts.
                    ran = getattr(e, "integrity_checks_run", 0)
                    if ran:
                        with self._lock:
                            self.integrity_checks_total += int(ran)
                if kind == "retryable" and attempt < self.max_retries:
                    backoff = self.backoff_base * (2 ** attempt)
                    with self._lock:
                        self.jobs_retried += 1
                        self.retry_total[reason] = (
                            self.retry_total.get(reason, 0) + 1
                        )
                    self.events.emit(
                        "job_retry", job_id=job_id, attempt=attempt,
                        backoff_seconds=backoff, error=str(e),
                        reason=reason, worker_id=self.worker_id,
                    )
                    self._sleep(backoff)
                    continue
                with self._lock:
                    self.jobs_failed += 1
                self._update(
                    job_id, status="failed", error=str(e),
                    finished_at=round(time.time(), 3),
                )
                self.events.emit(
                    "job_failed", job_id=job_id, error=str(e),
                    kind=(
                        "retries_exhausted" if kind == "retryable"
                        else f"fatal:{reason}"
                    ),
                    bucket=bucket, worker_id=self.worker_id,
                )
                self._note_drain()
                return
            seconds = time.perf_counter() - t0
            if isinstance(result, dict):
                streaming = result.get("streaming")
                if isinstance(streaming, dict):
                    with self._lock:
                        self.integrity_checks_total += int(
                            streaming.get("integrity_checks", 0)
                        )
            # Store first, then flip status: a GET that sees "done" must
            # always find the result bytes on disk.
            self.store.put_result(fp, result)
            stored = self.store.get_result(fp)
            # Progressive phase two (docs/SERVING.md "Progressive
            # serving runbook"): the estimate is in hand — enqueue the
            # low-priority tiled-refinement continuation BEFORE the
            # done update, so the terminal record already carries the
            # linkage and the done SSE frame can say upgrade_pending.
            cont_id = None
            if getattr(spec, "mode", "exact") == "progressive":
                cont_id = self._enqueue_continuation(
                    job_id, spec, x, stored
                )
            self._update(
                job_id, status="done", result=stored,
                finished_at=round(time.time(), 3), seconds=seconds,
                **(
                    {"continuation_job_id": cont_id}
                    if cont_id else {}
                ),
            )
            # Success accounting only AFTER the fenced terminal write:
            # a zombie whose job was taken over unwinds on LeaseLost at
            # _update, and must not count a completion — or feed a good
            # SLO attempt — for an attempt whose write the store
            # refused (the fleet-wide jobs_completed sum would exceed
            # the job count on every takeover-with-surviving-zombie
            # otherwise; put_result above is the documented residual —
            # first-writer-wins on canonical bytes).
            with self._lock:
                self.jobs_completed += 1
            # End-to-end latency over EXECUTED jobs (admission to done,
            # queue wait and retries included; dedup hits excluded —
            # they are disk reads, and folding their ~0s in would make
            # the execution distribution look bimodally fast).
            end_to_end = max(0.0, time.time() - submitted_at)
            self.hist_job_seconds.observe(end_to_end)
            # SLO feeds (docs/OBSERVABILITY.md "SLO layer"): the same
            # end-to-end latency the histogram sees, judged against the
            # bucket's objectives, plus one good attempt (queue wait
            # was already fed at pickup, outcome-blind).
            self.slo.observe_attempt(bucket, ok=True)
            self.slo.observe_job(bucket, end_to_end, ok=True)
            self._emit_plane_store_events(job_id, fp, result)
            self.events.emit(
                "job_done", job_id=job_id, fingerprint=fp,
                seconds=round(seconds, 3), bucket=bucket,
                worker_id=self.worker_id,
            )
            self._note_drain()
            return

    def _emit_plane_store_events(
        self, job_id: str, fp: str, result: Any
    ) -> None:
        """Append-subsystem observability, read off the finished
        result dict: ``plane_store_written`` whenever this job left a
        verifiable generation on disk (a packed exact run's gen-0
        capture, or an append's merged generation — fallbacks that
        re-bootstrapped count too, they wrote gen-0 under their own
        fingerprint), and ``refresh_recommended`` when the append's
        DKW staleness verdict says the accumulated drift can no longer
        be disclosed inside the bound.  Emission failures are
        impossible by construction (pure dict reads); malformed
        results simply emit nothing."""
        if not isinstance(result, dict):
            return
        plane_store = result.get("plane_store")
        if isinstance(plane_store, dict) and "error" not in plane_store:
            self.events.emit(
                "plane_store_written", job_id=job_id, fingerprint=fp,
                generation=int(plane_store.get("generation", 0)),
                h_done=int(plane_store.get("h_done", 0)),
                n=int(plane_store.get("n", 0)),
                worker_id=self.worker_id,
            )
        append = result.get("append")
        if not isinstance(append, dict):
            return
        if append.get("store_written"):
            self.events.emit(
                "plane_store_written", job_id=job_id, fingerprint=fp,
                generation=int(append.get("generation", 0)),
                h_done=int(append.get("h_total", 0)),
                n=int(append.get("n_new", 0)),
                marginal_lane_fraction=float(
                    append.get("marginal_lane_fraction", 1.0)
                ),
                worker_id=self.worker_id,
            )
        staleness = append.get("staleness")
        if isinstance(staleness, dict) and staleness.get(
            "refresh_recommended"
        ):
            self.events.emit(
                "refresh_recommended", job_id=job_id, fingerprint=fp,
                drift=float(staleness.get("drift", 0.0)),
                bound=float(staleness.get("bound", 0.0)),
                drift_excess=float(staleness.get("drift_excess", 0.0)),
                worker_id=self.worker_id,
            )

    # -- fused execution (serve/sched/fusion.py) -------------------------

    def _execute_fused(self, job_ids: List[str]) -> None:
        """Run a fusion-planned batch: the eligible jobs through ONE
        fused device program, everything else solo.  The invariant the
        whole path keeps is DEGRADE, NEVER BLOCK: any error inside the
        fused attempt falls every non-terminal job back to the
        ordinary solo path (retries, triage, resume from whatever
        checkpoints the fused attempt wrote), and one job's problem
        (takeover, cancel, dedup) never aborts its batch-mates."""
        loaded: Dict[str, tuple] = {}
        for job_id in job_ids:
            with self._lock:
                record = self._jobs.get(job_id)
                spec = self._specs.pop(job_id, None)
                x = self._data.pop(job_id, None)
            loaded[job_id] = (record, spec, x)
        runnable: List[str] = []
        now = time.time()
        for job_id in job_ids:
            record, spec, x = loaded[job_id]
            if record is None or spec is None or x is None:
                stored = self.store.load_job(job_id)
                if stored is None or stored.get("status") not in (
                    _TERMINAL
                ):
                    # Takeover raced the pickup: the successor owns it.
                    logger.warning(
                        "fused pickup stood down from job %s "
                        "(taken over)", job_id,
                    )
                continue
            runnable.append(job_id)
            # Queue wait at pickup, once per job, OUTCOME-BLIND — fed
            # here, before dedup/partition, so a backlog whose jobs
            # then dedup, degrade or fail still burns the objective
            # (the solo path's rule), and the solo fallback never
            # double-observes (preloaded jobs skip it in _execute).
            wait = max(0.0, now - float(
                record.get("submitted_at") or now
            ))
            self.hist_queue_wait_seconds.observe(wait)
            self.slo.observe_queue_wait(
                self._job_bucket(spec, *(int(v) for v in x.shape)),
                wait,
            )
        # Late dedup per job (the solo path's rule): a stored result is
        # a disk read, whatever vehicle the twin rode.  Per-job
        # isolation throughout: one job's store hiccup must not strand
        # its popped batch-mates in "running" (nothing upstream would
        # ever touch them again — this worker keeps renewing their
        # leases, so not even a peer takeover rescues them).
        still: List[str] = []
        for job_id in runnable:
            record, spec, x = loaded[job_id]
            fp = record["fingerprint"]
            try:
                cached = self.store.get_result(fp)
                if cached is None:
                    still.append(job_id)
                    continue
                bucket = self._job_bucket(
                    spec, *(int(v) for v in x.shape)
                )
                self._update(
                    job_id, status="done", result=cached,
                    from_cache=True, finished_at=round(time.time(), 3),
                )
            except LeaseLost:
                continue
            except Exception as e:  # noqa: BLE001 — isolate the batch
                self._fail_internal(job_id, e)
                continue
            with self._lock:
                self.cache_hits += 1
                self.jobs_completed += 1
            self.events.emit(
                "job_done", job_id=job_id, fingerprint=fp, cached=True,
                bucket=bucket, worker_id=self.worker_id,
            )
            self._note_drain()
        fingerprints = {
            job_id: loaded[job_id][0]["fingerprint"] for job_id in still
        }
        ring_empty = {
            job_id: (
                not self.checkpoints
                or ring_is_empty(self.store.checkpoint_dir(
                    fingerprints[job_id]
                ))
            )
            for job_id in still
        }
        parts = partition_batch(still, fingerprints, ring_empty)
        solo_ids = list(parts["solo"])
        fused_ids = list(parts["fused"])
        if fused_ids:
            solo_ids = self._run_fused_group(fused_ids, loaded) + solo_ids
        for job_id in solo_ids:
            try:
                self._execute(job_id, preloaded=loaded[job_id])
            except LeaseLost as e:
                logger.warning(
                    "worker stood down from job %s: %s", job_id, e
                )
            except Exception as e:  # noqa: BLE001 — isolate batch-mates
                # A scheduler bug on one fallback must not strand the
                # rest of the batch in "running" forever.
                self._fail_internal(job_id, e)

    def _cancel_executor_events(self) -> None:
        """Duck-typed ``cancel_events`` (stub executors without the
        generation guard simply have no late emissions to drop)."""
        cancel = getattr(self.executor, "cancel_events", None)
        if cancel is not None:
            cancel()

    def _run_fused_group(
        self, job_ids: List[str], loaded: Dict[str, tuple]
    ) -> List[str]:
        """Execute ``job_ids`` through one fused device program;
        returns the ids that must FALL BACK to solo (empty on clean
        success).  Per-job terminal handling mirrors ``_execute``'s
        success path; any exception inside the fused attempt degrades
        the whole group (minus a cancelled job, which terminalises)."""
        k = len(job_ids)
        specs = [loaded[j][1] for j in job_ids]
        xs = [loaded[j][2] for j in job_ids]
        n, d = (int(v) for v in xs[0].shape)
        buckets = {
            job_id: self._job_bucket(loaded[job_id][1], n, d)
            for job_id in job_ids
        }
        flags: Dict[str, threading.Event] = {}
        with self._lock:
            for job_id in job_ids:
                flag = self._cancel_flags.get(job_id)
                if flag is None:
                    flag = self._cancel_flags[job_id] = threading.Event()
                flags[job_id] = flag
        # (Queue waits were already observed at the fused PICKUP in
        # _execute_fused — once per job, outcome-blind.)
        started: List[str] = []
        for job_id in job_ids:
            try:
                # Quiet fence (the solo path's attempt-0 rule): a
                # refusal here means a peer stole the job while it
                # queued — stand down without the zombie counter.
                self._update(
                    job_id, status="running", attempt=0,
                    started_at=round(time.time(), 3),
                    quiet_fence=True,
                )
            except LeaseLost:
                continue
            except Exception as e:  # noqa: BLE001 — isolate the batch
                self._fail_internal(job_id, e)
                continue
            self.events.emit(
                "job_started", job_id=job_id, attempt=0, fused=True,
                worker_id=self.worker_id,
            )
            started.append(job_id)
        if len(started) < 2:
            return started
        job_ids = started
        # Re-derive the batch width AFTER the LeaseLost filter: events
        # (fusion_executed.k, job_done.fusion_k), the ballast padding
        # and the wedge-deadline scale must all describe the batch
        # that actually runs, not the one that was planned.
        k = len(job_ids)
        specs = [loaded[j][1] for j in job_ids]
        xs = [loaded[j][2] for j in job_ids]

        def make_block_cb(job_id):
            flag = flags[job_id]

            def block_cb(block, h_done, pac_list):
                if flag.is_set():
                    raise JobCancelled(job_id)
                self._lease_beat()
                self.events.emit(
                    "h_block_complete", job_id=job_id, block=block,
                    h_done=h_done, pac_area=pac_list, fused=True,
                )
                self.bus.publish(job_id, {
                    "event": "h_block_complete", "job_id": job_id,
                    "block": int(block), "h_done": int(h_done),
                    "pac_area": list(pac_list), "fused": True,
                })

            return block_cb

        block_cbs = [make_block_cb(j) for j in job_ids]
        checkpoint_dirs = None
        if self.checkpoints:
            checkpoint_dirs = [
                self.store.checkpoint_dir(loaded[j][0]["fingerprint"])
                for j in job_ids
            ]
        heartbeat = None
        expected_block_fn = None
        if self.watchdog and hasattr(self.executor, "run_fused"):
            heartbeat = Heartbeat()
            if hasattr(self.executor, "expected_block_seconds"):
                first = specs[0]

                def expected_block_fn():
                    try:
                        solo = self.executor.expected_block_seconds(
                            first, n, d
                        )
                    except Exception:  # noqa: BLE001 — an expectation
                        return None  # hiccup must not fail live jobs
                    # A fused block does k jobs' work: scale the solo
                    # expectation so fusion never reads as a wedge.
                    return None if solo is None else solo * k

        def call():
            return self.executor.run_fused(
                specs, xs,
                block_cbs=block_cbs,
                checkpoint_dirs=checkpoint_dirs,
                heartbeat=heartbeat,
                pad_to=self.fusion_max,
            )

        t0 = time.perf_counter()
        try:
            if self.job_timeout is None and heartbeat is None:
                results = call()
            else:
                results = self._supervised_call(
                    call, heartbeat, expected_block_fn
                )
            self._emulate_device_latency()
        except JobCancelled as e:
            # One client walked away mid-batch: ITS job terminalises,
            # the batch-mates degrade to solo (they resume from the
            # fused attempt's checkpoints — degrade, never block).
            self._cancel_executor_events()
            with self._lock:
                self.jobs_cancelled_total += 1
                self.fusion_degraded_total += 1
            survivors = [j for j in job_ids if j != e.job_id]
            try:
                self._update(
                    e.job_id, status="cancelled",
                    error=f"cancelled mid-run ({e.reason})",
                    finished_at=round(time.time(), 3),
                )
                self.events.emit(
                    "job_cancelled", job_id=e.job_id, reason=e.reason,
                    stage="running", bucket=buckets.get(e.job_id),
                    fused=True, worker_id=self.worker_id,
                )
                self._note_drain()
            except LeaseLost:
                pass
            return survivors
        except BaseException as e:  # noqa: BLE001 — degrade, don't die
            # ANY fused-attempt failure (timeout, wedge, integrity
            # breach, device fault) degrades the whole group to the
            # solo path, whose triage/retry/resume machinery owns the
            # hard cases.  The abandoned thread's late events drop via
            # the executor generation bump.
            self._cancel_executor_events()
            with self._lock:
                self.fusion_degraded_total += 1
                ran = getattr(e, "integrity_checks_run", 0)
                if ran:
                    self.integrity_checks_total += int(ran)
            logger.warning(
                "fused execution of %s degraded to solo: %s",
                job_ids, e,
            )
            return job_ids
        run_seconds = time.perf_counter() - t0
        with self._lock:
            self.fused_executions_total += 1
        self.events.emit(
            "fusion_executed", job_ids=list(job_ids),
            bucket=buckets[job_ids[0]], k=k,
            seconds=round(run_seconds, 3), worker_id=self.worker_id,
        )
        for job_id, result in zip(job_ids, results):
            record = loaded[job_id][0]
            fp = record["fingerprint"]
            streaming = result.get("streaming")
            if isinstance(streaming, dict):
                with self._lock:
                    self.integrity_checks_total += int(
                        streaming.get("integrity_checks", 0)
                    )
            try:
                # Store first, then flip status (the solo rule); per-
                # job isolation so one result's disk-full does not
                # strand the batch-mates whose results wrote fine.
                self.store.put_result(fp, result)
                stored = self.store.get_result(fp)
                self._update(
                    job_id, status="done", result=stored,
                    finished_at=round(time.time(), 3),
                    seconds=run_seconds,
                )
            except LeaseLost:
                continue
            except Exception as e:  # noqa: BLE001 — isolate the batch
                self._fail_internal(job_id, e)
                continue
            with self._lock:
                self.jobs_completed += 1
                self.fused_jobs_total += 1
            end_to_end = max(0.0, time.time() - float(
                record.get("submitted_at") or time.time()
            ))
            self.hist_job_seconds.observe(end_to_end)
            self.slo.observe_attempt(buckets[job_id], ok=True)
            self.slo.observe_job(buckets[job_id], end_to_end, ok=True)
            self.events.emit(
                "job_done", job_id=job_id, fingerprint=fp,
                seconds=round(run_seconds, 3), bucket=buckets[job_id],
                fused=True, fusion_k=k, worker_id=self.worker_id,
            )
            self._note_drain()
        # Every job was terminalised above (done, stood down, or
        # internally failed): nothing left for the solo fallback.
        return []
