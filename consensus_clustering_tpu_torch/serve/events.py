# Copied from consensus_clustering_tpu/serve/events.py.
"""Structured JSONL event log for the serving subsystem.

One line per lifecycle event, append-only, thread-safe (the HTTP handler
threads emit ``job_submitted`` while the scheduler worker emits
``job_started``/``job_done``, and the per-K ``k_batch_complete`` events
arrive on JAX debug-callback threads).  The schema mirrors
:class:`~consensus_clustering_tpu_torch.utils.metrics.MetricsLogger` —
``{"ts": <unix>, "event": <name>, ...fields}`` — so one JSONL consumer
can tail both a batch run's metrics file and the service's event log.

Events emitted by the service (every ``job_*`` event carries the
emitting scheduler's ``worker_id`` — docs/SERVING.md "Multi-worker
runbook": a merged log from several workers over one shared store must
still attribute every attempt):

- ``job_submitted``   — admission accepted (fields: job_id, fingerprint,
  shape, cached, worker_id; non-cached admissions also carry
  ``priority`` and ``tenant`` — the fair-share lane identity, which is
  what lets ``serve-admin report`` aggregate per priority and per
  tenant from the log alone)
- ``job_started``     — worker picked the job up (job_id, attempt,
  worker_id; ``fused=True`` when the job rides a fused device program)
- ``h_block_complete``— a streamed H-block's curves landed (job_id,
  block, h_done, pac_area; ``fused=True`` on fused executions): the
  per-block progress of the streaming sweep engine, the signs-of-life
  signal for a long job — also streamed live to SSE subscribers of
  ``GET /jobs/<id>/events``
- ``k_batch_complete``— per-K PAC at sweep completion (job_id, k, pac);
  emitted host-side by the executor once per K (the streaming driver
  owns the final curves, so no staged debug callback is involved)
- ``job_done``        — result stored (job_id, fingerprint, seconds,
  worker_id, bucket — the calibration shape-bucket string, so the
  offline query engine can group latency per bucket; ``cached=True``
  instead of seconds when served by late dedup; ``fused=True`` +
  ``fusion_k`` when the result rode a fused device program)
- ``job_retry``       — transient failure, will re-run (job_id, attempt,
  backoff_seconds, error, worker_id)
- ``job_failed``      — permanent failure / retries exhausted / timeout
  (job_id, error, kind, worker_id; plus bucket when the job reached
  worker pickup — the forensic report joins failed jobs' queue waits
  through it, so a backlog of failing jobs still shows up per bucket)

Hostile-path events (docs/SERVING.md "Overload & wedge runbook"):

- ``job_wedged``      — the hang watchdog abandoned a silent attempt
  (job_id, attempt, point, silent_seconds, deadline_seconds); followed
  by ``job_retry`` with reason ``wedged:<point>`` or ``job_failed``
- ``job_requeued``    — reconciliation/takeover re-queued an orphan
  (job_id, fingerprint, restart_requeues, worker_id)
- ``job_quarantined`` — a crash-looping orphan crossed the requeue cap
  (job_id, fingerprint, restarts, worker_id); payload + ring retained
- ``job_preflight_reject`` — admission refused on the memory estimate
  (fingerprint, shape, estimated_bytes, budget_bytes, worker_id);
  HTTP 413
- ``job_shed``        — admission refused by the overload shed policy
  (fingerprint, priority, tenant, reason, queue_depth,
  retry_after_seconds — derived from the live queue drain rate,
  worker_id); HTTP 429 + Retry-After

Fair-share / fusion / streamed-results events (docs/SERVING.md
"Fair-share & fusion runbook"):

- ``fusion_executed`` — k same-bucket jobs ran through ONE fused
  device program (job_ids, bucket, k, seconds, worker_id); each job
  still gets its own ``job_done`` with ``fused=True`` + ``fusion_k``,
  and per-job results are bit-identical to solo execution (the parity
  gate)
- ``job_cancelled``   — the client cancelled the job (job_id, reason:
  client_cancel | sse_disconnect, stage: queued | running, worker_id;
  bucket + ``fused=True`` when it was already running): terminal like
  ``done`` — lease released, checkpoint ring cleared, payload dropped,
  the worker slot freed at the next block boundary
- ``estimator_selected`` — a ``mode=auto`` admission resolved onto the
  sampled-pair estimator because only its O(M) footprint fit the
  memory budget (shape, exact_bytes, estimator_bytes, budget_bytes,
  n_pairs, pac_error_bound, worker_id); the job runs in estimate mode
  and its result carries the disclosed error bound — docs/SERVING.md
  "The 413 -> mode=estimate admission path"

Progressive serving events (docs/SERVING.md "Progressive serving
runbook"):

- ``continuation_enqueued`` — a progressive parent's estimate landed
  and its low-priority tiled-refinement continuation was admitted
  (job_id — the PARENT, continuation_job_id, fingerprint — the
  continuation's own request fingerprint, k — the chosen K being
  refined, priority, tenant, worker_id); the continuation rides the
  parent tenant's fair-share lane at the lowest weight, and its own
  lifecycle emits ordinary ``job_*`` events under its own id (linked
  back by ``continuation_of`` on its record and the parent's
  ``continuation_job_id``)
- ``result_upgraded`` — the continuation finished: the parent's
  banded estimate now has a bit-identical-to-dense EXACT twin for the
  chosen K (job_id — the PARENT, continuation_job_id, fingerprint —
  the REFINED ``result_fingerprint``, distinct by construction from
  both the estimate's and a from-scratch exact run's, best_k,
  pac_error_bound — 0.0, the band collapsed, worker_id); the upgrade
  is DISCLOSED, never a silent swap — the estimate record stands
  untouched under its own fingerprint

Append / plane-store events (docs/SERVING.md "Append runbook"):

- ``append_admitted`` — a ``mode="append"`` job passed admission: it
  will be priced and run at its MARGINAL lanes against the parent's
  persistent plane store (job_id, fingerprint, append_parent — the
  parent job's request fingerprint whose store it widens, n_iterations
  — the MARGINAL fresh-lane count, the only lanes that touch the
  device, shape, worker_id); the job's lifecycle
  then emits ordinary ``job_*`` events with the ``-append`` bucket
  suffix
- ``plane_store_written`` — a verifiable plane-store generation landed
  on disk (job_id, fingerprint, generation, h_done, n, worker_id):
  generation 0 when a packed exact run captured its final bit-planes,
  generation >= 1 when an append merged the parent's widened planes
  with its marginal lanes — append writes also carry
  ``marginal_lane_fraction``, the marginal-vs-full cost ratio the
  ``serve-admin report`` append rows aggregate (a fallback append that
  re-bootstrapped emits generation 0 under its OWN fingerprint with
  fraction 1.0 — disclosed, never a silent mix)
- ``refresh_recommended`` — an append's DKW staleness verdict says the
  accumulated distribution drift over the original rows exceeds the
  disclosed bound (job_id, fingerprint, drift, bound, drift_excess,
  worker_id); the append result still stands with its bound in the
  payload — the event is the operator's signal to schedule a
  from-scratch refresh

Multi-worker lease events (docs/SERVING.md "Multi-worker runbook"):

- ``lease_takeover``  — this worker claimed an orphan's lease and will
  re-queue the job (job_id, fingerprint, worker_id — the TAKER,
  prior_worker — whose lease was superseded (None when never leased),
  token — the new fencing token, reason: absent | expired | released |
  torn | self_restart); the job then resumes from its checkpoint ring
  bit-identically, and the previous owner's late writes are fenced
- ``lease_refused``   — a state-mutating write was REFUSED by the lease
  fence: a newer token supersedes this worker's, i.e. the job was taken
  over and we are the zombie (job_id, op — which write, worker_id — the
  ZOMBIE, token — the token we held, newer_token); the successor's
  record stands, local state is dropped

Fleet events (docs/SERVING.md "Fleet runbook"):

- ``fleet_heartbeat_written`` — this worker published its digest-
  verified capacity advertisement to ``fleet/<worker_id>.json``
  (worker_id, queue_depth, running — picked-up job count,
  drain_rate_per_s — the Retry-After basis rate or None before any
  drain, slo_burn_active — active (objective, bucket) burn pairs);
  one per lease-maintenance sweep while the fleet layer is enabled
- ``work_stolen``      — this worker stole a same-bucket SET of queued
  jobs from a live peer's advertised backlog (worker_id — the THIEF,
  stolen_from — the victim, job_ids, count, bucket — the shared
  executable bucket, warm — whether the thief already had it
  compiled, peer_backlog — the victim's advertised depth the plan
  acted on); each steal is an ordinary lease claim, so the victim's
  queue entries stand down quietly at pickup and every stolen job's
  later lifecycle emits ordinary ``job_*`` events under the thief's
  worker_id
- ``fleet_scale_signal`` — the measured autoscale recommendation
  CHANGED (worker_id, recommendation: scale_out | scale_in | hold,
  plus the whole disclosed basis: workers_seen, fleet_backlog,
  fleet_running, fleet_drain_rate_per_s, est_drain_seconds,
  slo_burn_active, target_drain_seconds); emitted on change only —
  the steady state is the /metrics ``fleet`` section's job

Data-integrity events (docs/SERVING.md "Integrity runbook"):

- ``integrity_violation`` — the accumulator sentinel found corrupt
  state (job_id, attempt, point, block, details: per-invariant
  violation counts); followed by ``job_retry`` with reason
  ``corrupt:<point>`` — the retry resumes from the last VERIFIED
  checkpoint generation

Observability events (docs/OBSERVABILITY.md):

- ``span``            — one timed operation in a job's execution tree
  (name, trace_id — the job_id for serve jobs — span_id,
  parent_span_id, seconds, status, per-span fields); emitted at span
  END by the scheduler (``queue_wait``, per-``attempt``), the executor
  (``compile``, ``execute``, ``checkpoint_write``) and the streaming
  driver (``resume_restore``, ``h_block``, ``host_evaluate``,
  ``integrity_check``)
- ``perf_drift``      — a shape bucket's live throughput left the
  configured band around its anchor (bucket, ratio, live_rate,
  anchor_rate, anchor_provenance: calibrated | observed, band_low,
  band_high, observations); one event per excursion, re-armed when the
  ratio returns in band — the perf-regression watchdog's operator
  signal
- ``profile_captured``— a one-shot ``serve-admin profile-next`` arm was
  consumed: the named job's first attempt ran under a ``jax.profiler``
  trace (job_id, profile_dir)
- ``slo_breach``      — an (objective, bucket) pair's error-budget burn
  rate exceeded the threshold over BOTH rolling windows (objective,
  signal, bucket, threshold_seconds, target, burn_short, burn_long,
  window_short_seconds, window_long_seconds, bad_count, sample_count);
  one event per excursion, re-armed when the short-window burn drops
  back under the threshold — docs/OBSERVABILITY.md "SLO layer"
- ``preflight_inaccurate`` — the memory preflight model's accuracy
  (estimated ÷ measured) left the configured band at a bucket (bucket,
  accuracy, estimated_bytes, measured_bytes, source: device | compiled,
  band_low, band_high, correction, observations); the correction
  factor is already feeding the 413 gate — docs/OBSERVABILITY.md
  "Memory accounting"
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class EventLog:
    """Append structured events to a JSONL file and/or the log.

    ``path=None`` logs via :mod:`logging` only — the service always has an
    event stream, a file just makes it durable.

    ``log_level`` sets the level the logging mirror uses.  Default:
    ``DEBUG`` when a file sink is configured, ``INFO`` otherwise — with
    a file the JSONL stream IS the record, and mirroring every event
    (per-block spans included) to stderr at INFO under load duplicates
    the whole stream into the process log.
    """

    def __init__(
        self, path: Optional[str] = None, log_level: Optional[int] = None
    ):
        self.path = path
        self.log_level = (
            log_level if log_level is not None
            else (logging.DEBUG if path else logging.INFO)
        )
        self._lock = threading.Lock()

    def emit(self, event: str, **fields: Any) -> Dict[str, Any]:
        record = {"ts": round(time.time(), 3), "event": event, **fields}
        line = json.dumps(record, default=float, sort_keys=True)
        if self.path:
            # One lock around the whole append: interleaved writes from
            # handler threads must not tear a line.
            with self._lock:
                with open(self.path, "a") as f:
                    f.write(line + "\n")
        logger.log(self.log_level, "serve event: %s", line)
        return record
