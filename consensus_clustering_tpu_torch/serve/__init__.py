"""Consensus as a service on the card: job scheduler, engine cache, result
store (the port of the reference package's ``serve/``).

- :mod:`.jobstore`  — persistent dedup-by-fingerprint result store
- :mod:`.executor`  — :class:`SweepExecutor`: validated jobs on the port's
  engines (stream, estimator, refinement, append) on one device
- :mod:`.scheduler` — bounded admission queue (weighted-fair DRR lanes
  by default, FIFO control arm), timeout, retry/backoff, hang
  watchdog, crash-loop quarantine, memory preflight, overload shedding
- :mod:`.sched`     — fair-share lanes, same-bucket job fusion (one
  shared block loop for k jobs, bit-identical to solo) and the SSE
  event bus behind ``GET /jobs/<id>/events``
- :mod:`.service`   — stdlib HTTP JSON API (POST /jobs, GET /jobs/<id>,
  /healthz, /metrics, /metrics.prom)
- :mod:`.events`    — structured JSONL lifecycle events
- :mod:`.watchdog`  — liveness heartbeats and the wedge verdict
- :mod:`.preflight` — admission-time memory estimate vs the budget
- :mod:`.admin`     — ``serve-admin``: quarantine list/show/release,
  profile-next and the forensic queries (:mod:`..obs.query`), on the
  store's files alone

``ConsensusService(store_dir, executor=SweepExecutor(device="cpu"))``
serves from the CPU; with no executor it builds one on the card and
raises without a GPU.  ``python -m consensus_clustering_tpu_torch serve``
starts it from the command line.

Lazy exports (PEP 562, the reference's pattern): importing the package
pulls in neither the executor nor torch's CUDA state.
"""

import importlib

_EXPORTS = {
    "EventLog": "consensus_clustering_tpu_torch.serve.events",
    "InvalidDataError": "consensus_clustering_tpu_torch.serve.executor",
    "JobSpec": "consensus_clustering_tpu_torch.serve.executor",
    "JobSpecError": "consensus_clustering_tpu_torch.serve.executor",
    "PRIORITIES": "consensus_clustering_tpu_torch.serve.executor",
    "SweepExecutor": "consensus_clustering_tpu_torch.serve.executor",
    "parse_job_spec": "consensus_clustering_tpu_torch.serve.executor",
    "ring_keep": "consensus_clustering_tpu_torch.serve.executor",
    "JobStore": "consensus_clustering_tpu_torch.serve.jobstore",
    "PreflightReject": "consensus_clustering_tpu_torch.serve.preflight",
    "estimate_job_bytes": "consensus_clustering_tpu_torch.serve.preflight",
    "estimate_estimator_bytes":
        "consensus_clustering_tpu_torch.serve.preflight",
    "resolve_memory_budget": "consensus_clustering_tpu_torch.serve.preflight",
    "JobTimeout": "consensus_clustering_tpu_torch.serve.scheduler",
    "QueueFull": "consensus_clustering_tpu_torch.serve.scheduler",
    "QueueShed": "consensus_clustering_tpu_torch.serve.scheduler",
    "Scheduler": "consensus_clustering_tpu_torch.serve.scheduler",
    "ShedPolicy": "consensus_clustering_tpu_torch.serve.scheduler",
    "ConsensusService": "consensus_clustering_tpu_torch.serve.service",
    "BackendInitTimeout": "consensus_clustering_tpu_torch.serve.watchdog",
    "Heartbeat": "consensus_clustering_tpu_torch.serve.watchdog",
    "JobWedged": "consensus_clustering_tpu_torch.serve.watchdog",
    "await_backend_init": "consensus_clustering_tpu_torch.serve.watchdog",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
