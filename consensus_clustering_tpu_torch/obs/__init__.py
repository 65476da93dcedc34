# Copied from consensus_clustering_tpu/obs/__init__.py.
"""Observability subsystem: spans, latency histograms, drift watchdog.

The layer that makes every perf/robustness claim observable from a LIVE
service (docs/OBSERVABILITY.md) instead of only from offline benchmarks:

- :mod:`.tracing`    — trace_id/span_id spans over the serve JSONL
  event stream (queue-wait, compile, per-H-block execute, host
  evaluate, checkpoint write, resume-restore, integrity checks);
- :mod:`.histograms` — fixed-bucket, pre-seeded latency histograms
  (end-to-end job, queue wait, block seconds, checkpoint writes) for
  ``/metrics``;
- :mod:`.prom`       — Prometheus text exposition of the same snapshot
  (``GET /metrics.prom``) plus the strict format checker that gates it;
- :mod:`.drift`      — the calibration-anchored perf-regression
  watchdog: live per-bucket resamples/s vs the autotune record (or a
  self-observed anchor), ``perf_drift`` events on band excursions;
- :mod:`.memory`     — per-bucket memory accounting: the preflight
  admission model vs measured reality (allocator high-water or XLA's
  compiled plan), ``preflight_inaccurate`` events + the correction
  factor the 413 gate feeds back;
- :mod:`.slo`        — latency/error objectives per bucket over rolling
  windows with multi-window burn rate, ``slo_breach`` events;
- :mod:`.query`      — the forensic query engine over the JSONL log
  (``serve-admin trace``/``report``/``bundle``).

Deliberately STDLIB-ONLY (no numpy, no jax): the scheduler, the
checkpoint writer thread, the latency probe harness, and tests all
import from here, and none of them should pay — or depend on — the
accelerator stack to observe it.
"""

from consensus_clustering_tpu_torch.obs.drift import (
    ANCHOR_CALIBRATED,
    ANCHOR_OBSERVED,
    DEFAULT_BAND,
    DriftWatchdog,
)
from consensus_clustering_tpu_torch.obs.histograms import (
    DEFAULT_TIME_BUCKETS,
    LatencyHistogram,
)
from consensus_clustering_tpu_torch.obs.memory import (
    DEFAULT_ACCURACY_BAND,
    MemoryAccountant,
)
from consensus_clustering_tpu_torch.obs.prom import (
    render_prometheus,
    validate_exposition,
)
from consensus_clustering_tpu_torch.obs.slo import (
    DEFAULT_OBJECTIVES,
    DEFAULT_WINDOWS,
    Objective,
    SLOMonitor,
    parse_objective,
)
from consensus_clustering_tpu_torch.obs.tracing import Span, Tracer, new_trace_id

__all__ = [
    "ANCHOR_CALIBRATED",
    "ANCHOR_OBSERVED",
    "DEFAULT_ACCURACY_BAND",
    "DEFAULT_BAND",
    "DEFAULT_OBJECTIVES",
    "DEFAULT_TIME_BUCKETS",
    "DEFAULT_WINDOWS",
    "DriftWatchdog",
    "LatencyHistogram",
    "MemoryAccountant",
    "Objective",
    "SLOMonitor",
    "Span",
    "Tracer",
    "new_trace_id",
    "parse_objective",
    "render_prometheus",
    "validate_exposition",
]
