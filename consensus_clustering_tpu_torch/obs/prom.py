# Copied from consensus_clustering_tpu/obs/prom.py.
"""Prometheus text exposition (0.0.4) over the serving metrics dict.

``GET /metrics`` keeps its JSON shape (the existing consumers and tests
speak it); ``GET /metrics.prom`` — or ``/metrics?format=prom`` — renders
the SAME scheduler snapshot in the Prometheus text format so standard
scrapers work against the service with zero glue.  One snapshot, two
serialisations: this module never reads counters itself, so the two
views cannot disagree.

Rendering rules (``cctpu_`` prefix throughout):

- numbers → one sample; names ending ``_total`` (and the legacy
  pre-suffix counters) are TYPE ``counter``, the rest ``gauge``;
- labelled dicts (``retry_total``, ``jobs_shed_total``, …) → one sample
  per key under a semantic label name (``reason``, ``priority``, …);
- ``latency_histograms`` → TYPE ``histogram`` families with cumulative
  ``_bucket{le=…}`` samples, ``_sum`` and ``_count``;
- ``perf_drift`` → per-bucket ``ratio``/``anchor_rate``/``flagged_total``
  /``active`` samples plus an ``anchor_info`` info-style metric carrying
  the provenance label;
- ``slo`` → per-(objective, bucket) ``burn_rate``/``good_fraction``/
  ``active``/``breaches_total``/``samples`` plus the objective config
  gauges (docs/OBSERVABILITY.md "SLO layer");
- ``memory_accounting`` → per-bucket estimated/measured/compiled/peak
  byte gauges, ``preflight_accuracy``/``_correction`` and the accuracy
  band (docs/OBSERVABILITY.md "Memory accounting");
- ``fleet`` → the capacity/autoscale snapshot of docs/SERVING.md
  "Fleet runbook": ``fleet_enabled``/``fleet_workers_seen``/
  ``fleet_backlog``/``fleet_peer_backlog``/``fleet_running``/
  ``fleet_slo_burn_active`` gauges, drain-rate and estimated-drain
  gauges when measured, and the current recommendation as
  ``cctpu_fleet_scale_info{recommendation="…"} 1``;
- ``backend`` (a string) → ``cctpu_backend_info{backend="…"} 1``;
- ``worker_id`` (a string) → ``cctpu_worker_info{worker_id="…"} 1``,
  and ``active_leases`` carries the same ``worker_id`` label — the
  per-worker lease gauge of docs/SERVING.md "Multi-worker runbook"
  (each process exports its own exposition; the label is what lets one
  scrape job aggregate a worker fleet over a shared store);
- ``None`` values (an unset ``memory_budget_bytes``) are OMITTED — the
  text format has no null, and a fake 0 would read as "budget: zero
  bytes".  Documented in docs/OBSERVABILITY.md.

:func:`validate_exposition` is the strict checker the acceptance
criteria demand: the tests AND the live latency probe both run every
rendered exposition through it, so a malformed family can never ship
silently.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

PREFIX = "cctpu"

#: Pre-``_total``-convention counters (monotonic but unsuffixed — the
#: JSON surface predates the exposition and its names are load-bearing).
_BARE_COUNTERS = frozenset(
    {
        "jobs_completed", "jobs_failed", "jobs_retried",
        "jobs_timed_out", "jobs_requeued", "jobs_quarantined",
        "cache_hits", "executable_cache_hits",
        "executable_cache_misses", "sweeps_executed",
    }
)

#: Semantic label names for the labelled counter dicts; anything not
#: listed falls back to the generic ``key``.
_LABEL_NAMES = {
    "retry_total": "reason",
    "jobs_shed_total": "priority",
    "integrity_violations_total": "point",
    "autotune_provenance_total": "provenance",
    # Fair-share lanes (docs/SERVING.md "Fair-share & fusion
    # runbook"): per-lane queue depth, labelled "tenant|priority".
    "fair_lanes": "lane",
}

def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _sample(
    name: str, labels: Optional[Mapping[str, Any]], value: Any
) -> str:
    if labels:
        inner = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in labels.items()
        )
        return f"{name}{{{inner}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


def _family(
    lines: List[str], name: str, kind: str, help_text: str
) -> None:
    lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} {kind}")


def _counter_kind(key: str) -> str:
    return (
        "counter"
        if key.endswith("_total") or key in _BARE_COUNTERS
        else "gauge"
    )


def _render_histogram(
    lines: List[str], name: str, snapshot: Mapping[str, Any]
) -> None:
    _family(lines, name, "histogram", f"{name} distribution (seconds)")
    for le, cum in snapshot["buckets"].items():
        lines.append(_sample(f"{name}_bucket", {"le": le}, cum))
    lines.append(_sample(f"{name}_sum", None, snapshot["sum"]))
    lines.append(_sample(f"{name}_count", None, snapshot["count"]))


def _render_perf_drift(
    lines: List[str], drift: Mapping[str, Any]
) -> None:
    base = f"{PREFIX}_perf_drift"
    _family(
        lines, f"{base}_enabled", "gauge",
        "1 when the perf-regression watchdog is on",
    )
    lines.append(_sample(f"{base}_enabled", None, drift.get("enabled")))
    band = drift.get("band") or (0, 0)
    _family(
        lines, f"{base}_band_low", "gauge",
        "lower edge of the acceptable live/anchor throughput ratio",
    )
    lines.append(_sample(f"{base}_band_low", None, band[0]))
    _family(
        lines, f"{base}_band_high", "gauge",
        "upper edge of the acceptable live/anchor throughput ratio",
    )
    lines.append(_sample(f"{base}_band_high", None, band[1]))
    _family(
        lines, f"{base}_ratio", "gauge",
        "live resamples/s over the bucket anchor (1.0 = on calibration)",
    )
    for bucket, v in drift.get("ratio", {}).items():
        lines.append(_sample(f"{base}_ratio", {"bucket": bucket}, v))
    _family(
        lines, f"{base}_anchor_rate", "gauge",
        "anchor resamples/s per bucket",
    )
    for bucket, v in drift.get("anchor_rate", {}).items():
        lines.append(
            _sample(f"{base}_anchor_rate", {"bucket": bucket}, v)
        )
    _family(
        lines, f"{base}_anchor_info", "gauge",
        "anchor provenance per bucket (calibrated | observed)",
    )
    for bucket, prov in drift.get("anchor_provenance", {}).items():
        lines.append(
            _sample(
                f"{base}_anchor_info",
                {"bucket": bucket, "provenance": prov},
                1,
            )
        )
    _family(
        lines, f"{base}_flagged_total", "counter",
        "drift-state transitions per bucket",
    )
    for bucket, v in drift.get("flagged_total", {}).items():
        lines.append(
            _sample(f"{base}_flagged_total", {"bucket": bucket}, v)
        )
    _family(
        lines, f"{base}_active", "gauge",
        "1 while the bucket's ratio sits outside the band",
    )
    for bucket, v in drift.get("active", {}).items():
        lines.append(_sample(f"{base}_active", {"bucket": bucket}, v))


def _render_slo(lines: List[str], slo: Mapping[str, Any]) -> None:
    base = f"{PREFIX}_slo"
    _family(
        lines, f"{base}_enabled", "gauge",
        "1 when the SLO monitor is on",
    )
    lines.append(_sample(f"{base}_enabled", None, slo.get("enabled")))
    windows = slo.get("windows") or (0, 0)
    _family(
        lines, f"{base}_window_short_seconds", "gauge",
        "short burn-rate evaluation window",
    )
    lines.append(
        _sample(f"{base}_window_short_seconds", None, windows[0])
    )
    _family(
        lines, f"{base}_window_long_seconds", "gauge",
        "long burn-rate evaluation window",
    )
    lines.append(
        _sample(f"{base}_window_long_seconds", None, windows[1])
    )
    _family(
        lines, f"{base}_burn_threshold", "gauge",
        "burn rate (error-budget spend multiple) that breaches",
    )
    lines.append(
        _sample(f"{base}_burn_threshold", None, slo.get("burn_threshold"))
    )
    _family(
        lines, f"{base}_objective_target", "gauge",
        "good-fraction target per objective",
    )
    for objective, desc in (slo.get("objectives") or {}).items():
        lines.append(
            _sample(
                f"{base}_objective_target",
                {"objective": objective}, desc.get("target"),
            )
        )
    _family(
        lines, f"{base}_objective_threshold_seconds", "gauge",
        "latency threshold per objective (absent for error_rate)",
    )
    for objective, desc in (slo.get("objectives") or {}).items():
        if desc.get("threshold_seconds") is not None:
            lines.append(
                _sample(
                    f"{base}_objective_threshold_seconds",
                    {"objective": objective},
                    desc["threshold_seconds"],
                )
            )
    per_bucket = (
        ("burn_rate", "gauge",
         "short-window error-budget burn multiple"),
        ("good_fraction", "gauge",
         "long-window good fraction vs the objective target"),
        ("active", "gauge", "1 while the (objective, bucket) breaches"),
        ("breaches_total", "counter",
         "breach-state transitions per (objective, bucket)"),
        ("samples", "gauge", "long-window sample count"),
    )
    for section, kind, help_text in per_bucket:
        _family(lines, f"{base}_{section}", kind, help_text)
        for objective, buckets in (slo.get(section) or {}).items():
            for bucket, v in buckets.items():
                lines.append(
                    _sample(
                        f"{base}_{section}",
                        {"objective": objective, "bucket": bucket}, v,
                    )
                )


def _render_memory_accounting(
    lines: List[str], mem: Mapping[str, Any]
) -> None:
    base = f"{PREFIX}_memory"
    _family(
        lines, f"{base}_accounting_enabled", "gauge",
        "1 when memory accounting is on",
    )
    lines.append(
        _sample(f"{base}_accounting_enabled", None, mem.get("enabled"))
    )
    band = mem.get("band") or (0, 0)
    _family(
        lines, f"{base}_accuracy_band_low", "gauge",
        "lower edge of the acceptable estimated/measured ratio",
    )
    lines.append(_sample(f"{base}_accuracy_band_low", None, band[0]))
    _family(
        lines, f"{base}_accuracy_band_high", "gauge",
        "upper edge of the acceptable estimated/measured ratio",
    )
    lines.append(_sample(f"{base}_accuracy_band_high", None, band[1]))
    per_bucket = (
        ("estimated_bytes", "gauge",
         "preflight model estimate for the bucket's last executed job"),
        ("measured_bytes", "gauge",
         "measured footprint (allocator delta, else compiled plan)"),
        ("compiled_bytes", "gauge",
         "XLA compiled-plan bytes (arguments + outputs + temps)"),
        ("peak_delta_bytes", "gauge",
         "device allocator high-water delta around the attempt"),
        ("accuracy", "gauge",
         "preflight accuracy: estimated over measured (1.0 = exact)"),
        ("correction", "gauge",
         "admission-gate scale factor fed back from measurements"),
        ("flagged_total", "counter",
         "accuracy-band excursions per bucket"),
        ("active", "gauge",
         "1 while the bucket's accuracy sits outside the band"),
    )
    for section, kind, help_text in per_bucket:
        name = (
            f"{PREFIX}_preflight_{section}"
            if section in ("accuracy", "correction", "flagged_total",
                           "active")
            else f"{base}_{section}"
        )
        _family(lines, name, kind, help_text)
        for bucket, v in (mem.get(section) or {}).items():
            lines.append(_sample(name, {"bucket": bucket}, v))
    _family(
        lines, f"{base}_measurement_info", "gauge",
        "measurement source per bucket (device | compiled)",
    )
    for bucket, src in (mem.get("source") or {}).items():
        lines.append(
            _sample(
                f"{base}_measurement_info",
                {"bucket": bucket, "source": src}, 1,
            )
        )


def _render_fleet(lines: List[str], fleet: Mapping[str, Any]) -> None:
    base = f"{PREFIX}_fleet"
    gauges = (
        ("enabled", f"{base}_enabled",
         "1 when the fleet capacity layer is on"),
        ("workers_seen", f"{base}_workers_seen",
         "workers visible through fresh fleet/ heartbeats (self "
         "included)"),
        ("fleet_backlog", f"{base}_backlog",
         "queued jobs across every visible worker"),
        ("peer_backlog", f"{base}_peer_backlog",
         "queued jobs advertised by peers (fleet minus own queue)"),
        ("fleet_running", f"{base}_running",
         "picked-up jobs across every visible worker"),
        ("slo_burn_active", f"{base}_slo_burn_active",
         "active SLO burn (objective, bucket) pairs across the fleet"),
    )
    for key, name, help_text in gauges:
        value = fleet.get(key)
        if value is None:
            continue  # same no-null rule as the top-level walk
        _family(lines, name, "gauge", help_text)
        lines.append(_sample(name, None, value))
    measured = (
        ("fleet_drain_rate_per_s", f"{base}_drain_rate_per_s",
         "summed measured drain rate across the fleet (jobs/s)"),
        ("est_drain_seconds", f"{base}_est_drain_seconds",
         "estimated seconds to drain the fleet backlog at the "
         "measured rate"),
    )
    for key, name, help_text in measured:
        value = fleet.get(key)
        if value is None:
            continue  # unmeasured before the first drain window
        _family(lines, name, "gauge", help_text)
        lines.append(_sample(name, None, value))
    recommendation = fleet.get("recommendation")
    if recommendation is not None:
        _family(
            lines, f"{base}_scale_info", "gauge",
            "current measured autoscale recommendation "
            "(scale_out | scale_in | hold)",
        )
        lines.append(
            _sample(
                f"{base}_scale_info",
                {"recommendation": recommendation}, 1,
            )
        )


def render_prometheus(metrics: Dict[str, Any]) -> str:
    """The scheduler metrics dict as Prometheus text format 0.0.4."""
    lines: List[str] = []
    for key, value in metrics.items():
        name = f"{PREFIX}_{key}"
        if value is None:
            continue  # no null in the text format (see module doc)
        if key == "latency_histograms":
            for hist_name, snapshot in value.items():
                _render_histogram(
                    lines, f"{PREFIX}_{hist_name}", snapshot
                )
            continue
        if key == "perf_drift":
            _render_perf_drift(lines, value)
            continue
        if key == "slo":
            _render_slo(lines, value)
            continue
        if key == "memory_accounting":
            _render_memory_accounting(lines, value)
            continue
        if key == "fleet":
            _render_fleet(lines, value)
            continue
        if key == "backend":
            _family(
                lines, f"{name}_info", "gauge",
                "serving backend label (tpu | gpu | cpu-fallback)",
            )
            lines.append(
                _sample(f"{name}_info", {"backend": value}, 1)
            )
            continue
        if key == "schedule":
            _family(
                lines, f"{name}_info", "gauge",
                "active admission schedule (fair | fifo)",
            )
            lines.append(
                _sample(f"{name}_info", {"schedule": value}, 1)
            )
            continue
        if key == "worker_id":
            _family(
                lines, f"{PREFIX}_worker_info", "gauge",
                "this process's restart-stable worker identity over "
                "the shared jobstore",
            )
            lines.append(
                _sample(f"{PREFIX}_worker_info", {"worker_id": value}, 1)
            )
            continue
        if key == "active_leases":
            _family(
                lines, name, "gauge",
                "job leases this worker currently holds",
            )
            lines.append(
                _sample(
                    name,
                    {"worker_id": metrics.get("worker_id") or "worker"},
                    value,
                )
            )
            continue
        if isinstance(value, Mapping):
            label = _LABEL_NAMES.get(key, "key")
            _family(
                lines, name, _counter_kind(key), f"{key} by {label}"
            )
            for sub, v in value.items():
                lines.append(_sample(name, {label: sub}, v))
            continue
        if isinstance(value, (int, float)):
            _family(lines, name, _counter_kind(key), key)
            lines.append(_sample(name, None, value))
            continue
        # An unknown shape must be loud in tests, silent in production:
        # skip it (the JSON view still carries it) — the schema test
        # pins the key set, so this branch only sees future additions.
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Strict format checker (the acceptance criterion's "strict text-format
# checker": tests and the live latency probe both run it)


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$"
)
_VALID_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


def _parse_labels(blob: str) -> Optional[Dict[str, str]]:
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(blob):
        m = _LABEL_RE.match(blob, pos)
        if m is None:
            return None
        labels[m.group(1)] = m.group(2)
        pos = m.end()
        if pos < len(blob):
            if blob[pos] != ",":
                return None
            pos += 1
    return labels


def validate_exposition(text: str) -> List[str]:
    """Strictly check a text-format exposition; returns problems ([] =
    valid).  Beyond the wire grammar it enforces this repo's contract:
    every sample family carries HELP + TYPE declared before its first
    sample, no duplicate sample (name, labelset), counter values finite
    and >= 0, and histograms are internally consistent (cumulative
    monotone buckets ending in ``le="+Inf"`` that equals ``_count``,
    with ``_sum`` present)."""
    problems: List[str] = []
    if not text.endswith("\n"):
        problems.append("exposition must end with a newline")
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    seen_samples: set = set()
    # histogram family -> {group labelset -> [(le, value)]}, sums, counts
    hist_buckets: Dict[str, Dict[Tuple, List[Tuple[float, float]]]] = {}
    hist_sum: Dict[str, Dict[Tuple, float]] = {}
    hist_count: Dict[str, Dict[Tuple, float]] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 4 or parts[1] not in ("HELP", "TYPE"):
                problems.append(
                    f"line {lineno}: comment is neither HELP nor TYPE"
                )
                continue
            _, kind, name, rest = parts
            if not _NAME_RE.match(name):
                problems.append(
                    f"line {lineno}: bad metric name {name!r}"
                )
                continue
            if kind == "TYPE":
                if rest not in _VALID_TYPES:
                    problems.append(
                        f"line {lineno}: bad TYPE {rest!r} for {name}"
                    )
                if name in types:
                    problems.append(
                        f"line {lineno}: duplicate TYPE for {name}"
                    )
                types[name] = rest
            else:
                helps[name] = rest
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name, _, label_blob, value_s = m.groups()
        labels = _parse_labels(label_blob) if label_blob else {}
        if labels is None:
            problems.append(
                f"line {lineno}: malformed labels in {line!r}"
            )
            continue
        try:
            value = float(value_s)
        except ValueError:
            problems.append(
                f"line {lineno}: unparseable value {value_s!r}"
            )
            continue
        family = name
        suffix = None
        for s in ("_bucket", "_sum", "_count"):
            base = name[: -len(s)]
            if name.endswith(s) and types.get(base) == "histogram":
                family, suffix = base, s
                break
        ftype = types.get(family)
        if ftype is None:
            problems.append(
                f"line {lineno}: sample {name} before/without a TYPE "
                f"declaration for {family}"
            )
            continue
        if family not in helps:
            problems.append(f"{family}: TYPE without HELP")
        key = (name, tuple(sorted(labels.items())))
        if key in seen_samples:
            problems.append(
                f"line {lineno}: duplicate sample {name}{labels}"
            )
        seen_samples.add(key)
        if ftype == "counter" and (
            value < 0 or math.isnan(value) or math.isinf(value)
        ):
            problems.append(
                f"line {lineno}: counter {name} has non-finite/negative "
                f"value {value_s}"
            )
        if ftype == "histogram":
            group = tuple(
                sorted((k, v) for k, v in labels.items() if k != "le")
            )
            if suffix == "_bucket":
                if "le" not in labels:
                    problems.append(
                        f"line {lineno}: histogram bucket without le"
                    )
                    continue
                le_s = labels["le"]
                le = (
                    math.inf if le_s == "+Inf" else None
                )
                if le is None:
                    try:
                        le = float(le_s)
                    except ValueError:
                        problems.append(
                            f"line {lineno}: bad le value {le_s!r}"
                        )
                        continue
                hist_buckets.setdefault(family, {}).setdefault(
                    group, []
                ).append((le, value))
            elif suffix == "_sum":
                hist_sum.setdefault(family, {})[group] = value
            elif suffix == "_count":
                hist_count.setdefault(family, {})[group] = value
            else:
                problems.append(
                    f"line {lineno}: bare sample {name} inside "
                    f"histogram family {family}"
                )
    for family, groups in hist_buckets.items():
        for group, buckets in groups.items():
            ordered = sorted(buckets)
            les = [le for le, _ in ordered]
            if not les or les[-1] != math.inf:
                problems.append(
                    f'{family}{dict(group)}: no le="+Inf" bucket'
                )
                continue
            values = [v for _, v in ordered]
            if any(b > a for b, a in zip(values, values[1:])):
                problems.append(
                    f"{family}{dict(group)}: bucket counts are not "
                    "cumulative/monotone"
                )
            count = hist_count.get(family, {}).get(group)
            if count is None:
                problems.append(f"{family}{dict(group)}: missing _count")
            elif values[-1] != count:
                problems.append(
                    f"{family}{dict(group)}: +Inf bucket {values[-1]} "
                    f"!= _count {count}"
                )
            if group not in hist_sum.get(family, {}):
                problems.append(f"{family}{dict(group)}: missing _sum")
    for family, ftype in types.items():
        if ftype == "histogram" and family not in hist_buckets:
            problems.append(f"{family}: histogram TYPE with no buckets")
    return problems
