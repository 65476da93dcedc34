# Copied from consensus_clustering_tpu/obs/memory.py.
"""Memory accounting: the preflight model vs what jobs actually use.

ROADMAP items 2–3 live or die on the N² memory wall, yet until this
module the service never compared :mod:`~consensus_clustering_tpu_torch.serve.
preflight`'s exact-term admission model against measured reality — the
413 gate could drift arbitrarily far from the backend without anyone
noticing (an over-estimate silently rejects jobs that would have fit; an
under-estimate is the OOM the gate exists to prevent).

Per shape bucket (the calibration store's bucket string, shared with the
drift watchdog), the executor feeds one observation per successful
execution:

- ``estimated_bytes`` — the preflight model's total for the job as
  admitted (block size resolved, checkpointing state known);
- ``compiled_bytes`` — XLA's own static plan for the warm block
  executable (``compiled.memory_analysis()``: arguments + outputs +
  peak temporaries), available on every backend including CPU;
- ``peak_delta_bytes`` — the device allocator high-water delta around
  the attempt (``device_memory_stats()``), available on TPU/GPU only.

The **measured** truth is the allocator delta when the backend reports
one, else the compiled plan; ``accuracy = estimated / measured`` is the
model's disclosed error, flagged (``preflight_inaccurate``, one-shot
per excursion like ``perf_drift``) when it leaves the configured band.
The **correction** — an EWMA of ``measured / estimated``, floored at
1.0 — feeds back into the admission gate: the scheduler scales the
model's estimate UP by it before comparing against the budget, so a
backend where the model under-counts tightens its own 413 gate from
live evidence.  The floor is deliberate: the model documents itself as
a lower bound with exact leading terms, and live evidence is only ever
allowed to make the gate MORE conservative, never to relax it below
the model (an over-admission OOMs every in-flight job; an
over-rejection is one structured 413).

Stdlib-only, one lock, injected emitter — the drift watchdog's shape,
so the obs package stays importable with a wedged backend.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

#: Default accuracy band (estimated ÷ measured).  Two regimes, both
#: healthy, both inside this band: at serving-scale N the model's exact
#: N² terms dominate and its deliberate over-counting (checkpoint
#: pinning ×3) puts the ratio above 1; at tiny N (the CI smoke shapes —
#: benchmarks/latency_probe.py measures ~0.4 at N=40 on CPU) XLA's
#: per-block lane/histogram temporaries, which the N²-exact model
#: ignores, dominate the compiled plan and push the ratio below 1.
#: Below the low edge the model UNDER-estimates at scale (the dangerous
#: direction: the 413 gate admits jobs bigger than it thinks); above
#: the high edge it over-rejects.
DEFAULT_ACCURACY_BAND = (0.2, 10.0)

#: Measurement provenances, disclosed per bucket in ``/metrics``.
SOURCE_DEVICE = "device"
SOURCE_COMPILED = "compiled"


def _pos_int(value: Any) -> Optional[int]:
    """The ONE normalization rule for byte measurements (shared by
    :func:`judge_measurement` and :meth:`MemoryAccountant.observe` so
    the two surfaces cannot diverge): a positive int, else None."""
    if value is None:
        return None
    v = int(value)
    return v if v > 0 else None


def attributable_peak_delta(
    mem_before: Dict[str, Any],
    mem_after: Dict[str, Any],
) -> Tuple[Optional[int], Optional[bool]]:
    """(peak_delta_bytes, masked) from allocator stats around one
    attempt.  The allocator never resets its process-lifetime
    high-water, so a reading is attributable to THIS attempt only when
    the high-water advanced during it; otherwise it is an earlier
    larger job's peak (``masked``) and must not be measured — feeding
    it onward would converge the bucket's correction EWMA on the old
    job's footprint and permanently inflate the 413 gate."""
    peak_after = mem_after.get("peak_bytes_in_use")
    peak_before = mem_before.get("peak_bytes_in_use")
    in_use_before = mem_before.get("bytes_in_use")
    if peak_after is None or in_use_before is None:
        return None, None
    masked = (
        peak_before is not None and int(peak_after) <= int(peak_before)
    )
    if masked:
        return None, True
    return max(0, int(peak_after) - int(in_use_before)), False


def judge_measurement(
    estimated_bytes: Optional[int],
    compiled_bytes: Optional[int] = None,
    peak_delta_bytes: Optional[int] = None,
) -> Tuple[Optional[int], Optional[str], Optional[float]]:
    """(measured_bytes, source, accuracy) for one observation — the ONE
    precedence rule (allocator delta beats compiled plan beats nothing)
    shared by :meth:`MemoryAccountant.observe` and the executor's
    per-result ``memory`` block, so the two surfaces cannot disagree."""
    estimated = _pos_int(estimated_bytes)
    compiled = _pos_int(compiled_bytes)
    peak = _pos_int(peak_delta_bytes)
    if peak is not None:
        measured, source = peak, SOURCE_DEVICE
    elif compiled is not None:
        measured, source = compiled, SOURCE_COMPILED
    else:
        return None, None, None
    accuracy = (
        round(estimated / measured, 4) if estimated is not None else None
    )
    return measured, source, accuracy


class _BucketMemory:
    __slots__ = (
        "estimated", "measured", "compiled", "peak_delta", "source",
        "accuracy", "correction_ewma", "flagged", "active",
        "observations",
    )

    def __init__(self):
        self.estimated: Optional[int] = None
        self.measured: Optional[int] = None
        self.compiled: Optional[int] = None
        self.peak_delta: Optional[int] = None
        self.source: Optional[str] = None
        self.accuracy: Optional[float] = None
        # EWMA of measured/estimated; the public correction is
        # max(1.0, this) — live evidence only ever tightens the gate.
        self.correction_ewma: Optional[float] = None
        self.flagged = 0
        self.active = False
        self.observations = 0


class MemoryAccountant:
    """Per-bucket estimate-vs-measured ledger + accuracy band check.

    ``observe()`` is called by the executor once per successful
    execution; it returns the ``preflight_inaccurate`` payload on a
    transition out of the accuracy band (and forwards it to the
    injected emitter), ``None`` otherwise.  ``correction(bucket)`` is
    the admission-gate feedback (>= 1.0 always).  ``snapshot()`` is the
    ``/metrics`` view, copied under this accountant's own lock.
    """

    def __init__(
        self,
        band: Tuple[float, float] = DEFAULT_ACCURACY_BAND,
        ewma_alpha: float = 0.3,
        enabled: bool = True,
    ):
        low, high = float(band[0]), float(band[1])
        if not 0.0 < low <= 1.0 <= high:
            raise ValueError(
                f"accuracy band must satisfy 0 < low <= 1 <= high, got "
                f"({low}, {high})"
            )
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}"
            )
        self.band = (low, high)
        self.ewma_alpha = float(ewma_alpha)
        self.enabled = bool(enabled)
        self._emit: Optional[Callable[..., Any]] = None
        self._buckets: Dict[str, _BucketMemory] = {}
        self._lock = threading.Lock()

    def set_emitter(self, emit: Optional[Callable[..., Any]]) -> None:
        """Install the event callback (``emit(**payload)``) — the
        scheduler binds its EventLog + counter here."""
        self._emit = emit

    def observe(
        self,
        bucket: str,
        estimated_bytes: int,
        compiled_bytes: Optional[int] = None,
        peak_delta_bytes: Optional[int] = None,
    ) -> Optional[Dict[str, Any]]:
        """Feed one executed job's (estimate, measurements); returns the
        ``preflight_inaccurate`` payload when this observation moves the
        bucket's accuracy outside the band (one-shot per excursion)."""
        if not self.enabled:
            return None
        estimated = _pos_int(estimated_bytes)
        if estimated is None:
            return None
        compiled = _pos_int(compiled_bytes)
        peak = _pos_int(peak_delta_bytes)
        # The allocator high-water is ground truth when the backend
        # reports one; the compiled plan is the portable fallback (the
        # CPU interpreter has no allocator stats) — the helper owns
        # both that precedence rule and the accuracy ratio.
        measured, source, accuracy = judge_measurement(
            estimated, compiled, peak
        )
        payload = None
        with self._lock:
            state = self._buckets.get(bucket)
            if state is None:
                state = self._buckets[bucket] = _BucketMemory()
            state.observations += 1
            state.estimated = estimated
            state.compiled = compiled
            state.peak_delta = peak
            state.measured = measured
            state.source = source
            if measured is None:
                # Nothing to judge the model against this time: the
                # snapshot must not keep showing the PREVIOUS ratio as
                # if it were current next to measured/source = None
                # (``active`` stays latched — no measurement is not
                # evidence the excursion resolved).
                state.accuracy = None
                return None
            state.accuracy = accuracy
            factor = measured / estimated
            if state.correction_ewma is None:
                state.correction_ewma = factor
            else:
                state.correction_ewma = (
                    (1.0 - self.ewma_alpha) * state.correction_ewma
                    + self.ewma_alpha * factor
                )
            low, high = self.band
            if low <= accuracy <= high:
                state.active = False  # re-arm the one-shot
                return None
            if state.active:
                return None  # already flagged this excursion
            state.active = True
            state.flagged += 1
            payload = {
                "bucket": bucket,
                "accuracy": accuracy,
                "estimated_bytes": estimated,
                "measured_bytes": measured,
                "source": source,
                "band_low": low,
                "band_high": high,
                "correction": round(max(1.0, state.correction_ewma), 4),
                "observations": state.observations,
            }
        # Outside the lock (the emitter takes the scheduler's lock and
        # the EventLog's — never nest ours under theirs).
        if self._emit is not None:
            try:
                self._emit(**payload)
            except Exception as e:  # noqa: BLE001 — telemetry must
                logger.warning(
                    "preflight_inaccurate emitter failed: %s", e
                )
        else:
            logger.warning(
                "memory model off at %s: estimated %d vs measured %d "
                "bytes (accuracy %.2f outside [%s, %s], %s)",
                bucket, estimated, measured, payload["accuracy"],
                self.band[0], self.band[1], source,
            )
        return payload

    def correction(self, bucket: str) -> float:
        """Admission-gate scale factor for this bucket: >= 1.0 always
        (live evidence only ever TIGHTENS the 413 gate — see the module
        docstring), 1.0 for buckets never observed."""
        with self._lock:
            state = self._buckets.get(bucket)
            if state is None or state.correction_ewma is None:
                return 1.0
            return max(1.0, state.correction_ewma)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/metrics`` ``memory_accounting`` section.  Top-level
        keys are FIXED (the schema test pins them); per-bucket sub-dicts
        grow with traffic.  Every field copied under this lock."""
        estimated: Dict[str, int] = {}
        measured: Dict[str, int] = {}
        compiled: Dict[str, int] = {}
        peak_delta: Dict[str, int] = {}
        accuracy: Dict[str, float] = {}
        correction: Dict[str, float] = {}
        source: Dict[str, str] = {}
        flagged_total: Dict[str, int] = {}
        active: Dict[str, bool] = {}
        with self._lock:
            for bucket, s in self._buckets.items():
                if s.estimated is not None:
                    estimated[bucket] = s.estimated
                if s.measured is not None:
                    measured[bucket] = s.measured
                if s.compiled is not None:
                    compiled[bucket] = s.compiled
                if s.peak_delta is not None:
                    peak_delta[bucket] = s.peak_delta
                if s.accuracy is not None:
                    accuracy[bucket] = s.accuracy
                if s.correction_ewma is not None:
                    correction[bucket] = round(
                        max(1.0, s.correction_ewma), 4
                    )
                if s.source is not None:
                    source[bucket] = s.source
                if s.flagged:
                    flagged_total[bucket] = s.flagged
                active[bucket] = s.active
        return {
            "enabled": self.enabled,
            "band": [self.band[0], self.band[1]],
            "estimated_bytes": estimated,
            "measured_bytes": measured,
            "compiled_bytes": compiled,
            "peak_delta_bytes": peak_delta,
            "accuracy": accuracy,
            "correction": correction,
            "source": source,
            "flagged_total": flagged_total,
            "active": active,
        }
