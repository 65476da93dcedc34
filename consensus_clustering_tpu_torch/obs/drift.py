# Copied from consensus_clustering_tpu/obs/drift.py.
"""Perf-regression watchdog: live per-bucket throughput vs its anchor.

ROADMAP item 5's free lunch: the serving executor already observes every
evaluated H-block's wall-clock (the hang watchdog's EWMA), and the
autotune calibration store already records what this *environment ×
shape bucket* is supposed to sustain (the ``stream_h_block`` record's
``rate``, resamples/s).  Comparing the two continuously turns the
service into a hardware/runtime regression watchdog: a thermally
throttled chip, a misbehaving runtime upgrade, or a noisy neighbour
shows up as a drift ratio long before anyone re-runs a benchmark.

Model, per shape bucket (the calibration store's bucket string):

- each block's **seconds per resample** (``block_seconds /
  resamples_per_block``) is EWMA'd (``alpha`` weight on the newest
  block — matching the wedge watchdog's smoothing) and the live rate is
  its reciprocal: time-domain smoothing, so one pathological block
  moves the EWMA the way it moves real throughput (rate-domain
  averaging would understate it), and normalising by the block's OWN
  resample count keeps a truncated final block honest — H values that
  don't divide the block size are routine, and crediting a partial
  block with full-block work would oscillate the ratio across the band
  every job;
- the **anchor** is the calibrated record's rate when the resolution
  that steered this bucket carried one (provenance ``calibrated``);
  otherwise the bucket self-anchors on its own EWMA after
  ``anchor_blocks`` observations (provenance ``observed``) — a
  deployment with no calibration store still catches *mid-run*
  regressions against its own early blocks;
- ``ratio = live_rate / anchor_rate``; outside ``band`` (low, high) the
  bucket enters the *drifting* state and ONE ``perf_drift`` event is
  emitted (re-armed when the ratio returns in band — a sustained
  regression is one operator signal, not one per block).  Ratios above
  the band flag too: a 3× "speedup" against a calibrated record means
  the record no longer describes this environment.

Stdlib-only, one lock, and the emitter is injected (the scheduler binds
its EventLog + counters) so this module never imports the serve stack.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

#: Anchor provenances (disclosed per bucket in ``/metrics``).
ANCHOR_CALIBRATED = "calibrated"
ANCHOR_OBSERVED = "observed"

#: Default drift band: live throughput below 60% of — or above 180% of
#: — the anchor flags.  Wide enough that CPU session noise (PERF.md
#: measures ±6-9% run-to-run) never false-positives; a real wedge-class
#: slowdown is orders of magnitude.
DEFAULT_BAND = (0.6, 1.8)


class _BucketState:
    __slots__ = (
        "ewma_spr", "observations", "anchor_rate",
        "anchor_provenance", "ratio", "active", "flagged",
    )

    def __init__(self):
        # EWMA of seconds-per-resample (see module docstring).
        self.ewma_spr: Optional[float] = None
        self.observations = 0
        self.anchor_rate: Optional[float] = None
        self.anchor_provenance: Optional[str] = None
        self.ratio: Optional[float] = None
        self.active = False
        self.flagged = 0


class DriftWatchdog:
    """Per-bucket resamples/s ledger + band check.

    ``observe()`` is called from the executor's block callback (one call
    per evaluated H-block); it returns the ``perf_drift`` event payload
    on a transition into the drifting state (and forwards it to the
    injected emitter), ``None`` otherwise.  ``snapshot()`` is the
    ``/metrics`` view — copied under the watchdog's own lock, so the
    endpoint's dict copy can never race a first-bucket insertion.
    """

    def __init__(
        self,
        band: Tuple[float, float] = DEFAULT_BAND,
        anchor_blocks: int = 12,
        ewma_alpha: float = 0.3,
        min_observations: int = 3,
        enabled: bool = True,
    ):
        low, high = (float(band[0]), float(band[1]))
        if not 0.0 < low < 1.0 <= high:
            raise ValueError(
                f"drift band must satisfy 0 < low < 1 <= high, got "
                f"({low}, {high})"
            )
        if anchor_blocks < 1:
            raise ValueError(
                f"anchor_blocks must be >= 1, got {anchor_blocks}"
            )
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}"
            )
        self.band = (low, high)
        self.anchor_blocks = int(anchor_blocks)
        self.ewma_alpha = float(ewma_alpha)
        self.min_observations = int(min_observations)
        self.enabled = bool(enabled)
        self._emit: Optional[Callable[..., Any]] = None
        self._buckets: Dict[str, _BucketState] = {}
        self._lock = threading.Lock()

    def set_emitter(self, emit: Optional[Callable[..., Any]]) -> None:
        """Install the event callback (``emit(**payload)``) — the
        scheduler binds its EventLog + drift counter here."""
        self._emit = emit

    def observe(
        self,
        bucket: str,
        block_seconds: float,
        resamples_per_block: float,
        calibrated_rate: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Feed one evaluated block; returns the ``perf_drift`` payload
        when this observation transitions the bucket into drift."""
        if not self.enabled or block_seconds <= 0 or resamples_per_block <= 0:
            return None
        payload = None
        spr = float(block_seconds) / float(resamples_per_block)
        with self._lock:
            state = self._buckets.get(bucket)
            if state is None:
                state = self._buckets[bucket] = _BucketState()
            if state.ewma_spr is None:
                state.ewma_spr = spr
            else:
                state.ewma_spr = (
                    (1.0 - self.ewma_alpha) * state.ewma_spr
                    + self.ewma_alpha * spr
                )
            state.observations += 1
            live_rate = 1.0 / state.ewma_spr
            if calibrated_rate is not None and calibrated_rate > 0:
                # A calibrated anchor always wins, and is refreshed on
                # every observation — the record is the contract.
                state.anchor_rate = float(calibrated_rate)
                state.anchor_provenance = ANCHOR_CALIBRATED
            elif (
                state.anchor_rate is None
                and state.observations >= self.anchor_blocks
            ):
                # Self-anchor: the bucket's own warmed-up EWMA becomes
                # the reference.  Set ONCE — a slow drift must not drag
                # its own anchor along with it.
                state.anchor_rate = live_rate
                state.anchor_provenance = ANCHOR_OBSERVED
            if (
                state.anchor_rate is None
                or state.observations < self.min_observations
            ):
                return None
            ratio = live_rate / state.anchor_rate
            state.ratio = ratio
            low, high = self.band
            if low <= ratio <= high:
                state.active = False  # re-arm the one-shot
                return None
            if state.active:
                return None  # already flagged this excursion
            state.active = True
            state.flagged += 1
            payload = {
                "bucket": bucket,
                "ratio": round(ratio, 4),
                "live_rate": round(live_rate, 2),
                "anchor_rate": round(state.anchor_rate, 2),
                "anchor_provenance": state.anchor_provenance,
                "band_low": low,
                "band_high": high,
                "observations": state.observations,
            }
        # Outside the lock: the emitter takes the scheduler's lock and
        # the EventLog's — never nest ours under theirs.
        if self._emit is not None:
            try:
                self._emit(**payload)
            except Exception as e:  # noqa: BLE001 — telemetry must
                logger.warning("perf_drift emitter failed: %s", e)
        else:
            logger.warning(
                "perf drift at %s: live %.2f r/s vs %s anchor %.2f "
                "(ratio %.3f outside [%s, %s])",
                bucket, payload["live_rate"],
                payload["anchor_provenance"], payload["anchor_rate"],
                payload["ratio"], self.band[0], self.band[1],
            )
        return payload

    def snapshot(self) -> Dict[str, Any]:
        """The ``/metrics`` ``perf_drift`` section.  Top-level keys are
        FIXED (the schema test pins them); the per-bucket sub-dicts grow
        with traffic.  Every field is read under this lock — a bucket
        mid-``observe`` on another thread must never surface a
        half-updated (rate, provenance) pair."""
        ratio: Dict[str, float] = {}
        anchor_rate: Dict[str, float] = {}
        anchor_provenance: Dict[str, str] = {}
        flagged_total: Dict[str, int] = {}
        active: Dict[str, bool] = {}
        with self._lock:
            for bucket, s in self._buckets.items():
                if s.ratio is not None:
                    ratio[bucket] = round(s.ratio, 4)
                if s.anchor_rate is not None:
                    anchor_rate[bucket] = round(s.anchor_rate, 2)
                    anchor_provenance[bucket] = s.anchor_provenance
                if s.flagged:
                    flagged_total[bucket] = s.flagged
                active[bucket] = s.active
        return {
            "enabled": self.enabled,
            "band": [self.band[0], self.band[1]],
            "ratio": ratio,
            "anchor_rate": anchor_rate,
            "anchor_provenance": anchor_provenance,
            "flagged_total": flagged_total,
            "active": active,
        }
