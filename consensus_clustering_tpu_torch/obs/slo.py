# Copied from consensus_clustering_tpu/obs/slo.py.
"""SLO layer: objectives over rolling windows with multi-window burn rate.

ROADMAP item 4's heavy-traffic scheduling work needs a judge: "is the
service meeting its latency/error objectives under load" is a question
the latency histograms alone cannot answer (they are cumulative over the
process lifetime — a regression an hour in drowns in the warm-up
distribution).  This module evaluates *objectives* over *rolling
windows*, per shape bucket, the same way the drift watchdog judges
throughput per bucket — because the Monti-style sweep's long-tail jobs
make a percentile objective the honest metric: one N=10⁴ job legitimately
takes 100× one N=10² job, so "p95 of THIS bucket" is the contract, not a
global mean.

Model (the Google-SRE multi-window burn-rate shape, stdlib-only):

- an **objective** names a signal (``job_seconds`` | ``queue_wait_seconds``
  | ``error_rate``), a threshold (seconds; unused for ``error_rate``),
  and a target good-fraction (0.95 ⇒ "p95 of job_seconds ≤ threshold");
- every observation is judged good/bad at observation time and appended
  to the (objective, bucket) rolling ledger; the **error budget** is
  ``1 - target`` and the **burn rate** is ``bad_fraction / budget`` — a
  burn of 1.0 spends the budget exactly, higher spends it faster;
- a **breach** requires the burn rate to exceed ``burn_threshold`` over
  BOTH windows (the long window to mean it, the short window to prove it
  is still happening — a resolved incident must not page an hour later)
  with at least ``min_count`` samples in the long window;
- breaches are one-shot per excursion like ``perf_drift``: one
  ``slo_breach`` event when the bucket enters breach, re-armed when the
  short-window burn drops back under the threshold.

The emitter is injected (the scheduler binds its EventLog + counter), so
this module never imports the serve stack — the obs package stays
stdlib-only and importable with a wedged backend.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

#: Signals an objective can judge.  ``job_seconds`` and
#: ``queue_wait_seconds`` are latency objectives (good = at-or-under the
#: threshold); ``error_rate`` judges attempt outcomes (good = the
#: attempt succeeded; the threshold field is ignored).
SIGNALS = ("job_seconds", "queue_wait_seconds", "error_rate")

#: Default objectives: generous enough that a healthy CPU-fallback
#: deployment never pages, tight enough that a wedge-class regression
#: (minutes of silence) or a failing backend shows up inside one short
#: window.  Operators override per deployment (serve --slo-objective).
DEFAULT_OBJECTIVES = (
    "job_seconds:600:0.95",
    "queue_wait_seconds:120:0.95",
    "error_rate::0.9",
)

#: Default (short, long) rolling windows in seconds.
DEFAULT_WINDOWS = (300.0, 3600.0)


class Objective:
    """One parsed SLO objective (immutable)."""

    __slots__ = ("name", "signal", "threshold", "target")

    def __init__(
        self, signal: str, threshold: Optional[float], target: float
    ):
        if signal not in SIGNALS:
            raise ValueError(
                f"unknown SLO signal {signal!r} (choose from "
                f"{list(SIGNALS)})"
            )
        if signal != "error_rate":
            if threshold is None or threshold <= 0:
                raise ValueError(
                    f"SLO objective {signal} needs a positive seconds "
                    f"threshold, got {threshold!r}"
                )
        else:
            threshold = None  # judged on outcome, not a latency bound
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"SLO target must be in (0, 1), got {target!r}"
            )
        self.name = signal
        self.signal = signal
        self.threshold = threshold
        self.target = float(target)

    def describe(self) -> Dict[str, Any]:
        return {
            "signal": self.signal,
            "threshold_seconds": self.threshold,
            "target": self.target,
        }


def parse_objective(spec: str) -> Objective:
    """``signal:threshold[:target]`` → :class:`Objective`.

    ``job_seconds:30`` (p95 default), ``job_seconds:30:0.99``,
    ``error_rate::0.9`` (the threshold slot is empty — outcome-judged).
    """
    parts = str(spec).split(":")
    if len(parts) not in (2, 3):
        raise ValueError(
            f"SLO objective {spec!r} is not signal:threshold[:target]"
        )
    signal = parts[0]
    threshold = float(parts[1]) if parts[1] != "" else None
    target = float(parts[2]) if len(parts) == 3 else 0.95
    return Objective(signal, threshold, target)


class _LedgerState:
    __slots__ = ("events", "active", "breaches", "burn_short",
                 "good_fraction_long", "samples_long")

    def __init__(self):
        # (timestamp, good) pairs inside the long window, oldest first.
        self.events: Deque[Tuple[float, bool]] = deque()
        self.active = False
        self.breaches = 0
        self.burn_short: Optional[float] = None
        self.good_fraction_long: Optional[float] = None
        self.samples_long = 0


class SLOMonitor:
    """Rolling-window SLO evaluation per (objective, shape bucket).

    The scheduler calls :meth:`observe_queue_wait` at worker pickup
    (outcome-blind: an admission backlog must burn the queue-wait
    objective even when the delayed jobs then fail — a wedged backend
    is exactly when it must page), :meth:`observe_job` once per
    terminal executed job (end-to-end latency), and
    :meth:`observe_attempt` once per attempt outcome (the error-rate
    signal counts retries a completed job burned, not just final
    verdicts).  ``snapshot()`` is the ``/metrics`` view — fixed
    top-level keys, per-bucket sub-dicts growing with traffic, all
    copied under this monitor's own lock (the drift watchdog's rule).
    """

    def __init__(
        self,
        objectives: Optional[Sequence[Any]] = None,
        windows: Tuple[float, float] = DEFAULT_WINDOWS,
        burn_threshold: float = 2.0,
        min_count: int = 3,
        enabled: bool = True,
        time_fn: Callable[[], float] = time.time,
    ):
        short, long_ = float(windows[0]), float(windows[1])
        if not 0 < short <= long_:
            raise ValueError(
                f"SLO windows must satisfy 0 < short <= long, got "
                f"({short}, {long_})"
            )
        if burn_threshold <= 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {burn_threshold}"
            )
        if min_count < 1:
            raise ValueError(f"min_count must be >= 1, got {min_count}")
        if objectives is None:
            objectives = DEFAULT_OBJECTIVES
        parsed: List[Objective] = []
        seen = set()
        for obj in objectives:
            o = obj if isinstance(obj, Objective) else parse_objective(obj)
            if o.name in seen:
                raise ValueError(
                    f"duplicate SLO objective for signal {o.name!r}"
                )
            seen.add(o.name)
            parsed.append(o)
        self.objectives = tuple(parsed)
        self.windows = (short, long_)
        self.burn_threshold = float(burn_threshold)
        self.min_count = int(min_count)
        self.enabled = bool(enabled)
        self._time = time_fn
        self._emit: Optional[Callable[..., Any]] = None
        self._by_name = {o.name: o for o in self.objectives}
        # (objective name, bucket) -> ledger
        self._ledgers: Dict[Tuple[str, str], _LedgerState] = {}
        self._lock = threading.Lock()

    def set_emitter(self, emit: Optional[Callable[..., Any]]) -> None:
        """Install the breach callback (``emit(**payload)``) — the
        scheduler binds its EventLog + ``slo_breach_events_total``."""
        self._emit = emit

    # -- feeds -----------------------------------------------------------

    def observe_queue_wait(
        self, bucket: str, queue_wait_seconds: Optional[float]
    ) -> List[Dict[str, Any]]:
        """Feed one job's admission→pickup wait, at pickup — BEFORE
        the outcome exists.  Deliberately outcome-blind: the wait
        already happened whether the job then succeeds, times out, or
        dies with the backend, and the wedged-backend overload (every
        job queues for minutes, then fails) is exactly the incident
        this objective exists to page on — judging completed jobs only
        would read healthy throughout it."""
        if not self.enabled or queue_wait_seconds is None:
            return []
        out: List[Dict[str, Any]] = []
        for objective in self.objectives:
            if objective.signal != "queue_wait_seconds":
                continue
            good = (
                float(queue_wait_seconds) <= float(objective.threshold)
            )
            payload = self._record(objective, bucket, good)
            if payload is not None:
                out.append(payload)
        return out

    def observe_job(
        self,
        bucket: str,
        job_seconds: Optional[float],
        ok: bool = True,
    ) -> List[Dict[str, Any]]:
        """Feed one terminal executed job; returns any breach payloads
        this observation triggered (also forwarded to the emitter).

        End-to-end latency judges completed jobs only (``ok=False``
        jobs have no honest end-to-end latency — their failure is the
        ``error_rate`` signal's business, fed per attempt; their queue
        wait was already fed at pickup by
        :meth:`observe_queue_wait`)."""
        if not self.enabled or not ok or job_seconds is None:
            return []
        out: List[Dict[str, Any]] = []
        for objective in self.objectives:
            if objective.signal != "job_seconds":
                continue
            good = float(job_seconds) <= float(objective.threshold)
            payload = self._record(objective, bucket, good)
            if payload is not None:
                out.append(payload)
        return out

    def observe_attempt(
        self, bucket: str, ok: bool
    ) -> Optional[Dict[str, Any]]:
        """Feed one attempt outcome into the ``error_rate`` objective
        (a job that succeeded after two retries still burned two bad
        attempts of error budget)."""
        if not self.enabled:
            return None
        for objective in self.objectives:
            if objective.signal == "error_rate":
                return self._record(objective, bucket, bool(ok))
        return None

    # -- evaluation ------------------------------------------------------

    def _window_counts(
        self, state: _LedgerState, now: float
    ) -> Tuple[int, int, int, int]:
        """Evict events past the long window; returns (bad_long,
        n_long, bad_short, n_short).  Caller holds the lock."""
        short, long_ = self.windows
        while state.events and now - state.events[0][0] > long_:
            state.events.popleft()
        n_long = len(state.events)
        bad_long = sum(1 for _, g in state.events if not g)
        bad_short = n_short = 0
        for ts, g in reversed(state.events):
            if now - ts > short:
                break
            n_short += 1
            if not g:
                bad_short += 1
        return bad_long, n_long, bad_short, n_short

    def _evaluate(
        self, objective: Objective, state: _LedgerState, now: float
    ) -> Tuple[bool, Dict[str, Any]]:
        """Re-derive the ledger's published fields (burn, good
        fraction, samples) from the windows AS OF ``now``; returns
        (breaching, detail) and re-arms the one-shot when the breach
        condition no longer holds.  Caller holds the lock.  Called from
        both the observation path and ``snapshot()`` — so a bucket
        whose traffic stopped still decays out of the breach state as
        its bad samples age past the windows, instead of reporting
        ``active=true`` in ``/metrics`` forever."""
        bad_long, n_long, bad_short, n_short = self._window_counts(
            state, now
        )
        budget = max(1.0 - objective.target, 1e-9)
        burn_long = (bad_long / n_long) / budget if n_long else 0.0
        burn_short = (
            (bad_short / n_short) / budget if n_short else 0.0
        )
        state.burn_short = round(burn_short, 4)
        state.good_fraction_long = (
            round(1.0 - bad_long / n_long, 4) if n_long else None
        )
        state.samples_long = n_long
        breaching = (
            n_long >= self.min_count
            and burn_long >= self.burn_threshold
            and burn_short >= self.burn_threshold
        )
        if not breaching:
            state.active = False  # re-arm the one-shot
        return breaching, {
            "burn_short": burn_short,
            "burn_long": burn_long,
            "bad_long": bad_long,
            "n_long": n_long,
        }

    def _record(
        self, objective: Objective, bucket: str, good: bool
    ) -> Optional[Dict[str, Any]]:
        now = self._time()
        short, long_ = self.windows
        payload = None
        with self._lock:
            key = (objective.name, bucket)
            state = self._ledgers.get(key)
            if state is None:
                state = self._ledgers[key] = _LedgerState()
            state.events.append((now, bool(good)))
            breaching, detail = self._evaluate(objective, state, now)
            if not breaching:
                return None
            if state.active:
                return None  # already flagged this excursion
            state.active = True
            state.breaches += 1
            payload = {
                "objective": objective.name,
                "signal": objective.signal,
                "bucket": bucket,
                "threshold_seconds": objective.threshold,
                "target": objective.target,
                "burn_short": round(detail["burn_short"], 4),
                "burn_long": round(detail["burn_long"], 4),
                "window_short_seconds": short,
                "window_long_seconds": long_,
                "bad_count": detail["bad_long"],
                "sample_count": detail["n_long"],
            }
        # Outside the lock: the emitter takes the scheduler's lock and
        # the EventLog's — never nest ours under theirs (drift's rule).
        if self._emit is not None:
            try:
                self._emit(**payload)
            except Exception as e:  # noqa: BLE001 — telemetry must
                logger.warning("slo_breach emitter failed: %s", e)
        else:
            logger.warning(
                "SLO breach: %s at %s burning %.1fx budget "
                "(target %.2f over %ss/%ss windows)",
                objective.name, bucket, payload["burn_long"],
                objective.target, short, long_,
            )
        return payload

    # -- /metrics --------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``/metrics`` ``slo`` section.  Top-level keys are FIXED
        (the schema test pins them); per-objective bucket sub-dicts grow
        with traffic.  Copied under this monitor's lock.

        Each ledger is RE-EVALUATED against the current time first: a
        bucket whose traffic stopped after a breach must decay out of
        ``active`` as its bad samples age past the windows — otherwise
        ``/metrics`` would report a resolved incident as ongoing
        forever (the re-arm would only ever run on the next
        observation, which never comes)."""
        objectives = {
            o.name: o.describe() for o in self.objectives
        }
        burn_rate: Dict[str, Dict[str, float]] = {
            o.name: {} for o in self.objectives
        }
        good_fraction: Dict[str, Dict[str, float]] = {
            o.name: {} for o in self.objectives
        }
        active: Dict[str, Dict[str, bool]] = {
            o.name: {} for o in self.objectives
        }
        breaches_total: Dict[str, Dict[str, int]] = {
            o.name: {} for o in self.objectives
        }
        samples: Dict[str, Dict[str, int]] = {
            o.name: {} for o in self.objectives
        }
        now = self._time()
        with self._lock:
            for (name, bucket), s in self._ledgers.items():
                objective = self._by_name.get(name)
                if objective is not None:
                    self._evaluate(objective, s, now)
                if s.burn_short is not None:
                    burn_rate[name][bucket] = s.burn_short
                if s.good_fraction_long is not None:
                    good_fraction[name][bucket] = s.good_fraction_long
                active[name][bucket] = s.active
                if s.breaches:
                    breaches_total[name][bucket] = s.breaches
                samples[name][bucket] = s.samples_long
        return {
            "enabled": self.enabled,
            "windows": [self.windows[0], self.windows[1]],
            "burn_threshold": self.burn_threshold,
            "min_count": self.min_count,
            "objectives": objectives,
            "burn_rate": burn_rate,
            "good_fraction": good_fraction,
            "active": active,
            "breaches_total": breaches_total,
            "samples": samples,
        }
