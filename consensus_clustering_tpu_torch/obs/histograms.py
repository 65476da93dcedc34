# Copied from consensus_clustering_tpu/obs/histograms.py.
"""Fixed-bucket latency histograms for the serving metrics surface.

ROADMAP item 4 asks for "latency histograms in ``/metrics``" so the
scheduler work is *measured, not asserted*.  These are Prometheus-style
cumulative histograms with one deliberate constraint: the bucket
boundaries are FIXED at construction and every bucket is pre-seeded at
zero, so the ``/metrics`` key set never changes over a process lifetime
— the PR-5/6 dict-copy rule (a first-key insertion racing the metrics
endpoint's dict copy would 500 it) applied to distributions.

Everything here is stdlib-only: the histogram is a list of counters
behind one lock, observed from the scheduler worker, the executor's
block callback, and the checkpoint writer thread — three threads, one
``observe`` each per event, no allocation on the hot path.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Sequence, Union

#: One bucket ladder for every serving latency (checkpoint writes are
#: ~10 ms, H-blocks 0.1-10 s, end-to-end jobs seconds to many minutes):
#: sharing one ladder keeps the exposition uniform and the JSON schema
#: test exact.  Spans 1 ms to 30 min; slower lands in +Inf.
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0,
)

#: The ``le`` label for the overflow bucket (Prometheus spelling).
INF_LABEL = "+Inf"


def bucket_label(bound: float) -> str:
    """Canonical string for a bucket bound — the JSON snapshot key AND
    the Prometheus ``le`` label value, one spelling for both."""
    return format(float(bound), "g")


class LatencyHistogram:
    """Cumulative fixed-bucket histogram of seconds.

    ``snapshot()`` returns the Prometheus-shaped view — cumulative
    per-``le`` counts ending in ``+Inf``, plus ``count`` and ``sum`` —
    with a key set that is identical from construction on (all buckets
    pre-seeded at zero).
    """

    def __init__(
        self, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
    ):
        bounds = tuple(float(b) for b in buckets)
        if not bounds:
            raise ValueError("need at least one bucket bound")
        for lo, hi in zip(bounds, bounds[1:]):
            if not lo < hi:
                raise ValueError(
                    f"bucket bounds must strictly increase, got "
                    f"{lo} >= {hi}"
                )
        if bounds[0] <= 0 or bounds[-1] != bounds[-1] or bounds[-1] == float(
            "inf"
        ):
            raise ValueError(
                "bounds must be positive finite numbers (the +Inf "
                "bucket is implicit)"
            )
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # last slot = +Inf
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        v = float(seconds)
        if v != v:  # NaN would silently poison sum
            return
        idx = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> Dict[str, Union[int, float, Dict[str, int]]]:
        """Prometheus-shaped view: cumulative buckets, count, sum."""
        with self._lock:
            counts = list(self._counts)
            total = self._count
            sum_ = self._sum
        buckets: Dict[str, int] = {}
        running = 0
        for bound, c in zip(self.bounds, counts):
            running += c
            buckets[bucket_label(bound)] = running
        buckets[INF_LABEL] = running + counts[-1]
        return {
            "buckets": buckets,
            "count": total,
            "sum": round(sum_, 6),
        }
