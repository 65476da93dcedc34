# Copied from consensus_clustering_tpu/serve/sched/fairshare.py.
"""Weighted-fair queueing over tenant × priority lanes.

The scheduler's admission queue was one bounded FIFO: at "millions of
users" scale, one tenant's burst parks everyone else's work behind it —
a high-priority interactive job waits out a best-effort bulk flood that
happened to arrive first.  :class:`FairShareQueue` replaces the FIFO
with **deficit round-robin (DRR)** over lanes keyed ``(tenant,
priority)``:

- every lane is FIFO *internally* (two jobs from one tenant at one
  priority keep their submission order);
- lanes are served in a rotation; each visit a lane earns its
  **weight** as deficit and spends 1 per job served, so over any busy
  interval lane throughput converges to the weight ratio (a weight-4
  lane drains 4× a weight-1 lane) without ever parking a lane outright;
- a **starvation clock** bounds the wait regardless of weights: a lane
  that has gone UNSERVED past ``starvation_seconds`` while holding an
  equally aged head job is served next, oldest head first (the grant
  is charged against the lane's deficit, so it pays the ride back —
  fairness bends, it doesn't break).  Both conditions matter: a deep
  backlog in a lane the rotation IS serving regularly is congestion,
  not starvation, and letting aged heads jump the rotation wholesale
  would invert the weights under any overload longer than the clock —
  the exact failure fair-share exists to prevent;
- capacity is GLOBAL (one ``maxsize`` across all lanes), preserving the
  bounded-admission contract the FIFO had: a full queue still 429s at
  submission, whatever the lane.

Lane weight = ``priority_weights[priority] × tenant_weights[tenant]``
(tenants default to 1.0).  The default priority weights (high 4,
normal 2, low 1) mean a saturated box spends 4/7 of its slots on
high-priority work while low-priority still progresses.

``take_matching`` is the same-bucket fusion hook (serve/sched/
fusion.py): after the fair order picks the next job, the planner pulls
up to k-1 more *matching* jobs out of ANY lane to ride the same fused
device program.  Taken jobs are bonus throughput — they leave the queue
earlier than their lane's turn, so the raid cannot starve the lanes it
takes from — and they are not charged to any lane's deficit.

Stdlib-only and jax-free by design: the queue is pure bookkeeping.
All methods are thread-safe (HTTP handler threads put, the scheduler
worker gets).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

#: Default priority weights: the shed policy's vocabulary, weighted.
DEFAULT_PRIORITY_WEIGHTS = {"high": 4.0, "normal": 2.0, "low": 1.0}


def lane_name(tenant: str, priority: str) -> str:
    """The one string spelling of a lane, used by /metrics
    (``fair_lanes``) and the runbook alike."""
    return f"{tenant}|{priority}"


class FairShareQueue:
    """DRR fair queue with the subset of the ``queue.Queue`` surface the
    scheduler uses (``put_nowait``/``get``/``qsize``/``maxsize``),
    extended with lane metadata on put and ``take_matching`` for the
    fusion planner.

    ``put_nowait(None)`` is the scheduler's stop-wake sentinel: it
    bypasses capacity and lane accounting entirely (a shutdown must
    never be refused by a full queue).
    """

    def __init__(
        self,
        maxsize: int = 16,
        priority_weights: Optional[Dict[str, float]] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        starvation_seconds: float = 30.0,
        clock=time.monotonic,
    ):
        self.maxsize = int(maxsize)
        self.priority_weights = dict(
            priority_weights or DEFAULT_PRIORITY_WEIGHTS
        )
        self.tenant_weights = dict(tenant_weights or {})
        for name, weights in (
            ("priority", self.priority_weights),
            ("tenant", self.tenant_weights),
        ):
            for key, w in weights.items():
                if not (isinstance(w, (int, float)) and w > 0):
                    raise ValueError(
                        f"{name} weight for {key!r} must be > 0, got {w!r}"
                    )
        if starvation_seconds <= 0:
            raise ValueError(
                f"starvation_seconds must be > 0, got {starvation_seconds}"
            )
        self.starvation_seconds = float(starvation_seconds)
        self._clock = clock
        self._cond = threading.Condition()
        # lane key -> deque[(item, enqueued_at)]; lanes are created on
        # first use and stay registered (their deficit state is what
        # makes the rotation fair across bursts).
        self._lanes: Dict[Tuple[str, str], deque] = {}
        self._deficit: Dict[Tuple[str, str], float] = {}
        self._rotation: List[Tuple[str, str]] = []
        self._pos = 0
        self._size = 0
        self._wake = 0
        # When each lane was last served (or created): the starvation
        # clock's evidence that a lane is actually being passed over,
        # not merely backlogged.
        self._last_served: Dict[Tuple[str, str], float] = {}
        # Counters for /metrics (read via snapshot()).
        self.served_total: Dict[str, int] = {}
        self.starvation_grants_total = 0

    #: Idle (empty) lanes beyond this count are garbage-collected:
    #: ``tenant`` is client-controlled, and without a bound every
    #: distinct value would permanently grow the rotation, the
    #: snapshot, and the /metrics label cardinality.
    _MAX_IDLE_LANES = 64

    # -- internals (call under self._cond) -------------------------------

    def _weight(self, lane: Tuple[str, str]) -> float:
        tenant, priority = lane
        return (
            self.priority_weights.get(priority, 1.0)
            * self.tenant_weights.get(tenant, 1.0)
        )

    def _lane(self, lane: Tuple[str, str]) -> deque:
        dq = self._lanes.get(lane)
        if dq is None:
            if len(self._lanes) >= self._MAX_IDLE_LANES:
                self._gc_idle_lanes()
            dq = deque()
            self._lanes[lane] = dq
            self._deficit[lane] = 0.0
            self._rotation.append(lane)
            self._last_served[lane] = self._clock()
        return dq

    def _gc_idle_lanes(self) -> None:
        """Drop EMPTY lanes so client-controlled tenant values cannot
        grow the rotation/metrics without bound.  An empty lane's DRR
        state is worthless anyway (the rotation zeroes an empty lane's
        deficit on every visit), so re-creation on next use is
        lossless."""
        keep = [
            lane for lane in self._rotation if self._lanes.get(lane)
        ]
        if len(keep) == len(self._rotation):
            return
        for lane in self._rotation:
            if lane not in self._lanes or not self._lanes[lane]:
                self._lanes.pop(lane, None)
                self._deficit.pop(lane, None)
                self._last_served.pop(lane, None)
        self._rotation = keep
        self._pos = 0

    def _serve(self, lane: Tuple[str, str]) -> Any:
        item, _ts = self._lanes[lane].popleft()
        self._size -= 1
        self._last_served[lane] = self._clock()
        key = lane_name(*lane)
        # The served counter keys on historical lanes; beyond a sane
        # cardinality new keys roll into one overflow bucket (tenant
        # is client-controlled — see _gc_idle_lanes).
        if key not in self.served_total and len(self.served_total) >= 512:
            key = "~overflow"
        self.served_total[key] = self.served_total.get(key, 0) + 1
        return item

    def _pick_starving(self) -> Optional[Tuple[str, str]]:
        """A lane is STARVING when it has gone unserved past the clock
        while holding an equally aged head — not merely backlogged: a
        lane the rotation serves regularly never qualifies however
        deep its queue, so weights keep ruling under sustained
        overload and the clock only catches lanes the weights are
        actually passing over."""
        now = self._clock()
        starving = None
        oldest = None
        for lane, dq in self._lanes.items():
            if not dq:
                continue
            head_ts = dq[0][1]
            if (
                now - head_ts > self.starvation_seconds
                and now - self._last_served.get(lane, head_ts)
                > self.starvation_seconds
                and (oldest is None or head_ts < oldest)
            ):
                starving, oldest = lane, head_ts
        return starving

    def _pick_drr(self) -> Tuple[str, str]:
        # Classic DRR, one item per call: visit lanes in rotation; an
        # empty lane forfeits its deficit (it cannot bank idle credit),
        # a visited lane earns its weight once per visit and spends 1
        # per served job.  With every weight > 0 and _size > 0 this
        # terminates: each full rotation adds weight to some nonempty
        # lane, so its deficit reaches 1 within ceil(1/weight) visits.
        while True:
            lane = self._rotation[self._pos % len(self._rotation)]
            dq = self._lanes[lane]
            if not dq:
                self._deficit[lane] = 0.0
                self._pos += 1
                continue
            if self._deficit[lane] < 1.0:
                self._deficit[lane] += self._weight(lane)
            if self._deficit[lane] >= 1.0:
                self._deficit[lane] -= 1.0
                # Exhausted its credit (or its queue): move on, so the
                # next get() visits the next lane.
                if self._deficit[lane] < 1.0 or len(dq) == 1:
                    self._pos += 1
                return lane
            self._pos += 1

    # -- queue surface ----------------------------------------------------

    def put_nowait(
        self,
        item: Any,
        tenant: str = "default",
        priority: str = "normal",
    ) -> None:
        """Enqueue onto the (tenant, priority) lane; raises
        :class:`queue.Full` at global capacity.  ``item=None`` is the
        wake sentinel (never counted, never refused)."""
        with self._cond:
            if item is None:
                self._wake += 1
                self._cond.notify()
                return
            if self.maxsize > 0 and self._size >= self.maxsize:
                raise queue.Full()
            self._lane((str(tenant), str(priority))).append(
                (item, self._clock())
            )
            self._size += 1
            self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Any:
        """Next item in fair order (starvation grants first, then DRR);
        blocks until an item or a wake sentinel (returned as ``None``)
        arrives.  Raises :class:`queue.Empty` on timeout."""
        with self._cond:
            if not self._cond.wait_for(
                lambda: self._size > 0 or self._wake > 0,
                timeout=timeout,
            ):
                raise queue.Empty()
            if self._wake > 0 and self._size == 0:
                self._wake -= 1
                return None
            starving = self._pick_starving()
            if starving is not None:
                # Charged against the lane's deficit: the clock bounds
                # the wait, it does not mint extra throughput.
                self._deficit[starving] -= 1.0
                self.starvation_grants_total += 1
                return self._serve(starving)
            return self._serve(self._pick_drr())

    def qsize(self) -> int:
        with self._cond:
            return self._size

    def take_matching(
        self, match: Callable[[Any], bool], limit: int
    ) -> List[Any]:
        """Remove and return up to ``limit`` queued items for which
        ``match(item)`` is true, scanning lanes in rotation order and
        each lane FIFO — the fusion planner's raid.  Taken items are
        NOT charged to any lane's deficit (they are bonus throughput:
        they ride a device program another job already paid for).
        ``match`` must be pure over pre-captured state — it is called
        under the queue lock."""
        taken: List[Any] = []
        if limit <= 0:
            return taken
        with self._cond:
            for lane in list(self._rotation):
                if len(taken) >= limit:
                    break
                dq = self._lanes[lane]
                kept = deque()
                while dq:
                    item, ts = dq.popleft()
                    if len(taken) < limit and match(item):
                        taken.append(item)
                        self._size -= 1
                    else:
                        kept.append((item, ts))
                self._lanes[lane] = kept
        return taken

    def queued_ids(self, limit: Optional[int] = None) -> List[Any]:
        """Queued items in APPROXIMATE pickup order — lanes in rotation
        order, each lane FIFO — for the fleet heartbeat's backlog
        advertisement (serve/fleet/heartbeat.py).  Approximate by
        design: DRR deficits and starvation grants can reorder lanes
        between this snapshot and the actual pickups, which is exactly
        why the steal planner skips the head and every claim re-reads
        the record.  Wake sentinels (``None`` items) are excluded."""
        out: List[Any] = []
        with self._cond:
            for lane in list(self._rotation):
                for item, _ts in self._lanes[lane]:
                    if item is None:
                        continue
                    out.append(item)
                    if limit is not None and len(out) >= limit:
                        return out
        return out

    def snapshot(self) -> Dict[str, Any]:
        """Per-lane depths + fairness counters for /metrics.  Lane keys
        are traffic-dynamic (like ``retry_total``); the caller's
        top-level key set stays fixed."""
        with self._cond:
            return {
                lane_name(*lane): len(dq)
                for lane, dq in self._lanes.items()
            }

    def served_snapshot(self) -> Dict[str, int]:
        with self._cond:
            return dict(self.served_total)


def parse_tenant_weights(specs: List[str]) -> Dict[str, float]:
    """CLI ``--tenant-weight tenant=W`` parser (repeatable)."""
    out: Dict[str, float] = {}
    for spec in specs or ():
        tenant, sep, w_s = spec.partition("=")
        if not sep or not tenant:
            raise ValueError(
                f"--tenant-weight {spec!r}: expected TENANT=WEIGHT"
            )
        try:
            w = float(w_s)
        except ValueError:
            raise ValueError(
                f"--tenant-weight {spec!r}: weight {w_s!r} is not a number"
            )
        if w <= 0:
            raise ValueError(
                f"--tenant-weight {spec!r}: weight must be > 0"
            )
        out[tenant] = w
    return out


def parse_priority_weights(spec: Optional[str]) -> Dict[str, float]:
    """CLI ``--priority-weights high:normal:low`` parser (three
    positive numbers, colon-separated)."""
    if not spec:
        return dict(DEFAULT_PRIORITY_WEIGHTS)
    parts = spec.split(":")
    if len(parts) != 3:
        raise ValueError(
            f"--priority-weights {spec!r}: expected HIGH:NORMAL:LOW"
        )
    try:
        values = [float(p) for p in parts]
    except ValueError:
        raise ValueError(
            f"--priority-weights {spec!r}: entries must be numbers"
        )
    if any(v <= 0 for v in values):
        raise ValueError(
            f"--priority-weights {spec!r}: weights must be > 0"
        )
    return {"high": values[0], "normal": values[1], "low": values[2]}


__all__ = [
    "DEFAULT_PRIORITY_WEIGHTS",
    "FairShareQueue",
    "lane_name",
    "parse_priority_weights",
    "parse_tenant_weights",
]
