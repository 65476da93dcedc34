# Copied from consensus_clustering_tpu/serve/sched/stream.py.
"""Streamed partial results: the SSE event bus and cancel semantics.

The streaming engine already produces everything a watching client
wants — per-block ``h_block_complete`` events and the adaptive PAC
trajectory — but until now they only landed in the JSONL log.  This
module gives them a live wire: ``GET /jobs/<id>/events`` streams them
as Server-Sent Events (SSE, ``text/event-stream``), so a client can
watch its consensus CDF converge block by block and CANCEL the moment
it has seen enough — admission capacity nobody else was using.

- :class:`JobEventBus` — in-process fan-out from the scheduler's
  callbacks to any number of SSE subscribers per job.  Publishing
  never blocks and never fails a job (a slow client's queue drops the
  oldest event; the JSONL log remains the durable record).
- :class:`JobCancelled` — raised inside a running attempt (from the
  per-block callback) when the client cancelled; the scheduler
  terminalises the job as ``cancelled``: lease released, checkpoint
  ring cleared, payload dropped — a terminal state like ``done``, so
  the worker slot frees at the next block boundary (a compiled block
  cannot be interrupted mid-flight; one block is the cancel latency).
- :func:`sse_event` — the one spelling of the wire format.

Cancel paths: ``POST /jobs/<id>/cancel`` (explicit), or opening the
SSE stream with ``?cancel_on_disconnect=1`` — then simply closing the
connection cancels the job (the probe's early-cancel client).

Stdlib-only by design, like the rest of serve/sched.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Any, Dict, List

#: Per-subscriber buffered events before the oldest is dropped.  SSE is
#: a convenience view over the durable JSONL stream, so dropping under
#: backpressure is correct — blocking the block loop would not be.
SUBSCRIBER_QUEUE_MAX = 256


class JobCancelled(Exception):
    """The client cancelled this job mid-run (SSE disconnect or an
    explicit ``POST /jobs/<id>/cancel``).  Terminal, not a failure:
    no retry, no SLO error-budget burn — the service did nothing
    wrong, the client changed its mind."""

    def __init__(self, job_id: str, reason: str = "client_cancel"):
        self.job_id = job_id
        self.reason = reason
        super().__init__(f"job {job_id} cancelled ({reason})")


class JobEventBus:
    """Fan-out of per-job progress events to SSE subscribers.

    The scheduler publishes from its callback paths (block completions,
    per-K results, terminal transitions); handler threads subscribe one
    bounded queue each.  Everything is best-effort by contract —
    telemetry must never fail a job."""

    def __init__(self, max_queue: int = SUBSCRIBER_QUEUE_MAX):
        self._lock = threading.Lock()
        self._subs: Dict[str, List[queue.Queue]] = {}
        self.max_queue = int(max_queue)

    def subscribe(self, job_id: str) -> queue.Queue:
        q: queue.Queue = queue.Queue(maxsize=self.max_queue)
        with self._lock:
            self._subs.setdefault(job_id, []).append(q)
        return q

    def unsubscribe(self, job_id: str, q: queue.Queue) -> None:
        with self._lock:
            subs = self._subs.get(job_id)
            if subs is None:
                return
            try:
                subs.remove(q)
            except ValueError:
                pass
            if not subs:
                del self._subs[job_id]

    def subscriber_count(self, job_id: str) -> int:
        with self._lock:
            return len(self._subs.get(job_id, ()))

    def publish(self, job_id: str, event: Dict[str, Any]) -> None:
        """Deliver to every subscriber; a full queue drops its OLDEST
        buffered event (the newest state is the one a watcher wants)."""
        with self._lock:
            subs = list(self._subs.get(job_id, ()))
        for q in subs:
            try:
                q.put_nowait(event)
            except queue.Full:
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                try:
                    q.put_nowait(event)
                except queue.Full:
                    pass


def sse_event(name: str, payload: Dict[str, Any]) -> bytes:
    """One Server-Sent Event frame: ``event:`` line + JSON ``data:``.
    The payload is compact JSON (no newlines), so one ``data:`` line
    always suffices."""
    data = json.dumps(payload, sort_keys=True, default=float)
    return f"event: {name}\ndata: {data}\n\n".encode()


def sse_keepalive() -> bytes:
    """An SSE comment frame: keeps the connection warm AND makes a
    vanished client visible (the write raises) even while no events
    flow — the disconnect-cancel path depends on it."""
    return b": keepalive\n\n"


__all__ = [
    "SUBSCRIBER_QUEUE_MAX",
    "JobCancelled",
    "JobEventBus",
    "sse_event",
    "sse_keepalive",
]
