# Copied from consensus_clustering_tpu/obs/tracing.py.
"""Trace spans over the JSONL event stream: correlation without a new sink.

The serving subsystem already has exactly one durable telemetry stream —
the :class:`~consensus_clustering_tpu_torch.serve.events.EventLog` JSONL file
— so spans ride it as ordinary events (``event: "span"``) instead of
inventing a second pipeline.  The model is the OpenTelemetry minimum:

- ``trace_id``   — one per job (the scheduler uses the ``job_id``, so a
  grep for a job id yields its whole execution tree next to its
  lifecycle events);
- ``span_id`` / ``parent_span_id`` — random 12-hex ids forming the tree
  (``queue_wait`` and per-``attempt`` spans at the scheduler,
  ``compile``/``execute``/``checkpoint_write`` at the executor,
  ``resume_restore``/``h_block``/``host_evaluate``/``integrity_check``
  in the streaming driver);
- one event per span, emitted at END with ``seconds`` — begin/end pairs
  would double the log volume and leave dangling begins on abandoned
  threads, and every consumer of a span wants its duration anyway.

Spans are TELEMETRY: a broken sink (disk full under the events file)
must degrade observability, never a job — sink failures are swallowed
with a log line.  Everything here is stdlib-only and thread-safe by
construction (each span is touched by one thread; the sink's own lock
serialises emission).
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)


def new_trace_id() -> str:
    """A fresh 16-hex trace id (batch callers; serving uses job_id)."""
    return uuid.uuid4().hex[:16]


def _new_span_id() -> str:
    return uuid.uuid4().hex[:12]


class Span:
    """One timed operation; emits a single ``span`` payload at end."""

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        fields: Dict[str, Any],
    ):
        self.tracer = tracer
        self.name = name
        self.span_id = _new_span_id()
        self.fields = dict(fields)
        self._t0 = time.perf_counter()
        self._done = False

    def add(self, **fields: Any) -> None:
        """Attach fields discovered mid-span (e.g. ``cached=True``)."""
        self.fields.update(fields)

    def end(self, status: str = "ok", **fields: Any) -> None:
        """Emit the span once; later calls are no-ops (the context
        manager and an explicit error path may both reach here)."""
        if self._done:
            return
        self._done = True
        self.fields.update(fields)
        self.tracer._emit(
            self.name,
            self.span_id,
            time.perf_counter() - self._t0,
            status,
            self.fields,
        )

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, _tb) -> bool:
        self.end(
            status="ok" if exc_type is None else "error",
            **(
                {} if exc_type is None
                else {"error_type": exc_type.__name__}
            ),
        )
        return False  # never swallow the caller's exception


class Tracer:
    """Span factory bound to a sink, a trace id, and a parent span.

    ``sink`` is any callable taking the span payload dict — the serving
    path binds ``lambda p: events.emit("span", **p)``.  ``child(...)``
    derives a tracer whose spans parent under a given span id (how the
    executor nests streaming-driver spans under its ``execute`` span);
    the sink and trace id are shared down the tree.
    """

    def __init__(
        self,
        sink: Callable[[Dict[str, Any]], Any],
        trace_id: Optional[str] = None,
        parent_span_id: Optional[str] = None,
    ):
        self.sink = sink
        self.trace_id = trace_id or new_trace_id()
        self.parent_span_id = parent_span_id

    def child(self, parent_span_id: str) -> "Tracer":
        return Tracer(self.sink, self.trace_id, parent_span_id)

    def span(self, name: str, **fields: Any) -> Span:
        """A started span; use as a context manager or call ``end()``."""
        return Span(self, name, fields)

    def record(self, name: str, seconds: float, **fields: Any) -> str:
        """Emit a retroactively-timed span (e.g. ``queue_wait``, whose
        start predates the tracer); returns its span id."""
        span_id = _new_span_id()
        self._emit(name, span_id, seconds, "ok", fields)
        return span_id

    def _emit(
        self,
        name: str,
        span_id: str,
        seconds: float,
        status: str,
        fields: Dict[str, Any],
    ) -> None:
        payload: Dict[str, Any] = {
            "name": name,
            "trace_id": self.trace_id,
            "span_id": span_id,
            "parent_span_id": self.parent_span_id,
            "seconds": round(float(seconds), 6),
            "status": status,
            **fields,
        }
        try:
            self.sink(payload)
        except Exception as e:  # noqa: BLE001 — telemetry must never
            # fail the operation it observes (disk full under the
            # events file is an observability outage, not a job error).
            logger.warning("span sink failed for %s: %s", name, e)
