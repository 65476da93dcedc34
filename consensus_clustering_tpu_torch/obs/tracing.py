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


# -- Port only: named host ranges on the sweep path ----------------------
#
# Not in the JAX package, whose sweep is one compiled program.  The port
# runs eagerly, so its layers (api, engine, clusterer) are host ranges
# that a ``torch`` profiler records beside the device operations each
# one launched.

import contextlib  # noqa: E402
import functools  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

#: Every range's name starts with this.
RANGE_PREFIX = "cc."
#: How many :func:`recording_ranges` blocks are open (on any thread).
_recording = 0
_recording_lock = threading.Lock()


@contextlib.contextmanager
def recording_ranges():
    """Let :func:`region` record its ranges inside this block, wherever a
    ``torch`` profiler records.

    Off by default: on a CUDA device a recorded range also leaves a
    GPU-side annotation in the trace, spanning the operations it
    launched, and a reader that takes every device event for an
    operation (the benchmark's ``portbench/trace.py``, until it tells
    annotations apart) would count it as device work.  The program turns
    it on around its own profiles (``profile_dir`` of the estimator and
    of a serve job, and ``profile_sweep``).
    """
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


class _Range:
    """One named range: a ``record_function`` while ranges are recorded
    (``on``), nothing otherwise.  As a decorator it opens a range of its
    name on every call."""

    __slots__ = ("name", "on", "_open")

    def __init__(self, name: str, on: bool):
        self.name = name
        self.on = on
        self._open = None

    def __enter__(self) -> "_Range":
        if self.on:
            import torch

            self._open = torch.profiler.record_function(
                RANGE_PREFIX + self.name)
            self._open.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._open is not None:
            opened, self._open = self._open, None
            opened.__exit__(exc_type, exc, tb)
        return False

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def ranged(*args: Any, **kwargs: Any) -> Any:
            with region(name):
                return fn(*args, **kwargs)

        return ranged


class _TimedRange(_Range):
    """A range that also times itself: ``seconds`` once it has closed,
    and the ``tracer``'s span ``span`` with ``fields`` (:meth:`add` more
    inside) when it closes without an exception."""

    __slots__ = ("span", "tracer", "fields", "seconds", "_t0")

    def __init__(self, name: str, on: bool, span: str, tracer,
                 fields: Dict[str, Any]):
        super().__init__(name, on)
        self.span, self.tracer, self.fields = span, tracer, fields
        self.seconds = 0.0
        self._t0 = 0.0

    def add(self, **fields: Any) -> None:
        self.fields.update(fields)

    def __enter__(self) -> "_TimedRange":
        super().__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.seconds = time.perf_counter() - self._t0
        super().__exit__(exc_type, exc, tb)
        if exc_type is None and self.tracer is not None:
            self.tracer.record(self.span, self.seconds, **self.fields)
        return False


#: The shared do-nothing range of each name (nothing recording).
_IDLE: Dict[str, _Range] = {}


def region(name: str, span: Optional[str] = None, tracer=None,
           **fields: Any) -> _Range:
    """The range ``cc.<name>`` of the sweep path, as a context manager or
    a decorator.

    Inside :func:`recording_ranges` and while a ``torch`` profiler
    records, it is a ``torch.profiler.record_function``: a host range on
    the clock of the device operations, so a trace ties each operation to
    the innermost range that launched it, and each idle gap to the range
    the host was in.  Otherwise it is this name's one shared do-nothing
    context: no clock read, no allocation, no dispatcher op.  torch is
    never imported here: without it loaded no profiler can be recording.
    Ranges of one thread nest; open them only on the thread that runs the
    sweep.

    With ``span`` the range is also timed (its ``seconds`` once closed)
    and, given a ``tracer`` (a :class:`Tracer`, or anything with its
    ``record``), emitted there as the span ``span`` with ``fields``: one
    ``with`` for a boundary that is both a range and a span.
    """
    on = _recording > 0 and _profiling()
    if span is not None:
        return _TimedRange(name, on, span, tracer, dict(fields))
    if on:
        return _Range(name, True)
    idle = _IDLE.get(name)
    if idle is None:
        idle = _IDLE[name] = _Range(name, False)
    return idle


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()
