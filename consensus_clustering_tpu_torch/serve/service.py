# Copied from consensus_clustering_tpu/serve/service.py.
"""Consensus-as-a-service: the stdlib-only HTTP JSON API.

``http.server.ThreadingHTTPServer`` in front of the scheduler — no web
framework, nothing the container doesn't already have.  Endpoints:

- ``POST /jobs``       — submit a sweep; body ``{"data": [[...]],
  "config": {...}}`` (see :func:`~consensus_clustering_tpu_torch.serve.
  executor.parse_job_spec` for the config schema).  202 + job record on
  admission, 200 + completed record when the (config, data) fingerprint
  dedups against the jobstore, 400 on a malformed body (structured,
  ``code: invalid_data`` with the offending row/col indices, when the
  data matrix itself is inadmissible — NaN/Inf or zero variance),
  429 when the
  queue is full — or, with ``Retry-After``, when the overload shed
  policy refuses this ``config.priority`` under pressure — and 413 when
  the body exceeds ``max_body_bytes`` or the memory preflight estimates
  the job over the backend budget (structured body with the estimate
  breakdown).
- ``GET /jobs/<id>``   — poll a job; embeds ``result`` once done.
- ``GET /jobs/<id>/events`` — Server-Sent Events: the current record,
  then live per-block progress (``h_block_complete`` + the PAC
  trajectory) and the terminal record; ``?cancel_on_disconnect=1``
  makes hanging up cancel the job (docs/SERVING.md "Fair-share &
  fusion runbook").
- ``POST /jobs/<id>/cancel`` — client cancel; terminal like ``done``
  (lease released, ring cleared, slot freed at the next block
  boundary).
- ``GET /healthz``     — liveness: status, backend label, uptime.
- ``GET /metrics``     — queue depth/capacity, jobs completed/failed/
  retried/timed-out/requeued, jobstore ``cache_hits``, in-process
  ``executable_cache_hits``, ``sweeps_executed``, the resilience
  counters (``checkpoint_writes_total``, ``checkpoint_resume_total``,
  ``retry_total`` by triage reason), the block-size resolution tiers
  (``autotune_provenance_total`` — docs/AUTOTUNE.md), the latency
  histograms + perf-drift snapshot (docs/OBSERVABILITY.md), and
  ``backend`` (``tpu`` | ``cpu-fallback``, bench.py's
  ``measurement_backend`` convention).
- ``GET /metrics.prom`` (alias ``GET /metrics?format=prom``) — the SAME
  scheduler snapshot in Prometheus text format 0.0.4
  (:mod:`consensus_clustering_tpu_torch.obs.prom`), so standard scrapers work
  with zero glue.

Durability (docs/SERVING.md "Crash recovery"): submitted jobs persist
their (config, data) payload, streamed executions checkpoint block
state into the jobstore's per-fingerprint ring, and a restarted process
re-queues orphaned jobs which then resume from their last completed
block — SIGKILL mid-job costs at most one block of work.

Run it with ``python -m consensus_clustering_tpu_torch serve`` or embed
:class:`ConsensusService` (``start()``/``stop()``) — the test suite does
the latter against an ephemeral port.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue as _queue_mod
import select
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs

from consensus_clustering_tpu_torch.serve.events import EventLog
from consensus_clustering_tpu_torch.serve.executor import (
    _TENANT_RE,
    InvalidDataError,
    JobSpecError,
    SweepExecutor,
    parse_job_spec,
)
from consensus_clustering_tpu_torch.serve.jobstore import JobStore
from consensus_clustering_tpu_torch.serve.preflight import PreflightReject
from consensus_clustering_tpu_torch.serve.scheduler import (
    _TERMINAL,
    QueueFull,
    QueueShed,
    Scheduler,
    ShedPolicy,
)
from consensus_clustering_tpu_torch.serve.sched.stream import (
    sse_event,
    sse_keepalive,
)

logger = logging.getLogger(__name__)

_DEFAULT_MAX_BODY = 64 * 2**20  # 64 MiB of JSON ~ a 2M-cell float matrix


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # The service object is attached to the server instance.
    @property
    def service(self) -> "ConsensusService":
        return self.server.service  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # route access logs to logging
        logger.debug("http: " + fmt, *args)

    def _send_json(
        self,
        code: int,
        payload: Dict[str, Any],
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        blob = json.dumps(payload, sort_keys=True, default=float).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(blob)

    def do_POST(self) -> None:  # noqa: N802 — http.server spelling
        path = self.path.rstrip("/")
        if path.startswith("/jobs/") and path.endswith("/cancel"):
            job_id = path[len("/jobs/"):-len("/cancel")]
            if not job_id or "/" in job_id:
                self._send_json(404, {"error": "bad job path"})
                return
            # Drain any body before responding: a client POSTing
            # `{}` on a keep-alive connection would otherwise desync
            # the next request's parse at the unread bytes.
            length = int(self.headers.get("Content-Length") or 0)
            if length > 0:
                if length > self.service.max_body_bytes:
                    self.close_connection = True
                else:
                    self.rfile.read(length)
            record = self.service.scheduler.cancel(job_id)
            if record is None:
                self._send_json(404, {"error": f"unknown job {job_id}"})
                return
            self._send_json(202, record)
            return
        if path != "/jobs":
            self._send_json(404, {"error": f"no such route {self.path}"})
            return
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            # No declared length (absent, zero, or chunked): anything the
            # client did send would desync keep-alive, so close.
            self.close_connection = True
            self._send_json(400, {"error": "missing request body"})
            return
        if length > self.service.max_body_bytes:
            # The body is rejected unread: close the connection rather than
            # let keep-alive misparse the unread bytes as the next request.
            self.close_connection = True
            self._send_json(
                413,
                {"error": f"body exceeds {self.service.max_body_bytes} bytes"},
            )
            return
        try:
            body = json.loads(self.rfile.read(length))
        except ValueError:
            self._send_json(400, {"error": "body is not valid JSON"})
            return
        try:
            spec, x = parse_job_spec(body)
        except InvalidDataError as e:
            # Structured 400 (the preflight-413 body shape): code
            # invalid_data, the offending row/col indices, and a hint —
            # an actionable refusal for a poisoned matrix, rejected
            # before anything persists or queues.
            self._send_json(400, dict(e.payload))
            return
        except JobSpecError as e:
            self._send_json(400, {"error": str(e)})
            return
        tenant_header = self.service.tenant_header
        if tenant_header:
            header_tenant = self.headers.get(tenant_header)
            if header_tenant is not None:
                # The header is the DEPLOYMENT's tenant identity (an
                # auth proxy stamps it); when present it overrides the
                # body's self-declared config.tenant.  Same alphabet
                # rule as the config field — lane keys become /metrics
                # labels and JSONL fields.
                if not _TENANT_RE.match(header_tenant):
                    self._send_json(400, {
                        "error": (
                            f"{tenant_header} header must be 1-64 "
                            "chars of [A-Za-z0-9._-], got "
                            f"{header_tenant!r}"
                        ),
                    })
                    return
                spec = dataclasses.replace(spec, tenant=header_tenant)
        try:
            record = self.service.scheduler.submit(spec, x)
        except PreflightReject as e:
            # Structured 413: the estimate breakdown and the budget —
            # an actionable refusal (shrink N / K / block, or raise the
            # budget), not a bare status code.
            self._send_json(413, dict(e.payload))
            return
        except QueueShed as e:
            # Shed ≠ full: the service is protecting higher-priority
            # traffic.  Retry-After is the client's backoff contract —
            # derived from the LIVE queue drain rate (floored at the
            # static --shed-retry-after), with the arithmetic disclosed
            # in the body so the hint reads as evidence.
            self._send_json(
                429,
                {
                    "error": str(e),
                    "shed": True,
                    "priority": e.priority,
                    "retry_after_seconds": e.retry_after,
                    "retry_after_basis": e.basis,
                },
                headers={"Retry-After": str(int(e.retry_after))},
            )
            return
        except QueueFull as e:
            self._send_json(429, {"error": str(e)})
            return
        self._send_json(200 if record["status"] == "done" else 202, record)

    def _send_text(self, code: int, text: str) -> None:
        blob = text.encode()
        self.send_response(code)
        # The Prometheus text-format content type (0.0.4 is the text
        # exposition version scrapers negotiate, not this package's).
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def do_GET(self) -> None:  # noqa: N802
        path, _, query = self.path.partition("?")
        path = path.rstrip("/") or "/"
        if path == "/healthz":
            self._send_json(200, self.service.health())
            return
        if path == "/metrics.prom" or (
            path == "/metrics"
            and "format=prom" in query.split("&")
        ):
            from consensus_clustering_tpu_torch.obs.prom import (
                render_prometheus,
            )

            self._send_text(
                200,
                render_prometheus(self.service.scheduler.metrics()),
            )
            return
        if path == "/metrics":
            self._send_json(200, self.service.scheduler.metrics())
            return
        if path.startswith("/jobs/") and path.endswith("/events"):
            job_id = path[len("/jobs/"):-len("/events")]
            if not job_id or "/" in job_id:
                self._send_json(404, {"error": "bad job path"})
                return
            self._serve_sse(job_id, parse_qs(query))
            return
        if path.startswith("/jobs/"):
            job_id = path[len("/jobs/"):]
            if "/" in job_id or not job_id:
                self._send_json(404, {"error": "bad job path"})
                return
            record = self.service.scheduler.get(job_id)
            if record is None:
                self._send_json(404, {"error": f"unknown job {job_id}"})
                return
            self._send_json(200, record)
            return
        self._send_json(404, {"error": f"no such route {self.path}"})

    def _serve_sse(self, job_id: str, params: Dict[str, list]) -> None:
        """``GET /jobs/<id>/events`` — Server-Sent Events: an initial
        ``state`` frame (the current record), then live
        ``h_block_complete``/``k_batch_complete`` frames as the job
        streams, ending with the terminal record (docs/SERVING.md
        "Fair-share & fusion runbook").  With
        ``?cancel_on_disconnect=1``, closing the connection CANCELS
        the job — a client that has watched the PAC trajectory
        converge far enough can simply hang up, and the worker slot
        frees at the next block boundary."""
        scheduler = self.service.scheduler
        cancel_on_disconnect = params.get(
            "cancel_on_disconnect", ["0"]
        )[0] in ("1", "true", "yes")
        # Subscribe BEFORE the record read: a terminal transition
        # between the two then lands in the subscription instead of
        # vanishing.
        sub = scheduler.bus.subscribe(job_id)
        try:
            record = scheduler.get(job_id)
            if record is None:
                self._send_json(404, {"error": f"unknown job {job_id}"})
                return
            scheduler.note_sse_stream()
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            # No Content-Length: the stream ends when the job does (or
            # the client hangs up), so this connection cannot be
            # keep-alive reused.
            self.close_connection = True
            self.end_headers()
            self.wfile.write(sse_event("state", record))
            self.wfile.flush()
            if record.get("status") in _TERMINAL:
                # A DONE progressive parent may still owe an upgrade
                # frame (docs/SERVING.md "Progressive serving
                # runbook").  Continuation still live → keep the
                # stream open (result_upgraded / continuation_settled
                # publish on the PARENT channel).  Continuation
                # already terminal → synthesize the settlement frame a
                # live subscriber would have received, then close.
                cont_id = (
                    record.get("continuation_job_id")
                    if record.get("status") == "done" else None
                )
                cont = scheduler.get(cont_id) if cont_id else None
                if cont is not None and cont.get("status") not in (
                    _TERMINAL
                ):
                    pass  # fall through to the live-frame loop below
                else:
                    if cont is not None:
                        if cont.get("status") == "done":
                            frame = {
                                "event": "result_upgraded",
                                "terminal": True,
                                "job_id": job_id,
                                "continuation_job_id": cont_id,
                                "pac_error_bound": 0.0,
                                "record": cont,
                            }
                        else:
                            frame = {
                                "event": "continuation_settled",
                                "terminal": True,
                                "job_id": job_id,
                                "continuation_job_id": cont_id,
                                "status": cont.get("status"),
                            }
                        self.wfile.write(sse_event(
                            frame["event"], frame
                        ))
                        self.wfile.flush()
                    return
            keepalive = self.service.sse_keepalive_seconds
            while True:
                # Disconnect detection by READING, not just writing: an
                # SSE client never sends after its request, so a
                # readable socket means EOF (the client hung up) — and
                # on some network stacks a write to a closed peer keeps
                # succeeding silently, so the write-failure path alone
                # is not a reliable signal.
                readable, _, _ = select.select(
                    [self.connection], [], [], 0
                )
                if readable and not self.connection.recv(1024):
                    raise ConnectionResetError("sse client closed")
                try:
                    event = sub.get(timeout=keepalive)
                except _queue_mod.Empty:
                    # Comment frame: keeps proxies from idling the
                    # stream out AND surfaces a vanished client (the
                    # write raises) while no events flow.
                    self.wfile.write(sse_keepalive())
                    self.wfile.flush()
                    continue
                self.wfile.write(sse_event(
                    event.get("event", "message"), event
                ))
                self.wfile.flush()
                if event.get("terminal"):
                    return
        except (BrokenPipeError, ConnectionError, OSError):
            # The client hung up mid-stream.
            if cancel_on_disconnect:
                try:
                    scheduler.cancel(job_id, reason="sse_disconnect")
                except Exception:  # noqa: BLE001 — a cancel failure
                    logger.exception(  # must not kill the handler
                        "sse disconnect-cancel failed for %s", job_id
                    )
        finally:
            scheduler.bus.unsubscribe(job_id, sub)


class _QuietHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose per-connection error hook LOGS instead
    of printing a traceback to stderr: an SSE client hanging up
    mid-write is normal operation (the disconnect-cancel path exists
    for it), and socketserver's default print would interleave noise
    into every consumer of the process's stderr — including the tier-1
    runner's dot stream."""

    def handle_error(self, request, client_address):
        logger.debug(
            "http connection error from %s", client_address,
            exc_info=True,
        )


class ConsensusService:
    """The assembled serving stack: jobstore + executor + scheduler + HTTP.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` —
    how the tests run hermetically).  ``start()`` serves on a daemon
    thread; ``serve_forever()`` blocks (the CLI path).
    """

    def __init__(
        self,
        store_dir: str,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_queue: int = 16,
        job_timeout: Optional[float] = None,
        max_retries: int = 2,
        backoff_base: float = 0.5,
        events_path: Optional[str] = None,
        executor: Optional[SweepExecutor] = None,
        max_body_bytes: int = _DEFAULT_MAX_BODY,
        job_checkpoints: bool = True,
        quarantine_after: int = 3,
        watchdog: bool = False,
        wedge_floor: float = 30.0,
        wedge_scale: float = 8.0,
        wedge_compile_grace: float = 600.0,
        shed_policy: Optional[ShedPolicy] = None,
        memory_budget_bytes: Optional[int] = None,
        slo_monitor=None,
        worker_id: Optional[str] = None,
        leases: bool = True,
        lease_ttl: float = 60.0,
        lease_sweep: Optional[float] = None,
        schedule: str = "fair",
        fusion_max: int = 1,
        priority_weights: Optional[Dict[str, float]] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
        starvation_seconds: float = 30.0,
        tenant_header: Optional[str] = "X-Tenant",
        sse_keepalive_seconds: float = 5.0,
        fleet: bool = True,
        fleet_target_drain_seconds: float = 60.0,
        emulate_device_seconds: float = 0.0,
    ):
        self.store = JobStore(store_dir)
        self.events = EventLog(events_path)
        self.executor = executor or SweepExecutor()
        self.scheduler = Scheduler(
            self.executor,
            self.store,
            max_queue=max_queue,
            job_timeout=job_timeout,
            max_retries=max_retries,
            backoff_base=backoff_base,
            events=self.events,
            checkpoints=job_checkpoints,
            quarantine_after=quarantine_after,
            watchdog=watchdog,
            wedge_floor=wedge_floor,
            wedge_scale=wedge_scale,
            wedge_compile_grace=wedge_compile_grace,
            shed_policy=shed_policy,
            memory_budget_bytes=memory_budget_bytes,
            slo=slo_monitor,
            worker_id=worker_id,
            leases=leases,
            lease_ttl=lease_ttl,
            lease_sweep=lease_sweep,
            schedule=schedule,
            fusion_max=fusion_max,
            priority_weights=priority_weights,
            tenant_weights=tenant_weights,
            starvation_seconds=starvation_seconds,
            fleet=fleet,
            fleet_target_drain_seconds=fleet_target_drain_seconds,
            emulate_device_seconds=emulate_device_seconds,
        )
        self.tenant_header = tenant_header
        if sse_keepalive_seconds <= 0:
            raise ValueError(
                f"sse_keepalive_seconds must be > 0, got "
                f"{sse_keepalive_seconds}"
            )
        self.sse_keepalive_seconds = float(sse_keepalive_seconds)
        self.max_body_bytes = max_body_bytes
        self.started_at = time.time()
        self._httpd = _QuietHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.service = self  # type: ignore[attr-defined]
        self._http_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def health(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "backend": self.executor.backend(),
            "uptime_seconds": round(time.time() - self.started_at, 3),
            "queue_depth": self.scheduler.queue_depth(),
        }

    def start(self) -> "ConsensusService":
        self.scheduler.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True
        )
        self._http_thread.start()
        return self

    def serve_forever(self) -> None:
        self.scheduler.start()
        logger.info(
            "consensus service listening on %s:%d (backend=%s)",
            self._httpd.server_address[0], self.port,
            self.executor.backend(),
        )
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(5.0)
            self._http_thread = None
        self.scheduler.stop()
