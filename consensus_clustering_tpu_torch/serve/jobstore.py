# Copied from consensus_clustering_tpu/serve/jobstore.py.
"""Persistent on-disk job/result store keyed by a (config, data) fingerprint.

The dedup layer of the serving subsystem: every job is identified by
:func:`~consensus_clustering_tpu_torch.utils.checkpoint.job_fingerprint` — the
sweep-checkpoint fingerprint scheme extended with a content hash of the
submitted data — so a repeat submission of an identical (config, data)
pair is answered from the stored result instead of re-running the sweep.

Layout (all writes are write-temp + ``os.replace``, the same atomic-rename
discipline as ``SweepCheckpoint.save_k``, so a crash can never leave a torn
result that a later hit would serve)::

    <dir>/results/<fingerprint>.json   canonical result bytes (sort_keys)
    <dir>/jobs/<job_id>.json           job record (status, timings, error)
    <dir>/payloads/<job_id>.json|.npy  submitted config + data matrix —
                                       what lets a RESTARTED process
                                       re-queue an orphaned job instead
                                       of failing it (crash-resume)
    <dir>/checkpoints/<fingerprint>/   per-job streamed block-checkpoint
                                       ring (resilience.StreamCheckpointer)
    <dir>/planes/<fingerprint>/        persistent plane store (append
                                       subsystem, ``append.store``) —
                                       unlike the ring it SURVIVES job
                                       completion: it is the artifact
                                       row-appends build on
    <dir>/leases/<job_id>/token-*.json fenced ownership (serve.leases):
                                       which worker may run — and WRITE —
                                       this job, at which fencing token

Results are stored as CANONICAL JSON bytes (``sort_keys=True``) and served
back verbatim: two submissions that dedup to the same fingerprint receive
byte-identical result payloads by construction, not by re-serialisation
luck.  Job records are small and mutable (status transitions); results are
immutable once written.  Payloads live exactly as long as their job is
non-terminal; checkpoint rings live until the job completes (a failed
job's ring deliberately survives, so resubmitting the identical job
resumes instead of restarting).
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np

from consensus_clustering_tpu_torch.utils.checkpoint import (  # noqa: F401
    data_fingerprint,
    job_fingerprint,
)


def canonical_result_bytes(result: Dict[str, Any]) -> bytes:
    """The one serialisation every result passes through before storage —
    sorted keys, floats via ``default=float`` — so byte-identity of stored
    results is a schema property."""
    return json.dumps(result, sort_keys=True, default=float).encode()


class JobStore:
    """Directory-backed result cache + job-record store."""

    def __init__(self, directory: str):
        self.directory = directory
        self.results_dir = os.path.join(directory, "results")
        self.jobs_dir = os.path.join(directory, "jobs")
        self.payloads_dir = os.path.join(directory, "payloads")
        self.checkpoints_dir = os.path.join(directory, "checkpoints")
        # Per-parent plane stores (append subsystem): the completed
        # packed exact run's bit-plane artifact, keyed by job
        # fingerprint.  A SIBLING of the checkpoint ring, never inside
        # it — the scheduler clears rings the moment a job completes,
        # and the plane store must outlive its job (it IS the reusable
        # artifact appends build on).
        self.planes_dir = os.path.join(directory, "planes")
        # Per-job fenced ownership leases (serve/leases.py) — which
        # worker may run and WRITE each job, at which fencing token.
        self.leases_dir = os.path.join(directory, "leases")
        # Operator control surface (serve-admin writes here with the
        # same atomic-rename discipline; the scheduler polls/claims):
        # today one file, profile_next.json.
        self.control_dir = os.path.join(directory, "control")
        # Fleet capacity advertisements (serve/fleet/heartbeat.py):
        # one digest-verified <worker_id>.json per live worker,
        # rewritten every lease sweep with the same tmp-then-rename
        # discipline as everything else here.
        self.fleet_dir = os.path.join(directory, "fleet")
        os.makedirs(self.results_dir, exist_ok=True)
        os.makedirs(self.jobs_dir, exist_ok=True)
        os.makedirs(self.payloads_dir, exist_ok=True)
        os.makedirs(self.checkpoints_dir, exist_ok=True)
        os.makedirs(self.planes_dir, exist_ok=True)
        os.makedirs(self.leases_dir, exist_ok=True)
        os.makedirs(self.control_dir, exist_ok=True)
        os.makedirs(self.fleet_dir, exist_ok=True)
        self._sweep_stale_tmps()
        self._sweep_stale_checkpoints()
        self._sweep_orphan_payloads()
        self.gc_stale_leases()

    # Temp files younger than this are treated as another process's
    # live writes (two services can share a store dir); older ones are
    # crash garbage — a process died between write and os.replace — and
    # without this sweep the matrix-sized payload temps in particular
    # would accumulate forever (same grace rule as the checkpoint ring).
    _TMP_GRACE_SECONDS = 600.0

    # A failed/timed-out job's checkpoint ring deliberately survives so
    # an identical resubmission resumes its progress — but "deliberate"
    # needs a bound: rings of jobs that are never resubmitted would
    # otherwise accumulate state-sized directories (GBs each at large N)
    # forever.  A week comfortably covers any resubmission horizon.
    _CKPT_RING_TTL_SECONDS = 7 * 24 * 3600.0

    def _sweep_stale_checkpoints(self) -> None:
        now = time.time()
        for name in os.listdir(self.checkpoints_dir):
            ring = os.path.join(self.checkpoints_dir, name)
            try:
                newest = max(
                    (
                        os.path.getmtime(os.path.join(ring, f))
                        for f in os.listdir(ring)
                    ),
                    default=os.path.getmtime(ring),
                )
                if now - newest > self._CKPT_RING_TTL_SECONDS:
                    shutil.rmtree(ring)
            except OSError:
                pass

    def _sweep_orphan_payloads(self) -> None:
        """GC finalized payloads whose job can never use them again.

        A crash can land between ``save_payload`` and ``save_job``
        (payload, no record) or between a terminal ``save_job`` and
        ``delete_payload`` (terminal record, payload left behind);
        neither is reachable by the reconciliation sweep (it only walks
        queued/running records), so without this the matrix-sized
        ``.npy`` payloads accumulate forever on a preemption-heavy pod.
        The grace window spares another live process's in-flight
        admission (payload written moments before its record).
        QUARANTINED jobs' payloads are explicitly spared: retaining the
        exact poison (config, data) for offline debugging — and for a
        ``serve-admin release`` re-run — is the quarantine contract.
        """
        now = time.time()
        for name in os.listdir(self.payloads_dir):
            if not name.endswith(".json"):
                continue  # the .npy goes (or stays) with its .json
            job_id = name[: -len(".json")]
            path = os.path.join(self.payloads_dir, name)
            try:
                if now - os.path.getmtime(path) <= self._TMP_GRACE_SECONDS:
                    continue
            except OSError:
                continue
            record = self.load_job(job_id)
            if record is None or record.get("status") not in (
                "queued", "running", "quarantined",
            ):
                self.delete_payload(job_id)

    def gc_stale_leases(self) -> None:
        """GC lease directories whose fencing history is dead weight.

        A lease tombstone must OUTLIVE its job long enough to refuse a
        zombie's late write (serve/leases.py), so live and recently
        terminal jobs' lease dirs are spared; what this sweeps is the
        long tail — jobs whose record is terminal (or gone) and whose
        newest token file is older than the grace window, where no
        writer that could be fenced can still exist.  Runs at store
        construction AND periodically from the scheduler's lease
        maintenance thread: a long-lived service otherwise accumulates
        one tombstone dir per terminal job forever, and the periodic
        takeover sweep re-reads every one of them each round."""
        now = time.time()
        for job_id in os.listdir(self.leases_dir):
            job_dir = os.path.join(self.leases_dir, job_id)
            try:
                newest = max(
                    (
                        os.path.getmtime(os.path.join(job_dir, f))
                        for f in os.listdir(job_dir)
                    ),
                    default=os.path.getmtime(job_dir),
                )
            except OSError:
                continue
            if now - newest <= self._TMP_GRACE_SECONDS:
                continue
            record = self.load_job(job_id)
            if record is None or record.get("status") not in (
                "queued", "running",
            ):
                try:
                    shutil.rmtree(job_dir)
                except OSError:
                    pass
        self._sweep_stale_heartbeats(now)

    def _sweep_stale_heartbeats(self, now: float) -> None:
        """GC dead workers' fleet heartbeats, on the lease GC's grace
        window.  A live worker rewrites its file every lease sweep
        (seconds), so a heartbeat older than the grace window can only
        be a dead worker's leaving.  The steal planner already rejects
        it on staleness long before this runs (serve/fleet/heartbeat.py
        — a dead worker's advert must never steer a steal); this just
        keeps the directory from accumulating one file per worker that
        ever existed."""
        try:
            names = os.listdir(self.fleet_dir)
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(self.fleet_dir, name)
            try:
                if now - os.path.getmtime(path) > self._TMP_GRACE_SECONDS:
                    os.remove(path)
            except OSError:
                pass

    def _sweep_stale_tmps(self) -> None:
        now = time.time()
        lease_dirs = [
            os.path.join(self.leases_dir, name)
            for name in os.listdir(self.leases_dir)
            if os.path.isdir(os.path.join(self.leases_dir, name))
        ]
        for directory in (
            self.results_dir, self.jobs_dir, self.payloads_dir,
            self.control_dir, self.fleet_dir, *lease_dirs,
        ):
            try:
                names = os.listdir(directory)
            except OSError:
                # A peer on the shared store removed this lease dir
                # between the listing above and here (admission
                # rollback, or another booting store's stale-lease GC).
                continue
            for name in names:
                # Canonical names are <hex>.json / <hex>.npy; every
                # temp spelling here embeds ".tmp".
                if ".tmp" not in name:
                    continue
                path = os.path.join(directory, name)
                try:
                    if now - os.path.getmtime(path) > self._TMP_GRACE_SECONDS:
                        os.remove(path)
                except OSError:
                    pass

    # -- fingerprints ----------------------------------------------------

    def fingerprint(self, payload: Dict[str, Any], x: np.ndarray) -> str:
        return job_fingerprint(payload, x)

    # -- results (immutable, keyed by fingerprint) -----------------------

    def _result_path(self, fp: str) -> str:
        return os.path.join(self.results_dir, f"{fp}.json")

    def get_result_bytes(self, fp: str) -> Optional[bytes]:
        path = self._result_path(fp)
        try:
            with open(path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def get_result(self, fp: str) -> Optional[Dict[str, Any]]:
        raw = self.get_result_bytes(fp)
        return None if raw is None else json.loads(raw)

    def put_result(self, fp: str, result: Dict[str, Any]) -> bytes:
        """Store a result; returns the canonical bytes actually written.

        First-writer-wins: if a concurrent writer already landed this
        fingerprint, the existing bytes are kept (both writers computed
        the same deterministic sweep, so either copy is correct — keeping
        the first preserves byte-identity for readers that already saw
        it).
        """
        existing = self.get_result_bytes(fp)
        if existing is not None:
            return existing
        blob = canonical_result_bytes(result)
        # Unique temp name: two processes sharing a store dir must never
        # rename each other's half-written temp out from under them.
        tmp = f"{self._result_path(fp)}.{uuid.uuid4().hex}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._result_path(fp))  # atomic: no torn results
        return blob

    # -- job records (mutable status documents) --------------------------

    def _job_path(self, job_id: str) -> str:
        # job ids are uuid hex generated by the scheduler; validate anyway
        # so a crafted GET /jobs/../x can never escape the store directory.
        if not job_id.replace("-", "").isalnum():
            raise ValueError(f"invalid job id {job_id!r}")
        return os.path.join(self.jobs_dir, f"{job_id}.json")

    def save_job(self, record: Dict[str, Any]) -> None:
        path = self._job_path(record["job_id"])
        # Unique temp name: the submitting HTTP thread and the scheduler
        # worker may mirror the same record near-simultaneously, and two
        # writers sharing one ".tmp" name would rename each other's file
        # out from under them (FileNotFoundError on the loser's replace).
        tmp = f"{path}.{uuid.uuid4().hex}.tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, default=float, sort_keys=True)
        os.replace(tmp, path)

    def delete_job(self, job_id: str) -> None:
        try:
            os.remove(self._job_path(job_id))
        except FileNotFoundError:
            pass

    def load_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._job_path(job_id)) as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return None

    # -- job payloads (config + data, for crash re-queue) ----------------

    def _payload_paths(self, job_id: str) -> Tuple[str, str]:
        if not job_id.replace("-", "").isalnum():
            raise ValueError(f"invalid job id {job_id!r}")
        base = os.path.join(self.payloads_dir, job_id)
        return base + ".json", base + ".npy"

    def save_payload(
        self,
        job_id: str,
        payload: Dict[str, Any],
        x: np.ndarray,
        restart_attempts: int = 0,
    ) -> None:
        """Persist what re-running the job needs: the fingerprint-bearing
        config payload plus the data matrix.  Written at admission and
        deleted on the terminal transition — the window in between is
        exactly when a process death would otherwise strand the job.

        ``restart_attempts`` rides in an envelope AROUND the spec
        payload (never inside it — the spec payload is hashed into the
        job fingerprint, and a counter there would change the job's
        identity on every restart).  It is the monotonically increasing
        requeue counter the crash-loop quarantine threshold reads: a
        one-shot record flag forgets previous restarts, this survives
        *all* of them.
        """
        json_path, npy_path = self._payload_paths(job_id)
        tmp = f"{npy_path}.{uuid.uuid4().hex}.tmp.npy"
        np.save(tmp, np.ascontiguousarray(x))
        os.replace(tmp, npy_path)
        # Data first, record second: a crash between the two leaves an
        # orphan .npy (garbage, never loaded) instead of a payload whose
        # load would fail mid-reconciliation.
        self._write_payload_json(
            json_path, payload, int(restart_attempts)
        )

    @staticmethod
    def _write_payload_json(
        json_path: str, payload: Dict[str, Any], restart_attempts: int
    ) -> None:
        envelope = {
            "spec": payload,
            "restart_attempts": int(restart_attempts),
        }
        tmp = f"{json_path}.{uuid.uuid4().hex}.tmp"
        with open(tmp, "w") as f:
            json.dump(envelope, f, sort_keys=True, default=float)
        os.replace(tmp, json_path)

    def set_payload_attempts(
        self, job_id: str, payload: Dict[str, Any], restart_attempts: int
    ) -> None:
        """Rewrite the payload's restart counter (JSON only — the
        matrix-sized ``.npy`` is untouched).  Called by reconciliation
        BEFORE re-enqueueing, so a crash-loop that dies again before
        running still advances the counter — the property that makes
        the quarantine threshold reachable at all."""
        json_path, _ = self._payload_paths(job_id)
        self._write_payload_json(json_path, payload, restart_attempts)

    def load_payload(
        self, job_id: str
    ) -> Optional[Tuple[Dict[str, Any], np.ndarray, int]]:
        """(spec payload, data, restart_attempts) or None.

        Pre-envelope payloads (stores written before the quarantine
        counter existed) load with ``restart_attempts=0`` — a restarted
        service over an old store starts counting from now.
        """
        try:
            json_path, npy_path = self._payload_paths(job_id)
        except ValueError:
            return None
        try:
            with open(json_path) as f:
                raw = json.load(f)
            x = np.load(npy_path)
        except (FileNotFoundError, ValueError):
            return None
        if (
            isinstance(raw, dict)
            and "spec" in raw
            and "restart_attempts" in raw
        ):
            return raw["spec"], x, int(raw["restart_attempts"])
        return raw, x, 0

    def delete_payload(self, job_id: str) -> None:
        try:
            for path in self._payload_paths(job_id):
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
        except ValueError:
            pass

    # -- per-job block-checkpoint rings ----------------------------------

    def checkpoint_dir(self, fingerprint: str) -> str:
        """Directory for a job's streamed block-checkpoint ring, keyed
        by the job FINGERPRINT (not the job id): a resubmission of an
        identical failed job resumes the previous attempt's ring."""
        if not fingerprint.isalnum():
            raise ValueError(f"invalid fingerprint {fingerprint!r}")
        return os.path.join(self.checkpoints_dir, fingerprint)

    def clear_checkpoints(self, fingerprint: str) -> None:
        """Drop a completed job's ring (its result is stored; the
        block state is dead weight)."""
        try:
            shutil.rmtree(self.checkpoint_dir(fingerprint))
        except (OSError, ValueError):
            pass

    # -- per-parent plane stores (append subsystem) ----------------------

    def plane_dir(self, fingerprint: str) -> str:
        """Directory for a job's persistent plane store
        (``append.store.PlaneStore``), keyed by the job FINGERPRINT:
        an append names its parent by fingerprint, and successive
        appends against the same root parent land their generations in
        the same store.  Unlike the checkpoint ring this directory
        survives job completion — it is the artifact, not scaffolding."""
        if not fingerprint.isalnum():
            raise ValueError(f"invalid fingerprint {fingerprint!r}")
        return os.path.join(self.planes_dir, fingerprint)

    def clear_planes(self, fingerprint: str) -> None:
        """Operator/test retention hook: drop one parent's plane store
        (appends against it will fall back to full recompute)."""
        try:
            shutil.rmtree(self.plane_dir(fingerprint))
        except (OSError, ValueError):
            pass

    # -- profiling control (serve-admin profile-next) --------------------

    def _profile_request_path(self) -> str:
        return os.path.join(self.control_dir, "profile_next.json")

    def arm_profile(self, profile_dir: str) -> str:
        """Arm a one-shot ``jax.profiler`` trace of the next executed
        job into ``profile_dir`` (docs/OBSERVABILITY.md).  Atomic write
        — arming again before a claim just replaces the target dir.
        ``serve-admin profile-next`` writes the SAME file stdlib-only;
        this method is the in-process spelling (tests, embedders)."""
        path = self._profile_request_path()
        tmp = f"{path}.{uuid.uuid4().hex}.tmp"
        os.makedirs(self.control_dir, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(
                {
                    # abspath, matching serve-admin's spelling: the
                    # trace must land where the ARMER meant, not
                    # relative to the service process's cwd.
                    "profile_dir": os.path.abspath(str(profile_dir)),
                    "armed_at": round(time.time(), 3),
                },
                f, sort_keys=True,
            )
        os.replace(tmp, path)
        return path

    def claim_profile(self) -> Optional[str]:
        """Consume an armed profile request; returns its target dir or
        None.  The claim is the ``os.replace`` to a unique name — two
        racing workers cannot both win, and a crash mid-claim leaves at
        most a stale ``.claimed`` temp (swept by the tmp GC)."""
        path = self._profile_request_path()
        if not os.path.exists(path):  # cheap fast path, checked per job
            return None
        claimed = f"{path}.{uuid.uuid4().hex}.tmp"
        try:
            os.replace(path, claimed)
        except FileNotFoundError:
            return None  # another worker won the claim
        try:
            with open(claimed) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            payload = None
        finally:
            try:
                os.remove(claimed)
            except OSError:
                pass
        if not isinstance(payload, dict) or not payload.get("profile_dir"):
            return None  # malformed arm: consumed, logged by caller
        return str(payload["profile_dir"])

    def iter_jobs(self):
        """Yield every stored (job_id, record) pair — the scheduler's
        restart reconciliation sweep."""
        for name in sorted(os.listdir(self.jobs_dir)):
            if not name.endswith(".json"):
                continue
            record = self.load_job(name[: -len(".json")])
            if record is not None:
                yield record["job_id"], record
