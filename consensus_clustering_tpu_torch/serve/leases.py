# Copied from consensus_clustering_tpu/serve/leases.py.
"""Fenced job leases: at-most-once execution over the shared jobstore.

The jobstore's atomic writes make a SINGLE process crash-safe; they do
nothing for ownership.  Two ``serve`` processes pointed at one store
would both believe a queued orphan is theirs, both run it, and a
restarting worker's reconciliation would re-queue — and push toward
quarantine — jobs a *live* peer is legitimately running.  This module
is the ownership layer (docs/SERVING.md "Multi-worker runbook"):

- **claim** — a worker claims a job by atomically creating
  ``leases/<job_id>/token-<N>.json`` (payload written to a tmp file,
  then hard-linked into the token name: exactly one winner, no lock
  server, and the file appears with its content in one step).  The
  file carries the owner's ``worker_id``, a monotonically increasing
  **fencing token** ``N``, and an expiry.
- **renew** — the owner periodically rewrites its token file with a
  fresh ``expires_at`` (atomic replace).  Renewal is wall-clock driven
  (the scheduler's lease maintenance thread plus the per-block
  heartbeat path), NOT block-completion driven — so a slow block, a
  long compile, or an idle queue slot can never read as death; only a
  dead or stopped process lets the lease expire.
- **take over** — a peer that finds a lease absent, expired, released,
  or torn claims the NEXT token with the same ``O_EXCL`` rule.  Token
  files are never renamed away, so readers never observe a
  transient-absence window; superseded slots are deleted only after the
  newer token exists.
- **fence** — every state-mutating jobstore write checks that the
  writer's token is still the newest before writing.  A SIGSTOP'd
  zombie that wakes after its job was taken over finds a newer token
  and is REFUSED (``lease_refused`` event) instead of clobbering the
  successor's result.  (The check-then-write pair is not one atomic
  operation — the residual window is a disk write wide, and both
  writers are post-takeover running the same deterministic job, so a
  record clobbered inside it differs only in timing fields; the result
  store itself is first-writer-wins on canonical bytes.)
- **release** — a terminal transition rewrites the token file with
  ``released: true``, KEEPING the token: the tombstone is what fences a
  zombie's late write after the successor already finished.  A released
  job (``serve-admin release``) is re-claimable at the next token.

A *torn* token file — the slot taken but unreadable — cannot be
produced by a claim (the link is atomic with the content), only by
disk-level damage to an existing token.  It is handled defensively: a
torn newest token is treated as already expired (nothing readable
says anyone is renewing it), so the next claimant takes the slot
after it.

Deliberately stdlib-only at import time (``resilience.faults`` is
imported lazily inside the renewal path): ``serve-admin`` renders lease
state through :func:`read_lease` under its no-jax/no-numpy
``-X importtime`` pin.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: Token filenames sort lexically == numerically at 8 digits; a sweep
#: farm that burns 10^8 takeovers of one job has other problems.
_TOKEN_RE = re.compile(r"^token-(\d{8})\.json$")


def _token_name(token: int) -> str:
    return f"token-{token:08d}.json"


class LeaseLost(RuntimeError):
    """A fenced write was refused: a newer token supersedes the writer.

    Raised by the scheduler's fence check — the job was taken over (the
    writer is a zombie from the store's point of view), so the write is
    dropped and the successor's record stands.
    """

    def __init__(
        self,
        job_id: str,
        op: str,
        token: Optional[int],
        newer_token: Optional[int],
    ):
        self.job_id = job_id
        self.op = op
        self.token = token
        self.newer_token = newer_token
        super().__init__(
            f"lease for job {job_id} superseded (held token {token}, "
            f"newest {newer_token}): {op} refused"
        )


def read_lease(leases_dir: str, job_id: str) -> Optional[Dict[str, Any]]:
    """The newest lease state for a job, from the store's JSON alone.

    Returns the token file's payload (plus ``torn: False``), or a
    ``torn: True`` stub when the newest slot is unreadable (a claimant
    token file was damaged on disk), or ``None`` when
    the job has never been leased.  Stdlib-only — ``serve-admin``
    ``list``/``show`` render from this under the no-jax importtime pin.
    """
    if not job_id.replace("-", "").isalnum():
        return None
    job_dir = os.path.join(leases_dir, job_id)
    try:
        names = os.listdir(job_dir)
    except OSError:
        return None
    newest = None
    for name in names:
        m = _TOKEN_RE.match(name)
        if m is not None:
            token = int(m.group(1))
            if newest is None or token > newest:
                newest = token
    if newest is None:
        return None
    try:
        with open(os.path.join(job_dir, _token_name(newest))) as f:
            payload = json.load(f)
        if not isinstance(payload, dict):
            raise ValueError("lease payload is not an object")
    except (OSError, ValueError):
        return {
            "job_id": job_id,
            "token": newest,
            "worker_id": None,
            "expires_at": 0.0,
            "released": False,
            "torn": True,
        }
    payload.setdefault("token", newest)
    payload["torn"] = False
    return payload


def lease_state_name(lease: Dict[str, Any], now: float) -> str:
    """Classify a :func:`read_lease` payload: ``torn`` | ``released``
    | ``expired`` | ``live``.

    The ONE spelling of the state ladder (precedence matters: a torn
    slot has no readable flags, a released tombstone never expires
    into takeover-by-expiry).  ``serve-admin``'s rendering, the
    claim-orphan takeover decision, and the scheduler's periodic
    dead-lease scan all call this — so the state an operator sees can
    never disagree with the takeover the scheduler performs."""
    if lease.get("torn"):
        return "torn"
    if lease.get("released"):
        return "released"
    if float(lease.get("expires_at") or 0.0) <= now:
        return "expired"
    return "live"


class LeaseManager:
    """One worker's view of the lease directory.

    Tracks the tokens this worker holds (``_owned``), claims fresh jobs
    at admission, takes over orphans whose lease is absent/expired/
    released/torn, renews everything it owns on a wall-clock cadence,
    and answers the scheduler's fence checks.  All disk state is the
    token files described in the module docstring; all methods are
    thread-safe.
    """

    def __init__(
        self,
        leases_dir: str,
        worker_id: str,
        ttl: float = 60.0,
        renew_every: Optional[float] = None,
        clock=time.time,
    ):
        if ttl <= 0:
            raise ValueError(f"lease ttl must be > 0, got {ttl}")
        self.leases_dir = leases_dir
        self.worker_id = str(worker_id)
        self.ttl = float(ttl)
        self.renew_every = (
            float(renew_every) if renew_every is not None
            else self.ttl / 4.0
        )
        if self.renew_every <= 0:
            raise ValueError(
                f"renew_every must be > 0, got {self.renew_every}"
            )
        self._clock = clock
        self._owned: Dict[str, int] = {}
        self._state_lock = threading.Lock()
        # Serialises renewal rounds: the ``lease_renewal`` fault point
        # (``pause`` action — the deterministic zombie) sleeps under
        # this lock, so a paused worker renews NOTHING until it wakes;
        # the heartbeat-path renewal try-locks and skips rather than
        # stalling a live block loop behind a peer round.
        self._renew_lock = threading.Lock()
        self._renew_rounds = 0
        self._last_renew = 0.0

    # -- disk state ------------------------------------------------------

    def _job_dir(self, job_id: str) -> str:
        if not job_id.replace("-", "").isalnum():
            raise ValueError(f"invalid job id {job_id!r}")
        return os.path.join(self.leases_dir, job_id)

    def current(self, job_id: str) -> Optional[Dict[str, Any]]:
        return read_lease(self.leases_dir, job_id)

    def _lease_payload(self, job_id: str, token: int) -> Dict[str, Any]:
        now = self._clock()
        return {
            "job_id": job_id,
            "token": int(token),
            "worker_id": self.worker_id,
            "acquired_at": round(now, 3),
            "renewed_at": round(now, 3),
            "expires_at": round(now + self.ttl, 3),
            "released": False,
            "released_status": None,
        }

    def _rewrite(
        self, job_id: str, token: int, payload: Dict[str, Any]
    ) -> None:
        path = os.path.join(self._job_dir(job_id), _token_name(token))
        tmp = f"{path}.{uuid.uuid4().hex}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True)
        os.replace(tmp, path)

    def _try_claim(self, job_id: str, token: int) -> bool:
        """Atomically create token file ``token``; False when another
        claimant already took the slot (the link race loser).

        The payload is written to a tmp file FIRST and hard-linked into
        the token name — one winner (``link(2)`` fails with EEXIST for
        everyone else, same exclusivity as ``O_EXCL``) AND the token
        file appears with its full content in one step.  Create-then-
        write would open a window where a third worker's sweep lists
        the slot, reads an empty file, classifies a LIVE claimant's
        in-flight claim as torn, and falsely supersedes it."""
        job_dir = self._job_dir(job_id)
        os.makedirs(job_dir, exist_ok=True)
        path = os.path.join(job_dir, _token_name(token))
        # Suffix chosen so _TOKEN_RE never matches the tmp name; a
        # crash-stranded tmp is swept with the dir by gc_stale_leases.
        tmp = f"{path}.{uuid.uuid4().hex}.claim"
        with open(tmp, "w") as f:
            json.dump(self._lease_payload(job_id, token), f, sort_keys=True)
        try:
            os.link(tmp, path)
        except FileExistsError:
            return False
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        # GC superseded slots now that the newer token exists (fencing
        # only needs the max; a zombie's late renewal rewrite of a
        # deleted sub-max slot just recreates a file that still loses).
        for name in os.listdir(job_dir):
            m = _TOKEN_RE.match(name)
            if m is not None and int(m.group(1)) < token:
                try:
                    os.remove(os.path.join(job_dir, name))
                except OSError:
                    pass
        with self._state_lock:
            self._owned[job_id] = token
        return True

    # -- claims ----------------------------------------------------------

    def claim_new(self, job_id: str) -> Optional[int]:
        """Claim a freshly admitted job (token 1).  Job ids are fresh
        uuids, so contention here means a recycled id — fall back to
        the orphan rules rather than corrupt the token order."""
        if self._try_claim(job_id, 1):
            return 1
        claimed = self.claim_orphan(job_id)
        return claimed[0] if claimed is not None else None

    def claim_orphan(
        self, job_id: str, boot: bool = False
    ) -> Optional[Tuple[int, str, Optional[str]]]:
        """Try to take over an orphaned job's lease.

        Returns ``(token, reason, prior_worker)`` on success, ``None``
        when the job is NOT ours to take — a live peer's lease (leave it
        alone: this is the rule that stops a booting worker counting a
        healthy peer's jobs as restarts) or a lost claim race.  Reasons:
        ``absent`` (never leased — pre-lease stores), ``expired``,
        ``released``, ``torn`` (unreadable token file), and
        ``self_restart`` (``boot=True`` only: a live-looking lease held
        by OUR worker_id at boot is our dead former self — a worker_id
        is restart-stable precisely so recovery need not wait out the
        ttl)."""
        cur = self.current(job_id)
        state = (
            None if cur is None else lease_state_name(cur, self._clock())
        )
        if cur is None:
            token, reason = 1, "absent"
        elif state != "live":
            token, reason = int(cur["token"]) + 1, state
        elif cur.get("worker_id") == self.worker_id:
            with self._state_lock:
                tracked = self._owned.get(job_id) == cur.get("token")
            if tracked or not boot:
                return None
            token, reason = int(cur["token"]) + 1, "self_restart"
        else:
            return None  # a live peer's lease
        if not self._try_claim(job_id, token):
            return None  # another taker won the O_EXCL race
        return token, reason, (cur or {}).get("worker_id")

    def claim_steal(
        self, job_id: str
    ) -> Optional[Tuple[int, Optional[str]]]:
        """Steal a LIVE peer's lease: claim the next token over it.

        A steal is just a claim — zero new ownership semantics.  The
        fencing, renewal, release, and tombstone rules are exactly the
        orphan-takeover ones; the only difference from
        :meth:`claim_orphan` is the precondition: the current lease
        must be a live PEER's (dead leases are claim_orphan's job, and
        our own jobs are not stealable — the fleet planner relieving
        us of our own queue would be a no-op with extra fencing).  The
        superseded peer discovers the loss at its next renewal round,
        and any write it attempts first is refused by the fence like
        any zombie's.  Returns ``(token, prior_worker)``, or ``None``
        when the lease is not a live peer's or the claim race was
        lost."""
        cur = self.current(job_id)
        if cur is None:
            return None
        if lease_state_name(cur, self._clock()) != "live":
            return None
        if cur.get("worker_id") == self.worker_id:
            return None
        token = int(cur["token"]) + 1
        if not self._try_claim(job_id, token):
            return None
        return token, cur.get("worker_id")

    # -- renewal ---------------------------------------------------------

    def renew_owned(self, blocking: bool = True) -> List[str]:
        """Renew every owned lease; returns job_ids LOST (superseded by
        a newer token — we are a zombie for those jobs now).

        The ``lease_renewal`` fault point fires here — on BLOCKING
        (maintenance-thread) rounds only, once per round that actually
        has leases to renew, with the round index counting only those
        rounds so a plan's index is deterministic.  ``CCTPU_FAULTS=
        "lease_renewal=0:pause:30"`` stalls THIS worker's renewal long
        enough for a peer to take over — the deterministic zombie the
        cluster chaos schedule drives.  The non-blocking heartbeat
        spelling never fires it: a pause there would stall the block
        loop and fail the attempt, which is exactly what the zombie
        scenario must NOT do (and while the maintenance thread sleeps
        inside the fault under ``_renew_lock``, the heartbeat path's
        try-lock skips — the paused worker renews NOTHING)."""
        if blocking:
            self._renew_lock.acquire()
        elif not self._renew_lock.acquire(blocking=False):
            return []
        try:
            with self._state_lock:
                owned = dict(self._owned)
            if not owned:
                return []
            if blocking:
                # Lazy import keeps this module stdlib-only at import
                # time (the serve-admin contract); resilience.faults
                # itself is stdlib, but its package __init__ reaches
                # numpy.
                from consensus_clustering_tpu_torch.resilience.faults import (
                    faults,
                )

                faults.fire("lease_renewal", self._renew_rounds)
                self._renew_rounds += 1
            self._last_renew = self._clock()
            lost: List[str] = []
            for job_id, token in owned.items():
                cur = self.current(job_id)
                if (
                    cur is None
                    or int(cur.get("token") or 0) != token
                    or cur.get("torn")
                    or cur.get("worker_id") != self.worker_id
                ):
                    with self._state_lock:
                        self._owned.pop(job_id, None)
                    lost.append(job_id)
                    continue
                now = self._clock()
                payload = {
                    k: v for k, v in cur.items() if k != "torn"
                }
                payload["renewed_at"] = round(now, 3)
                payload["expires_at"] = round(now + self.ttl, 3)
                self._rewrite(job_id, token, payload)
            return lost
        finally:
            self._renew_lock.release()

    def maybe_renew(self) -> List[str]:
        """Rate-limited, non-blocking renewal — the per-block heartbeat
        spelling: cheap enough to ride every beat, skips when a round
        ran recently or one is in flight (never stalls a block loop)."""
        if self._clock() - self._last_renew < self.renew_every:
            return []
        return self.renew_owned(blocking=False)

    # -- fencing / release ----------------------------------------------

    def check_fence(self, job_id: str) -> bool:
        """True when this worker's token is still the newest — the
        write-side gate every state-mutating jobstore write runs."""
        with self._state_lock:
            token = self._owned.get(job_id)
        if token is None:
            return False
        cur = self.current(job_id)
        return (
            cur is not None
            and not cur.get("torn")
            and int(cur.get("token") or 0) == token
            and cur.get("worker_id") == self.worker_id
        )

    def fence_info(
        self, job_id: str
    ) -> Tuple[Optional[int], Optional[int]]:
        """(our token, newest token on disk) — the refusal event's
        evidence fields."""
        with self._state_lock:
            mine = self._owned.get(job_id)
        cur = self.current(job_id)
        newest = None if cur is None else int(cur.get("token") or 0)
        return mine, newest

    def release(self, job_id: str, status: str) -> bool:
        """Terminal transition: tombstone the lease (released flag set,
        TOKEN KEPT — the tombstone is what refuses a zombie's late
        write after we finished).  False when we no longer own it."""
        with self._state_lock:
            token = self._owned.pop(job_id, None)
        if token is None:
            return False
        cur = self.current(job_id)
        if (
            cur is None
            or cur.get("torn")
            or int(cur.get("token") or 0) != token
            or cur.get("worker_id") != self.worker_id
        ):
            return False  # superseded while terminalising: nothing to say
        now = self._clock()
        payload = {k: v for k, v in cur.items() if k != "torn"}
        payload["released"] = True
        payload["released_status"] = status
        payload["released_at"] = round(now, 3)
        self._rewrite(job_id, token, payload)
        return True

    def forget(self, job_id: str) -> None:
        """Drop local ownership without touching disk (the fence already
        refused us — the newer token is the record)."""
        with self._state_lock:
            self._owned.pop(job_id, None)

    def drop(self, job_id: str) -> None:
        """Admission rollback (queue full): the job never existed, so
        its lease dir goes with it."""
        self.forget(job_id)
        try:
            shutil.rmtree(self._job_dir(job_id), ignore_errors=True)
        except ValueError:
            pass

    def owned_count(self) -> int:
        with self._state_lock:
            return len(self._owned)

    def owned_jobs(self) -> List[str]:
        with self._state_lock:
            return sorted(self._owned)
