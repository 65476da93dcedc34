"""Preemption-safe block checkpoints for the streaming H-block engine.

The port of the reference package's ``resilience/blocks.py``.  A streamed
sweep's state at a block boundary is an exact resume point: the resample
plan folds every draw with its GLOBAL index, so the state (dense Mij/Iij
or packed bit-planes), the cursor ``h_done`` and the adaptive trajectory
are all a resume needs.

Durability discipline:

- **Torn writes**: every generation is written to a ``*.tmp`` sibling and
  ``os.replace``'d into place, so a crash mid-write leaves temp garbage,
  never a half-written ``gen-*.ckpt``.
- **Silent corruption**: frames are CRC32-framed end to end; a flipped
  bit or a truncated file fails the frame check and the reader falls back
  to the previous generation.  A semantic digest (:func:`..integrity.
  frame_digest`) taken before serialisation lets the reader refuse a
  frame whose content changed before its CRC was computed.
- **Wrong state**: every frame embeds the stream fingerprint
  (:func:`..utils.checkpoint.stream_fingerprint`), and the reader refuses
  state from a different sweep, package or device type.
- **Lost progress against disk use**: a ring of the last :data:`KEEP`
  (2) generations.

Frame layout (all integers little-endian), the reference's, so each
package's :func:`decode_frame` reads the other's frames::

    magic   b"CCTPUBLK1\\n"
    u64     header length
    bytes   header JSON
    u64     payload length
    bytes   payload      (np.savez of the state + curve arrays)
    u32     CRC32 over everything after the magic

Writes run on one background thread behind a one-slot queue.  The writer
takes **host numpy arrays only**: the port's engine updates its state in
place, so the driver copies a checkpointed block's state to the host
before the next block launches and hands the copy over; the digest, the
serialisation, the CRC and the disk write run off the driver's thread.
``flush()`` is the barrier.
"""

from __future__ import annotations

import io
import json
import logging
import os
import queue
import re
import struct
import threading
import time
import uuid
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from consensus_clustering_tpu_torch.resilience.faults import faults
from consensus_clustering_tpu_torch.resilience.integrity import (
    flip_array_bits,
    frame_digest,
)

logger = logging.getLogger(__name__)

_MAGIC = b"CCTPUBLK1\n"
_GEN_RE = re.compile(r"^gen-(\d{8})\.ckpt$")
#: Generations the ring keeps: the newest and the one a resume falls back
#: to when the newest is unreadable or refused.
KEEP = 2


class CheckpointFrameError(ValueError):
    """A checkpoint file failed framing/CRC/fingerprint validation."""


def _frame_pieces(header: Dict[str, Any], arrays: Dict[str, np.ndarray]):
    """Yield one generation's byte pieces in on-disk order, magic first.

    The SINGLE owner of the frame layout: :func:`encode_frame`
    concatenates the pieces (tests, small frames) and the writer
    streams them with an incremental CRC (production, GB-scale state) —
    the two paths cannot drift because there is one definition.
    """
    header_blob = json.dumps(header, sort_keys=True).encode()
    buf = io.BytesIO()
    # Uncompressed savez: checkpoints are written every block, and the
    # int32 count accumulators compress poorly early (dense small ints)
    # while the write cost lands on the block cadence — favour speed.
    np.savez(buf, **arrays)
    payload = buf.getbuffer()  # zero-copy view of the npz bytes
    yield _MAGIC
    yield struct.pack("<Q", len(header_blob))
    yield header_blob
    yield struct.pack("<Q", payload.nbytes)
    yield payload


def encode_frame(header: Dict[str, Any], arrays: Dict[str, np.ndarray]) -> bytes:
    """Serialise one generation: magic + length-framed JSON header +
    npz payload + trailing CRC32 over everything after the magic."""
    magic, *rest = _frame_pieces(header, arrays)
    body = b"".join(bytes(piece) for piece in rest)
    return magic + body + struct.pack("<I", zlib.crc32(body))


def decode_frame(blob: bytes) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Inverse of :func:`encode_frame`; raises
    :class:`CheckpointFrameError` on any framing/CRC violation."""
    if not blob.startswith(_MAGIC):
        raise CheckpointFrameError("bad magic (not a block checkpoint)")
    body, trailer = blob[len(_MAGIC):-4], blob[-4:]
    if len(blob) < len(_MAGIC) + 8 + 8 + 4:
        raise CheckpointFrameError("truncated frame (shorter than framing)")
    (crc,) = struct.unpack("<I", trailer)
    if zlib.crc32(body) != crc:
        raise CheckpointFrameError("CRC mismatch (corrupt or truncated)")
    (header_len,) = struct.unpack("<Q", body[:8])
    if 8 + header_len + 8 > len(body):
        raise CheckpointFrameError("header length exceeds frame")
    header_blob = body[8:8 + header_len]
    (payload_len,) = struct.unpack(
        "<Q", body[8 + header_len:8 + header_len + 8]
    )
    payload = body[8 + header_len + 8:]
    if payload_len != len(payload):
        raise CheckpointFrameError("payload length mismatch")
    try:
        header = json.loads(header_blob)
    except ValueError as e:
        # Reachable only for corruption that PREDATES the CRC (the
        # trailer already vouched for these bytes); same fall-back
        # contract as an undecodable payload.
        raise CheckpointFrameError(f"header undecodable ({e})")
    try:
        with np.load(io.BytesIO(payload)) as z:
            arrays = {name: z[name] for name in z.files}
    except Exception as e:  # noqa: BLE001 — np.load raises zipfile/
        # format/IO errors of several types for a damaged npz; ANY of
        # them escaping here would crash the resume scan instead of
        # letting the ring fall back to the previous generation.
        raise CheckpointFrameError(f"payload undecodable ({e})")
    return header, arrays


class StreamCheckpointer:
    """Ring of CRC-framed block-state generations with an async writer.

    One instance per (directory, run-identity); the identity itself
    lives in each frame's ``fingerprint`` header field, so the reader —
    not the directory layout — enforces that resumes never cross
    configs/seeds/datasets.

    The driver writes every evaluated block; the ring keeps the last
    ``keep`` generations (:data:`KEEP`; the serve executor keeps more
    when the invariant sentinel runs every few blocks, so a caught
    corruption still finds a verified generation behind it).
    ``write_seconds_total`` sums the writer thread's seconds (digest,
    serialisation, CRC, disk) over ``writes_total`` writes, and
    ``on_write(seconds, block)``, when given, hears each one.
    """

    def __init__(
        self,
        directory: str,
        keep: int = KEEP,
        on_write: Optional[Callable[[float, int], None]] = None,
    ):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = int(keep)
        self.on_write = on_write
        self.writes_total = 0
        self.write_seconds_total = 0.0
        #: Incremented by the streaming driver when a run actually
        #: restored state from this ring.
        self.resumes_total = 0
        #: Generations the reader REFUSED on semantic grounds (digest
        #: mismatch or invariant breach, the verified-checkpoints gate,
        #: distinct from CRC/framing failures).
        self.verify_rejects = 0
        self.last_error: Optional[BaseException] = None
        #: (path, reason) pairs the reader skipped — surfaced for tests
        #: and for the resume log line.
        self.skipped: List[Tuple[str, str]] = []
        os.makedirs(directory, exist_ok=True)
        # maxsize=1 is deliberate backpressure: each queued item holds
        # one host copy of the state, so one slot caps the copies at
        # three (the driver's newest, one queued, one serialising), and
        # a disk slower than the block cadence stalls the driver on
        # put() instead of queueing unbounded state-sized copies.
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._writer: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # -- write path ------------------------------------------------------

    def write_async(
        self, header: Dict[str, Any], arrays: Dict[str, Any]
    ) -> None:
        """Queue one generation for the background writer.

        ``arrays`` values must be host numpy arrays the caller no longer
        changes (the writer thread never touches a device tensor).
        Blocks only when two writes are already pending (see
        ``__init__`` on why that backpressure is wanted).
        """
        for name, value in arrays.items():
            if not isinstance(value, np.ndarray):
                raise TypeError(
                    f"checkpoint array {name!r} must be a host numpy "
                    f"array, got {type(value).__name__}"
                )
        self._ensure_writer()
        self._queue.put((dict(header), dict(arrays)))

    def flush(self) -> None:
        """Barrier: returns once every queued write has hit the ring."""
        if self._writer is None:
            return
        self._queue.join()

    def close(self) -> None:
        self.flush()
        with self._lock:
            writer, self._writer = self._writer, None
        if writer is not None:
            self._queue.put(None)
            writer.join(timeout=10.0)

    def _ensure_writer(self) -> None:
        with self._lock:
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop,
                    name="ckpt-writer",
                    daemon=True,
                )
                self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                try:
                    self._write_one(*item)
                except BaseException as e:  # noqa: BLE001 — durability is
                    # best-effort: a failed write degrades recovery
                    # granularity, it must never fail the sweep itself.
                    self.last_error = e
                    logger.warning("checkpoint write failed: %s", e)
            finally:
                self._queue.task_done()

    def _path(self, block_index: int) -> str:
        return os.path.join(self.directory, f"gen-{block_index:08d}.ckpt")

    def _write_one(self, header: Dict[str, Any], arrays: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        block = int(header["block_index"])
        # Self-heal the directory: another process clearing a shared
        # ring would otherwise fail every later write here at open(tmp),
        # silently disabling durability mid-run.
        os.makedirs(self.directory, exist_ok=True)
        host = {name: np.asarray(v) for name, v in arrays.items()}
        # Semantic digest from the PRISTINE host arrays, before any
        # byte of the payload exists: resume re-derives it from the
        # decoded arrays, so payload corruption between here and the
        # CRC — which the CRC itself would bless — is refused at read
        # time (integrity.verify_state_frame).  One pass over the state
        # on the writer thread, off the driver's thread.
        if "digest" not in header:
            header = dict(header)
            header["digest"] = frame_digest(host)
        # Corruption fault point BETWEEN the digest and serialisation:
        # the flipped bits land in the arrays the npz is built from, so
        # the written frame is fully readable — zip CRCs, frame CRC,
        # lengths all check out — and its content disagrees with the
        # header's digest.  Only the verified-checkpoints gate can
        # catch that lie at resume.  (Flipping the BYTES instead would
        # trip the npz member CRC and degrade the fault to the
        # unreadable-frame class the ring already survived.)  The
        # largest array is flipped on a COPY, leaving the caller's
        # arrays as they were.
        nbits = faults.corrupt("checkpoint_payload", index=block)
        if nbits:
            victim = max(host, key=lambda name: host[name].nbytes)
            corrupted = np.array(host[victim])
            flip_array_bits(corrupted.view(np.int32), nbits, seed=block)
            host = dict(host)
            host[victim] = corrupted
        # Streamed framing, CRC accumulated piecewise: the state payload
        # is GBs at large N, and `_MAGIC + body + crc`-style
        # concatenation would peak at 3-4x that in host RAM per write,
        # so the shared _frame_pieces layout is written piece by piece
        # (the payload piece is a zero-copy view of the npz bytes).
        magic, *framing, payload = _frame_pieces(header, host)
        final = self._path(block)
        tmp = f"{final}.{uuid.uuid4().hex}.tmp"
        crc = 0
        with open(tmp, "wb") as f:
            f.write(magic)
            for piece in framing:
                crc = zlib.crc32(piece, crc)
                f.write(piece)
            f.flush()
            # Fault point between framing and payload: the "die
            # mid-write" tests land exactly here, proving a torn temp
            # never becomes a served generation.
            faults.fire("checkpoint_mid_write", index=block)
            crc = zlib.crc32(payload, crc)
            f.write(payload)
            f.write(struct.pack("<I", crc))
        del payload  # release the BytesIO exportable buffer
        os.replace(tmp, final)  # atomic: no torn gen-*.ckpt, ever
        faults.fire("checkpoint_post_write", index=block)
        self._prune(keep_latest=block)
        seconds = time.perf_counter() - t0
        self.writes_total += 1
        self.write_seconds_total += seconds
        if self.on_write is not None:
            self.on_write(seconds, block)

    # A temp file younger than this is treated as a LIVE write, not
    # crash garbage: a second checkpointer can share the directory (an
    # identical job resubmitted while a timed-out attempt's abandoned
    # thread still streams), and pruning its in-flight temp would turn
    # that writer's os.replace into a lost checkpoint.
    _TMP_GRACE_SECONDS = 600.0

    def _prune(self, keep_latest: int) -> None:
        # Rank generations by WRITE RECENCY, not by block index: the
        # directory can hold stale generations from a superseded stream
        # (same job fingerprint, different stream fingerprint — e.g. a
        # restart with a different block size, or an api re-fit after a
        # crash between the per-K save and clear()), and those carry
        # ARBITRARY block indexes.  Index-ranked pruning would let a
        # stale gen-00000007 evict the gen-00000000 this run just wrote
        # — silently disabling its durability.  By mtime, stale files
        # are the oldest and go first; ``keep_latest`` (the block just
        # written) is excluded outright so a filesystem with coarse
        # mtimes can never drop the newest generation on a tie.
        anchor = os.path.basename(self._path(keep_latest))

        def mtime(name: str) -> float:
            try:
                return os.path.getmtime(os.path.join(self.directory, name))
            except OSError:
                return 0.0

        ranked = sorted(
            (
                # Tie-break equal mtimes (coarse-timestamp filesystems)
                # by block index, which IS write order within one
                # stream — the common case of a ring with no stale
                # files.
                (mtime(name), block, name)
                for block, name in self._generations()
                if name != anchor
            ),
            reverse=True,
        )
        for _, _, name in ranked[self.keep - 1:]:
            self._unlink(name)
        now = time.time()
        for name in os.listdir(self.directory):
            # Only STALE temp files are garbage (a crashed or
            # fault-killed writer's leftovers); this writer's own temp
            # was renamed before _prune runs on the same single thread,
            # and a concurrent writer's young temp is protected by the
            # grace window above.
            if not name.endswith(".tmp"):
                continue
            try:
                age = now - os.path.getmtime(
                    os.path.join(self.directory, name)
                )
            except OSError:
                continue  # already renamed or removed by its owner
            if age > self._TMP_GRACE_SECONDS:
                self._unlink(name)

    def _unlink(self, name: str) -> None:
        try:
            os.remove(os.path.join(self.directory, name))
        except OSError:
            pass

    def clear(self) -> None:
        """Drop every generation (the run they belong to is superseded —
        completed, or checkpointed at a coarser granularity)."""
        self.flush()
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return  # a sibling's cleanup got here first: nothing to drop
        for name in names:
            if _GEN_RE.match(name) or name.endswith(".tmp"):
                self._unlink(name)

    # -- read path -------------------------------------------------------

    def _generations(self) -> List[Tuple[int, str]]:
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        for name in names:
            m = _GEN_RE.match(name)
            if m:
                out.append((int(m.group(1)), name))
        return sorted(out)

    def latest(
        self,
        fingerprint: str,
        verify: Optional[
            Callable[[Dict[str, Any], Dict[str, np.ndarray]], Optional[str]]
        ] = None,
    ) -> Optional[Tuple[Dict[str, Any], Dict[str, np.ndarray]]]:
        """Newest VALID generation matching ``fingerprint``, or None.

        Scans newest-first; anything unreadable (truncated, CRC
        mismatch) or belonging to a different sweep (stale fingerprint)
        is skipped with a logged reason and the ring falls back to the
        previous generation — recovering less progress beats resuming
        from the wrong state.

        ``verify`` (the streaming driver passes
        :func:`~consensus_clustering_tpu.resilience.integrity.
        verify_state_frame`) adds the SEMANTIC gate on top of framing:
        a frame that decodes cleanly but fails its digest or the
        accumulator invariants is refused the same way — counted in
        ``verify_rejects`` — so recovery replays from the last
        *verified* generation, never merely the last readable one.
        """
        self.flush()
        self.skipped = []
        for block, name in reversed(self._generations()):
            path = os.path.join(self.directory, name)
            try:
                with open(path, "rb") as f:
                    header, arrays = decode_frame(f.read())
            except (CheckpointFrameError, OSError) as e:
                reason = f"unreadable ({e})"
                logger.warning(
                    "skipping checkpoint %s: %s — falling back to the "
                    "previous generation", path, reason,
                )
                self.skipped.append((path, reason))
                continue
            if header.get("fingerprint") != fingerprint:
                reason = (
                    "stale fingerprint "
                    f"({header.get('fingerprint')} != {fingerprint}: "
                    "different config/seed/data)"
                )
                logger.warning("skipping checkpoint %s: %s", path, reason)
                self.skipped.append((path, reason))
                continue
            if verify is not None:
                bad = verify(header, arrays)
                if bad is not None:
                    self.verify_rejects += 1
                    reason = f"refused by verification ({bad})"
                    logger.warning(
                        "skipping checkpoint %s: %s — falling back to "
                        "the previous generation", path, reason,
                    )
                    self.skipped.append((path, reason))
                    continue
            return header, arrays
        return None
