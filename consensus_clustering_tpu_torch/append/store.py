"""Persistent, digest-verified plane store for incremental consensus.

A copy of the reference package's ``append/store.py`` (the port imports
nothing of that package); the port's manifests also name the ``backend``
that wrote them (:func:`..utils.checkpoint.backend_tag`), which
:func:`.engine.check_compat` holds an append to.

A completed packed exact run's accumulator state — the per-K uint32
co-membership bit-planes and the Iij co-sampling plane — IS the
sufficient statistic for every curve the service serves: Mij/Iij are
pure popcounts over it.  This module persists that state as a
**generation** on disk so a later row-append job can reuse the old
lanes' counts exactly instead of re-running them.

Layout (one directory per parent run, never inside a checkpoint ring,
which a completed fit clears)::

    <dir>/gen-00000000/arrays.npz      # planes + coplanes, uint32
    <dir>/gen-00000000/manifest.json   # schema, shapes, digests, lineage
    <dir>/gen-00000001/...             # after the first append, etc.

Each generation is CUMULATIVE: its arrays carry every lane generation
merged along the word axis, so a reader needs exactly one generation —
the newest verifiable one — never a reconstruction across files.

Write protocol (crash-mid-append safety, the chaos contract): arrays
first, manifest last, each via unique-tmp + ``os.replace``.  A torn
write therefore leaves either no manifest (the generation is invisible)
or a manifest whose per-array digests no longer match (the generation
is REFUSED at load).  :meth:`PlaneStore.load_latest` walks generations
newest-first and returns the first one that verifies; if none does it
raises :class:`PlaneStoreError` and the caller falls back to a full
recompute — generations are never silently mixed with unverified bytes.

Digests reuse :func:`..utils.checkpoint.data_fingerprint` (sha256 over
dtype + shape + raw bytes), the primitive the checkpoint fingerprints
trust.  Arrays are stored as uint32, the reference's layout; the port's
int32 bit patterns are viewed, never converted.

numpy + stdlib at write and read time.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from consensus_clustering_tpu_torch.utils.checkpoint import data_fingerprint

#: Manifest schema tag; bump on any layout change so old stores refuse
#: loudly instead of deserialising garbage.
STORE_SCHEMA = "planes-v1"

_GEN_PREFIX = "gen-"
_ARRAYS = ("planes", "coplanes")


def as_uint32(a) -> np.ndarray:
    """uint32 words of a plane array: int32 bit patterns are viewed."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return np.ascontiguousarray(a, dtype=np.uint32)


class PlaneStoreError(Exception):
    """The store (or a specific generation) failed verification.

    ``reason`` is a stable machine-readable code, so a caller can tell a torn write (``digest_mismatch``) from a store
    that never existed (``no_store``) from a schema skew
    (``schema_mismatch``) without reading logs.
    """

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(
            f"plane store: {reason}" + (f" ({detail})" if detail else "")
        )


class PlaneStore:
    """One parent run's plane-store directory (see module docstring)."""

    def __init__(self, directory: str):
        self.directory = str(directory)

    # -- enumeration ----------------------------------------------------

    def generations(self) -> List[int]:
        """Generation numbers present on disk (ascending; a generation
        counts as present once its directory exists — verification is
        load-time, not listing-time)."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        gens = []
        for name in names:
            if name.startswith(_GEN_PREFIX):
                try:
                    gens.append(int(name[len(_GEN_PREFIX):]))
                except ValueError:
                    continue
        return sorted(gens)

    def _gen_dir(self, generation: int) -> str:
        return os.path.join(
            self.directory, f"{_GEN_PREFIX}{int(generation):08d}"
        )

    # -- write ----------------------------------------------------------

    def write_generation(
        self,
        generation: int,
        manifest: Dict[str, Any],
        arrays: Dict[str, np.ndarray],
    ) -> str:
        """Atomically persist one cumulative generation; returns its dir.

        ``manifest`` is the caller's metadata (lineage, config payload,
        ``h_done``, data fingerprint...); schema tag, shapes, digests
        and the write timestamp are stamped here so they can never
        drift from the bytes actually written.  Order matters: arrays
        land (tmp + replace) BEFORE the manifest — the manifest's
        existence is the generation's commit point.
        """
        missing = [k for k in _ARRAYS if k not in arrays]
        if missing:
            raise ValueError(f"write_generation missing arrays {missing}")
        gen_dir = self._gen_dir(generation)
        os.makedirs(gen_dir, exist_ok=True)
        payload = {key: as_uint32(arrays[key]) for key in _ARRAYS}
        arrays_path = os.path.join(gen_dir, "arrays.npz")
        tmp = f"{arrays_path}.{uuid.uuid4().hex}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, arrays_path)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        record = dict(manifest)
        record["schema"] = STORE_SCHEMA
        record["generation"] = int(generation)
        record["shapes"] = {
            key: list(payload[key].shape) for key in _ARRAYS
        }
        record["digests"] = {
            key: data_fingerprint(payload[key]) for key in _ARRAYS
        }
        record["written_at"] = round(time.time(), 3)
        manifest_path = os.path.join(gen_dir, "manifest.json")
        tmp = f"{manifest_path}.{uuid.uuid4().hex}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(record, f, sort_keys=True)
            os.replace(tmp, manifest_path)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        return gen_dir

    # -- read -----------------------------------------------------------

    def _load_generation(
        self, generation: int
    ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """Load + verify ONE generation; raises PlaneStoreError."""
        gen_dir = self._gen_dir(generation)
        manifest_path = os.path.join(gen_dir, "manifest.json")
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise PlaneStoreError("manifest_unreadable", str(e))
        if manifest.get("schema") != STORE_SCHEMA:
            raise PlaneStoreError(
                "schema_mismatch",
                f"got {manifest.get('schema')!r}, want {STORE_SCHEMA!r}",
            )
        try:
            with np.load(os.path.join(gen_dir, "arrays.npz")) as z:
                arrays = {key: np.asarray(z[key]) for key in _ARRAYS}
        except (
            OSError, ValueError, KeyError, EOFError,
            # A mid-file bit flip fails the member CRC during the lazy
            # read — zipfile raises BadZipFile (NOT an OSError), and the
            # torn-write contract demands it degrade like any other
            # unreadable-arrays verdict.
            zipfile.BadZipFile,
        ) as e:
            raise PlaneStoreError("arrays_unreadable", str(e))
        digests = manifest.get("digests") or {}
        for key in _ARRAYS:
            got = data_fingerprint(
                np.ascontiguousarray(arrays[key], dtype=np.uint32)
            )
            if got != digests.get(key):
                # The torn-write / bit-rot verdict: the manifest
                # committed different bytes than the ones on disk.
                raise PlaneStoreError(
                    "digest_mismatch",
                    f"{key}: {got} != {digests.get(key)}",
                )
        return manifest, arrays

    def load_latest(
        self,
    ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """The newest generation that VERIFIES (manifest present, schema
        current, every array matching its committed digest).

        Walks newest-first: a crash mid-append leaves at worst one torn
        tail generation, and the previous one — untouched by the append
        protocol — still verifies.  Raises :class:`PlaneStoreError`
        with reason ``no_store`` (nothing on disk) or the LAST
        per-generation failure when nothing verifies: the caller's
        contract is full recompute, never a partial read.
        """
        gens = self.generations()
        if not gens:
            raise PlaneStoreError("no_store", self.directory)
        last_error: Optional[PlaneStoreError] = None
        for generation in reversed(gens):
            try:
                return self._load_generation(generation)
            except PlaneStoreError as e:
                last_error = e
        assert last_error is not None
        raise last_error

    def clear(self) -> None:
        """Drop the whole store (tests / operator retention tooling)."""
        try:
            shutil.rmtree(self.directory)
        except OSError:
            pass
