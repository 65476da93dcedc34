# Ported from consensus_clustering_tpu/autotune/store.py.
"""Calibration store, the read side: schema-versioned, parity-gated
performance records that the autotune policy and the scheduler read.

Every measured knob recommendation (``stream_h_block`` for the serve
path) lives in one JSON record keyed by **environment fingerprint ×
shape bucket × knob**.  The environment fingerprint (the GPU's name, the
CUDA driver, the torch and CUDA versions, the device count) mirrors
``utils/checkpoint.stream_fingerprint``'s refuse-foreign-state rule: a
number tuned on one stack must never silently steer another —
:meth:`CalibrationStore.get` only ever resolves records whose embedded
fingerprint matches the *current* environment, and raises
:class:`ForeignFingerprintError` on a record whose content disagrees
with where it sits (a copied/renamed file).  A record carries
``schema_version``; a version the reader does not understand is a loud
:class:`SchemaVersionError`, never a silently misparsed knob.

The write side (the probes, ``make_record`` and ``save``) is not ported
yet (ROADMAP A12), so a store holds only records written elsewhere.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Sequence

SCHEMA_VERSION = 1


class CalibrationError(ValueError):
    """A calibration record or store operation is invalid."""


class SchemaVersionError(CalibrationError):
    """Record written under a schema this reader does not understand."""


class ForeignFingerprintError(CalibrationError):
    """Record belongs to a different environment than it claims / than
    the store resolving it."""


def environment() -> Dict[str, Any]:
    """The identity of the stack a measurement is valid for: the GPU's
    name, the CUDA driver, the torch and CUDA versions and the device
    count (``device_kind`` ``cpu``, no driver, on a machine without one).

    ``device_count`` rides along because several knobs are per-device
    quantities (``cluster_batch`` applies to each device's LOCAL
    resample shard — SweepConfig docs — so a value tuned on one layout
    can silently stop sub-batching on a wider mesh).
    """
    import torch

    on_cuda = torch.cuda.is_available()
    driver = getattr(torch._C, "_cuda_getDriverVersion", None)
    return {
        "device_kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
        "backend": "torch-cuda" if on_cuda else "torch-cpu",
        "driver_version": driver() if on_cuda and driver else None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_count": torch.cuda.device_count() if on_cuda else 1,
    }


def env_fingerprint(env: Optional[Dict[str, Any]] = None) -> str:
    """16-hex digest of :func:`environment` (the record key component)."""
    payload = environment() if env is None else env
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def shape_bucket(
    n: int, d: int, h: int, k_values: Sequence[int]
) -> str:
    """Filesystem-safe bucket string for a sweep shape.

    Matching is EXACT: a record calibrated at one bucket never steers a
    different shape (nearest-bucket interpolation is future work, and
    doing it silently would break the provenance story).
    """
    ks = sorted(int(k) for k in k_values)
    return f"n{int(n)}_d{int(d)}_h{int(h)}_k{ks[0]}-{ks[-1]}"


def load_record(
    path: str, expect_env: Optional[str] = None
) -> Dict[str, Any]:
    """Read + validate one record file.

    ``expect_env`` enforces the refuse-foreign-fingerprint rule: the
    record's embedded fingerprint must equal it, or the record is
    refused even if someone copied the file into this environment's
    slot.
    """
    try:
        with open(path) as f:
            record = json.load(f)
    except (OSError, ValueError) as e:
        raise CalibrationError(f"unreadable calibration record {path}: {e}")
    if not isinstance(record, dict):
        raise CalibrationError(
            f"calibration record {path} is not a JSON object"
        )
    version = record.get("schema_version")
    if version != SCHEMA_VERSION:
        raise SchemaVersionError(
            f"calibration record {path} has schema_version={version!r}, "
            f"this reader understands {SCHEMA_VERSION}; refusing to "
            "guess at its fields"
        )
    if expect_env is not None and record.get("env_fingerprint") != expect_env:
        raise ForeignFingerprintError(
            f"calibration record {path} was measured on a different "
            f"stack (env_fingerprint {record.get('env_fingerprint')!r} "
            f"!= {expect_env!r}); a foreign number must not steer this "
            "environment"
        )
    return record


class CalibrationStore:
    """Directory of calibration records, one file per
    (environment, knob, bucket).

    ``env`` defaults to the live :func:`environment`; tests inject a
    synthetic one.  A directory that does not exist holds no records.
    """

    def __init__(
        self, directory: str, env: Optional[Dict[str, Any]] = None
    ):
        self.directory = directory
        self.env = environment() if env is None else dict(env)
        self.env_fp = env_fingerprint(self.env)

    def _path(self, knob: str, bucket: str, env_fp: str) -> str:
        return os.path.join(
            self.directory, f"{env_fp}__{knob}__{bucket}.json"
        )

    def get(
        self, knob: str, bucket: str
    ) -> Optional[Dict[str, Any]]:
        """The CURRENT environment's record for (knob, bucket), or None.

        Foreign environments cannot match by construction (the
        fingerprint keys the filename), and a file whose content
        disagrees with its slot raises :class:`ForeignFingerprintError`
        rather than resolving — the stream-checkpoint refusal rule.
        """
        path = self._path(knob, bucket, self.env_fp)
        if not os.path.exists(path):
            return None
        record = load_record(path, expect_env=self.env_fp)
        if record.get("knob") != knob or record.get("bucket") != bucket:
            # A record copied/renamed into another slot must not steer
            # it (e.g. an adaptive_tol float sitting in a
            # stream_h_block slot) — same refusal class as a foreign
            # environment.
            raise ForeignFingerprintError(
                f"calibration record {path} claims "
                f"({record.get('knob')!r}, {record.get('bucket')!r}) "
                f"but sits in the ({knob!r}, {bucket!r}) slot; refusing "
                "a mislabelled record"
            )
        return record
