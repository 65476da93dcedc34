# Ported from consensus_clustering_tpu/autotune/store.py.
"""Calibration store: schema-versioned, parity-gated performance records.

Every measured knob recommendation (``max_iter`` cap, ``cluster_batch``,
``split_init``, ``stream_h_block``, ``adaptive_tol``) lives here as one
JSON record keyed by **environment fingerprint × shape bucket × knob**.
The environment fingerprint (the GPU's name, the CUDA driver, the torch
and CUDA versions, the device count) mirrors
``utils/checkpoint.stream_fingerprint``'s refuse-foreign-state rule: a
number tuned on one stack must never silently steer another —
:meth:`CalibrationStore.get` only ever resolves records whose embedded
fingerprint matches the *current* environment, and raises
:class:`ForeignFingerprintError` on a record whose content disagrees
with where it sits (a copied/renamed file).  The file format is the
reference package's, but its environment has other fields, so a record
of one package is foreign to the other in both directions.

Records are written atomically (tmp + ``os.replace``, the jobstore /
checkpoint convention) and carry ``schema_version``; a version the
reader does not understand is a loud :class:`SchemaVersionError`, never
a silently misparsed knob.

The parity gate is structural: :meth:`CalibrationStore.save` refuses any
record whose ``parity`` section is missing or whose gate did not pass —
Monti et al. (2003) consensus matrices and the Şenbabaoğlu et al. (2014)
PAC criterion are the correctness bar, so an un-gated timing can never
become a recommendation (the probes in :mod:`.probes` construct records
through :func:`make_record`, which enforces the same rule earlier).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

SCHEMA_VERSION = 1

# Knobs the subsystem understands; save() rejects anything else so a
# probe typo cannot mint a record no resolver will ever read.
KNOWN_KNOBS = (
    "max_iter",
    "cluster_batch",
    "split_init",
    "stream_h_block",
    "adaptive_tol",
)


class CalibrationError(ValueError):
    """A calibration record or store operation is invalid."""


class SchemaVersionError(CalibrationError):
    """Record written under a schema this reader does not understand."""


class ForeignFingerprintError(CalibrationError):
    """Record belongs to a different environment than it claims / than
    the store resolving it."""


def environment(device=None) -> Dict[str, Any]:
    """The identity of the stack a measurement on ``device`` is valid
    for: the GPU's name, the CUDA driver, the torch and CUDA versions and
    the device count.  ``device`` None means ``cuda`` where a GPU is
    visible; a CPU device (or no GPU) gives ``device_kind`` ``cpu``, no
    driver and one device.

    ``device_count`` rides along because several knobs are per-device
    quantities (``cluster_batch`` applies to each device's LOCAL
    resample shard — SweepConfig docs — so a value tuned on one layout
    can silently stop sub-batching on a wider mesh).
    """
    import torch

    dev = None if device is None else torch.device(device)
    on_cuda = torch.cuda.is_available() if dev is None else dev.type == "cuda"
    return {
        "device_kind": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
        "backend": "torch-cuda" if on_cuda else "torch-cpu",
        "driver_version": _driver_version() if on_cuda else None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_count": torch.cuda.device_count() if on_cuda else 1,
    }


def _driver_version() -> int:
    """The CUDA driver's version (``cuDriverGetVersion``, e.g. 12080):
    torch reports the toolkit it was built with, not the driver."""
    import ctypes

    version = ctypes.c_int()
    status = ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(
        ctypes.byref(version))
    if status != 0:
        raise CalibrationError(f"cuDriverGetVersion failed ({status})")
    return version.value


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


def make_record(
    knob: str,
    bucket: str,
    value: Any,
    *,
    parity: Dict[str, Any],
    rate: Optional[float] = None,
    baseline_value: Any = None,
    baseline_rate: Optional[float] = None,
    probe: Optional[str] = None,
    env: Optional[Dict[str, Any]] = None,
    evidence: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble a schema-current record; raises unless the parity gate
    passed (the probes' single choke point for the never-ungated rule).
    """
    if knob not in KNOWN_KNOBS:
        raise CalibrationError(
            f"unknown knob {knob!r} (known: {KNOWN_KNOBS})"
        )
    if not isinstance(parity, dict) or "max_pac_delta" not in parity:
        raise CalibrationError(
            "parity section missing/malformed: a record must state the "
            "PAC comparison that gated it"
        )
    if not parity.get("passed"):
        raise CalibrationError(
            f"parity gate did not pass for {knob}@{bucket} "
            f"(max_pac_delta={parity.get('max_pac_delta')!r} vs "
            f"tolerance={parity.get('tolerance')!r}); refusing to mint "
            "a recommendation from it"
        )
    env = environment() if env is None else env
    record: Dict[str, Any] = {
        "schema_version": SCHEMA_VERSION,
        "knob": knob,
        "bucket": bucket,
        "env": dict(env),
        "env_fingerprint": env_fingerprint(env),
        "value": value,
        "parity": dict(parity),
    }
    if rate is not None:
        record["rate"] = round(float(rate), 2)
    if baseline_value is not None:
        record["baseline_value"] = baseline_value
    if baseline_rate is not None:
        record["baseline_rate"] = round(float(baseline_rate), 2)
        if rate:
            record["speedup"] = round(float(rate) / float(baseline_rate), 3)
    if probe is not None:
        record["probe"] = probe
    if evidence:
        record["evidence"] = evidence
    return record


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
    synthetic one, and the probes that of the device they measure on.
    The directory is created lazily on first save, and one that does not
    exist holds no records.
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

    def save(self, record: Dict[str, Any]) -> str:
        """Atomically persist a record; returns its path.

        Validation is the same gate :func:`make_record` applies — a
        hand-built dict does not get to skip it.
        """
        for field in ("knob", "bucket", "env_fingerprint", "parity"):
            if field not in record:
                raise CalibrationError(
                    f"record missing required field {field!r}"
                )
        if record.get("schema_version") != SCHEMA_VERSION:
            raise SchemaVersionError(
                f"refusing to write schema_version="
                f"{record.get('schema_version')!r} (current: "
                f"{SCHEMA_VERSION})"
            )
        if record["knob"] not in KNOWN_KNOBS:
            raise CalibrationError(f"unknown knob {record['knob']!r}")
        if not record["parity"].get("passed"):
            raise CalibrationError(
                "refusing to store a record whose parity gate did not "
                "pass"
            )
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(
            record["knob"], record["bucket"], record["env_fingerprint"]
        )
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)  # atomic: no torn records
        return path

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

    def records(
        self, all_envs: bool = True
    ) -> List[Tuple[str, Dict[str, Any]]]:
        """Every readable record as (path, record) — the ``show``/
        ``diff`` surface.  Unreadable/foreign-schema files are returned
        as (path, {"error": ...}) entries so an operator listing never
        hides a broken record."""
        out: List[Tuple[str, Dict[str, Any]]] = []
        if not os.path.isdir(self.directory):
            return out
        for name in sorted(os.listdir(self.directory)):
            if not name.endswith(".json") or name.endswith(".tmp"):
                continue
            path = os.path.join(self.directory, name)
            try:
                record = load_record(path)
            except CalibrationError as e:
                out.append((path, {"error": str(e)}))
                continue
            if not all_envs and record.get("env_fingerprint") != self.env_fp:
                continue
            out.append((path, record))
        return out
