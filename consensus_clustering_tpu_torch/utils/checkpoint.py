"""Per-K checkpoint / resume and the fingerprints of resumable state.

The port of the reference package's ``utils/checkpoint.py``.  Each
completed K saves an npz with its curves (and matrices, when kept), keyed
by a fingerprint of everything that determines them; a resumed fit runs
only the missing Ks and refuses a directory written by another sweep.

Both fingerprints carry a **backend tag**, ``torch-cuda`` or
``torch-cpu`` (the device type): the port's float clustering is not the
reference package's, and the card's kernels and the CPU's plain versions
are bit-identical only inside the kernels, so state from one backend is
never resumed by another.  The port's ``SweepConfig`` holds no device
field: the tag carries the device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from consensus_clustering_tpu_torch.config import SweepConfig

_META = "sweep_meta.json"


def backend_tag(device) -> str:
    """``torch-<device type>`` of the device a sweep runs on."""
    return f"torch-{torch.device(device).type}"


def _fingerprint(config: SweepConfig, seed: int, backend: str) -> str:
    """Identity of a completed K's result.

    Drops what shapes the work but never a count: ``k_values`` (each K's
    result is independent of its siblings: the plan is K-free),
    ``store_matrices``, ``chunk_size``, ``integrity_check_every`` (a pure
    observer), ``accum_repr`` (packed counts equal dense counts),
    ``use_packed_kernel`` and ``fuse_block`` (the same planes either
    way), ``k_interleave`` (the same counts on any mesh);
    ``stream_h_block`` is normalised to None (streamed full H equals
    the monolithic sweep bit for bit).  The adaptive knobs stay: they
    change ``h_effective``.
    """
    payload = dataclasses.asdict(config)
    payload["seed"] = seed
    payload["backend"] = backend
    for name in ("k_values", "store_matrices", "chunk_size",
                 "integrity_check_every", "accum_repr", "use_packed_kernel",
                 "fuse_block", "k_interleave"):
        payload.pop(name)
    payload["stream_h_block"] = None
    blob = json.dumps(payload, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def data_fingerprint(x: np.ndarray) -> str:
    """Content hash of a data matrix: dtype, shape and raw bytes."""
    x = np.ascontiguousarray(x)
    h = hashlib.sha256()
    h.update(str(x.dtype).encode())
    h.update(repr(x.shape).encode())
    h.update(x.tobytes())
    return h.hexdigest()[:16]


def stream_fingerprint(
    config: SweepConfig,
    seed: int,
    data_sha: str,
    *,
    backend: str,
    n_iterations: Optional[int] = None,
    adaptive_tol: Optional[float] = None,
    adaptive_patience: Optional[int] = None,
    adaptive_min_h: Optional[int] = None,
) -> str:
    """Identity of a streamed sweep's block-granular resume state.

    The per-K scheme, stricter: the data's content (``data_sha``), the K
    list (the state stacks every K), ``stream_h_block`` (the boundaries
    ``h_done`` snaps to) and ``accum_repr`` (the state IS the
    representation) stay in, and the resolved runtime H and adaptive knobs
    replace the build config's.  Dropped, as the reference drops them:
    ``store_matrices``, ``chunk_size``, ``use_packed_kernel``,
    ``integrity_check_every`` and ``fuse_block`` (fused and unfused steps
    write the same planes), and ``k_interleave``: frames hold the counts
    cropped and in K order, which no mesh changes.
    """
    payload = dataclasses.asdict(config)
    payload["seed"] = seed
    payload["backend"] = backend
    for name in ("store_matrices", "chunk_size", "use_packed_kernel",
                 "integrity_check_every", "fuse_block", "k_interleave"):
        payload.pop(name)
    payload["n_iterations"] = (
        config.n_iterations if n_iterations is None else int(n_iterations)
    )
    payload["adaptive_tol"] = (
        config.adaptive_tol if adaptive_tol is None else float(adaptive_tol)
    )
    payload["adaptive_patience"] = (
        config.adaptive_patience if adaptive_patience is None
        else int(adaptive_patience)
    )
    payload["adaptive_min_h"] = (
        config.adaptive_min_h if adaptive_min_h is None
        else int(adaptive_min_h)
    )
    blob = json.dumps(
        {"scheme": "stream-v1", "config": payload, "data_sha": data_sha},
        sort_keys=True,
    ).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def estimator_stream_fingerprint(
    config: SweepConfig,
    seed: int,
    data_sha: str,
    *,
    backend: str,
    n_pairs: int,
    n_iterations: Optional[int] = None,
    adaptive_tol: Optional[float] = None,
    adaptive_patience: Optional[int] = None,
    adaptive_min_h: Optional[int] = None,
) -> str:
    """Identity of a sampled-pair estimator's block-resume state.

    :func:`stream_fingerprint` (backend tag included) under its own scheme
    tag, ``estimator-v1``, with ``n_pairs``: pair counts at another sample
    size are another layout and another statistic, and the tag keeps
    estimator and streamed-sweep frames from resuming each other in a
    shared ring.  The pairs themselves are a pure function of the seed.
    """
    base = stream_fingerprint(
        config, seed, data_sha, backend=backend,
        n_iterations=n_iterations, adaptive_tol=adaptive_tol,
        adaptive_patience=adaptive_patience, adaptive_min_h=adaptive_min_h,
    )
    blob = json.dumps(
        {"scheme": "estimator-v1", "stream": base, "n_pairs": int(n_pairs)},
        sort_keys=True,
    ).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


#: The port's package family in every serving job's fingerprint: a port
#: result never dedups against a JAX-package result in a shared job store.
JOB_BACKEND = "torch"


def job_fingerprint(payload: Dict, x: np.ndarray) -> str:
    """Fingerprint of a serving job: the job's JSON config ``payload``
    (every semantics-bearing field, the seed included; the scheduler
    adds the executor's :func:`backend_tag`, so a card result and a CPU
    result never answer each other's job), the data's
    :func:`data_fingerprint` and the port's family (:data:`JOB_BACKEND`).
    Two submissions with equal payload and data collide, which is the
    dedup the job store wants; the reference's ``job_fingerprint`` of
    the same payload and data differs (its blob has no family).
    """
    blob = json.dumps(
        {"config": payload, "data_sha": data_fingerprint(x),
         "backend": JOB_BACKEND},
        sort_keys=True,
    ).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class SweepCheckpoint:
    """Directory of per-K npz checkpoints with a config fingerprint."""

    def __init__(self, directory: str, config: SweepConfig, seed: int,
                 backend: str):
        self.directory = directory
        self.fp = _fingerprint(config, seed, backend)
        os.makedirs(directory, exist_ok=True)
        meta_path = os.path.join(directory, _META)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                existing = json.load(f)
            if existing.get("fingerprint") != self.fp:
                raise ValueError(
                    f"checkpoint dir {directory} belongs to a different "
                    "sweep (config/seed/backend fingerprint mismatch: "
                    f"{existing.get('fingerprint')} != {self.fp}); use a "
                    "fresh directory"
                )
        else:
            with open(meta_path, "w") as f:
                json.dump(
                    {
                        "fingerprint": self.fp,
                        "config": dataclasses.asdict(config),
                        "seed": seed,
                        "backend": backend,
                    },
                    f, indent=1,
                )

    def _path(self, k: int) -> str:
        return os.path.join(self.directory, f"k{k:04d}.npz")

    def completed_ks(self) -> list:
        out = []
        for name in os.listdir(self.directory):
            # Strict k<digits>.npz only: a crash between save_k's write and
            # rename can leave k....npz.tmp.npz behind, which must not parse.
            if name.startswith("k") and name.endswith(".npz"):
                stem = name[1:-4]
                if stem.isdigit():
                    out.append(int(stem))
        return sorted(out)

    def save_k(self, k: int, entry: Dict[str, np.ndarray]):
        arrays = {
            name: np.asarray(val)
            for name, val in entry.items()
            if val is not None and name != "consensus_labels"
        }
        # np.savez appends ".npz" when missing, so the temp name must end
        # with it for os.replace to find the file it wrote.
        tmp = self._path(k) + ".tmp.npz"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, self._path(k))  # atomic: no torn checkpoints

    def load_k(self, k: int) -> Optional[Dict[str, np.ndarray]]:
        path = self._path(k)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {name: z[name] for name in z.files}
