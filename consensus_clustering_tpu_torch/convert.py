"""Carry the reference package's state across, so both compute the same thing.

The inputs are plain Python and numpy values, never JAX objects: pass
``dataclasses.asdict`` of a reference ``SweepConfig`` or ``KMeans``, and
``np.asarray(jax.random.key_data(key))`` for a key.  Initial centroids pass
as numpy arrays directly; an estimator's pair counts and a plane store's
generation pass as numpy arrays and directories.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.models.agglomerative import (
    AgglomerativeClustering,
)
from consensus_clustering_tpu_torch.models.gmm import GaussianMixture
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.models.spectral import SpectralClustering

# Reference SweepConfig fields with their defaults that this port can run
# only at those defaults (each belongs to a feature not ported yet).
_UNPORTED_DEFAULTS: Dict[str, Any] = {}
# Fields that only choose an execution strategy, never a result, and have
# no counterpart here (the port's kernels always serve the card).
_STRATEGY_ONLY = {"use_packed_kernel", "use_pallas"}


def config_from_jax(fields: Dict[str, Any]) -> SweepConfig:
    """A port :class:`SweepConfig` from ``dataclasses.asdict`` of the
    reference's; raises for a field set to an engine not ported yet."""
    own = {f for f in SweepConfig.__dataclass_fields__}
    kept = {}
    for name, value in fields.items():
        if name in own:
            kept[name] = tuple(value) if name in (
                "k_values", "pac_interval") else value
        elif name in _UNPORTED_DEFAULTS:
            if value != _UNPORTED_DEFAULTS[name]:
                raise NotImplementedError(
                    f"SweepConfig.{name}={value!r} is not ported yet"
                )
        elif name not in _STRATEGY_ONLY:
            raise ValueError(f"unknown SweepConfig field {name!r}")
    return SweepConfig(**kept)


def kmeans_from_jax(fields: Dict[str, Any]) -> KMeans:
    """A port :class:`KMeans` from the reference's fields.  Its kernel knobs
    (``use_pallas``, ``pallas_interpret``) have no counterpart: on the card
    the port's Lloyd step is always its kernel."""
    return KMeans(
        n_init=int(fields.get("n_init", 1)),
        max_iter=int(fields.get("max_iter", 100)),
        tol=float(fields.get("tol", 1e-4)),
    )


_CLUSTERERS = {
    "GaussianMixture": GaussianMixture,
    "AgglomerativeClustering": AgglomerativeClustering,
    "SpectralClustering": SpectralClustering,
}


def clusterer_from_jax(name: str, fields: Dict[str, Any]):
    """The port's clusterer of the reference class ``name`` (``KMeans``,
    ``GaussianMixture``, ``AgglomerativeClustering`` or
    ``SpectralClustering``) from ``dataclasses.asdict`` of the reference's;
    raises for a field the port's class does not have."""
    if name == "KMeans":
        return kmeans_from_jax(fields)
    if name not in _CLUSTERERS:
        raise ValueError(
            f"unknown clusterer {name!r}; choose KMeans or one of "
            f"{sorted(_CLUSTERERS)}"
        )
    cls = _CLUSTERERS[name]
    unknown = set(fields) - set(cls.__dataclass_fields__)
    if unknown:
        raise ValueError(f"{name} has no field(s) {sorted(unknown)}")
    return cls(**fields)


def key_from_jax(key_data: np.ndarray, device=None) -> torch.Tensor:
    """A port key (..., 2) int64 from ``jax.random.key_data`` (uint32)."""
    data = np.asarray(key_data)
    if data.shape[-1:] != (2,):
        raise ValueError(f"key data must end in a pair of words, got {data.shape}")
    return torch.as_tensor(data.astype(np.int64), device=device)


def planes_from_jax(planes: np.ndarray, device=None) -> torch.Tensor:
    """Reference uint32 bit-planes as the port's int32 tensor, the same 32
    bits in every word."""
    data = np.ascontiguousarray(np.asarray(planes))
    if data.dtype != np.uint32:
        raise ValueError(f"bit-planes must be uint32, got {data.dtype}")
    return torch.as_tensor(data.view(np.int32).copy(), device=device)


def state_from_jax(state: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """A reference ``StreamingSweep`` state (or a run's ``final_state``) as
    numpy arrays -> the port's state: uint32 planes become int32 bit
    patterns, int32 dense counts carry over as they are."""
    out = {}
    for name, value in state.items():
        data = np.asarray(value)
        if data.dtype == np.uint32:
            out[name] = planes_from_jax(data, device)
        else:
            out[name] = torch.as_tensor(data.astype(np.int32), device=device)
    return out


def pair_state_from_jax(arrays: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """A reference estimator's pair counts (a checkpoint frame's
    ``state_mij``/``state_iij``, or ``run(return_state=True)``'s
    ``pair_state`` ``mij``/``iij``) as the port's engine state: (nK, M) and
    (M,) int32 tensors."""
    def pick(name):
        value = arrays.get(f"state_{name}", arrays.get(name))
        if value is None:
            raise ValueError(f"no {name!r} or 'state_{name}' counts given")
        return torch.as_tensor(np.asarray(value).astype(np.int32),
                               device=device)

    state = {"mij": pick("mij"), "iij": pick("iij")}
    if state["mij"].dim() != 2 or state["iij"].shape != state["mij"].shape[1:]:
        raise ValueError(
            f"expected (nK, M) mij and (M,) iij, got "
            f"{tuple(state['mij'].shape)} and {tuple(state['iij'].shape)}"
        )
    return state


def plane_store_from_jax(source: str, destination: str, device=None):
    """Re-write the reference package's verified plane store at
    ``source`` as a port store at ``destination``, under the port's
    backend tag for ``device`` (default ``cuda``): the one route by which
    reference planes enter a port store (a port append refuses another
    backend's manifest).

    The newest generation that verifies is carried over with its number,
    lineage, seed and data fingerprint; its config becomes the port's
    (:func:`config_from_jax`).  Returns the written manifest.
    """
    from consensus_clustering_tpu_torch.append.store import PlaneStore
    from consensus_clustering_tpu_torch.device import resolve_device
    from consensus_clustering_tpu_torch.utils.checkpoint import backend_tag

    manifest, arrays = PlaneStore(source).load_latest()
    if manifest.get("backend") is not None:
        raise ValueError(
            f"{source} was written by backend {manifest['backend']!r}, not "
            "by the reference package"
        )
    record = {key: value for key, value in manifest.items()
              if key not in ("schema", "generation", "shapes", "digests",
                             "written_at")}
    record["config"] = dataclasses.asdict(config_from_jax(manifest["config"]))
    record["backend"] = backend_tag(resolve_device(device))
    generation = int(manifest["generation"])
    store = PlaneStore(destination)
    store.write_generation(generation, record, arrays)
    return store.load_latest()[0]
