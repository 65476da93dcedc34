"""The append engine: marginal-cost consensus for a grown dataset.

The port of the reference package's ``append/engine.py``.  ``run_append``
answers ``N_old -> N_new`` with only ``h_new`` fresh resample lanes on the
device: the parent's digest-verified plane store supplies every old
lane's counts exactly (:mod:`.store`), the fresh generation runs through
the packed streaming engine (:class:`..parallel.streaming.StreamingSweep`
with ``capture_state=True``: B2, the final assignment, B4 and B3 on the
card), :mod:`.mixing` merges the generations along the word axis, and the
merged curves, the Iij accounting check and the staleness verdict are
counted on the device (:mod:`..ops.tiles`: B3 and B1's count entry).
Unless disabled, the merged state is written back as the store's next
generation, atomically.

Seed discipline: generation ``g`` draws from :func:`generation_seed`
(``fold_in`` of the root seed with ``g``), so no appended lane replays an
earlier generation's resample stream.

Any verification failure (missing store, torn write, schema skew,
another backend's store, data-prefix or config mismatch) raises
:class:`.store.PlaneStoreError`; the caller's contract is a full
recompute, never a mix of generations that did not verify.  A port store
holds only the port's generations: a store the reference package wrote
enters one only through :func:`..convert.plane_store_from_jax`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.append.mixing import (
    merge_generations,
    widen_planes,
)
from consensus_clustering_tpu_torch.append.staleness import staleness_report
from consensus_clustering_tpu_torch.append.store import (
    PlaneStore,
    PlaneStoreError,
    as_uint32,
)
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.device import resolve_device
from consensus_clustering_tpu_torch.estimator.bounds import DEFAULT_DELTA
from consensus_clustering_tpu_torch.ops.popcount import packed_coassoc_counts
from consensus_clustering_tpu_torch.ops.tiles import (
    TILE_ROWS,
    plane_words,
    planes_curves,
)
from consensus_clustering_tpu_torch.utils.checkpoint import (
    backend_tag,
    data_fingerprint,
)

#: SweepConfig fields that must MATCH between the parent's stored config
#: and an append request for the generations to measure one statistic
#: (execution knobs such as stream_h_block are free to differ).
_COMPAT_FIELDS = (
    "k_values",
    "subsampling",
    "bins",
    "pac_interval",
    "parity_zeros",
    "dtype",
)


def generation_seed(seed: int, generation: int) -> int:
    """Generation ``g``'s lane seed: the root seed itself for generation
    0, else ``randint(fold_in(PRNGKey(seed), g), (), 0, 2**31 - 1)``, the
    reference's draw bit for bit."""
    if int(generation) == 0:
        return int(seed)
    key = rng.fold_in(rng.prng_key(int(seed)), int(generation))
    return int(rng.randint(key, (), 0, 2**31 - 1))


def config_payload(config: SweepConfig) -> Dict[str, Any]:
    """The JSON-able SweepConfig payload a manifest stores."""
    return dataclasses.asdict(config)


def config_from_manifest(
    manifest: Dict[str, Any],
    *,
    n_samples: int,
    n_iterations: int,
    stream_h_block: Optional[int] = None,
) -> SweepConfig:
    """The new generation's SweepConfig: statistic-shaping fields from the
    store, shape and lane budget the append's own, ``stream_h_block``
    overridable (default: the store's, else min(32, H)); packed, no
    matrices, no early stop (a generation runs its full budget)."""
    payload = dict(manifest["config"])
    payload["n_samples"] = int(n_samples)
    payload["n_iterations"] = int(n_iterations)
    payload["k_values"] = tuple(int(k) for k in payload["k_values"])
    payload["pac_interval"] = tuple(payload["pac_interval"])
    payload["store_matrices"] = False
    payload["adaptive_tol"] = None
    payload["accum_repr"] = "packed"
    if stream_h_block is not None:
        payload["stream_h_block"] = int(stream_h_block)
    if payload.get("stream_h_block") is None:
        payload["stream_h_block"] = max(1, min(32, int(n_iterations)))
    return SweepConfig(**payload)


def check_compat(
    manifest: Dict[str, Any],
    x: np.ndarray,
    *,
    backend: Optional[str] = None,
    **expected: Any,
) -> Optional[str]:
    """Reason the append CANNOT reuse this store, or None if it can.

    ``backend`` (a :func:`..utils.checkpoint.backend_tag`) must equal the
    manifest's: the reference package's manifests name none, and a store
    written on another device type holds other float clustering.
    ``expected`` holds the request's statistic-shaping fields (any of
    ``_COMPAT_FIELDS``, ``clusterer_name``, ``clusterer_options``); each
    one given must equal the stored one.  The first ``n_old`` rows of
    ``x`` must be byte-identical to the parent's data.
    """
    if backend is not None and manifest.get("backend") != backend:
        return f"backend_mismatch:{manifest.get('backend')}!={backend}"
    n_old = int(manifest.get("n", -1))
    n_new = int(x.shape[0])
    if n_old < 1:
        return "manifest_missing_n"
    if n_new < n_old:
        return f"shrunk_dataset:{n_new}<{n_old}"
    if int(x.shape[1]) != int(manifest.get("n_features", -1)):
        return "feature_count_mismatch"
    meta = manifest.get("clusterer") or {}
    want_name = expected.pop("clusterer_name", None)
    if want_name is not None and meta.get("name") != want_name:
        return "config_mismatch:clusterer"
    want_opts = expected.pop("clusterer_options", None)
    if want_opts is not None and dict(want_opts) != dict(
        meta.get("options") or {}
    ):
        return "config_mismatch:clusterer_options"
    stored = manifest.get("config") or {}
    for field in _COMPAT_FIELDS:
        want = expected.get(field)
        if want is None:
            continue
        have = stored.get(field)
        if isinstance(have, list):
            have = tuple(have)
        if isinstance(want, (list, tuple)):
            want = tuple(want)
        if have != want:
            return f"config_mismatch:{field}"
    prefix_sha = data_fingerprint(np.ascontiguousarray(x[:n_old]))
    if prefix_sha != manifest.get("data_sha"):
        return "data_prefix_mismatch"
    return None


def _base_manifest(
    config: SweepConfig,
    seed: int,
    data_sha: str,
    h_done: int,
    generations: List[Dict[str, Any]],
    backend: str,
    clusterer_meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    return {
        "n": int(config.n_samples),
        "n_features": int(config.n_features),
        "k_values": [int(k) for k in config.k_values],
        "seed": int(seed),
        "h_done": int(h_done),
        "data_sha": data_sha,
        "config": config_payload(config),
        "backend": backend,
        # Clusterer identity lives outside SweepConfig: recorded, or
        # cross-clusterer appends would verify.
        "clusterer": dict(clusterer_meta or {}),
        "generations": list(generations),
    }


def write_generation_zero(
    store: PlaneStore,
    x: np.ndarray,
    *,
    config: SweepConfig,
    seed: int,
    final_state: Dict[str, np.ndarray],
    h_done: int,
    backend: str,
    clusterer_meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Persist a completed packed run's captured state as the store's
    generation 0, written by ``backend``; returns the manifest."""
    manifest = _base_manifest(
        config, seed, data_fingerprint(np.ascontiguousarray(x)), h_done,
        [{"generation": 0, "h": int(h_done), "n": int(config.n_samples),
          "seed": int(seed)}],
        backend, clusterer_meta=clusterer_meta,
    )
    store.write_generation(0, manifest, final_state)
    return manifest


def _stream(clusterer, config: SweepConfig, x, seed: int, h: int, device,
            block_callback) -> Dict[str, Any]:
    """A packed streamed run capturing its planes (kernels built first)."""
    from consensus_clustering_tpu_torch.parallel.streaming import (
        StreamingSweep,
    )

    engine = StreamingSweep(clusterer, config, device=device)
    compile_seconds = engine.warmup()
    out = engine.run(x, int(seed), int(h), block_callback=block_callback,
                     capture_state=True)
    out["timing"]["compile_seconds"] = compile_seconds
    return out


def bootstrap_generation(
    x: np.ndarray,
    *,
    config: SweepConfig,
    clusterer,
    seed: int,
    n_iterations: Optional[int] = None,
    store: Optional[PlaneStore] = None,
    block_callback: Optional[Callable] = None,
    clusterer_meta: Optional[Dict[str, Any]] = None,
    device=None,
) -> Dict[str, Any]:
    """Run one packed exact stream from scratch on ``device`` (default
    ``cuda``), capture its planes (``final_state``) and, with ``store``,
    persist them as generation 0."""
    device = resolve_device(device)
    h = int(n_iterations if n_iterations is not None else config.n_iterations)
    out = _stream(clusterer, config, x, seed, h, device, block_callback)
    if "final_state" not in out:
        raise ValueError(
            "the parent stream stopped early and captured no planes; "
            "bootstrap a generation with adaptive_tol=None"
        )
    if store is not None:
        write_generation_zero(
            store, x, config=config, seed=int(seed),
            final_state=out["final_state"],
            h_done=int(out["streaming"]["h_effective"]),
            backend=backend_tag(device), clusterer_meta=clusterer_meta,
        )
        out["store_written"] = True
    return out


def iij_accounting_holds(
    merged: torch.Tensor, old: torch.Tensor, new: torch.Tensor,
    tile_rows: int = TILE_ROWS,
) -> bool:
    """``Iij(merged) == Iij(old) + Iij(new)`` exactly, for (W, N) int32
    co-sampling words on one device (``old`` widened to N), checked a row
    tile at a time through the popcount (B3 on the card)."""
    n = merged.shape[1]
    for r0 in range(0, n, tile_rows):
        tile = slice(r0, r0 + tile_rows)
        lhs = packed_coassoc_counts(merged[:, tile], merged)
        rhs = (packed_coassoc_counts(old[:, tile], old)
               + packed_coassoc_counts(new[:, tile], new))
        if not torch.equal(lhs, rhs):
            return False
    return True


def curves_for_planes(
    planes, coplanes, *, bins: int, pac_lo_idx: int, pac_hi_idx: int,
    parity_zeros: bool = True, device=None,
) -> Dict[str, List]:
    """Per-K ``pac_area``, ``cdf`` and ``hist`` lists of a full (nK, k_max,
    W, N) plane set, counted on ``device`` (default ``cuda``): the
    reference's ``mixing.curves_for_planes`` (its numpy copy is
    :func:`.mixing.curves_for_planes`) without the N x N matrices."""
    device = resolve_device(device)
    curves = planes_curves(plane_words(planes, device),
                           plane_words(coplanes, device), bins, pac_lo_idx,
                           pac_hi_idx, parity_zeros)
    return {"pac_area": [float(v) for v in curves["pac_area"]],
            "cdf": list(curves["cdf"]), "hist": list(curves["hist"])}


def run_append(
    store: PlaneStore,
    x: np.ndarray,
    *,
    h_new: int,
    clusterer,
    stream_h_block: Optional[int] = None,
    block_callback: Optional[Callable] = None,
    write_store: bool = True,
    delta: float = DEFAULT_DELTA,
    device=None,
    **expected: Any,
) -> Dict[str, Any]:
    """Answer an append request from a verified plane store, on ``device``
    (default ``cuda``).

    Loads the newest verified generation, checks it against the request
    (:func:`check_compat`, the backend included), runs ONLY ``h_new``
    fresh lanes over the grown data with the generation's seed, judges
    staleness over the old rows, merges the generations, checks the Iij
    accounting, computes the merged per-K curves and writes the next
    generation.  Raises :class:`PlaneStoreError` on any verification
    failure.  Returns ``pac_area``/``cdf``/``hist``, the new lanes'
    ``streaming`` and ``timing``, and the ``append`` disclosure (lineage,
    marginal accounting, the staleness verdict, ``run_seconds``).
    """
    device = resolve_device(device)
    manifest, old_arrays = store.load_latest()
    reason = check_compat(manifest, x, backend=backend_tag(device),
                          **expected)
    if reason is not None:
        raise PlaneStoreError(reason)

    n_new = int(x.shape[0])
    n_old = int(manifest["n"])
    h_old = int(manifest["h_done"])
    generation = int(manifest["generation"]) + 1
    root_seed = int(manifest["seed"])
    seed_g = generation_seed(root_seed, generation)
    config = config_from_manifest(manifest, n_samples=n_new,
                                  n_iterations=int(h_new),
                                  stream_h_block=stream_h_block)
    t0 = time.perf_counter()
    out = _stream(clusterer, config, x, seed_g, int(h_new), device,
                  block_callback)
    new_arrays = {name: as_uint32(v)
                  for name, v in out.pop("final_state").items()}
    h_eff = int(out["streaming"]["h_effective"])
    lo, hi = config.pac_idx

    staleness = staleness_report(
        old_arrays, new_arrays, n_old=n_old, k_values=config.k_values,
        h_old=h_old, h_new=h_eff, subsampling=config.subsampling,
        bins=config.bins, pac_lo_idx=lo, pac_hi_idx=hi,
        parity_zeros=config.parity_zeros, delta=delta, device=device,
    )
    merged = merge_generations([old_arrays, new_arrays], n_new)
    # The provable half of the mixing contract, checked on every append:
    # merged Iij == widened old Iij + new Iij, in exact integers.
    if not iij_accounting_holds(
        plane_words(merged["coplanes"], device),
        plane_words(widen_planes(old_arrays["coplanes"], n_new), device),
        plane_words(new_arrays["coplanes"], device),
    ):
        raise PlaneStoreError(
            "iij_accounting_violation",
            "merged Iij != old + new — refusing to serve mixed counts",
        )
    curves = curves_for_planes(
        merged["planes"], merged["coplanes"], bins=config.bins,
        pac_lo_idx=lo, pac_hi_idx=hi, parity_zeros=config.parity_zeros,
        device=device,
    )

    store_written = False
    if write_store:
        history = list(manifest.get("generations") or [])
        history.append({"generation": int(generation), "h": int(h_eff),
                        "n": int(n_new), "seed": int(seed_g)})
        next_manifest = _base_manifest(
            config, root_seed, data_fingerprint(np.ascontiguousarray(x)),
            h_old + h_eff, history, backend_tag(device),
            clusterer_meta=manifest.get("clusterer"),
        )
        store.write_generation(generation, next_manifest, merged)
        store_written = True
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    h_total = h_old + h_eff
    return {
        "pac_area": curves["pac_area"],
        "cdf": curves["cdf"],
        "hist": curves["hist"],
        "streaming": dict(out["streaming"]),
        "timing": dict(out.get("timing") or {}),
        "append": {
            "generation": int(generation),
            "parent_generation": int(manifest["generation"]),
            "n_old": n_old,
            "n_new": n_new,
            "dn": n_new - n_old,
            "h_old": h_old,
            "h_new": h_eff,
            "h_total": h_total,
            "marginal_lane_fraction": float(h_eff) / float(max(1, h_total)),
            "iij_bit_identical": True,
            "staleness": staleness,
            "store_written": store_written,
            "fallback": False,
            "run_seconds": time.perf_counter() - t0,
        },
    }
