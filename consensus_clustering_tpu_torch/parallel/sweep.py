"""The K sweep: resample -> cluster -> count -> analyse, on a mesh.

The port of the reference package's ``parallel/sweep.py``:

- the resample plan is drawn once from ``split(PRNGKey(seed))[0]`` and is
  shared by every K (so Iij is computed once);
- per K, each resample's clusterer key is ``fold_in(key_cluster, k)`` (and
  ``fold_in(., h)`` under ``reseed_clusterer_per_resample``), the lanes are
  clustered in ``cluster_batch`` groups, and Mij, Cij, the histogram
  (the kernel of :mod:`..ops.hist` on the card) and the curves follow;
- ``pac_area`` is re-derived from the assembled CDF, as the reference does;
- with ``accum_repr="packed"`` Mij and Iij come from bit-planes through the
  popcount kernel (:mod:`..ops.popcount`), the same counts bit for bit;
- on a ('k', 'h', 'n') mesh (:mod:`.mesh`; default one device, the
  1 x 1 x 1 mesh, which is the single-device path) the lanes, row blocks
  and K values split over the shards by :func:`sweep_geometry`, and every
  mesh gives the one-device result bit for bit (:func:`build_sweep`).

Where the reference compiles one program, this runs eagerly; the Lloyd loop
checks on the host after each step whether any lane is still running.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.models.kmeans import (
    lloyd_counts,
    lloyd_since,
)
from consensus_clustering_tpu_torch.models.protocol import Clusterer
from consensus_clustering_tpu_torch.obs.tracing import region
from consensus_clustering_tpu_torch.ops import _build, launch_counts
from consensus_clustering_tpu_torch.ops.analysis import (
    cdf_pac_from_counts,
    consensus_matrix,
)
from consensus_clustering_tpu_torch.ops.bitpack import (
    coassoc_counts_packed,
    cosample_counts_packed,
)
from consensus_clustering_tpu_torch.ops.coassoc import coassociation_counts
from consensus_clustering_tpu_torch.ops.hist import consensus_hist_counts
from consensus_clustering_tpu_torch.ops.popcount import packed_coassoc_counts
from consensus_clustering_tpu_torch.ops.resample import (
    cosample_counts,
    resample_indices,
)
from consensus_clustering_tpu_torch.parallel.mesh import (
    KSHARD_AXIS,
    RESAMPLE_AXIS,
    ROW_AXIS,
    Mesh,
    engine_mesh,
)
from consensus_clustering_tpu_torch.utils.metrics import (
    device_memory_stats,
    peak_memory_window,
)

logger = logging.getLogger(__name__)

#: The CUDA sources every sweep builds before it runs on the card.
KERNELS = ("hist", "lloyd", "popcount", "fused_block")


def build_kernels(device: torch.device) -> float:
    """Build the kernels for a run on ``device`` (nothing on the CPU);
    returns the seconds it took (0 when they are built already)."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        _build.build(KERNELS)
    return time.perf_counter() - t0


def kernel_route(device: torch.device) -> str:
    """``cuda`` where the wrappers launch their kernels, ``plain`` where
    they take their plain versions (CPU tensors)."""
    return "cuda" if device.type == "cuda" else "plain"


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    """Each kernel's launches since the :func:`..ops.launch_counts`
    snapshot ``before``."""
    return {name: n - before[name] for name, n in launch_counts().items()}


def resample_lane_keys(
    config: SweepConfig, key_cluster: torch.Tensor, k: int,
    h_global: torch.Tensor,
) -> torch.Tensor:
    """(H, 2) clusterer keys for one K over GLOBAL resample ids (H,).

    ``fold_in(key_cluster, k)``, then ``fold_in(., h)`` per resample under
    ``reseed_clusterer_per_resample``; otherwise every resample re-seeds
    identically, as the reference does.
    """
    key_k = rng.fold_in(key_cluster, k)
    if config.reseed_clusterer_per_resample:
        return rng.fold_in(key_k, h_global)
    return key_k.expand(h_global.shape[0], 2)


def fit_resample_lanes(
    clusterer: Clusterer,
    config: SweepConfig,
    keys: torch.Tensor,
    x_sub: torch.Tensor,
    k: int,
    k_max: int,
    return_centroids: bool = False,
) -> torch.Tensor:
    """(H, n_sub) labels of every resample for one K, or with
    ``return_centroids`` the (H, k_max, d) final centroids of each
    resample's best restart (the clusterer's ``fit(...)[1]``, the fused
    block step's input).

    ``cluster_batch`` groups the resamples so each group's Lloyd loop stops
    at its own slowest lane; ``split_init`` seeds every lane in one batch
    first.  Results are identical either way: they are a pure per-lane
    function of (key, x_sub, k).
    """
    def fit(keys_g, x_g, **kwargs):
        if return_centroids:
            return clusterer.fit(keys_g, x_g, k, k_max, **kwargs)[1]
        return clusterer.fit_predict(keys_g, x_g, k, k_max, **kwargs)

    h = x_sub.shape[0]
    batch = config.cluster_batch
    if batch is None or batch >= h:
        return fit(keys, x_sub)
    groups = [slice(s, min(s + batch, h)) for s in range(0, h, batch)]
    if config.split_init and hasattr(clusterer, "init_centroids"):
        inits = clusterer.init_centroids(keys, x_sub, k, k_max)
        parts = [fit(keys[g], x_sub[g], init_centroids=inits[g])
                 for g in groups]
    else:
        parts = [fit(keys[g], x_sub[g]) for g in groups]
    return torch.cat(parts)


def curves_from_counts(
    config: SweepConfig, counts_per_k
) -> Dict[str, torch.Tensor]:
    """Stacked per-K ``hist`` and ``cdf`` (nK, bins) from each K's strict
    upper-triangle bin counts, and ``pac_area`` (nK,) re-derived from the
    stacked CDF, as the reference does."""
    lo, hi = config.pac_idx
    hists, cdfs = [], []
    for counts in counts_per_k:
        hist_k, cdf_k, _ = cdf_pac_from_counts(
            counts, config.n_samples, lo, hi, config.parity_zeros
        )
        hists.append(hist_k)
        cdfs.append(cdf_k)
    cdf = torch.stack(cdfs)
    return {"hist": torch.stack(hists), "cdf": cdf,
            "pac_area": cdf[:, hi - 1] - cdf[:, lo]}


class SweepGeometry(NamedTuple):
    """The mesh geometry of a sweep (reference ``SweepGeometry``): N padded
    to ``n_pad = n_local * n_r`` rows over 'n', the H rows of a program
    (the whole plan, or a stream's block) padded to ``h_pad`` over the
    ('h' x 'n') shards with ``local_h`` lanes each (padded rows are -1),
    and the K list padded to a multiple of the k-groups with repeats of
    its last K, optionally laid out round-robin (``k_unperm`` maps each K
    position to its row in the padded, permuted list).  One
    implementation for every engine: their bit parity rests on it."""

    n_h: int
    n_r: int
    n_k: int
    n_local: int
    n_pad: int
    h_pad: int
    local_h: int
    n_ks: int
    k_values_pad: Tuple[int, ...]
    k_unperm: Optional[np.ndarray]

    def k_original(self) -> List[int]:
        """The K position of each row of ``k_values_pad`` (>= ``n_ks``:
        padding)."""
        if self.k_unperm is None:
            return list(range(len(self.k_values_pad)))
        return [int(i) for i in np.argsort(self.k_unperm)]


def sweep_geometry(config: SweepConfig, mesh: Mesh,
                   h_rows: int) -> SweepGeometry:
    """:class:`SweepGeometry` for ``h_rows`` resample rows on ``mesh``
    (``config.n_iterations`` for the monolithic sweep, the block size for
    the streaming engines); the reference's arithmetic, with its warning
    when ``cluster_batch`` no longer splits a shard's lanes."""
    n_h = mesh.shape[RESAMPLE_AXIS]
    n_r = mesh.shape[ROW_AXIS]
    n_k = mesh.shape[KSHARD_AXIS]
    n = config.n_samples
    n_local = -(-n // n_r)
    n_pad = n_local * n_r
    h_pad = -(-h_rows // (n_h * n_r)) * (n_h * n_r)
    local_h = h_pad // (n_h * n_r)
    # cluster_batch applies to each device's LOCAL lanes: a value tuned
    # on one layout silently stops sub-batching on a wider mesh.
    if (config.cluster_batch is not None
            and config.cluster_batch >= local_h):
        logger.warning(
            "cluster_batch=%d >= the per-device resample shard (%d of "
            "%d rows over %d devices): sub-batching is a no-op on this "
            "mesh layout, equivalent to cluster_batch=None; re-tune at "
            "the deployment mesh (SweepConfig.cluster_batch docs)",
            config.cluster_batch, local_h, h_rows, n_h * n_r,
        )
    n_ks = len(config.k_values)
    k_local = -(-n_ks // n_k)
    k_values_pad = tuple(config.k_values) + (config.k_values[-1],) * (
        k_local * n_k - n_ks
    )
    # Round-robin: group g runs k_values_pad[g::n_k].
    if config.k_interleave and n_k > 1:
        perm = [g + j * n_k for g in range(n_k) for j in range(k_local)]
        k_values_pad = tuple(k_values_pad[i] for i in perm)
        k_unperm = np.argsort(np.asarray(perm))
    else:
        k_unperm = None
    return SweepGeometry(
        n_h=n_h, n_r=n_r, n_k=n_k, n_local=n_local, n_pad=n_pad,
        h_pad=h_pad, local_h=local_h, n_ks=n_ks,
        k_values_pad=k_values_pad, k_unperm=k_unperm,
    )


def shard_lanes(geo: SweepGeometry, coord) -> slice:
    """The rows of a (padded) plan that shard ``coord`` clusters: global
    rows are blocked 'h'-major, then 'n'."""
    start = (coord[1] * geo.n_r + coord[2]) * geo.local_h
    return slice(start, start + geo.local_h)


def row_lanes(geo: SweepGeometry, h: int) -> slice:
    """The rows of 'h' row ``h``: its ``n_r`` shards' lanes in order."""
    start = h * geo.n_r * geo.local_h
    return slice(start, start + geo.n_r * geo.local_h)


def valid_lanes(geo: SweepGeometry, coord, h_total: int,
                h_start: int = 0) -> int:
    """How many of shard ``coord``'s lanes are real resamples (global id <
    ``h_total``); the rest are padding, which is never clustered."""
    first = h_start + shard_lanes(geo, coord).start
    return max(0, min(geo.local_h, h_total - first))


def lane_ids(geo: SweepGeometry, coord, h_start: int,
             device) -> torch.Tensor:
    """The global resample ids of shard ``coord``'s lanes (int64)."""
    lanes = shard_lanes(geo, coord)
    return h_start + torch.arange(lanes.start, lanes.stop, dtype=torch.int64,
                                  device=device)


def padded_plan(indices: torch.Tensor, h_pad: int) -> torch.Tensor:
    """The plan with rows up to ``h_pad`` appended as -1 (padding)."""
    pad = h_pad - indices.shape[0]
    if pad <= 0:
        return indices
    return torch.cat([indices, indices.new_full((pad, indices.shape[1]),
                                                -1)])


def local_column(mesh: Mesh, g: int, r: int):
    """This process's shards of the 'h' column (g, ., r)."""
    return [c for c in mesh.axis((g, 0, r), RESAMPLE_AXIS)
            if mesh.is_local(c)]


class DeviceCopies:
    """Copies of the inputs every shard reads (the data, the plan, the
    keys) on each distinct device of a mesh, made once per run:
    ``copies(t, coord)`` is ``t`` on ``coord``'s device.  A virtual mesh
    makes no copy."""

    def __init__(self, mesh: Mesh):
        self._mesh = mesh
        # (id, device) -> (source, copy): the source is held so that its
        # id is not reused while the copy is cached.
        self._made: Dict[Tuple[int, str], Tuple[torch.Tensor,
                                                torch.Tensor]] = {}

    def __call__(self, t: torch.Tensor, coord) -> torch.Tensor:
        dev = self._mesh.device(coord)
        if t.device == dev:
            return t
        key = (id(t), str(dev))
        if key not in self._made:
            self._made[key] = (t, t.to(dev, non_blocking=True))
        return self._made[key][1]


def build_sweep(
    clusterer: Clusterer, config: SweepConfig, device=None,
    progress_callback: Optional[Callable[[int, float], None]] = None,
    mesh: Optional[Mesh] = None,
) -> Callable[[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """Return ``sweep(x, key) -> dict`` on ``mesh`` (default: the one
    device ``device``, ``cuda`` unless named).

    The dict holds, stacked over ``config.k_values``: ``pac_area`` (nK,),
    ``hist`` and ``cdf`` (nK, bins), and with ``store_matrices`` also
    ``iij`` (N, N) and ``mij``/``cij`` (nK, N, N), on the mesh's primary
    device.

    On a mesh (reference ``build_sweep``'s ``local_body``): shard (g, h,
    r) clusters lanes ``(h * n_r + r) * local_h ...`` of the (padded) plan
    for its k-group's Ks, keyed by the global resample id; the labels are
    gathered along 'n', each shard counts the (n_local, n_pad) row block
    ``r`` of Mij and Iij over its 'h' row's resamples, the blocks are
    summed over 'h', B1 bins each row block at ``row_offset = r *
    n_local`` and the counts are summed over 'n'.  The per-K rows are
    un-permuted, K padding cropped, and the curves derived from the
    assembled counts, so every mesh gives the one-device result bit for
    bit.  Shards run one after another from this thread.  Across
    processes each runs the k-groups and row blocks it holds a shard of;
    the Ks of k-groups it does not hold arrive by :meth:`..mesh.Mesh.
    merge_k`, so every process returns the whole result.

    ``progress_callback(k, pac)``, if given, is called once per K as soon
    as that K's curves exist (in K order without a 'k' axis, else in the
    order the k-groups run them), with the PAC the result reports; each
    call reads one value from the device.  Without it the sweep adds no
    work.
    """
    mesh = engine_mesh(mesh, device)
    geo = sweep_geometry(config, mesh, config.n_iterations)
    n = config.n_samples
    h_total = config.n_iterations
    k_max = config.k_max
    dtype = config.torch_dtype
    packed = config.accum_repr == "packed"
    k_local = len(geo.k_values_pad) // geo.n_k
    orig = geo.k_original()

    def sweep(x: torch.Tensor, key: torch.Tensor) -> Dict[str, torch.Tensor]:
        on = DeviceCopies(mesh)

        def primary(t):
            return t.to(mesh.primary, non_blocking=True)

        x = primary(x.to(dtype=dtype))
        pair = rng.split(key.to(mesh.primary))
        key_resample, key_cluster = pair[0], pair[1]
        indices = padded_plan(
            resample_indices(key_resample, n, h_total, config.n_sub),
            geo.h_pad)
        counts: Dict[int, torch.Tensor] = {}
        mijs: Dict[int, torch.Tensor] = {}
        iij_full = None
        for g in range(geo.n_k):
            if not mesh.holds(g):
                continue  # another process runs this k-group's Ks
            iij = {}
            with region("engine.accumulate"):
                for r in mesh.held_rows(g):
                    parts = {}
                    for c in local_column(mesh, g, r):
                        rows = on(indices, c)[row_lanes(geo, c[1])]
                        parts[c] = _cosample(rows, n, geo, r, packed)
                    iij[r] = mesh.psum(parts,
                                       mesh.axis((g, 0, r), RESAMPLE_AXIS))
            # Each k-group's Iij is the same: a group whose rows span
            # processes merges it with those processes.
            if config.store_matrices and (iij_full is None
                                          or mesh.rows_span(g)):
                full = primary(mesh.merge_rows(g, iij, dim=0))[:n, :n]
                iij_full = full if iij_full is None else iij_full
            shards = [c for c in mesh.coords() if c[0] == g
                      and mesh.is_local(c)]
            x_sub = {c: on(x, c)[on(indices, c)[shard_lanes(geo, c)]
                                  [:valid_lanes(geo, c, h_total)]]
                     for c in shards}
            for p in range(g * k_local, (g + 1) * k_local):
                if orig[p] >= geo.n_ks:
                    continue  # K padding: a repeat of the last K
                k = geo.k_values_pad[p]
                with region("engine.cluster"):
                    labels = {c: _shard_labels(clusterer, config, geo, c,
                                               on(key_cluster, c), k,
                                               x_sub[c], h_total)
                              for c in shards}
                lines = gather_lines(mesh, labels, g)
                owner_hist = {}
                mij_rows = {}
                for r in mesh.held_rows(g):
                    with region("engine.accumulate"):
                        parts = {}
                        for c in local_column(mesh, g, r):
                            rows = on(indices, c)[row_lanes(geo, c[1])]
                            row = lines[c[1]].to(mesh.device(c),
                                                 non_blocking=True)
                            parts[c] = _coassoc(row, rows, n, k_max, config,
                                                geo, r, packed)
                        mij = mesh.psum(parts,
                                        mesh.axis((g, 0, r), RESAMPLE_AXIS))
                        cij = consensus_matrix(mij, iij[r],
                                               row_offset=r * geo.n_local)
                    with region("engine.evaluate"):
                        owner_hist[r] = consensus_hist_counts(
                            cij, n, r * geo.n_local, config.bins)
                    if config.store_matrices:
                        mij_rows[r] = mij
                with region("engine.evaluate"):
                    counts[orig[p]] = primary(mesh.merge_rows(g, owner_hist))
                if progress_callback is not None:
                    _report(progress_callback, config, k, counts[orig[p]])
                if config.store_matrices:
                    mijs[orig[p]] = primary(
                        mesh.merge_rows(g, mij_rows, dim=0))[:n, :n]
        # Across processes that split 'k': the Ks other processes ran.
        group_of = k_positions_groups(geo)
        ran = set(counts)
        counts = mesh.merge_k(counts, group_of, torch.zeros(
            config.bins, dtype=torch.int32), mesh.primary)
        if config.store_matrices:
            mijs = mesh.merge_k(mijs, group_of, iij_full, mesh.primary)
        if progress_callback is not None:
            for i in sorted(set(counts) - ran):
                _report(progress_callback, config, config.k_values[i],
                        counts[i])
        with region("engine.evaluate"):
            out = curves_from_counts(config,
                                     [counts[i] for i in range(geo.n_ks)])
        if config.store_matrices:
            out["iij"] = iij_full
            out["mij"] = torch.stack([mijs[i] for i in range(geo.n_ks)])
            out["cij"] = torch.stack([consensus_matrix(m, iij_full)
                                      for m in out["mij"]])
        return out

    sweep.device = mesh.primary
    sweep.mesh = mesh
    return sweep


def _report(progress_callback, config: SweepConfig, k: int,
            counts: torch.Tensor) -> None:
    """``progress_callback(k, pac)`` from one K's assembled counts."""
    pac = curves_from_counts(config, [counts])["pac_area"]
    progress_callback(int(k), float(pac[0]))


def k_positions_groups(geo: SweepGeometry) -> List[int]:
    """The k-group that runs each K position (K padding dropped)."""
    k_local = len(geo.k_values_pad) // geo.n_k
    out = [0] * geo.n_ks
    for p, i in enumerate(geo.k_original()):
        if i < geo.n_ks:
            out[i] = p // k_local
    return out


def gather_lines(mesh: Mesh, parts: Dict[Any, torch.Tensor],
                 g: int) -> Dict[int, torch.Tensor]:
    """Each 'h' row of k-group ``g`` this process holds a shard of: its
    shards' ``parts`` (this process's; across processes every shard's)
    concatenated along 'n' in shard order, once a row, on the device of
    the row's first local shard."""
    out = {}
    for h in range(mesh.shape[RESAMPLE_AXIS]):
        line = mesh.axis((g, h, 0), ROW_AXIS)
        if mesh.owner(line) is not None:
            out[h] = mesh.all_gather(parts, line)
    return out


def _row_block(geo: SweepGeometry, r: int) -> Dict[str, int]:
    """The row-block arguments of the count builders for row shard ``r``
    (none on a mesh without an 'n' axis: the whole matrix)."""
    if geo.n_r == 1:
        return {}
    return {"n_cols": geo.n_pad, "row_start": r * geo.n_local,
            "n_rows": geo.n_local}


def _cosample(rows, n, geo, r, packed):
    if packed:
        return cosample_counts_packed(rows, n, popcount_fn=packed_coassoc_counts,
                                      **_row_block(geo, r))
    return cosample_counts(rows, n, **_row_block(geo, r))


def _coassoc(labels, rows, n, k_max, config, geo, r, packed):
    if packed:
        return coassoc_counts_packed(labels, rows, n, k_max,
                                     popcount_fn=packed_coassoc_counts,
                                     **_row_block(geo, r))
    return coassociation_counts(labels, rows, n, k_max, config.chunk_size,
                                **_row_block(geo, r))


def _shard_centroids(clusterer, config, geo, coord, key_cluster, k, x_sub,
                     h_start: int = 0):
    """(valid lanes, k_max, d) final centroids of shard ``coord``'s valid
    lanes for one K (the fused block step's input)."""
    nv = x_sub.shape[0]
    if nv == 0:
        return x_sub.new_zeros((0, config.k_max, config.n_features))
    keys = resample_lane_keys(config, key_cluster, k,
                              lane_ids(geo, coord, h_start,
                                       x_sub.device)[:nv])
    return fit_resample_lanes(clusterer, config, keys, x_sub, k,
                              config.k_max, return_centroids=True)


def _shard_labels(clusterer, config, geo, coord, key_cluster, k, x_sub,
                  h_total, h_start: int = 0):
    """(local_h, n_sub) labels of shard ``coord``'s lanes for one K, -1 on
    its padded lanes (which are not clustered: a lane's labels are a pure
    function of its key and subsample)."""
    dev = x_sub.device
    labels = torch.full((geo.local_h, config.n_sub), -1, dtype=torch.int64,
                        device=dev)
    nv = x_sub.shape[0]
    if nv:
        keys = resample_lane_keys(config, key_cluster, k,
                                  lane_ids(geo, coord, h_start, dev)[:nv])
        labels[:nv] = fit_resample_lanes(clusterer, config, keys, x_sub, k,
                                         config.k_max)
    return labels


def run_sweep(
    clusterer: Clusterer,
    config: SweepConfig,
    x: np.ndarray,
    seed: int,
    device=None,
    progress_callback: Optional[Callable[[int, float], None]] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """Run a sweep; return host (numpy) results plus a ``timing`` block
    (``progress_callback`` and ``mesh``: see :func:`build_sweep`).

    ``timing``: ``compile_seconds`` (building the CUDA kernels; 0 when
    already built or on the CPU), ``run_seconds`` (wall clock until every
    result is on the host, after ``torch.cuda.synchronize()``),
    ``resamples_per_second`` (H x nK / run_seconds), ``device_memory``
    (peak allocator bytes of this run on the primary device; {} on the
    CPU), ``device_memory_per_device`` (the same for each distinct device
    of the mesh this process holds), ``kernel_launches`` (launches of
    each kernel in this run), ``lloyd`` (the Lloyd loop's counts in this
    run, :func:`..models.kmeans.lloyd_counts`), ``mesh`` (its axis
    sizes), ``processes`` (how many processes the mesh spans) and, for a
    packed sweep, ``packed_kernel`` (``cuda`` or ``plain``).
    """
    sweep = build_sweep(clusterer, config, device, progress_callback, mesh)
    mesh = sweep.mesh
    device = mesh.primary
    on_cuda = device.type == "cuda"
    compile_seconds = build_kernels(device)
    x_dev = torch.as_tensor(np.asarray(x)).to(device)
    key = rng.prng_key(seed, device)
    with contextlib.ExitStack() as windows:
        for dev in mesh.local_devices:
            windows.enter_context(peak_memory_window(dev))
        launches0, lloyd0 = launch_counts(), lloyd_counts()
        with region("engine"):
            r0 = time.perf_counter()
            out = sweep(x_dev, key)
            with region("engine.evaluate"):
                host = {name: value.cpu().numpy()
                        for name, value in out.items()}
            for dev in mesh.local_devices:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            run_seconds = time.perf_counter() - r0
        total = config.n_iterations * len(config.k_values)
        host["timing"] = {
            "compile_seconds": compile_seconds,
            "run_seconds": run_seconds,
            "resamples_per_second": total / max(run_seconds, 1e-9),
            "device": (
                torch.cuda.get_device_name(device) if on_cuda else "cpu"
            ),
            "device_memory": device_memory_stats(device) if on_cuda else {},
            "device_memory_per_device": per_device_memory(mesh),
            "kernel_launches": launches_since(launches0),
            "lloyd": lloyd_since(lloyd0),
            "mesh": dict(mesh.shape),
            "processes": mesh.process_count,
        }
        if config.accum_repr == "packed":
            host["timing"]["packed_kernel"] = kernel_route(device)
        return host


def per_device_memory(mesh: Mesh) -> Dict[str, Dict[str, int]]:
    """Allocator statistics of each distinct CUDA device of ``mesh`` this
    process holds ({} on the CPU)."""
    return {str(dev): device_memory_stats(dev)
            for dev in mesh.local_devices if dev.type == "cuda"}
