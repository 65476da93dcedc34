"""The streaming H-block sweep: state kept on the device, H a runtime
argument, adaptive early stop.

The port of the reference package's ``parallel/streaming.py``, described
here on one device (on a mesh see :class:`StreamingSweep`).  The sweep runs
as blocks of ``stream_h_block`` resamples:

- **State on the device.**  Dense: per-K ``mij`` (nK, N, N) and ``iij``
  (N, N) int32.  Packed: per-K cluster bit-planes ``planes`` (nK, k_max,
  w_cap, n_pad2) and co-sample planes ``coplanes`` (w_cap, n_pad2), int32
  words holding uint32 bit patterns (:mod:`..ops.bitpack`), 1/32 the bytes;
  int32 Mij/Iij exist only as row tiles of ``tile_r`` rows, popcounted
  (:mod:`..ops.popcount`), histogrammed through their Cij
  (:func:`..ops.hist.consensus_hist_from_counts`) and dropped
  (:func:`..ops.tiles.packed_hist_counts`).  The
  state is updated in place (block b owns words ``b * wb .. b * wb + wb``).
- **H is a runtime argument.**  One engine serves any ``n_iterations``
  (packed: up to the capacity its build config's H sets).
- **Bit-exact at full H.**  Every draw folds its GLOBAL resample index
  (the plan's ``h_start``, the lane keys), labels are a pure per-lane
  function of (key, x_sub, k), and the counts are exact integers, so the
  streamed full-H Mij, Iij, cdf and pac_area equal the monolithic sweep's
  bit for bit, dense or packed.
- **Fused block step** (packed, ``fuse_block``): the clusterer returns its
  final centroids and :func:`..ops.fused_block.fused_assign_pack` assigns
  and packs every column against the block's own co-sample planes, so
  labels never reach device memory; the unfused step packs the labels.
  Both give the same planes bit for bit.
- **Adaptive early stop** (:func:`adaptive_decision`), with the reference's
  rule, on the per-block PAC trajectory.
- **Resilience** (:mod:`..resilience`): a ring of block checkpoints the
  run resumes from bit for bit (the state is updated in place, so each
  checkpointed block's state is copied to the host before the next block
  launches), the accumulator invariant sentinel every
  ``integrity_check_every`` blocks, and the ``block_start`` and
  ``accumulator`` fault points.

The reference pipelines its driver (block b+1 is dispatched before block
b's curves are read, and a stop discards it); this driver is synchronous,
which gives the same answer: the same ``h_effective``, the same trajectory,
and no block beyond the stop in the result.  Rows past ``h_total`` in the
last block are padding: their plan rows are -1, and their lanes are not
clustered (a per-lane result, so skipping them changes nothing).
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

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
from consensus_clustering_tpu_torch.ops import launch_counts
from consensus_clustering_tpu_torch.ops.analysis import consensus_matrix
from consensus_clustering_tpu_torch.ops.bitpack import (
    pack_cosample_planes,
    pack_label_planes,
    packed_width,
)
from consensus_clustering_tpu_torch.ops.fused_block import fused_assign_pack
from consensus_clustering_tpu_torch.ops.hist import consensus_hist_from_counts
from consensus_clustering_tpu_torch.ops.popcount import packed_coassoc_counts
from consensus_clustering_tpu_torch.ops.resample import resample_indices
from consensus_clustering_tpu_torch.ops.tiles import packed_hist_counts
from consensus_clustering_tpu_torch.parallel.mesh import (
    RESAMPLE_AXIS,
    ROW_AXIS,
    Mesh,
    engine_mesh,
)
from consensus_clustering_tpu_torch.parallel.sweep import (
    DeviceCopies,
    _coassoc,
    _cosample,
    _shard_centroids,
    _shard_labels,
    build_kernels,
    curves_from_counts,
    gather_lines,
    k_positions_groups,
    kernel_route,
    launches_since,
    local_column,
    per_device_memory,
    row_lanes,
    shard_lanes,
    sweep_geometry,
    valid_lanes,
)
from consensus_clustering_tpu_torch.resilience.blocks import (
    StreamCheckpointer,
)
from consensus_clustering_tpu_torch.resilience.faults import (
    IntegrityError,
    faults,
)
from consensus_clustering_tpu_torch.resilience.integrity import (
    build_packed_sentinel,
    build_sentinel,
    flip_array_bits,
    sentinel_sample_rows,
    verify_state_frame,
)
from consensus_clustering_tpu_torch.utils.checkpoint import (
    backend_tag,
    data_fingerprint,
    stream_fingerprint,
)
from consensus_clustering_tpu_torch.utils.metrics import (
    device_memory_stats,
    in_peak_memory_window,
)

#: Rows of a packed evaluation tile (before rounding up to a multiple of 8).
TILE_ROWS = 256


def _row_tiles(n_elems: int) -> Tuple[int, int]:
    """``(n_tiles, tile_r)``: n_tiles equal tiles of tile_r rows (a multiple
    of 8) that cover ``n_elems`` element columns; the packed element width
    is their product."""
    n_tiles = -(-n_elems // TILE_ROWS)
    tile_r = -(-n_elems // n_tiles)
    return n_tiles, -(-tile_r // 8) * 8


def adaptive_decision(
    prev_pac: Optional[np.ndarray],
    pac: np.ndarray,
    quiet: int,
    tol: float,
    patience: int,
    min_h: int,
    h_done: int,
    n_iterations: int,
) -> Tuple[int, bool]:
    """The reference's early-stop rule after one block: ``(quiet, stop)``.

    A block is quiet when every K's PAC moved less than ``tol`` since the
    previous block (the first block is never quiet and resets nothing);
    the stream stops once ``patience`` consecutive blocks were quiet, at
    least ``min_h`` resamples are in, and resamples remain.
    """
    if prev_pac is not None:
        if np.max(np.abs(pac - prev_pac)) < tol:
            quiet += 1
        else:
            quiet = 0
    stop = quiet >= patience and min_h <= h_done < n_iterations
    return quiet, stop


class StreamingSweep:
    """The H-block step on a mesh (default one device) plus the host
    driver that streams it.

    Build once per (shape, mesh, config-minus-H) and call :meth:`run` for
    any ``n_iterations`` (packed: up to the capacity of the build config's
    H).

    On a mesh (reference ``StreamingSweep``'s ``local_step`` and
    ``local_step_packed``) a block's ``hb_pad`` rows (``stream_h_block``
    padded to a multiple of the ('h' x 'n') shards) split over every
    shard, as in :func:`..parallel.sweep.build_sweep`; the state is kept
    per (k-group, row shard) on the device of that 'h' column's first
    shard: dense ``mij`` (k_local, n_local, n_pad) and ``iij`` row blocks,
    packed ``planes`` (k_local, k_max, w_cap, n_local_pack) and
    ``coplanes`` for the shard's element columns.  Packed, each shard packs
    its 'h' row's bits for its own columns, the block planes are summed
    over 'h' (disjoint bits: the sum is an OR), and the planes are
    gathered along 'n' for the popcount tiles; fused, the per-lane
    centroids are gathered instead of labels.  Frames, the sentinels,
    ``capture_state`` and ``finalize`` see the state cropped to N and in
    K order (:meth:`gather_state`), which no mesh changes, so a frame
    written under one mesh resumes under any mesh with the same padded
    block.

    Across processes (any of 'k', 'h', 'n' spanning them) each process
    keeps the state of the (k-group, row shard)s it holds a shard of,
    and runs the merges it takes part in (:mod:`.mesh`).
    :meth:`gather_state` is collective: every process calls it at the
    same points and gets the one-device layout, so the sentinel, the
    adaptive stop, ``capture_state`` and :meth:`finalize` read the same
    tensors everywhere, and a sentinel's verdict is agreed over the
    processes.  Only the primary process writes frames; on resume it
    picks the generation and broadcasts it, so a process that cannot see
    the ring resumes all the same, and a frame written under one process
    layout resumes under another with the same padded block.
    """

    def __init__(
        self,
        clusterer: Clusterer,
        config: SweepConfig,
        mesh: Optional[Mesh] = None,
        device=None,
    ):
        if config.stream_h_block is None:
            raise ValueError(
                "StreamingSweep needs SweepConfig.stream_h_block (the "
                "resamples-per-block size); use build_sweep for the "
                "monolithic program"
            )
        self.mesh = engine_mesh(mesh, device)
        self.config = config
        self.clusterer = clusterer
        self.device = self.mesh.primary
        geo = sweep_geometry(config, self.mesh, config.stream_h_block)
        self._geo = geo
        self._hb = geo.h_pad
        self._n_ks = len(config.k_values)
        self._k_local = len(geo.k_values_pad) // geo.n_k
        self._orig = geo.k_original()
        packed = config.accum_repr == "packed"
        self._packed = packed
        self.packed_kernel = None
        self.fuse_block = None
        self.fused_kernel = None
        self._sentinel = None  # built at the first check
        if packed:
            self.packed_kernel = kernel_route(self.device)
            eligible = (
                getattr(clusterer, "supports_fused_assign", False)
                and config.dtype == "float32"
            )
            if config.fuse_block == "on" and not eligible:
                raise ValueError(
                    "fuse_block='on' needs an f32 dtype and a clusterer "
                    "declaring supports_fused_assign (labels a pure "
                    "nearest-centroid function of fit()'s centroids); got "
                    f"dtype={config.dtype!r}, clusterer "
                    f"{type(clusterer).__name__}"
                )
            if config.fuse_block == "on" or (
                config.fuse_block == "auto" and eligible
            ):
                self.fuse_block = "fused"
                self.fused_kernel = kernel_route(self.device)
            else:
                self.fuse_block = "unfused"
            # Capacity: the build config's H in whole blocks; each block
            # owns wb whole words, so block b's bits start at word b * wb.
            self._n_blocks_cap = -(-config.n_iterations // self._hb)
            self._h_cap = self._n_blocks_cap * self._hb
            self._wb = packed_width(self._hb)
            self._w_cap = self._n_blocks_cap * self._wb
            # Row tiles of the evaluation: n_tiles equal tiles of tile_r
            # rows (a multiple of 8) cover a shard's n_local columns, so a
            # tile never crosses into another shard's; columns >= N hold
            # no bits.
            self._n_tiles, self._tile_r = _row_tiles(geo.n_local)
            self._n_local_pack = self._tile_r * self._n_tiles
            self._n_pad2 = self._n_local_pack * geo.n_r

    # -- state -----------------------------------------------------------

    def _owners(self):
        """(g, r) -> the coordinate keeping that state shard, for each
        shard this process keeps."""
        return {(g, r): self.mesh.row_owner(g, r)
                for g in range(self._geo.n_k)
                for r in self.mesh.held_rows(g)}

    def _shard_shapes(self) -> Dict[str, Tuple[int, ...]]:
        geo, k_max = self._geo, self.config.k_max
        if self._packed:
            return {"planes": (self._k_local, k_max, self._w_cap,
                               self._n_local_pack),
                    "coplanes": (self._w_cap, self._n_local_pack)}
        return {"mij": (self._k_local, geo.n_local, geo.n_pad),
                "iij": (geo.n_local, geo.n_pad)}

    def init_state(self) -> Dict[str, Dict[Tuple[int, int], torch.Tensor]]:
        """Fresh zeroed int32 state shards this process keeps, made on
        their devices: ``{name: {(g, r): tensor}}``."""
        owners = self._owners()
        return {name: {gr: torch.zeros(shape, dtype=torch.int32,
                                       device=self.mesh.device(c))
                       for gr, c in owners.items()}
                for name, shape in self._shard_shapes().items()}

    def _k_rows(self):
        """K position i -> (k-group, local slot) of its state row."""
        rows = [None] * self._n_ks
        for p, i in enumerate(self._orig):
            if i < self._n_ks:
                rows[i] = divmod(p, self._k_local)
        return rows

    def _gather_rows(self, shards, g: int, dim: int) -> torch.Tensor:
        """One k-group's shards of a state tensor joined along ``dim`` (the
        element axis) on the primary device."""
        return self.mesh.merge_rows(
            g, {r: t for (gi, r), t in shards.items() if gi == g},
            dim=dim, dest=self.device)

    def gather_state(self, state) -> Dict[str, torch.Tensor]:
        """The state in K order on the primary device, in the layout of
        the one-device engine, which no mesh changes: what the frames, the
        sentinels, ``capture_state`` and :meth:`finalize` read.  Dense
        ``mij`` (nK, N, N) and ``iij`` (N, N); packed ``planes`` (nK, k_max,
        w_cap, W) and ``coplanes`` (w_cap, W), with W the one-device
        element width (:meth:`_frame_width`; columns >= N hold no bits).
        On one device these are the state's own tensors.  Collective
        across processes: each gathers its k-groups' rows, then the Ks
        of k-groups it does not hold (:meth:`..mesh.Mesh.merge_k`)."""
        n = self.config.n_samples
        per_k, whole = ("planes", "coplanes") if self._packed else (
            "mij", "iij")
        groups, other = {}, None
        for g in range(self._geo.n_k):
            if not self.mesh.holds(g):
                continue
            groups[g] = self._gather_rows(state[per_k], g,
                                          3 if self._packed else 1)
            # Each k-group keeps its own copy of the rest: a group whose
            # rows span processes merges it with those processes.
            if other is None or self.mesh.rows_span(g):
                got = self._gather_rows(state[whole], g,
                                        1 if self._packed else 0)
                other = got if other is None else other
        rows = self._k_rows()
        if self._geo.n_k == 1 and rows == [(0, j) for j in range(self._n_ks)]:
            stacked = groups[0][:self._n_ks]
        else:
            mine = {i: groups[g][j] for i, (g, j) in enumerate(rows)
                    if g in groups}
            like = next(iter(groups.values()))[0]
            merged = self.mesh.merge_k(mine, [g for g, _ in rows], like,
                                       self.device)
            stacked = torch.stack([merged[i] for i in range(self._n_ks)])
        if not self._packed:
            return {per_k: stacked[:, :n, :n], whole: other[:n, :n]}
        width = self._frame_width()
        return {per_k: _to_width(stacked, width),
                whole: _to_width(other, width)}

    def _frame_width(self) -> int:
        """The packed element width of the one-device layout: the frames'
        (the reference's one-device frames have it too)."""
        n_tiles, tile_r = _row_tiles(self.config.n_samples)
        return n_tiles * tile_r

    def _load_state(self, state, flat: Dict[str, torch.Tensor]) -> None:
        """Write :meth:`gather_state`-shaped tensors into the shards, in
        place; columns >= N are not written."""
        geo, n = self._geo, self.config.n_samples
        width = self._n_local_pack if self._packed else geo.n_local
        for name, value in flat.items():
            for (g, r), shard in state[name].items():
                lo = r * width
                hi = min(n, lo + width)
                if hi <= lo:
                    continue
                if name == "planes":
                    for i, (gi, j) in enumerate(self._k_rows()):
                        if gi == g:
                            shard[j, ..., :hi - lo].copy_(value[i, ..., lo:hi])
                elif name == "coplanes":
                    shard[:, :hi - lo].copy_(value[:, lo:hi])
                elif name == "mij":
                    for i, (gi, j) in enumerate(self._k_rows()):
                        if gi == g:
                            shard[j, :hi - lo, :n].copy_(value[i, lo:hi])
                else:
                    shard[:hi - lo, :n].copy_(value[lo:hi])

    def warmup(self) -> float:
        """Build the CUDA kernels (nothing on the CPU); returns seconds."""
        return build_kernels(self.device)

    # -- the block step --------------------------------------------------

    def _block_plan(self, key_resample, h_start: int, h_total: int):
        """The block's (hb_pad, n_sub) plan with rows >= h_total set to
        -1."""
        config = self.config
        indices = resample_indices(
            key_resample, config.n_samples, self._hb, config.n_sub,
            h_start=h_start,
        )
        n_valid = max(0, min(self._hb, h_total - h_start))
        indices[n_valid:] = -1
        return indices

    def _lanes(self, on, indices, x, g, h_start, h_total):
        """Each local shard of k-group ``g``: its valid lanes' subsamples."""
        geo = self._geo
        return {c: on(x, c)[on(indices, c)[shard_lanes(geo, c)]
                            [:valid_lanes(geo, c, h_total, h_start)]]
                for c in self.mesh.coords()
                if c[0] == g and self.mesh.is_local(c)}

    def _group_slots(self, g: int):
        """(local slot, K position, K) of k-group ``g``'s real Ks: a
        prefix of its slots (the padding repeats sit at the end)."""
        out = []
        for j in range(self._k_local):
            p = g * self._k_local + j
            if self._orig[p] < self._n_ks:
                out.append((j, self._orig[p], self._geo.k_values_pad[p]))
        return out

    def _step_dense(self, state, x, x_cols, key_resample, key_cluster,
                    h_start, h_total):
        config, geo, mesh = self.config, self._geo, self.mesh
        n, k_max = config.n_samples, config.k_max
        on = DeviceCopies(mesh)
        indices = self._block_plan(key_resample, h_start, h_total)
        counts = [None] * self._n_ks
        for g in range(geo.n_k):
            if not mesh.holds(g):
                continue  # another process runs this k-group's Ks
            with region("engine.accumulate"):
                for r in mesh.held_rows(g):
                    parts = {c: _cosample(
                        on(indices, c)[row_lanes(geo, c[1])], n, geo, r,
                        False) for c in local_column(mesh, g, r)}
                    state["iij"][(g, r)] += mesh.psum(
                        parts, mesh.axis((g, 0, r), RESAMPLE_AXIS))
            x_sub = self._lanes(on, indices, x, g, h_start, h_total)
            for j, i, k in self._group_slots(g):
                with region("engine.cluster"):
                    labels = {c: _shard_labels(self.clusterer, config, geo,
                                               c, on(key_cluster, c), k, xs,
                                               h_total, h_start)
                              for c, xs in x_sub.items()}
                lines = gather_lines(mesh, labels, g)
                hist = {}
                for r in mesh.held_rows(g):
                    with region("engine.accumulate"):
                        parts = {}
                        for c in local_column(mesh, g, r):
                            row = lines[c[1]].to(mesh.device(c),
                                                 non_blocking=True)
                            parts[c] = _coassoc(
                                row, on(indices, c)[row_lanes(geo, c[1])],
                                n, k_max, config, geo, r, False)
                        mij = state["mij"][(g, r)][j]
                        mij += mesh.psum(parts,
                                         mesh.axis((g, 0, r), RESAMPLE_AXIS))
                    # Curves from the ACCUMULATED counts: the consensus
                    # over every resample so far, at the last block the
                    # monolithic input.
                    o = mesh.row_owner(g, r)
                    with region("engine.evaluate"):
                        hist[r] = consensus_hist_from_counts(
                            mij, state["iij"][(g, r)], n, r * geo.n_local,
                            config.bins,
                            torch.zeros(config.bins, dtype=torch.int64,
                                        device=mesh.device(o)))
                with region("engine.evaluate"):
                    counts[i] = mesh.merge_rows(g, hist, dest=self.device)
        return self._merge_counts(counts)

    def _merge_counts(self, counts):
        """Every K's histogram counts on every process: the Ks of k-groups
        this process does not hold come from the processes that do."""
        mine = {i: c for i, c in enumerate(counts) if c is not None}
        merged = self.mesh.merge_k(
            mine, k_positions_groups(self._geo),
            torch.zeros(self.config.bins, dtype=torch.int64), self.device)
        return [merged[i] for i in range(self._n_ks)]

    def _step_packed(self, state, x, x_cols, key_resample, key_cluster,
                     h_start, h_total):
        config, geo, mesh = self.config, self._geo, self.mesh
        k_max, wb, nlp = config.k_max, self._wb, self._n_local_pack
        on = DeviceCopies(mesh)
        indices = self._block_plan(key_resample, h_start, h_total)
        word0 = (h_start // self._hb) * wb
        counts = [None] * self._n_ks
        for g in range(geo.n_k):
            if not mesh.holds(g):
                continue  # another process runs this k-group's Ks
            # Each shard's 'h' row's plan in its own element columns, and
            # the bit offset of that row's first resample in the block.
            cols, my_cop = {}, {}
            with region("engine.accumulate"):
                for r in mesh.held_rows(g):
                    parts = {}
                    for c in local_column(mesh, g, r):
                        rows = on(indices, c)[row_lanes(geo, c[1])]
                        lo = r * nlp
                        cols[c] = torch.where(
                            (rows >= lo) & (rows < lo + nlp), rows - lo, -1)
                        my_cop[c] = parts[c] = pack_cosample_planes(
                            cols[c], nlp, n_words=wb,
                            row0=row_lanes(geo, c[1]).start)
                    state["coplanes"][(g, r)][word0:word0 + wb] = mesh.psum(
                        parts, mesh.axis((g, 0, r), RESAMPLE_AXIS))
            x_sub = self._lanes(on, indices, x, g, h_start, h_total)
            slots = self._group_slots(g)
            for j, _, k in slots:
                if self.fuse_block == "fused":
                    # Padded to a shard's lanes for the gather, then cut to
                    # the row's valid lanes (a prefix of its lanes).
                    with region("engine.cluster"):
                        fitted = {c: _pad_lanes(_shard_centroids(
                            self.clusterer, config, geo, c,
                            on(key_cluster, c), k, xs, h_start),
                            geo.local_h) for c, xs in x_sub.items()}
                    lines = gather_lines(mesh, fitted, g)
                    lines = {h: t[:self._row_valid(g, h, h_start, h_total)]
                             for h, t in lines.items()}
                else:
                    with region("engine.cluster"):
                        fitted = {c: _shard_labels(
                            self.clusterer, config, geo, c,
                            on(key_cluster, c), k, xs, h_total, h_start)
                            for c, xs in x_sub.items()}
                    lines = gather_lines(mesh, fitted, g)
                with region("engine.accumulate"):
                    for r in mesh.held_rows(g):
                        parts = {}
                        for c in local_column(mesh, g, r):
                            g0 = row_lanes(geo, c[1]).start
                            row = lines[c[1]].to(mesh.device(c),
                                                 non_blocking=True)
                            if self.fuse_block == "fused":
                                parts[c] = fused_assign_pack(
                                    x_cols[c], row, k, my_cop[c], g0,
                                    n_words=wb)
                            else:
                                parts[c] = pack_label_planes(
                                    row, cols[c], k_max, nlp, n_words=wb,
                                    row0=g0)
                        state["planes"][(g, r)][j, :, word0:word0 + wb] = (
                            mesh.psum(parts,
                                      mesh.axis((g, 0, r), RESAMPLE_AXIS)))
            # The evaluation, per row tile of each row shard: one Iij tile,
            # then every K's Mij tile from its planes, histogrammed through
            # its Cij (formed in the kernel's registers) and dropped: the
            # only int32 counts that ever exist in the packed step.  The
            # planes are gathered along 'n' once a block (across processes,
            # from every process holding the group).
            with region("engine.evaluate"):
                held = mesh.held_rows(g)
                first = mesh.device(mesh.row_owner(g, held[0]))
                planes_all = self._gather_rows(state["planes"], g, 3)
                cop_all = self._gather_rows(state["coplanes"], g, 1)
                hist = {}
                for r in held:
                    dev = mesh.device(mesh.row_owner(g, r))
                    planes = planes_all.to(dev, non_blocking=True)
                    cop = cop_all.to(dev, non_blocking=True)
                    words = planes[:len(slots)].reshape(
                        len(slots), k_max * self._w_cap, self._n_pad2)
                    hist[r] = packed_hist_counts(
                        words, cop, config.bins, self._tile_r,
                        n_valid=config.n_samples,
                        rows=(r * nlp, (r + 1) * nlp))
                merged = mesh.merge_rows(g, hist, dest=first).to(self.device)
            for (_, i, _), row in zip(slots, merged):
                counts[i] = row
        return self._merge_counts(counts)

    def _row_valid(self, g: int, h: int, h_start: int, h_total: int) -> int:
        """The valid lanes of 'h' row ``h`` of k-group ``g`` in a block."""
        return sum(valid_lanes(self._geo, c, h_total, h_start)
                   for c in self.mesh.axis((g, h, 0), ROW_AXIS))

    def columns(self, x: torch.Tensor):
        """The fused step's element rows of each local shard: ``{coord:
        (n_local_pack, d) float32}``, element j of the shard's columns at
        row j, zero pad rows (they carry no co-sample bits, so their
        in-kernel labels are never used).  None for the other steps."""
        if self.fuse_block != "fused":
            return None
        config, nlp = self.config, self._n_local_pack
        full = torch.zeros((self._n_pad2, config.n_features),
                           dtype=torch.float32, device=self.device)
        full[:config.n_samples] = x
        blocks = [full[r * nlp:(r + 1) * nlp] for r in range(self._geo.n_r)]
        on = DeviceCopies(self.mesh)
        return {c: on(blocks[c[2]], c)
                for c in self.mesh.coords() if self.mesh.is_local(c)}

    def step(self, state, x, key, h_start: int, h_total: int, x_cols=None):
        """One block: updates ``state`` in place, returns the per-K
        ``hist``/``cdf``/``pac_area`` curves of the counts so far.
        ``x_cols`` is :meth:`columns` of ``x``, made here when omitted."""
        if x_cols is None:
            x_cols = self.columns(x)
        pair = rng.split(key)
        step = self._step_packed if self._packed else self._step_dense
        counts = step(state, x, x_cols, pair[0], pair[1], h_start, h_total)
        with region("engine.evaluate"):
            return curves_from_counts(self.config, counts)

    def finalize(self, state) -> Dict[str, torch.Tensor]:
        """Mij (nK, N, N), Iij and Cij from the final state; in packed mode
        the popcount of the full planes, its only full materialisation."""
        flat = self.gather_state(state)
        n = self.config.n_samples
        if self._packed:
            cop = flat["coplanes"]
            iij = packed_coassoc_counts(cop, cop)[:n, :n]
            mij = torch.stack([
                packed_coassoc_counts(p.reshape(-1, cop.shape[1]),
                                      p.reshape(-1, cop.shape[1]))[:n, :n]
                for p in flat["planes"]])
        else:
            mij, iij = flat["mij"], flat["iij"]
        cij = torch.stack([consensus_matrix(m, iij) for m in mij])
        return {"mij": mij, "iij": iij, "cij": cij}

    # -- resilience ------------------------------------------------------

    def _frame_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """The shapes of :meth:`gather_state`, which the frames hold."""
        n, n_ks, k_max = self.config.n_samples, self._n_ks, self.config.k_max
        if self._packed:
            width = self._frame_width()
            return {"planes": (n_ks, k_max, self._w_cap, width),
                    "coplanes": (self._w_cap, width)}
        return {"mij": (n_ks, n, n), "iij": (n, n)}

    def _integrity_stats(self, flat, h_seen: int, block: int):
        """The invariant sentinel on :meth:`gather_state`'s ``flat`` state
        (the packed one on packed state, whose spot rows launch kernel B3
        on the card): per-invariant violation counts, all zero for a valid
        state."""
        if self._sentinel is None:
            self._sentinel = (
                build_packed_sentinel(self._hb, self.config.k_max)
                if self._packed else build_sentinel()
            )
        idx = sentinel_sample_rows(self.config.n_samples, block)
        return self._sentinel(flat, h_seen, idx)

    def _flip_state_bits(self, state, nbits: int, block: int,
                         h_seen: int) -> None:
        """The ``accumulator`` bitflip fault, in place: the live region of
        this process's first per-K accumulator shard (dense ``mij``;
        packed: the planes' words of the blocks run) goes to the host,
        gets :func:`..resilience.integrity.flip_array_bits` with the block
        as seed, and is written back; on one device that is the whole
        accumulator.  No merge runs: a plan may arm one process only.
        Reached only when a plan armed it."""
        n = self.config.n_samples
        (g, r), value = sorted(
            state["planes" if self._packed else "mij"].items())[0]
        real = len(self._group_slots(g))
        if self._packed:
            words = -(-h_seen // self._hb) * self._wb
            cols = min(self._n_local_pack, n - r * self._n_local_pack)
            live = value[:real, :, :words, :cols]
        else:
            live = value[:real, :min(self._geo.n_local,
                                     n - r * self._geo.n_local), :n]
        host = live.cpu().numpy().copy()
        flip_array_bits(host, nbits, seed=block)
        live.copy_(torch.from_numpy(host))

    def _host_snapshot(self, flat) -> Dict[str, np.ndarray]:
        """A host copy of :meth:`gather_state`'s ``flat`` for the ring,
        taken before the next block updates the state in place; packed
        planes as uint32 views of their int32 bit patterns, the
        reference's frame dtype."""
        out = {}
        for name, value in flat.items():
            host = value.to("cpu", copy=True).numpy()
            out[f"state_{name}"] = host.view(np.uint32) if self._packed \
                else host
        return out

    def _restore(self, arrays):
        state = self.init_state()
        flat = {}
        for name in self._frame_shapes():
            host = np.ascontiguousarray(arrays[f"state_{name}"])
            if host.dtype == np.uint32:
                host = host.view(np.int32)
            flat[name] = torch.from_numpy(host).to(self.device)
        self._load_state(state, flat)
        return state

    def _verify_frame(self, header, arrays) -> Optional[str]:
        """:func:`..resilience.integrity.verify_state_frame`, after the
        state's shapes are checked against this engine's (a packed ring
        from an engine of another capacity has other word counts)."""
        for name, shape in self._frame_shapes().items():
            got = arrays.get(f"state_{name}")
            if got is None or tuple(got.shape) != shape:
                return (f"state_{name} is not a {shape} array for this "
                        "engine")
        return verify_state_frame(header, arrays)

    # -- the driver ------------------------------------------------------

    @in_peak_memory_window
    @region("engine")
    def run(
        self,
        x: np.ndarray,
        seed: int,
        n_iterations: int,
        block_callback: Optional[Callable[[int, int, List[float]], None]] = None,
        adaptive_tol: Optional[float] = None,
        adaptive_patience: Optional[int] = None,
        adaptive_min_h: Optional[int] = None,
        checkpointer: Optional[StreamCheckpointer] = None,
        integrity_check_every: Optional[int] = None,
        tracer=None,
        capture_state: bool = False,
    ) -> Dict[str, Any]:
        """Stream the sweep; returns host results and streaming stats.

        ``n_iterations`` and the adaptive knobs (default: the build
        config's) are runtime arguments.  ``block_callback(b, h_done,
        pac_list)`` is called after each block.  ``capture_state`` (packed
        only) returns the final state as ``final_state``: per-K planes in
        K-values order cropped to the words run and the real N (``planes``
        (nK, k_max, W, N), ``coplanes`` (W, N), int32 bit patterns); an
        early-stopped run captures none, as the reference's does.

        ``checkpointer`` (a :class:`..resilience.blocks.StreamCheckpointer`)
        makes the run resumable at block granularity: each due block's
        state (copied to the host before the next block updates it in
        place), curves and adaptive trajectory go to its ring, and a call
        with the same config, seed, data, backend, H and adaptive knobs
        (:func:`..utils.checkpoint.stream_fingerprint`) resumes from the
        newest generation that passes :func:`..resilience.integrity.
        verify_state_frame`, bit for bit as the uninterrupted run.

        ``integrity_check_every`` (default: the build config's; 0 = off)
        runs the invariant sentinel after every that-many-th block, the
        final block, and every block under adaptive stop (any block can
        be the last).  A breach raises :class:`..resilience.faults.
        IntegrityError` before the block's curves enter the trajectory or
        its state the ring.  An exception leaving ``run`` carries
        ``integrity_checks_run``.

        ``tracer`` (an :class:`..obs.tracing.Tracer`, or anything with its
        ``record(name, seconds, **fields)``; the serve executor passes a
        child of its ``execute`` span) gets the run's timed spans:
        ``resume_restore`` when a checkpoint generation is restored, and
        for each block ``integrity_check`` (the sentinel, where due),
        ``host_evaluate`` (the curves' copy to the host, which waits for
        the block's device work) and ``h_block`` (the block's wall
        clock), each at the boundary of its ``cc.engine.*`` range
        (:func:`..obs.tracing.region`).  None records nothing.

        ``timing`` holds ``run_seconds``, ``resamples_per_second``
        (h_effective x nK / run_seconds), ``device_memory``, ``device``,
        ``kernel_launches``, ``lloyd`` (the Lloyd loop's counts,
        :func:`..models.kmeans.lloyd_counts`) and, packed,
        ``packed_kernel`` (cuda|plain), ``fuse_block`` (fused|unfused)
        and, fused, ``fused_kernel``.
        ``streaming`` adds the resilience accounting: ``resumed_from_block``
        (0: a fresh run), ``checkpoint_writes``, ``integrity_checks`` and
        their seconds (``restore_seconds``, ``checkpoint_copy_seconds``,
        the writer thread's ``checkpoint_write_seconds``,
        ``integrity_seconds``).
        """
        config = self.config
        if n_iterations < 1:
            raise ValueError(f"n_iterations must be >= 1, got {n_iterations}")
        if self._packed and n_iterations > self._h_cap:
            raise ValueError(
                f"packed accumulator capacity is {self._h_cap} resamples "
                f"(built from n_iterations={config.n_iterations}, block "
                f"{self._hb}); got n_iterations={n_iterations} — rebuild "
                "the engine with a config whose n_iterations covers the "
                "largest H it will serve"
            )
        if capture_state and not self._packed:
            raise ValueError(
                "capture_state requires accum_repr='packed': the captured "
                "state is the packed bit-planes"
            )
        if adaptive_tol is None:
            adaptive_tol = config.adaptive_tol
        if adaptive_patience is None:
            adaptive_patience = config.adaptive_patience
        if adaptive_min_h is None:
            adaptive_min_h = config.adaptive_min_h
        if integrity_check_every is None:
            integrity_check_every = config.integrity_check_every
        integrity_check_every = int(integrity_check_every)
        if integrity_check_every < 0:
            raise ValueError(
                f"integrity_check_every must be >= 0, got "
                f"{integrity_check_every}"
            )
        adaptive = adaptive_tol is not None
        if adaptive and config.store_matrices:
            raise ValueError(
                "adaptive early stop is incompatible with store_matrices"
            )
        device = self.device
        on_cuda = device.type == "cuda"
        launches0, lloyd0 = launch_counts(), lloyd_counts()
        t0 = time.perf_counter()
        xd = torch.as_tensor(np.asarray(x)).to(device=device,
                                               dtype=config.torch_dtype)
        key = rng.prng_key(seed, device)
        x_cols = self.columns(xd)
        n_blocks = -(-n_iterations // self._hb)
        trajectory: List[List[float]] = []
        prev_pac = None
        quiet = 0
        stopped_early = False
        h_effective = 0
        host: Dict[str, np.ndarray] = {}
        state = None
        start_block = 0
        resume_terminal = False
        seconds = dict.fromkeys(("restore", "copy", "integrity"), 0.0)
        ring = RingRole(self.mesh, checkpointer)
        if ring.on:
            ckpt_fp = stream_fingerprint(
                config, seed, data_fingerprint(np.asarray(x)),
                backend=backend_tag(device), n_iterations=n_iterations,
                adaptive_tol=adaptive_tol,
                adaptive_patience=adaptive_patience,
                adaptive_min_h=adaptive_min_h,
            )
            t_restore = time.perf_counter()
            resume = ring.latest(ckpt_fp, self._verify_frame)
            if resume is not None:
                header, arrays = resume
                terminal = (bool(header.get("stopped", False))
                            or int(header["h_done"]) >= n_iterations)
                if not terminal and int(header.get("hb_pad", self._hb)) \
                        != self._hb:
                    raise ValueError(
                        f"checkpoint frame written with padded blocks of "
                        f"{header.get('hb_pad')} resamples does not align "
                        f"with this engine's {self._hb} (stream_h_block "
                        "padded over the mesh's ('h' x 'n') shards): "
                        "resume on a mesh with the same padded block, or "
                        "point the run at a fresh checkpoint ring"
                    )
                state = self._restore(arrays)
                # float32, as the live run's PAC: the adaptive comparison
                # must not widen to f64 on the resumed path only.
                trajectory = [[float(v) for v in row]
                              for row in header["trajectory"]]
                if trajectory:
                    prev_pac = np.asarray(trajectory[-1], dtype=np.float32)
                quiet = int(header["quiet"])
                h_effective = int(header["h_done"])
                host = {name[len("curve_"):]: arrays[name]
                        for name in arrays if name.startswith("curve_")}
                start_block = int(header["block_index"]) + 1
                ring.resumed()
                stopped_early = bool(header.get("stopped", False))
                # A terminal generation (stop decided, or the last block)
                # replays the stored answer with no block run.
                resume_terminal = stopped_early or h_effective >= n_iterations
                if on_cuda:
                    torch.cuda.synchronize(device)
            seconds["restore"] = time.perf_counter() - t_restore
            if resume is not None and tracer is not None:
                tracer.record("resume_restore", seconds["restore"],
                              resumed_from_block=start_block,
                              h_done=h_effective, terminal=resume_terminal)
        if state is None:
            state = self.init_state()
        integrity_checks = 0

        def check_due(b: int) -> bool:
            if integrity_check_every <= 0:
                return False
            # Under adaptive stop any block can be the answer, so every
            # block is checked: a stop never ships unchecked curves.
            return adaptive or (
                b % integrity_check_every == integrity_check_every - 1
                or b == n_blocks - 1
            )

        try:
            for b in range(start_block, start_block if resume_terminal
                           else n_blocks):
                with region("engine.block", "h_block", tracer,
                            block=b) as block:
                    faults.fire("block_start", index=b)
                    curves = self.step(state, xd, key, b * self._hb,
                                       n_iterations, x_cols=x_cols)
                    h_done = min((b + 1) * self._hb, n_iterations)
                    nbits = faults.corrupt("accumulator", index=b)
                    if nbits:
                        self._flip_state_bits(state, nbits, b, h_done)
                    if check_due(b):
                        if on_cuda:
                            torch.cuda.synchronize(device)
                        with region("engine.integrity", "integrity_check",
                                    tracer, block=b) as check:
                            integrity_checks += 1
                            found = agree_counts(
                                self.mesh, self._integrity_stats(
                                    self.gather_state(state), h_done, b))
                            bad = {name: v for name, v in found.items()
                                   if v}
                            check.add(violations=len(bad))
                        seconds["integrity"] += check.seconds
                        if bad:
                            raise IntegrityError(
                                "accumulator",
                                f"integrity sentinel: block {b} state "
                                f"violates the count invariants ({bad}): "
                                "corrupt accumulator; retry from the last "
                                "verified checkpoint",
                                block=b, details=bad,
                                checks_run=integrity_checks,
                            )
                    with region("engine.evaluate", "host_evaluate", tracer,
                                block=b):
                        host = {name: v.cpu().numpy()
                                for name, v in curves.items()}
                    h_effective = h_done
                    block.add(h_done=h_effective)
                    pac = host["pac_area"]
                    trajectory.append([float(v) for v in pac])
                    if block_callback is not None:
                        block_callback(b, h_effective, trajectory[-1])
                    stop = False
                    if adaptive:
                        quiet, stop = adaptive_decision(
                            prev_pac, pac, quiet, adaptive_tol,
                            adaptive_patience, adaptive_min_h, h_effective,
                            n_iterations,
                        )
                    prev_pac = pac
                    if ring.on:
                        with region("engine.checkpoint"):
                            t_copy = time.perf_counter()
                            flat = self.gather_state(state)
                            if ring.writer:
                                arrays = self._host_snapshot(flat)
                            seconds["copy"] += time.perf_counter() - t_copy
                    if ring.writer:
                        arrays.update({f"curve_{name}": v
                                       for name, v in host.items()})
                        checkpointer.write_async({
                            "fingerprint": ckpt_fp,
                            "block_index": int(b),
                            "h_done": int(h_effective),
                            "n_iterations": int(n_iterations),
                            "trajectory": [list(row) for row in trajectory],
                            "quiet": int(quiet),
                            "stopped": bool(stop),
                            "accum_repr": config.accum_repr,
                            "hb_pad": int(self._hb),
                            "written_at": round(time.time(), 3),
                        }, arrays)
                    if stop:
                        stopped_early = True
                        break
        except BaseException as e:
            try:
                e.integrity_checks_run = integrity_checks
            except Exception:  # noqa: BLE001 -- never mask the failure
                pass
            raise
        finally:
            if checkpointer is not None:
                # An aborted run still leaves a consistent ring.
                checkpointer.flush()
        out: Dict[str, Any] = dict(host)
        if config.store_matrices and not stopped_early:
            out.update({name: v.cpu().numpy()
                        for name, v in self.finalize(state).items()})
        if capture_state and not stopped_early:
            w_used = -(-h_effective // self._hb) * self._wb
            n = config.n_samples
            flat = self.gather_state(state)
            out["final_state"] = {
                "planes": flat["planes"][:, :, :w_used, :n].cpu().numpy(),
                "coplanes": flat["coplanes"][:w_used, :n].cpu().numpy(),
            }
        for dev in self.mesh.local_devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        run_seconds = time.perf_counter() - t0
        del state
        out["streaming"] = {
            "h_block": int(config.stream_h_block),
            "h_block_padded": int(self._hb),
            "h_requested": int(n_iterations),
            "h_effective": int(h_effective),
            "n_blocks_run": len(trajectory),
            "stopped_early": stopped_early,
            "pac_trajectory": trajectory,
            "resumed_from_block": int(start_block),
            "checkpoint_writes": ring.writes(),
            "integrity_checks": int(integrity_checks),
            "integrity_check_every": int(integrity_check_every),
            "accum_repr": config.accum_repr,
            "restore_seconds": seconds["restore"],
            "checkpoint_copy_seconds": seconds["copy"],
            "checkpoint_write_seconds": ring.write_seconds(),
            "integrity_seconds": seconds["integrity"],
        }
        out["timing"] = {
            "run_seconds": run_seconds,
            "resamples_per_second": h_effective * self._n_ks / max(
                run_seconds, 1e-9
            ),
            "device": torch.cuda.get_device_name(device) if on_cuda else "cpu",
            "device_memory": device_memory_stats(device) if on_cuda else {},
            "device_memory_per_device": per_device_memory(self.mesh),
            "kernel_launches": launches_since(launches0),
            "lloyd": lloyd_since(lloyd0),
            "mesh": dict(self.mesh.shape),
            "processes": self.mesh.process_count,
        }
        if self.packed_kernel is not None:
            out["timing"]["packed_kernel"] = self.packed_kernel
            out["timing"]["fuse_block"] = self.fuse_block
            if self.fused_kernel is not None:
                out["timing"]["fused_kernel"] = self.fused_kernel
        return out


    # -- the fused driver (the serve batch axis) -------------------------

    def run_fused(
        self,
        xs: List[np.ndarray],
        seeds: List[int],
        n_iterations: int,
        block_callback: Optional[
            Callable[[int, int, int, List[float]], None]
        ] = None,
        checkpointers: Optional[List[Optional[StreamCheckpointer]]] = None,
        integrity_check_every: int = 0,
    ) -> List[Dict[str, Any]]:
        """Stream k same-shape sweeps as one batch: the serve fusion path
        (reference ``StreamingSweep.run_fused``).

        ``xs``/``seeds`` are k >= 2 independent jobs at this engine's
        shape and one ``n_iterations``.  The jobs run one after another
        through :meth:`run` (the *looping* design, ``PERF.md`` §6: every
        clusterer's lanes keep their solo batches, where stacking k jobs'
        lanes into one call would put GMM and spectral lanes in batches
        whose GEMMs round apart on the card), so each job's curves,
        trajectory and frames are its solo run's, bit for bit.

        Narrower than :meth:`run`, as the reference: no adaptive stop,
        and each of ``checkpointers`` gets the frames its job's solo run
        writes, under its solo fingerprint, so a solo retry resumes them.
        The invariant sentinel checks every job at
        ``integrity_check_every``; a breach aborts the batch.
        ``block_callback(job, block, h_done, pac_list)`` fires per job per
        block.  Returns one :meth:`run` host dict per job.
        """
        k = len(xs)
        if k < 2:
            raise ValueError(f"run_fused needs >= 2 jobs, got {k}")
        if len(seeds) != k:
            raise ValueError("xs and seeds must align")
        if checkpointers is not None and len(checkpointers) != k:
            raise ValueError("checkpointers must align with xs")
        if self.config.adaptive_tol is not None:
            raise ValueError("fused jobs take no adaptive stop")
        shape = (self.config.n_samples, self.config.n_features)
        for x in xs:
            if tuple(x.shape) != shape:
                raise ValueError(
                    f"fused job shape {tuple(x.shape)} != engine shape "
                    f"{shape}"
                )
        checkpointers = checkpointers or [None] * k
        return [
            self.run(
                x, int(seed), n_iterations,
                block_callback=(
                    None if block_callback is None
                    else functools.partial(block_callback, i)
                ),
                checkpointer=checkpointer,
                integrity_check_every=int(integrity_check_every),
            )
            for i, (x, seed, checkpointer) in enumerate(
                zip(xs, seeds, checkpointers))
        ]


class RingRole:
    """What this process does with a run's checkpoint ring.

    On one process: whatever ``checkpointer`` (or None) says.  On a mesh
    across processes the primary's decides for every process: where it
    has a ring, every process takes part in the state gathers of its
    snapshots and resumes (``on``), but only the primary reads the ring
    and writes frames (``writer``); what it resumes from is broadcast, so
    a process that cannot see the ring resumes all the same.
    """

    def __init__(self, mesh: Mesh, checkpointer: Optional[StreamCheckpointer]):
        from consensus_clustering_tpu_torch.parallel import distributed

        self.checkpointer = checkpointer
        self.spans = mesh.process_count > 1
        primary = not self.spans or distributed.is_primary()
        self.on = checkpointer is not None
        if self.spans:
            self.on = bool(distributed.broadcast_object(self.on))
        self.writer = primary and checkpointer is not None
        self._writes0 = checkpointer.writes_total if checkpointer else 0
        self._write_s0 = (checkpointer.write_seconds_total
                          if checkpointer else 0.0)

    def latest(self, fingerprint: str, verify):
        """The primary's newest verified generation, on every process."""
        found = (self.checkpointer.latest(fingerprint, verify=verify)
                 if self.writer else None)
        if self.spans:
            from consensus_clustering_tpu_torch.parallel import distributed

            found = distributed.broadcast_object(found)
        return found

    def resumed(self) -> None:
        if self.checkpointer is not None:
            self.checkpointer.resumes_total += 1

    def writes(self) -> int:
        if self.checkpointer is None:
            return 0
        return self.checkpointer.writes_total - self._writes0

    def write_seconds(self) -> float:
        if self.checkpointer is None:
            return 0.0
        return self.checkpointer.write_seconds_total - self._write_s0


def agree_counts(mesh: Mesh, found: Dict[str, int]) -> Dict[str, int]:
    """A sentinel's violation counts summed over a mesh's processes, so
    every process reaches one verdict (a breach in one process's copy
    raises in all, and none is left waiting in a merge)."""
    if mesh.process_count == 1:
        return found
    from consensus_clustering_tpu_torch.parallel import distributed

    every = distributed.gather_objects(found)
    return {name: sum(int(f[name]) for f in every) for name in found}


def _pad_lanes(t: torch.Tensor, lanes: int) -> torch.Tensor:
    """``t`` with zero lanes appended along its first axis up to
    ``lanes``: the same tensor when it has them already."""
    pad = lanes - t.shape[0]
    if pad <= 0:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def _to_width(words: torch.Tensor, width: int) -> torch.Tensor:
    """``words`` with its last (element) axis cut or zero-padded to
    ``width``: the same tensor when it has that width already."""
    have = words.shape[-1]
    if have == width:
        return words
    if have > width:
        return words[..., :width]
    pad = words.new_zeros(words.shape[:-1] + (width - have,))
    return torch.cat([words, pad], dim=-1)


def run_streaming_sweep(
    clusterer: Clusterer,
    config: SweepConfig,
    x: np.ndarray,
    seed: int,
    device=None,
    block_callback=None,
    checkpointer: Optional[StreamCheckpointer] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, Any]:
    """Build the engine, build the kernels and stream ``config``'s H: the
    counterpart of :func:`..parallel.sweep.run_sweep`, whose ``timing``
    adds ``compile_seconds`` (building the kernels).  ``checkpointer``
    makes the run resumable (:meth:`StreamingSweep.run`); ``mesh`` (or
    ``device``) is where it runs."""
    engine = StreamingSweep(clusterer, config, mesh=mesh, device=device)
    compile_seconds = engine.warmup()
    out = engine.run(x, seed, config.n_iterations,
                     block_callback=block_callback,
                     checkpointer=checkpointer)
    out["timing"]["compile_seconds"] = compile_seconds
    return out
