"""The ('k', 'h', 'n') device mesh and the two merges the sharded engines
need.

The port of the reference package's ``parallel/mesh.py``.  A sweep has
three parallel dimensions:

- ``'h'`` (resamples): each device clusters its share of the resamples,
  and the int32 partial counts are summed over the axis;
- ``'n'`` (consensus-matrix rows): each device owns a block of rows of
  the N x N counts; labels are gathered along the axis first;
- ``'k'`` (sweep values): each k-group of devices runs its own slice of
  the K list.

:class:`Mesh` is a (k, h, n) grid of ``torch.device`` with the rank of
the process that owns each entry.  A device may repeat: ``["cpu"] * 8``
or ``[cuda:0] * 8`` is a *virtual* mesh that runs every shard's lanes,
row blocks, padding and merges on one device, one shard after another.
On distinct cards the merges move tensors with ``.to(owner,
non_blocking=True)``: a copy between the cards where they have peer
access, which the CUDA driver otherwise stages through host memory.  After
:func:`.distributed.initialize`, a mesh spans every process's devices in
rank-major order, and any axis may span processes.  A merge whose shards
lie on several processes runs in the group of exactly those processes
(:func:`.distributed.make_groups`, made when the mesh is built): a sum
over an 'h' column is all-reduced, a gather along an 'n' line
all-gathered as equal-shaped shards, and the K values of k-groups held by
other processes are filled in by :meth:`Mesh.merge_k`.  Each process keeps
the state of the row shards it holds a shard of, so every merge is a
function of shard coordinates alone, the same on every process, and
every process issues the merges it takes part in in the same order.

The merges are exact for integers, which is all the engines merge
(counts, labels, bit-plane words), so every factorisation of the mesh
gives the one-device result bit for bit.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from consensus_clustering_tpu_torch.device import resolve_device

RESAMPLE_AXIS = "h"
ROW_AXIS = "n"
KSHARD_AXIS = "k"
AXES = (KSHARD_AXIS, RESAMPLE_AXIS, ROW_AXIS)

Coord = Tuple[int, int, int]


class ProcessDevice(NamedTuple):
    """A device of one process: ``rank`` owns it, ``device`` is its name
    in that process."""

    rank: int
    device: torch.device


def _normalise(device) -> torch.device:
    """``device`` as a ``torch.device``, a CUDA device with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A (k, h, n) grid of devices, with the process rank of each.

    ``shape`` is a dict of axis sizes, as ``jax.sharding.Mesh.shape`` is.
    A coordinate is a ``(g, h, r)`` tuple.  This process computes the
    shards whose rank is its own (:meth:`is_local`).
    """

    axis_names = AXES

    def __init__(self, devices: np.ndarray, ranks: np.ndarray, rank: int = 0):
        if devices.ndim != 3 or devices.shape != ranks.shape:
            raise ValueError("a mesh is a (k, h, n) grid of devices and ranks")
        self.devices = devices
        self.ranks = ranks
        self.rank = int(rank)
        self.shape = dict(zip(AXES, devices.shape))
        local = [c for c in self.coords() if self.is_local(c)]
        if not local:
            raise ValueError(f"the mesh holds no device of process {rank}")
        self.primary = self.device(local[0])
        self.local_devices: List[torch.device] = list(
            dict.fromkeys(self.device(c) for c in local))
        self.process_ranks: Tuple[int, ...] = tuple(
            sorted(set(int(r) for r in ranks.flat)))
        self.process_count = len(self.process_ranks)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, processes={self.process_count}, "
                f"devices={[str(d) for d in self.devices.flat]})")

    def coords(self) -> List[Coord]:
        """Every coordinate, in grid order."""
        return list(itertools.product(*(range(s) for s in
                                        self.devices.shape)))

    def is_local(self, coord: Coord) -> bool:
        return int(self.ranks[coord]) == self.rank

    def device(self, coord: Coord) -> torch.device:
        return self.devices[coord]

    def axis(self, coord: Coord, name: str) -> List[Coord]:
        """The coordinates along axis ``name`` through ``coord``, in shard
        order."""
        i = AXES.index(name)
        return [coord[:i] + (j,) + coord[i + 1:]
                for j in range(self.devices.shape[i])]

    def owner(self, coords: Sequence[Coord]) -> Optional[Coord]:
        """This process's first coordinate among ``coords`` (where a merge
        over them lands here), or None."""
        return next((c for c in coords if self.is_local(c)), None)

    def ranks_of(self, coords: Sequence[Coord]) -> Tuple[int, ...]:
        """The processes holding ``coords``, sorted."""
        return tuple(sorted({int(self.ranks[c]) for c in coords}))

    def rank_sets(self) -> List[Tuple[int, ...]]:
        """The processes of every axis line, in grid order, then of the
        whole mesh: the sets the merges run in."""
        out = []
        for i, name in enumerate(AXES):
            for c in self.coords():
                if c[i] == 0:
                    out.append(self.ranks_of(self.axis(c, name)))
        out.append(self.process_ranks)
        return out

    def holds(self, g: int) -> bool:
        """True where this process holds a shard of k-group ``g``."""
        return bool((self.ranks[g] == self.rank).any())

    def row_owner(self, g: int, r: int) -> Optional[Coord]:
        """Where this process keeps the row block ``r`` of k-group ``g``:
        its first shard of that 'h' column, the owner of the merge over
        'h'; None where it holds no shard of the column (once 'n' or 'k'
        spans processes)."""
        return self.owner(self.axis((g, 0, r), RESAMPLE_AXIS))

    def held_rows(self, g: int) -> List[int]:
        """The row blocks of k-group ``g`` this process keeps."""
        return [r for r in range(self.shape[ROW_AXIS])
                if self.row_owner(g, r) is not None]

    def _dest(self, dest) -> torch.device:
        """A merge's destination: a coordinate's device, or a device."""
        return self.device(dest) if isinstance(dest, tuple) else dest

    def psum(self, parts: Dict[Coord, torch.Tensor],
             coords: Sequence[Coord], dest=None) -> Optional[torch.Tensor]:
        """The sum of integer partial counts over one axis group.

        ``parts`` holds this process's shards of ``coords`` (every local
        one).  They are summed on ``dest`` (a local coordinate or a
        device; default the device of :meth:`owner`), in shard order;
        across processes the sum is then all-reduced in the group of the
        processes holding ``coords``, so every one of them gets it.  None
        where this process holds no shard of the group.
        """
        owner = self.owner(coords)
        if owner is None:
            return None
        dev = self._dest(owner if dest is None else dest)
        total = None
        for c in coords:
            if c in parts:
                t = parts[c].to(dev, non_blocking=True)
                total = t if total is None else total + t
        ranks = self.ranks_of(coords)
        if len(ranks) > 1:
            from consensus_clustering_tpu_torch.parallel import distributed

            if any(total is p for p in parts.values()):
                total = total.clone()  # the reduction is in place
            distributed.all_reduce(total, ranks)
        return total

    def all_gather(self, parts: Dict[Coord, torch.Tensor],
                   coords: Sequence[Coord], dim: int = 0,
                   dest=None) -> torch.Tensor:
        """The concatenation of one axis group's shards along ``dim``, in
        shard order, on ``dest`` (a local coordinate or a device; default
        :meth:`owner`'s device); one shard is returned as it is.

        ``parts`` holds this process's shards of ``coords``.  Across
        processes every shard must have one shape: each process sends its
        shards stacked (padded with zeros to the most any process holds),
        the group of the processes holding ``coords`` all-gathers them,
        and every one of those processes concatenates the same shards.
        """
        dev = self._dest(self.owner(coords) if dest is None else dest)
        ranks = self.ranks_of(coords)
        if len(ranks) == 1:
            ts = [parts[c].to(dev, non_blocking=True) for c in coords]
            return ts[0] if len(ts) == 1 else torch.cat(ts, dim)
        from consensus_clustering_tpu_torch.parallel import distributed

        held = {rk: [c for c in coords if int(self.ranks[c]) == rk]
                for rk in ranks}
        mine = [parts[c].to(dev, non_blocking=True)
                for c in held[self.rank]]
        slots = max(len(cs) for cs in held.values())
        mine += [torch.zeros_like(mine[0])] * (slots - len(mine))
        got = distributed.all_gather(torch.stack(mine), ranks)
        pieces = []
        for c in coords:
            rk = int(self.ranks[c])
            pieces.append(got[ranks.index(rk)][held[rk].index(c)])
        return torch.cat(pieces, dim)

    def row_lines(self, g: int) -> List[List[Coord]]:
        """The 'n' lines of k-group ``g`` this process merges its row
        shards over, in 'h' order: every line spanning processes that
        holds a shard here (each of their processes takes part in each),
        else the first line it holds a shard of."""
        lines = [self.axis((g, h, 0), ROW_AXIS)
                 for h in range(self.shape[RESAMPLE_AXIS])]
        mine = [ln for ln in lines if self.owner(ln) is not None]
        spanning = [ln for ln in mine if len(self.ranks_of(ln)) > 1]
        return spanning or mine[:1]

    def rows_span(self, g: int) -> bool:
        """True where k-group ``g``'s row merges here cross processes."""
        return any(len(self.ranks_of(ln)) > 1 for ln in self.row_lines(g))

    def merge_rows(self, g: int, values: Dict[int, torch.Tensor],
                   dim: Optional[int] = None, dest=None) -> torch.Tensor:
        """k-group ``g``'s row shards combined on every process holding a
        shard of it: ``values[r]`` is this process's copy of row shard
        ``r``'s value (for each of :meth:`held_rows`), summed (``dim``
        None) or concatenated along ``dim`` in row order, on ``dest``.
        Every 'n' line holds each row shard once, so the merge runs along
        :meth:`row_lines`."""
        out = None
        for line in self.row_lines(g):
            parts = {c: values[c[2]] for c in line if self.is_local(c)}
            got = (self.psum(parts, line, dest=dest) if dim is None
                   else self.all_gather(parts, line, dim=dim, dest=dest))
            out = got if out is None else out  # every line: the same
        return out

    def splits_k(self) -> bool:
        """True where some process holds no shard of some k-group: its
        K values then come from other processes (:meth:`merge_k`)."""
        every = set(self.process_ranks)
        return any(set(int(r) for r in self.ranks[g].flat) != every
                   for g in range(self.shape[KSHARD_AXIS]))

    def merge_k(self, values: Dict[int, torch.Tensor],
                group_of: Sequence[int], like: torch.Tensor,
                dest) -> Dict[int, torch.Tensor]:
        """Every K position's value on every process: ``values`` holds
        those this process computed (its k-groups'), ``group_of[i]`` is
        position ``i``'s k-group, ``like`` a tensor of the values' shape
        and dtype.  Where :meth:`splits_k`, the lowest process of each
        k-group contributes its values, zeros elsewhere, and the sum is
        all-reduced over the mesh's processes: an integer sum with zeros,
        exact for counts and bit patterns alike."""
        if not self.splits_k():
            return values
        from consensus_clustering_tpu_torch.parallel import distributed

        buf = torch.zeros((len(group_of),) + tuple(like.shape),
                          dtype=like.dtype, device=dest)
        for i, g in enumerate(group_of):
            first = min(int(r) for r in self.ranks[g].flat)
            if i in values and first == self.rank:
                buf[i] = values[i].to(dest)
        distributed.all_reduce(buf, self.process_ranks)
        return {i: buf[i] for i in range(len(group_of))}


def _process_devices(devices) -> List[ProcessDevice]:
    from consensus_clustering_tpu_torch.parallel import distributed

    if devices is None:
        if distributed.is_initialized():
            return distributed.devices()
        resolve_device(None)  # raises without a visible GPU
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    rank = distributed.process_index()
    return [d if isinstance(d, ProcessDevice)
            else ProcessDevice(rank, _normalise(d)) for d in devices]


def resample_mesh(
    devices: Optional[Sequence] = None,
    row_shards: int = 1,
    k_shards: int = 1,
) -> Mesh:
    """A ('k', 'h', 'n') mesh over ``devices`` (default: every visible
    CUDA device, or after :func:`.distributed.initialize` every
    process's, in rank-major order).

    ``k_shards`` groups split the K sweep; within each group
    ``row_shards`` devices shard consensus-matrix rows and the rest go to
    the resample axis.  One device gives the trivial 1 x 1 x 1 mesh, which
    is also the single-device path.  ``devices`` are this process's
    ``torch.device``s (or names; one may repeat) or
    :class:`ProcessDevice`s.
    """
    from consensus_clustering_tpu_torch.parallel import distributed

    entries = _process_devices(devices)
    n_dev = len(entries)
    if k_shards < 1 or row_shards < 1:
        raise ValueError(
            f"k_shards={k_shards} and row_shards={row_shards} must be >= 1"
        )
    if n_dev % (row_shards * k_shards) != 0:
        raise ValueError(
            f"{n_dev} devices not divisible by "
            f"k_shards*row_shards={k_shards * row_shards}"
        )
    shape = (k_shards, n_dev // (row_shards * k_shards), row_shards)
    grid = np.empty(n_dev, dtype=object)
    grid[:] = [e.device for e in entries]
    ranks = np.asarray([e.rank for e in entries], dtype=np.int64)
    mesh = Mesh(grid.reshape(shape), ranks.reshape(shape),
                distributed.process_index())
    if mesh.process_count > 1:
        if mesh.process_count != distributed.process_count():
            raise ValueError(
                f"a mesh across processes spans every process: this one "
                f"holds {mesh.process_count} of "
                f"{distributed.process_count()}")
        distributed.make_groups(mesh.rank_sets())
    return mesh


def engine_mesh(mesh: Optional[Mesh], device=None) -> Mesh:
    """The mesh an engine runs on: ``mesh``, or the 1 x 1 x 1 mesh of
    ``device`` (default ``cuda``; without one this raises unless the
    caller names the CPU).  Both may be given only when ``device`` is the
    mesh's primary device."""
    if mesh is None:
        return resample_mesh([resolve_device(device)])
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a consensus_clustering_tpu_torch Mesh "
            f"(parallel.resample_mesh), got {type(mesh).__name__}"
        )
    if device is not None and _normalise(device) != mesh.primary:
        raise ValueError(
            f"device={device!r} is not the mesh's primary device "
            f"{mesh.primary}: pass one of device and mesh"
        )
    return mesh
