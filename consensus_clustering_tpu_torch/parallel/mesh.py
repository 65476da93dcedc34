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
rank-major order, and a sum over 'h' whose shards lie on several
processes is all-reduced in the process group (:mod:`.distributed`).

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
        self.process_count = len(set(ranks.flat))

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

    def row_owner(self, g: int, r: int) -> Coord:
        """Where this process keeps the row block ``r`` of k-group ``g``:
        its first shard of that 'h' column, the owner of the merge over
        'h' (every process holds one, :func:`_check_process_layout`)."""
        return self.owner(self.axis((g, 0, r), RESAMPLE_AXIS))

    def _group(self, coords: Sequence[Coord]):
        """The process group of the counts when ``coords`` lie on several
        processes (then on every one: :func:`_check_process_layout`), else
        None."""
        if len({int(self.ranks[c]) for c in coords}) == 1:
            return None
        from consensus_clustering_tpu_torch.parallel import distributed

        return distributed.counts_group()

    def psum(self, parts: Dict[Coord, torch.Tensor],
             coords: Sequence[Coord]) -> Optional[torch.Tensor]:
        """The sum of integer partial counts over one axis group.

        ``parts`` holds this process's shards of ``coords`` (every local
        one).  They are summed on the device of :meth:`owner`, in shard
        order; across processes the sum is then all-reduced in the
        group, so every process holding a shard gets it.  None where this
        process holds no shard of the group.
        """
        owner = self.owner(coords)
        if owner is None:
            return None
        dev = self.device(owner)
        total = None
        for c in coords:
            if c in parts:
                t = parts[c].to(dev, non_blocking=True)
                total = t if total is None else total + t
        group = self._group(coords)
        if group is not None:
            import torch.distributed as dist

            if any(total is p for p in parts.values()):
                total = total.clone()  # the reduction is in place
            dist.all_reduce(total, group=group)
        return total

    def all_gather(self, parts: Dict[Coord, torch.Tensor],
                   coords: Sequence[Coord], dim: int = 0,
                   dest: Optional[Coord] = None) -> torch.Tensor:
        """The concatenation of one axis group's shards along ``dim``, in
        shard order, on ``dest``'s device (default :meth:`owner`); one
        shard is returned as it is.  The shards lie in this process:
        across processes the ported layouts split 'h' only
        (:func:`_check_process_layout`), and the engines gather along 'n'
        and 'k'."""
        dev = self.device(self.owner(coords) if dest is None else dest)
        ts = [parts[c].to(dev, non_blocking=True) for c in coords]
        return ts[0] if len(ts) == 1 else torch.cat(ts, dim)


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
        _check_process_layout(mesh)
    return mesh


def _check_process_layout(mesh: Mesh) -> None:
    """Across processes the ported layouts split the 'h' axis only: each
    process holds whole 'n' rows and a shard of every ('k', 'n')
    position, so each merge over 'n' or 'k' stays in one process and
    every process ends with the whole result."""
    from consensus_clustering_tpu_torch.config import not_ported

    every = set(int(r) for r in mesh.ranks.flat)
    k_s, h_s, n_s = mesh.devices.shape
    rows_whole = all(len(set(mesh.ranks[g, h, :].tolist())) == 1
                     for g in range(k_s) for h in range(h_s))
    columns_full = all(set(mesh.ranks[g, :, r].tolist()) == every
                       for g in range(k_s) for r in range(n_s))
    if not (rows_whole and columns_full):
        raise not_ported(
            "a mesh whose 'k' or 'n' axis spans processes (across "
            "processes, shard 'h' only: every process holds whole 'n' rows "
            "and a device of every 'k' group)", "A19")


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
