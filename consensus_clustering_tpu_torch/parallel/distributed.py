"""Multi-process bootstrap: one call before building a mesh across processes.

The port of the reference package's ``parallel/distributed.py``.  Once every
process has called :func:`initialize`, :func:`..mesh.resample_mesh` (with no
devices) spans every process's devices in rank-major order, as
``jax.devices()`` does after ``jax.distributed.initialize``, and the same
sharded engine runs on every process: each computes its own shards, and a
merge whose shards lie on several processes goes through the
``torch.distributed`` group of exactly those processes.  Building a mesh
makes the group of every set of ranks one of its axis lines spans
(:func:`make_groups`, collective: every process builds the same mesh).

The groups' backend: NCCL when every process has CUDA cards of its own;
gloo on the CPU, and for processes that share a card (NCCL refuses two
ranks on one GPU).  The choice is logged and :func:`backend` reports it.
gloo takes CUDA tensors in its all-reduce and all-gather but runs them
in host memory (it copies them to the host and back inside the call;
checked with torch 2.11 on an H100 by ``chip_smoke.py``'s ``mesh``
phase).  Objects
(a resumed frame, a mode decision, a sentinel's verdict) go over the
default gloo group (:func:`broadcast_object`, :func:`gather_objects`).
Typical launch (the same script in every process)::

    from consensus_clustering_tpu_torch.parallel import distributed
    distributed.initialize("10.0.0.1:29500", num_processes=2, process_id=r)
    mesh = resample_mesh(row_shards=2)      # every process's devices
    cc = ConsensusClustering(..., mesh=mesh)

Every engine that takes a mesh runs across processes (the monolithic
sweep, the stream, the estimator), with any of 'k', 'h' and 'n' spanning
them; every process ends with the one-device result, and only the
primary (rank 0) writes checkpoints.
"""

from __future__ import annotations

import logging
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from consensus_clustering_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

# The process's distributed state: the devices table, the backend and the
# merges' groups (sorted rank tuple -> group).  The process group itself
# is process-global in torch.distributed, as the runtime is in JAX.
_STATE: Dict[str, Any] = {}


def _card_id(device: torch.device) -> str:
    """What makes two processes' devices the same card: the CUDA card's
    UUID, or the host's CPU."""
    if device.type == "cuda":
        uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
        if uuid is not None:
            return str(uuid)
        return f"{socket.gethostname()}:cuda:{device.index}"
    return "cpu"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_devices: Optional[Sequence] = None,
) -> None:
    """Join the process group (idempotent; ``num_processes=1`` is a no-op).

    ``coordinator_address`` is ``host:port`` of process 0 (None: torch's
    ``env://`` variables).  ``local_devices`` are this process's devices
    in the global mesh (default every visible CUDA card; the CPU only
    when named, e.g. ``["cpu", "cpu"]``).
    """
    import torch.distributed as dist

    from consensus_clustering_tpu_torch.parallel.mesh import (
        ProcessDevice,
        _normalise,
    )

    if num_processes == 1:
        logger.info("distributed: single process, nothing to initialise")
        return
    if is_initialized():
        logger.info("distributed: already initialised")
        return
    if local_devices is None:
        resolve_device(None)  # raises without a visible GPU
        local_devices = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
    local = [_normalise(d) for d in local_devices]
    init_method = ("env://" if coordinator_address is None
                   else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=num_processes, rank=process_id)
    table: List[Optional[List[Tuple[str, str]]]] = [None] * dist.get_world_size()
    dist.all_gather_object(table, [(str(d), _card_id(d)) for d in local])
    cards = [card for entries in table for _, card in entries]
    per_rank = [{card for _, card in entries} for entries in table]
    shared = any(per_rank[a] & per_rank[b]
                 for a in range(len(per_rank))
                 for b in range(a + 1, len(per_rank)))
    if all(card != "cpu" for card in cards) and not shared:
        backend = "nccl"
        torch.cuda.set_device(local[0])
        world = dist.new_group(backend="nccl")
    else:
        backend = "gloo"
        world = dist.group.WORLD
    _STATE.update(
        backend=backend,
        groups={tuple(range(dist.get_world_size())): world},
        devices=[ProcessDevice(rank, torch.device(name))
                 for rank, entries in enumerate(table)
                 for name, _ in entries],
    )
    logger.info(
        "distributed: process %d/%d up, %d global devices, merges over "
        "%s%s",
        dist.get_rank(), dist.get_world_size(), len(_STATE["devices"]),
        backend, " (processes share a card)" if shared else "",
    )


def is_initialized() -> bool:
    """True once :func:`initialize` has joined a group in this process."""
    return bool(_STATE)


def process_index() -> int:
    """This process's rank (0 without a group)."""
    if not is_initialized():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def process_count() -> int:
    """The processes in the group (1 without one)."""
    if not is_initialized():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def is_primary() -> bool:
    """True on the process that should write checkpoints, plots and logs."""
    return process_index() == 0


def backend() -> Optional[str]:
    """``nccl`` or ``gloo``: the backend the counts are merged over (None
    without a group)."""
    return _STATE.get("backend")


def devices():
    """Every process's devices in rank-major order
    (:class:`..mesh.ProcessDevice`)."""
    if not is_initialized():
        raise RuntimeError("distributed.initialize has not run")
    return list(_STATE["devices"])


def make_groups(rank_sets: Sequence[Sequence[int]]) -> None:
    """Make the group of each set of two or more ranks that has none yet,
    in the order given, on the merges' backend.  Collective:
    ``torch.distributed.new_group`` must be called by every process for
    every group, members or not, in the same order, so every process
    calls this with the same sets (a mesh's, in grid order)."""
    import torch.distributed as dist

    if not is_initialized():
        raise RuntimeError("distributed.initialize has not run")
    groups = _STATE["groups"]
    for ranks in rank_sets:
        key = tuple(sorted(set(int(r) for r in ranks)))
        if len(key) > 1 and key not in groups:
            groups[key] = dist.new_group(ranks=list(key),
                                         backend=_STATE["backend"])
            logger.info("distributed: group %s over %s", key,
                        _STATE["backend"])


def group(ranks: Sequence[int]):
    """The group of exactly ``ranks`` (made by :func:`make_groups`)."""
    key = tuple(sorted(set(int(r) for r in ranks)))
    if not is_initialized() or key not in _STATE["groups"]:
        raise RuntimeError(
            f"no process group for ranks {key}: build the mesh with "
            "resample_mesh after distributed.initialize")
    return _STATE["groups"][key]


def all_reduce(tensor: torch.Tensor, ranks: Sequence[int]) -> None:
    """Sum ``tensor`` in place over the processes ``ranks``."""
    import torch.distributed as dist

    dist.all_reduce(tensor, group=group(ranks))


def all_gather(tensor: torch.Tensor,
               ranks: Sequence[int]) -> List[torch.Tensor]:
    """Every one of ``ranks``' ``tensor`` (equal shapes), in rank order,
    on ``tensor``'s device."""
    import torch.distributed as dist

    tensor = tensor.contiguous()
    out = [torch.empty_like(tensor) for _ in sorted(set(ranks))]
    dist.all_gather(out, tensor, group=group(ranks))
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``obj`` of process ``src`` on every process (pickled, over the
    default gloo group); every process calls it, the others' ``obj``
    unused."""
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def gather_objects(obj: Any) -> List[Any]:
    """Every process's ``obj``, in rank order, on every process."""
    import torch.distributed as dist

    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def shutdown() -> None:
    """Leave the group (tests and scripts that start a second one)."""
    import torch.distributed as dist

    if is_initialized():
        dist.destroy_process_group()
        _STATE.clear()
