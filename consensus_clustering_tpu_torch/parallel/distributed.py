"""Multi-process bootstrap: one call before building a mesh across processes.

The port of the reference package's ``parallel/distributed.py``.  Once every
process has called :func:`initialize`, :func:`..mesh.resample_mesh` (with no
devices) spans every process's devices in rank-major order, as
``jax.devices()`` does after ``jax.distributed.initialize``, and the same
sharded engine runs on every process: each computes its own shards, and a
merge whose shards lie on several processes goes through a
``torch.distributed`` process group on the int32 counts.

The group's backend: NCCL when every process has CUDA cards of its own;
gloo on the CPU, and for processes that share a card (NCCL refuses two
ranks on one GPU).  The choice is logged and :func:`backend` reports it.
gloo takes the counts as CUDA tensors but runs its all-reduce in host
memory: it copies them to the host and back inside the call.
Typical launch (the same script in every process)::

    from consensus_clustering_tpu_torch.parallel import distributed
    distributed.initialize("10.0.0.1:29500", num_processes=2, process_id=r)
    mesh = resample_mesh(row_shards=2)      # every process's devices
    cc = ConsensusClustering(..., mesh=mesh)

The monolithic sweep runs across processes; the stream and the estimator
take a mesh of one process only (ROADMAP A19).
"""

from __future__ import annotations

import logging
import socket
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from consensus_clustering_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

# The process's distributed state: the devices table and the counts'
# group.  The process group itself is process-global in torch.distributed,
# as the runtime is in JAX.
_STATE: Dict[str, object] = {}


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
        counts_group = dist.new_group(backend="nccl")
    else:
        backend = "gloo"
        counts_group = dist.group.WORLD
    _STATE.update(
        backend=backend,
        group=counts_group,
        devices=[ProcessDevice(rank, torch.device(name))
                 for rank, entries in enumerate(table)
                 for name, _ in entries],
    )
    logger.info(
        "distributed: process %d/%d up, %d global devices, counts over %s%s",
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


def counts_group():
    """The process group the counts are merged in (every process)."""
    if not is_initialized():
        raise RuntimeError("distributed.initialize has not run")
    return _STATE["group"]


def shutdown() -> None:
    """Leave the group (tests and scripts that start a second one)."""
    import torch.distributed as dist

    if is_initialized():
        dist.destroy_process_group()
        _STATE.clear()
