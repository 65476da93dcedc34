"""Execution layer: the device mesh, the sweep engines, multi-process init.

The names below load on first use, so that importing a module of this
package does not import every engine.
"""

import importlib

_EXPORTS = {
    "distributed": "consensus_clustering_tpu_torch.parallel.distributed",
    "resample_mesh": "consensus_clustering_tpu_torch.parallel.mesh",
    "build_sweep": "consensus_clustering_tpu_torch.parallel.sweep",
    "run_sweep": "consensus_clustering_tpu_torch.parallel.sweep",
    "StreamingSweep": "consensus_clustering_tpu_torch.parallel.streaming",
    "run_streaming_sweep": "consensus_clustering_tpu_torch.parallel.streaming",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name == "distributed":
        return importlib.import_module(_EXPORTS[name])
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
