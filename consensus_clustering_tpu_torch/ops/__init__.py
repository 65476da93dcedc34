"""Tensor operations of the sweep: resampling, exact counts, bit-planes,
analysis, and the hand-written CUDA kernels: the histogram (:mod:`.hist`),
the Lloyd step (:mod:`.lloyd`), the popcount counts (:mod:`.popcount`),
the final assignment, alone and fused with packing (:mod:`.fused_block`),
and the k-means++ candidate draws (:mod:`.kmeanspp`, whose launch count is
its module's own and not among :func:`launch_counts`).
"""

from typing import Dict


def _counters():
    """Each kernel's name -> (wrapper module, its launch-count attribute)."""
    from consensus_clustering_tpu_torch.ops import (
        fused_block,
        hist,
        lloyd,
        popcount,
    )

    return {
        "hist": (hist, "launch_count"),
        "lloyd": (lloyd, "launch_count"),
        "popcount": (popcount, "launch_count"),
        "fused_block": (fused_block, "launch_count"),
        "assign": (fused_block, "assign_launch_count"),
    }


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches since its count was last set to 0."""
    return {name: getattr(module, attr)
            for name, (module, attr) in _counters().items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for module, attr in _counters().values():
        setattr(module, attr, 0)
