"""Resilience for streamed sweeps: checkpoints, fault injection, integrity.

The port of the reference package's ``resilience`` package.  The
streaming engine's state at a block boundary is an exact resume point
(the resample plan folds every draw with its GLOBAL index), and this
package turns that into recovery at block granularity:

- :mod:`.blocks`: :class:`StreamCheckpointer`, a ring of CRC-framed,
  atomically renamed block generations written by a background thread;
- :mod:`.faults`: deterministic fault injection (``CCTPU_FAULTS`` or
  ``faults.configure``) and :func:`classify_error`;
- :mod:`.integrity`: the accumulator sentinels the driver runs every
  ``integrity_check_every`` blocks, the digest and invariant check that
  makes resume trust only verified generations, and input admission.
"""

from consensus_clustering_tpu_torch.resilience.blocks import (
    CheckpointFrameError,
    StreamCheckpointer,
)
from consensus_clustering_tpu_torch.resilience.faults import (
    FaultInjector,
    InjectedFault,
    InjectedOOM,
    IntegrityError,
    classify_error,
    faults,
)
from consensus_clustering_tpu_torch.resilience.integrity import (
    INTEGRITY_POINTS,
    check_input_matrix,
    frame_digest,
    verify_state_frame,
)

__all__ = [
    "CheckpointFrameError",
    "FaultInjector",
    "INTEGRITY_POINTS",
    "InjectedFault",
    "InjectedOOM",
    "IntegrityError",
    "StreamCheckpointer",
    "check_input_matrix",
    "classify_error",
    "faults",
    "frame_digest",
    "verify_state_frame",
]
