# Ported from consensus_clustering_tpu/ops/probe.py.
"""Once-per-device kernel probe: every CUDA kernel built and launched.

The reference probes each Pallas kernel once per backend and, when one
fails to compile or run, degrades to the XLA fallback with a warning.  The
port has no fallback: :func:`probe_kernels` builds every kernel, launches
each once on a ragged multi-tile shape (edge tiles are where a layout bug
hides), holds each output against its plain version, and **raises** if a
build, a launch or a comparison fails.  The verdict is cached per CUDA
device, so a service pays the probe once at start-up and a broken build
stops it there, before its first job.  On the CPU the wrappers take their
plain versions, and the verdict is ``plain``.

The probe's launches count in the kernels' launch counts like any other.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Tuple

import torch

from consensus_clustering_tpu_torch.ops import (
    fused_block,
    hist,
    lloyd,
    popcount,
)
from consensus_clustering_tpu_torch.ops.analysis import consensus_matrix
from consensus_clustering_tpu_torch.ops.bitpack import (
    pack_cosample_planes,
    popcount_accumulate,
)

# CUDA device -> verdict.  Module-global on purpose: the verdict is a
# property of the device and the checkout's kernels, not of any caller.
_VERDICTS: Dict[str, str] = {}
_LOCK = threading.Lock()


class KernelProbeError(RuntimeError):
    """A kernel launched but disagreed with its plain version."""


def _equal(got, ref) -> bool:
    if isinstance(got, tuple):
        return all(torch.equal(a, b.to(a.dtype)) for a, b in zip(got, ref))
    return torch.equal(got, ref)


def _cases(dev: torch.device) -> List[Tuple[str, Callable, Callable]]:
    """(kernel, wrapper call, plain call) at ragged shapes: rows and
    columns that fill no tile, ``k`` below ``k_max``, lanes that straddle
    a word, a row block off the diagonal."""
    g = torch.Generator(device=dev).manual_seed(23)
    iij = torch.randint(1, 41, (129, 517), generator=g, device=dev,
                        dtype=torch.int32)
    mij = torch.floor(iij * torch.rand((129, 517), generator=g,
                                       device=dev)).int()
    cij = consensus_matrix(mij, iij)
    zeros = torch.zeros(20, dtype=torch.int64, device=dev)
    b, n, d, n_init, k_max, k = 5, 1237, 37, 2, 13, 9
    x = torch.randn((b, n, d), generator=g, device=dev) * 3
    src = torch.arange(b, device=dev,
                       dtype=torch.int32).repeat_interleave(n_init)
    cents = x[src.long()[:, None],
              torch.randint(0, n, (b * n_init, k_max), generator=g,
                            device=dev)]
    words = torch.randint(-2**31, 2**31 - 1, (13, 300), generator=g,
                          device=dev, dtype=torch.int32)
    n_cols, lanes, n_words, row0 = 640, 45, 2, 17
    cols = torch.randn((n_cols, 24), generator=g, device=dev) * 3
    idx = torch.stack([torch.randperm(n_cols, generator=g, device=dev)
                       [:int(0.8 * n_cols)] for _ in range(lanes)])
    cop = pack_cosample_planes(idx, n_cols, n_words=n_words, row0=row0)
    lane_cents = cols[torch.randint(0, n_cols, (lanes, 9), generator=g,
                                    device=dev)]
    return [
        ("hist", lambda: hist.consensus_hist_counts(cij, 500, 200, 20),
         lambda: hist.consensus_hist_counts_plain(cij, 500, 200, 20)),
        ("hist (count entry)",
         lambda: hist.consensus_hist_from_counts(
             mij, iij, 500, 200, 20, zeros.clone()),
         lambda: hist.consensus_hist_from_counts_plain(
             mij, iij, 500, 200, 20, zeros.clone())),
        ("lloyd", lambda: lloyd.lloyd_step(x, src, cents, k),
         lambda: lloyd.lloyd_step_ordered_plain(x, src, cents, k)),
        ("assign", lambda: fused_block.assign_labels(x, src, cents, k),
         lambda: fused_block.assign_labels_plain(x, src, cents, k)),
        ("popcount",
         lambda: popcount.packed_coassoc_counts(words[:, 36:300], words),
         lambda: popcount_accumulate(words[:, 36:300], words)),
        ("fused_block",
         lambda: fused_block.fused_assign_pack(cols, lane_cents, 5, cop,
                                               row0, n_words=n_words),
         lambda: fused_block.fused_planes_plain(cols, lane_cents, 5, cop,
                                                row0, n_words)),
    ]


def probe_kernels(device) -> str:
    """``cuda`` once every kernel has been built, launched and found equal
    to its plain version on ``device``; ``plain`` for the CPU.

    Raises :class:`..ops._build.KernelBuildError` when a kernel does not
    build, ``RuntimeError`` when one does not launch, and
    :class:`KernelProbeError` when one disagrees with its plain version.
    A failed probe is not cached: the next call probes again.
    """
    device = torch.device(device)
    if device.type != "cuda":
        return "plain"
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    with _LOCK:
        if key not in _VERDICTS:
            with torch.cuda.device(device):
                wrong = [name for name, got, ref in _cases(device)
                         if not _equal(got(), ref())]
                torch.cuda.synchronize(device)
            if wrong:
                raise KernelProbeError(
                    f"kernels {wrong} disagree with their plain versions "
                    f"on {torch.cuda.get_device_name(device)} ({key})"
                )
            _VERDICTS[key] = "cuda"
        return _VERDICTS[key]
