"""Consensus-CDF histogram: the CUDA kernel ``csrc/hist.cu`` and its plain
PyTorch version.

Counts the strict upper triangle of a Cij row block into ``bins`` bins over
[0, 1], against the f32-rounded ``linspace`` edges (last bin right-closed),
so the counts equal ``np.histogram``'s.  ``row_offset`` places the block's
row 0 in global coordinates; rows and columns >= ``n_valid`` are ignored.

On a CPU tensor :func:`consensus_hist_counts` runs the plain version; on a
CUDA tensor it launches the kernel, or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from consensus_clustering_tpu_torch.ops import _build
from consensus_clustering_tpu_torch.ops.analysis import (
    hist_edges,
    masked_histogram_counts,
)

MAX_BINS = 128

#: Kernel launches since the count was last set to 0.
launch_count = 0


def _triangle_mask(cij: torch.Tensor, n_valid: int, row_offset: int):
    rows = row_offset + torch.arange(cij.shape[0], device=cij.device)
    cols = torch.arange(cij.shape[1], device=cij.device)
    return (
        (cols[None, :] > rows[:, None])
        & (rows[:, None] < n_valid)
        & (cols[None, :] < n_valid)
    )


def consensus_hist_counts_plain(
    cij: torch.Tensor, n_valid: int, row_offset: int, bins: int
) -> torch.Tensor:
    """The plain version: a masked compare-and-sum per bin."""
    mask = _triangle_mask(cij, n_valid, row_offset)
    return masked_histogram_counts(cij, mask, bins)


@functools.lru_cache(maxsize=None)
def _device_edges(bins: int, device: torch.device) -> torch.Tensor:
    """The bins' edges on ``device``, copied there once, not per launch."""
    return torch.tensor(hist_edges(bins), device=device)


def _library():
    lib = _build.load("hist")
    if not getattr(lib, "_cc_typed", False):
        lib.cc_hist_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.cc_hist_counts.restype = ctypes.c_int
        lib.cc_error_string.argtypes = [ctypes.c_int]
        lib.cc_error_string.restype = ctypes.c_char_p
        lib._cc_typed = True
    return lib


def consensus_hist_counts_kernel(
    cij: torch.Tensor, n_valid: int, row_offset: int, bins: int
) -> torch.Tensor:
    """Launch ``csrc/hist.cu`` on PyTorch's current stream."""
    global launch_count
    if cij.device.type != "cuda":
        raise ValueError(f"the histogram kernel needs a CUDA tensor, got {cij.device}")
    if cij.dtype != torch.float32 or cij.dim() != 2:
        raise ValueError(
            f"cij must be a 2-D float32 tensor, got {cij.dtype} {tuple(cij.shape)}"
        )
    cij = cij.contiguous()
    edges = _device_edges(bins, cij.device)
    out = torch.zeros(bins, dtype=torch.int32, device=cij.device)
    lib = _library()
    status = lib.cc_hist_counts(
        cij.data_ptr(), cij.shape[0], cij.shape[1], int(row_offset),
        int(n_valid), edges.data_ptr(), bins, out.data_ptr(),
        torch.cuda.current_stream(cij.device).cuda_stream,
    )
    if status != 0:
        raise RuntimeError(
            f"hist kernel launch failed: {lib.cc_error_string(status).decode()}"
        )
    launch_count += 1
    return out


def consensus_hist_counts(
    cij: torch.Tensor, n_valid: int, row_offset: int, bins: int
) -> torch.Tensor:
    """(bins,) int32 counts of the strict upper triangle of a Cij block.

    Args:
      cij: (R, C) f32 consensus-matrix block (the full matrix when R == C).
      n_valid: N; global rows and columns >= N are padding.
      row_offset: global index of the block's row 0.
      bins: histogram bins over [0, 1], at most 128.
    """
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"bins={bins} must be in [1, {MAX_BINS}]")
    if cij.device.type == "cpu":
        return consensus_hist_counts_plain(cij, n_valid, row_offset, bins)
    return consensus_hist_counts_kernel(cij, n_valid, row_offset, bins)
