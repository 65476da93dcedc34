"""Consensus-CDF histogram: the CUDA kernel ``csrc/hist.cu`` and its plain
PyTorch version, with two entries.

Counts the strict upper triangle of a row block into ``bins`` bins over
[0, 1], against the f32-rounded ``linspace`` edges (last bin right-closed),
so the counts equal ``np.histogram``'s.  ``row_offset`` places the block's
row 0 in global coordinates; rows and columns >= ``n_valid`` are ignored.
:func:`consensus_hist_counts` takes a Cij block (the dense sweep);
:func:`consensus_hist_from_counts` takes the int32 Mij and Iij tiles and
forms Cij in the kernel's registers, the bits of
:func:`.analysis.consensus_matrix` (the streaming engine's evaluation).

On CPU tensors the entries run the plain version; on CUDA tensors they
launch the kernel, or raise.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from consensus_clustering_tpu_torch.ops import _build
from consensus_clustering_tpu_torch.ops.analysis import (
    consensus_matrix,
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
def _host_edges(bins: int) -> np.ndarray:
    """The edges the kernel takes by value, kept alive per bins."""
    return np.ascontiguousarray(hist_edges(bins))


def _library():
    lib = _build.load("hist")
    if not getattr(lib, "_cc_typed", False):
        lib.cc_hist_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.cc_hist_counts.restype = ctypes.c_int
        lib.cc_hist_from_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.cc_hist_from_counts.restype = ctypes.c_int
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
    out = torch.zeros(bins, dtype=torch.int32, device=cij.device)
    lib = _library()
    # Launch on the tensors' card: the stream is that card's, and the
    # library reads the current device (its shared-memory reservations).
    with torch.cuda.device(cij.device):
        status = lib.cc_hist_counts(
            cij.data_ptr(), cij.shape[0], cij.shape[1], int(row_offset),
            int(n_valid), _host_edges(bins).ctypes.data, bins, out.data_ptr(),
            torch.cuda.current_stream(cij.device).cuda_stream,
        )
    _check_status(lib, status)
    launch_count += 1
    return out


def _check_status(lib, status):
    if status != 0:
        raise RuntimeError(
            f"hist kernel launch failed: {lib.cc_error_string(status).decode()}"
        )


def consensus_hist_from_counts_plain(
    mij: torch.Tensor, iij: torch.Tensor, n_valid: int, row_offset: int,
    bins: int, out: torch.Tensor,
) -> torch.Tensor:
    """The plain version of :func:`consensus_hist_from_counts`:
    :func:`.analysis.consensus_matrix`, then the plain histogram."""
    cij = consensus_matrix(mij, iij, row_offset=row_offset)
    out += consensus_hist_counts_plain(cij, n_valid, row_offset, bins)
    return out


def consensus_hist_from_counts_kernel(
    mij: torch.Tensor, iij: torch.Tensor, n_valid: int, row_offset: int,
    bins: int, out: torch.Tensor,
) -> torch.Tensor:
    """Launch the count entry of ``csrc/hist.cu`` on PyTorch's current
    stream."""
    global launch_count
    if mij.device.type != "cuda" or iij.device != mij.device or (
        out.device != mij.device
    ):
        raise ValueError(
            "the histogram kernel needs mij, iij and out on one CUDA device, "
            f"got {mij.device} / {iij.device} / {out.device}"
        )
    if mij.dtype != torch.int32 or iij.dtype != torch.int32 or (
        mij.dim() != 2 or mij.shape != iij.shape
    ):
        raise ValueError(
            f"mij and iij must be 2-D int32 tensors of one shape, got "
            f"{mij.dtype} {tuple(mij.shape)} / {iij.dtype} {tuple(iij.shape)}"
        )
    if out.dtype != torch.int64 or tuple(out.shape) != (bins,) or (
        not out.is_contiguous()
    ):
        raise ValueError(
            f"out must be a contiguous ({bins},) int64 tensor, got "
            f"{out.dtype} {tuple(out.shape)}"
        )
    mij, iij = mij.contiguous(), iij.contiguous()
    lib = _library()
    # Launch on the tensors' card: the stream is that card's, and the
    # library reads the current device (its shared-memory reservations).
    with torch.cuda.device(mij.device):
        status = lib.cc_hist_from_counts(
            mij.data_ptr(), iij.data_ptr(), mij.shape[0], mij.shape[1],
            int(row_offset), int(n_valid), _host_edges(bins).ctypes.data, bins,
            out.data_ptr(), torch.cuda.current_stream(mij.device).cuda_stream,
        )
    _check_status(lib, status)
    launch_count += 1
    return out


def consensus_hist_from_counts(
    mij: torch.Tensor, iij: torch.Tensor, n_valid: int, row_offset: int,
    bins: int, out: torch.Tensor,
) -> torch.Tensor:
    """Add the (bins,) counts of the strict upper triangle of the Cij of
    int32 count tiles into ``out``; returns ``out``.

    Equal to ``out += consensus_hist_counts(consensus_matrix(mij, iij,
    row_offset), n_valid, row_offset, bins)``, without forming Cij.

    Args:
      mij, iij: (R, C) int32 co-clustering and co-sampling counts.
      n_valid: N; global rows and columns >= N are padding.
      row_offset: global index of the block's row 0.
      bins: histogram bins over [0, 1], at most 128.
      out: (bins,) int64 counts, added to in place.
    """
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"bins={bins} must be in [1, {MAX_BINS}]")
    if mij.device.type == "cpu":
        return consensus_hist_from_counts_plain(mij, iij, n_valid, row_offset,
                                                bins, out)
    return consensus_hist_from_counts_kernel(mij, iij, n_valid, row_offset,
                                             bins, out)


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
