"""Popcount co-occurrence counts: the CUDA kernel ``csrc/popcount.cu`` and
its plain PyTorch version.

``out[i, j] = sum_l popcount(row_words[l, i] & col_words[l, j])`` over int32
words holding uint32 bit patterns (:mod:`.bitpack`): exact packed Mij/Iij
tiles.  On CPU tensors :func:`packed_coassoc_counts` runs the plain version
(:func:`.bitpack.popcount_accumulate`); on CUDA tensors it launches the
kernel, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from consensus_clustering_tpu_torch.ops import _build
from consensus_clustering_tpu_torch.ops.bitpack import popcount_accumulate

#: Kernel launches since the count was last set to 0.
launch_count = 0


def _library():
    lib = _build.load("popcount")
    if not getattr(lib, "_cc_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cc_popcount_counts.argtypes = [p, p, i, i, i, ll, ll, p, p]
        lib.cc_popcount_counts.restype = ctypes.c_int
        lib.cc_error_string.argtypes = [ctypes.c_int]
        lib.cc_error_string.restype = ctypes.c_char_p
        lib._cc_typed = True
    return lib


def _row_major(words: torch.Tensor) -> torch.Tensor:
    """``words`` itself when its rows are unit-stride (a column slice of
    the planes passes as is), else a contiguous copy."""
    if words.dim() == 2 and words.stride(1) == 1 and (
        words.shape[0] <= 1 or words.stride(0) >= words.shape[1]
    ):
        return words
    return words.contiguous()


def packed_coassoc_counts_kernel(
    row_words: torch.Tensor, col_words: torch.Tensor
) -> torch.Tensor:
    """Launch ``csrc/popcount.cu`` on PyTorch's current stream."""
    global launch_count
    if row_words.device.type != "cuda" or col_words.device != row_words.device:
        raise ValueError(
            "the popcount kernel needs both operands on one CUDA device, got "
            f"{row_words.device} / {col_words.device}"
        )
    if row_words.dtype != torch.int32 or col_words.dtype != torch.int32:
        raise ValueError(
            f"bit-planes must be int32 bit patterns, got {row_words.dtype} / "
            f"{col_words.dtype}"
        )
    if row_words.dim() != 2 or col_words.dim() != 2 or (
        row_words.shape[0] != col_words.shape[0]
    ):
        raise ValueError(
            f"expected (L, R) and (L, C) words, got {tuple(row_words.shape)} "
            f"and {tuple(col_words.shape)}"
        )
    rows, cols = _row_major(row_words), _row_major(col_words)
    n_words, n_rows = rows.shape
    n_cols = cols.shape[1]
    out = torch.empty((n_rows, n_cols), dtype=torch.int32, device=rows.device)
    lib = _library()
    # Launch on the tensors' card: the stream is that card's, and the
    # library reads the current device (its shared-memory reservations).
    with torch.cuda.device(rows.device):
        status = lib.cc_popcount_counts(
            rows.data_ptr(), cols.data_ptr(), n_words, n_rows, n_cols,
            max(rows.stride(0), n_rows), max(cols.stride(0), n_cols),
            out.data_ptr(), torch.cuda.current_stream(rows.device).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"popcount kernel launch failed: "
            f"{lib.cc_error_string(status).decode()}"
        )
    launch_count += 1
    return out


def packed_coassoc_counts(
    row_words: torch.Tensor, col_words: torch.Tensor
) -> torch.Tensor:
    """(R, C) int32 popcount co-occurrence of (L, R) and (L, C) int32
    words: the plain version on the CPU, the kernel on the card."""
    if row_words.device.type == "cpu":
        return popcount_accumulate(row_words, col_words)
    return packed_coassoc_counts_kernel(row_words, col_words)
