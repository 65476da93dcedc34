"""Bit-packed co-membership planes and the popcount co-occurrence counts.

The port of the reference package's ``ops/bitpack.py``.  A resample's
membership of element i in cluster c is one bit: ``planes[c, w, i]`` holds,
in its 32 bits, element i's membership in cluster c across resamples
``32w .. 32w+31`` (the accumulation layout), so

    Mij[i, j] = sum over (c, w) of popcount(planes[c, w, i] & planes[c, w, j])

and the co-sampling plane gives Iij the same way.  The counts are exact
integers and equal the dense one-hot counts bit for bit.

Planes are **int32 tensors holding the uint32 bit patterns** of the
reference's arrays (torch has no usable uint32 here: CPU ``>>`` on uint32 is
not implemented).  So right shifts are arithmetic and every extract masks
after shifting, bit 31 is ``INT32_MIN``, and a popcount first widens a word
to int64 with ``& 0xFFFFFFFF``.  Scatter-adding disjoint bits into int32
equals OR, bit 31 included: no carry ever happens.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

#: Bits per packed word.
PACK_BITS = 32

_WORD_MASK = 0xFFFFFFFF


def packed_width(n: int) -> int:
    """Words needed to hold ``n`` bits: ``ceil(n / 32)``."""
    return -(-int(n) // PACK_BITS)


def bit_values(shift: torch.Tensor) -> torch.Tensor:
    """int32 ``1 << shift`` for shifts in [0, 32): bit 31 is INT32_MIN."""
    one = torch.ones_like(shift, dtype=torch.int32)
    return torch.bitwise_left_shift(one, shift.to(torch.int32))


def _as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as int32 with the same 32 bits."""
    words = words & _WORD_MASK
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack {0, 1} integers along the LAST axis: ``(..., n)`` ->
    ``(..., ceil(n/32))`` int32; bit ``i % 32`` of word ``i // 32`` is
    ``bits[..., i]``, and tail bits beyond ``n`` are zero."""
    n = bits.shape[-1]
    w = packed_width(n)
    pad = w * PACK_BITS - n
    if pad:
        bits = torch.cat([bits, bits.new_zeros(bits.shape[:-1] + (pad,))], -1)
    b = bits.reshape(bits.shape[:-1] + (w, PACK_BITS)).to(torch.int64)
    shifts = torch.arange(PACK_BITS, dtype=torch.int64, device=bits.device)
    return _as_int32_bits(torch.sum(b << shifts, dim=-1))


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``(..., w)`` words -> ``(..., n)``
    int32 {0, 1}."""
    shifts = torch.arange(PACK_BITS, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    out = bits.reshape(words.shape[:-1] + (words.shape[-1] * PACK_BITS,))
    return out[..., :n]


def pack_label_planes(
    labels: torch.Tensor,
    indices: torch.Tensor,
    k_max: int,
    n_cols: int,
    *,
    n_words: Optional[int] = None,
    row0=0,
) -> torch.Tensor:
    """Accumulation-layout packing: resamples become BITS of int32 words.

    Row ``j`` of ``labels`` lands at bit position ``row0 + j``: bit
    ``(row0 + j) % 32`` of word ``(row0 + j) // 32``.  Entries with a label
    outside [0, k_max), an index outside [0, n_cols) or a word outside
    [0, n_words) are dropped, the reference's ``_valid_scatter`` rule.  One
    scatter-add builds the planes: within a resample the indices are
    distinct and different resamples own different bits, so integer add is
    bitwise OR.

    Args:
      labels, indices: (R, n_sub) integer labels and subsample indices.
      k_max: cluster planes.
      n_cols: element-axis width.
      n_words: word-axis length (default ``ceil((row0 + R) / 32)``).
      row0: bit offset of row 0 (an int or a 0-d tensor).

    Returns:
      (k_max, n_words, n_cols) int32 bit patterns.
    """
    h_rows = labels.shape[0]
    row0 = int(row0)
    if n_words is None:
        n_words = packed_width(row0 + h_rows)
    dev = labels.device
    pos = row0 + torch.arange(h_rows, dtype=torch.int64, device=dev)
    word = (pos // PACK_BITS)[:, None].expand(labels.shape)
    vals = bit_values(pos % PACK_BITS)[:, None].expand(labels.shape)
    labels = labels.to(torch.int64)
    indices = indices.to(torch.int64)
    valid = (
        (labels >= 0) & (labels < k_max) & (indices >= 0)
        & (indices < n_cols) & (word < n_words)
    )
    flat = (labels * n_words + word) * n_cols + indices
    planes = torch.zeros(k_max * n_words * n_cols, dtype=torch.int32,
                         device=dev)
    planes.index_add_(0, flat[valid], vals[valid])
    return planes.reshape(k_max, n_words, n_cols)


def pack_cosample_planes(
    indices: torch.Tensor,
    n_cols: int,
    *,
    n_words: Optional[int] = None,
    row0=0,
) -> torch.Tensor:
    """(n_words, n_cols) int32 co-sampling planes in the accumulation
    layout: :func:`pack_label_planes` with one plane that every sampled
    element belongs to."""
    return pack_label_planes(
        torch.zeros_like(indices), indices, 1, n_cols,
        n_words=n_words, row0=row0,
    )[0]


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word's 32-bit pattern, as int64 (SWAR)."""
    v = words.to(torch.int64) & _WORD_MASK
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _WORD_MASK) >> 24


def popcount_accumulate(
    row_words: torch.Tensor,
    col_words: torch.Tensor,
    *,
    word_chunk: int = 4,
) -> torch.Tensor:
    """The plain popcount co-occurrence: ``out[i, j] = sum_l
    popcount(row_words[l, i] & col_words[l, j])``, word chunk by word chunk
    (the transient is a (word_chunk, R, C) int64 broadcast).

    Args:
      row_words: (L, R) int32 row-side bit columns.
      col_words: (L, C) int32 column side.

    Returns:
      (R, C) int32 exact counts.
    """
    l_words, n_rows = row_words.shape
    l2, n_c = col_words.shape
    if l2 != l_words:
        raise ValueError(f"row/col word counts differ: {l_words} vs {l2}")
    word_chunk = max(1, min(int(word_chunk), max(l_words, 1)))
    acc = torch.zeros((n_rows, n_c), dtype=torch.int64,
                      device=row_words.device)
    for start in range(0, l_words, word_chunk):
        a = row_words[start:start + word_chunk]
        b = col_words[start:start + word_chunk]
        acc += popcount32(a[:, :, None] & b[:, None, :]).sum(dim=0)
    return acc.to(torch.int32)


def _row_slice(words, row_start, n_rows):
    if row_start is None:
        return words
    return words[:, int(row_start):int(row_start) + n_rows]


def coassoc_counts_packed(
    labels: torch.Tensor,
    indices: torch.Tensor,
    n_samples: int,
    k_max: int,
    *,
    n_cols: Optional[int] = None,
    row_start: Optional[int] = None,
    n_rows: Optional[int] = None,
    popcount_fn: Optional[Callable[..., torch.Tensor]] = None,
) -> torch.Tensor:
    """Packed counterpart of :func:`..ops.coassoc.coassociation_counts`:
    the same int32 counts bit for bit, through bit-planes.

    ``popcount_fn`` (default :func:`popcount_accumulate`) computes the
    tile; the engines pass :func:`..ops.popcount.packed_coassoc_counts`.
    ``row_start``/``n_rows`` select a row block of the result.
    """
    if n_cols is None:
        n_cols = n_samples
    if (row_start is None) != (n_rows is None):
        raise ValueError("row_start and n_rows must be passed together")
    popcount_fn = popcount_fn or popcount_accumulate
    planes = pack_label_planes(labels, indices, k_max, n_cols)
    words = planes.reshape(-1, n_cols)
    return popcount_fn(_row_slice(words, row_start, n_rows), words)


def cosample_counts_packed(
    indices: torch.Tensor,
    n_samples: int,
    *,
    n_cols: Optional[int] = None,
    row_start: Optional[int] = None,
    n_rows: Optional[int] = None,
    popcount_fn: Optional[Callable[..., torch.Tensor]] = None,
) -> torch.Tensor:
    """Packed counterpart of :func:`..ops.resample.cosample_counts`: Iij
    from the co-sampling planes alone."""
    if n_cols is None:
        n_cols = n_samples
    if (row_start is None) != (n_rows is None):
        raise ValueError("row_start and n_rows must be passed together")
    popcount_fn = popcount_fn or popcount_accumulate
    words = pack_cosample_planes(indices, n_cols)
    return popcount_fn(_row_slice(words, row_start, n_rows), words)
