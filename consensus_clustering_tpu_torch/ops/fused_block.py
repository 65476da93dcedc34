"""The final nearest-centroid assignment, alone (:func:`assign_labels`) and
fused with bit-plane packing (:func:`fused_assign_pack`): the CUDA kernels
of ``csrc/fused_block.cu`` and their plain PyTorch versions.

Every distance here is ``max((|x|^2 - 2 x.c) + |c|^2, 0)`` with each norm
and dot product summed over d in ascending order, each product and sum
rounded on its own: the routine of ``csrc/common.cuh`` that the Lloyd
kernel, :func:`assign_labels` and :func:`fused_assign_pack` share on the
card, and :func:`row_sqdist_plain` repeats op for op on the CPU.  A row's
distances therefore do not depend on which other rows are computed beside
it (a GEMM's blocking would make them depend on the row count), so the
fused planes equal the label path's planes bit for bit, by construction, on
both devices.  Slots >= k are +inf, and ties go to the lowest slot.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels, or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from consensus_clustering_tpu_torch.ops import _build
from consensus_clustering_tpu_torch.ops.bitpack import (
    PACK_BITS,
    bit_values,
)

#: Columns (rows of x) per block of both kernels (CC_FUSED_TILE).
TILE = 128
#: Shared memory one block may use on an H100 (227 KB).
MAX_SMEM_BYTES = 232448
MAX_LANES = 65535
#: Streaming multiprocessors of an H100 SXM.
H100_SMS = 132
#: B4 blocks an SM that :func:`fused_word_splits` sizes the grid for: at
#: the stream's block a block stages its 16 lanes at once in 101 KB of
#: shared memory, so 2 share an SM.
FUSED_BLOCKS_PER_SM = 2

#: Launches of the fused assign+pack kernel (B4) since last set to 0.
launch_count = 0
#: Launches of the final-assignment kernel since last set to 0.
assign_launch_count = 0


def _sq_norm(v: torch.Tensor) -> torch.Tensor:
    """(...,) sum of v[..., f]^2, f ascending, each op rounded."""
    s = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for f in range(v.shape[-1]):
        s = s + v[..., f] * v[..., f]
    return s


def row_sqdist_plain(
    x: torch.Tensor, centroids: torch.Tensor, k: int
) -> torch.Tensor:
    """(..., n, k_max) distances of x (..., n, d) to centroids
    (..., k_max, d), batch dimensions broadcast; slots >= k are +inf.

    The plain version of the kernels' shared routine: an explicit per-row
    reduction over d, never a GEMM, so every entry is the same whatever
    rows share the call.
    """
    x_sq = _sq_norm(x)
    c_sq = _sq_norm(centroids)
    cross = torch.zeros(
        torch.broadcast_shapes(x.shape[:-2], centroids.shape[:-2])
        + (x.shape[-2], centroids.shape[-2]),
        dtype=x.dtype, device=x.device,
    )
    for f in range(x.shape[-1]):
        cross = cross + x[..., :, None, f] * centroids[..., None, :, f]
    dist = torch.clamp((x_sq[..., None] - 2.0 * cross) + c_sq[..., None, :],
                       min=0.0)
    k_max = centroids.shape[-2]
    valid = torch.arange(k_max, device=x.device) < k
    return torch.where(valid, dist, torch.full_like(dist, float("inf")))


def _round4(v: int) -> int:
    return -(-v // 4) * 4


@functools.lru_cache(maxsize=None)
def tile_layout(d: int, k_max: int, extra_words: int):
    """The shared-memory layout of a (lane, 128-row tile) block of the
    Lloyd or the assignment kernel, or None when none fits.

    Returns (xs, ks, cg, vec): the rows' stride (d + 1 for an even d where
    it fits: an odd stride is free of bank conflicts), the stride of the
    transposed centroid chunk, the slots per chunk, and whether the chunk
    is read 4 slots at a time (ks a multiple of 4).  The block holds one
    chunk ((d + 1) * ks words), the rows (128 * xs) and ``extra_words``.
    Preference: every slot in one chunk, then chunks of a multiple of 4
    slots, then (k_max < 4 only) an unpadded chunk read one slot at a time.
    """
    maxw = MAX_SMEM_BYTES // 4
    strides = (d | 1, d) if d % 2 == 0 else (d,)
    for xs in strides:
        ks = _round4(k_max)
        if ks * (d + 1) + TILE * xs + extra_words <= maxw:
            return xs, ks, k_max, True
    for xs in strides:
        cg = (maxw - TILE * xs - extra_words) // (d + 1) // 4 * 4
        if cg >= 4:
            return xs, cg, cg, True
    if k_max * (d + 1) + TILE * d + extra_words <= maxw:
        return d, k_max, k_max, False
    return None


def lanes_per_block(lanes: int, b: int, n: int) -> int:
    """Consecutive lanes that one block of the Lloyd or the assignment
    kernel takes in turn on its 128-row tile.

    ``lanes // b``: with lane_src in runs of a resample's n_init restarts,
    as KMeans lays it out, a block's lanes share one staged tile.  Any
    lane_src gives the same results (a block stages its rows again where
    the resample changes).  1 where sharing would leave fewer than two
    blocks per SM of an H100.
    """
    per = max(1, lanes // b)
    if per > 1 and -(-n // TILE) * -(-lanes // per) < 2 * H100_SMS:
        return 1
    return per


def tile_smem_bytes(d: int, k_max: int, extra_words: int) -> int:
    """The least shared memory a tile block needs: the smallest chunk
    (min(4, k_max) slots) beside the rows at stride d."""
    return 4 * (min(4, k_max) * (d + 1) + TILE * d + extra_words)


def smem_bytes_assign(d: int, k_max: int) -> int:
    """Shared memory an assign block needs at least (the layout of the .cu
    file with the smallest chunk of slots)."""
    return tile_smem_bytes(d, k_max, 0)


@functools.lru_cache(maxsize=None)
def fused_layout(d: int, k_max: int):
    """(xs, ks, vec, lane_group) of a fused block, or None when one lane's
    centroids do not fit beside the column tile: the row stride and the
    slot stride as in :func:`tile_layout` (every slot of a lane staged at
    once), and the lanes (at most 32) staged together."""
    maxw = MAX_SMEM_BYTES // 4
    strides = (d | 1, d) if d % 2 == 0 else (d,)
    for ks, vec in ((_round4(k_max), True), (k_max, False)):
        for xs in strides:
            free = maxw - TILE * xs - k_max * TILE
            group = min(PACK_BITS, free // (ks * (d + 1)))
            if group >= 1:
                return xs, ks, vec, group
    return None


def smem_bytes_fused(d: int, k_max: int, lane_group: int) -> int:
    """Shared memory of one fused block staging ``lane_group`` lanes in
    the layout of :func:`fused_layout` (the unpadded one if none fits)."""
    layout = fused_layout(d, k_max)
    xs, ks = (layout[0], layout[1]) if layout else (d, k_max)
    return 4 * (TILE * xs + lane_group * ks * (d + 1) + k_max * TILE)


def lane_group_size(d: int, k_max: int) -> int:
    """Lanes of one plane word (at most 32) whose centroids a fused block
    stages at once: as many as fit in shared memory, 0 if none does."""
    layout = fused_layout(d, k_max)
    return layout[3] if layout else 0


def fused_word_splits(n_words: int, n_cols: int) -> int:
    """Splits of each plane word's lanes, one fused block each: enough that
    the grid, 128-column tiles by words by splits, fills
    FUSED_BLOCKS_PER_SM blocks an SM of an H100, at most 32.  At the
    stream's block that is 2: fewer, longer blocks stage their x tile and
    lanes once for more pairs (PERF.md, Findings)."""
    tiles = -(-n_cols // TILE)
    want = -(-FUSED_BLOCKS_PER_SM * H100_SMS // (tiles * n_words))
    return max(1, min(PACK_BITS, want))


def _library():
    lib = _build.load("fused_block")
    if not getattr(lib, "_cc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cc_assign_labels.argtypes = [
            p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p,
        ]
        lib.cc_assign_labels.restype = ctypes.c_int
        lib.cc_fused_assign_pack.argtypes = [
            p, p, i, i, i, i, i, i, i, i, p, i, i, i, i, p, p, p,
        ]
        lib.cc_fused_assign_pack.restype = ctypes.c_int
        lib.cc_error_string.argtypes = [ctypes.c_int]
        lib.cc_error_string.restype = ctypes.c_char_p
        lib._cc_typed = True
    return lib


def _check_status(lib, status, what):
    if status != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{lib.cc_error_string(status).decode()}"
        )


# -- the final assignment ------------------------------------------------


def assign_labels_plain(
    x: torch.Tensor, lane_src: torch.Tensor, centroids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`assign_labels`."""
    dist = row_sqdist_plain(x[lane_src.long()], centroids, k)
    best = dist.min(dim=-1)
    return best.indices, best.values


def assign_labels_kernel(
    x: torch.Tensor, lane_src: torch.Tensor, centroids: torch.Tensor, k: int,
    per_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``assign_kernel`` of ``csrc/fused_block.cu``; ``per_block``
    lanes a block (default :func:`lanes_per_block`)."""
    global assign_launch_count
    if x.device.type != "cuda":
        raise ValueError(
            f"the assignment kernel needs CUDA tensors, got {x.device}"
        )
    if x.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise ValueError(
            f"the assignment kernel is float32-only, got {x.dtype} / "
            f"{centroids.dtype}"
        )
    b, n, d = x.shape
    lanes, k_max, d_c = centroids.shape
    if d_c != d or lane_src.shape != (lanes,):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, centroids "
            f"{tuple(centroids.shape)}, lane_src {tuple(lane_src.shape)}"
        )
    if not 1 <= k <= k_max:
        raise ValueError(f"k={k} must be in [1, k_max={k_max}]")
    if lanes > MAX_LANES:
        raise ValueError(f"{lanes} lanes exceed the kernel grid's {MAX_LANES}")
    layout = tile_layout(d, k_max, 0)
    if layout is None:
        raise ValueError(
            f"d={d}, k_max={k_max} need {smem_bytes_assign(d, k_max)} bytes "
            f"of shared memory per block; the kernel's layout holds "
            f"{MAX_SMEM_BYTES}"
        )
    xs, ks, cg, vec = layout
    x = x.contiguous()
    centroids = centroids.contiguous()
    lane_src = lane_src.to(device=x.device, dtype=torch.int32).contiguous()
    labels = torch.empty((lanes, n), dtype=torch.int64, device=x.device)
    dmin = torch.empty((lanes, n), dtype=torch.float32, device=x.device)
    lib = _library()
    # Launch on the tensors' card: the stream is that card's, and the
    # library reads the current device (its shared-memory reservations).
    with torch.cuda.device(x.device):
        status = lib.cc_assign_labels(
            x.data_ptr(), lane_src.data_ptr(), centroids.data_ptr(), lanes,
            per_block or lanes_per_block(lanes, b, n), n, d, k_max, int(k), xs,
            ks, cg,
            int(vec), labels.data_ptr(),
            dmin.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_status(lib, status, "assignment")
    assign_launch_count += 1
    return labels, dmin


def assign_labels(
    x: torch.Tensor, lane_src: torch.Tensor, centroids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each lane's nearest-centroid labels and min-distances.

    Args:
      x: (B, n, d) resamples.
      lane_src: (L,) resample of each lane.
      centroids: (L, k_max, d) final centroids.
      k: active slots.

    Returns:
      (labels (L, n) int64, min-distances (L, n)).
    """
    if x.device.type == "cpu":
        return assign_labels_plain(x, lane_src, centroids, k)
    return assign_labels_kernel(x, lane_src, centroids, k)


# -- the fused assign + pack step (B4) -----------------------------------


def fused_planes_plain(
    x_cols: torch.Tensor,
    centroids: torch.Tensor,
    k: int,
    coplanes: torch.Tensor,
    row0: int,
    n_words: int,
) -> torch.Tensor:
    """The plain version of :func:`fused_assign_pack`: labels of every
    (lane, column) by :func:`row_sqdist_plain`, then the co-sampled ones
    scattered into planes (the reference's ``fused_planes_reference``)."""
    n_lanes, k_max, _ = centroids.shape
    n_cols = x_cols.shape[0]
    dev = x_cols.device
    planes = torch.zeros((k_max, n_words, n_cols), dtype=torch.int32,
                         device=dev)
    if n_lanes == 0:
        return planes
    labels = row_sqdist_plain(x_cols[None], centroids, k).argmin(dim=-1)
    rows = int(row0) + torch.arange(n_lanes, device=dev)
    word = rows // PACK_BITS
    shift = (rows % PACK_BITS).to(torch.int32)
    keep = word < n_words
    words = coplanes.to(torch.int32)[word.clamp(max=n_words - 1)]
    sampled = ((words >> shift[:, None]) & 1) != 0
    slots = torch.arange(k_max, device=dev)
    onehot = (labels[:, None, :] == slots[None, :, None]) & sampled[:, None]
    vals = onehot.to(torch.int32) * bit_values(shift)[:, None, None]
    # Disjoint bits per (plane, word, column): integer add is bitwise OR.
    planes.index_add_(1, word[keep], vals[keep].transpose(0, 1))
    return planes


def fused_assign_pack_kernel(
    x_cols: torch.Tensor,
    centroids: torch.Tensor,
    k: int,
    coplanes: torch.Tensor,
    row0: int,
    n_words: int,
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Launch ``fused_planes_kernel`` of ``csrc/fused_block.cu`` (and its
    merge kernel): each word's lanes in ``splits`` blocks (default
    :func:`fused_word_splits`)."""
    global launch_count
    if x_cols.device.type != "cuda":
        raise ValueError(
            f"the fused assign+pack kernel needs CUDA tensors, got "
            f"{x_cols.device}"
        )
    if x_cols.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise ValueError(
            f"the fused kernel is float32-only, got {x_cols.dtype} / "
            f"{centroids.dtype}"
        )
    if coplanes.dtype != torch.int32:
        raise ValueError(f"coplanes must be int32 bit patterns, got "
                         f"{coplanes.dtype}")
    n_cols, d = x_cols.shape
    n_lanes, k_max, d_c = centroids.shape
    if d_c != d or tuple(coplanes.shape) != (n_words, n_cols):
        raise ValueError(
            f"shape mismatch: x_cols {tuple(x_cols.shape)}, centroids "
            f"{tuple(centroids.shape)}, coplanes {tuple(coplanes.shape)}, "
            f"n_words {n_words}"
        )
    if not 1 <= k <= k_max:
        raise ValueError(f"k={k} must be in [1, k_max={k_max}]")
    layout = fused_layout(d, k_max)
    if layout is None:
        raise ValueError(
            f"d={d}, k_max={k_max}: one lane's centroids do not fit the "
            f"kernel's {MAX_SMEM_BYTES} bytes of shared memory"
        )
    x_cols = x_cols.contiguous()
    centroids = centroids.contiguous()
    coplanes = coplanes.contiguous()
    xs, ks, vec, group = layout
    splits = splits or fused_word_splits(n_words, n_cols)
    if n_words * splits > MAX_LANES:
        raise ValueError(f"{n_words} words x {splits} splits exceed the "
                         f"kernel grid's {MAX_LANES}")
    planes = torch.empty((k_max, n_words, n_cols), dtype=torch.int32,
                         device=x_cols.device)
    parts = (torch.empty((k_max, n_words * splits, n_cols), dtype=torch.int32,
                         device=x_cols.device) if splits > 1 else None)
    lib = _library()
    # Launch on the tensors' card: the stream is that card's, and the
    # library reads the current device (its shared-memory reservations).
    with torch.cuda.device(x_cols.device):
        status = lib.cc_fused_assign_pack(
            x_cols.data_ptr(), centroids.data_ptr(), n_lanes, n_cols, d, k_max,
            int(k), xs, ks, int(vec), coplanes.data_ptr(), int(row0), n_words,
            splits, min(group, -(-PACK_BITS // splits)),
            parts.data_ptr() if parts is not None else None, planes.data_ptr(),
            torch.cuda.current_stream(x_cols.device).cuda_stream,
        )
    _check_status(lib, status, "fused assign+pack")
    launch_count += 1
    return planes


def fused_assign_pack(
    x_cols: torch.Tensor,
    centroids: torch.Tensor,
    k: int,
    coplanes: torch.Tensor,
    row0: int,
    *,
    n_words: int,
) -> torch.Tensor:
    """Final assignment + bit-plane packing of one block.

    Args:
      x_cols: (n_cols, d) float32 element rows.
      centroids: (n_lanes, k_max, d) final per-lane centroids
        (``KMeans.fit(...)[1]``).
      k: active slots.
      coplanes: (n_words, n_cols) int32 co-sample planes of the block:
        bit ``row0 + l`` of column j says element j is in lane l's
        resample.
      row0: bit offset of lane 0.
      n_words: words of the block's planes.

    Returns:
      (k_max, n_words, n_cols) int32 planes, bit-identical to
      :func:`.bitpack.pack_label_planes` of the lanes' final labels.
    """
    if x_cols.device.type == "cpu":
        return fused_planes_plain(x_cols, centroids, k, coplanes, row0,
                                  n_words)
    return fused_assign_pack_kernel(x_cols, centroids, k, coplanes, row0,
                                    n_words)
