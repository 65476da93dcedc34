"""One fused Lloyd step over a batch of KMeans lanes: the CUDA kernel
``csrc/lloyd.cu`` and its plain PyTorch version.

A lane is one KMeans restart on one resample.  ``x`` holds the resamples,
(B, n, d), and ``lane_src`` maps each lane to its resample, so the n_init
restarts of a resample read the same rows.  Per lane the step computes the
squared distances ``max(|x|^2 - 2 x.c + |c|^2, 0)`` (slots >= k at +inf),
the argmin labels (lowest slot on ties), the per-slot sums and counts of
the rows, and for each bucket (row mod k_max) the lowest row of the largest
min-distance — the relocation candidates of an empty cluster.

On CPU tensors :func:`lloyd_step` runs the plain version (the reference
package's XLA Lloyd body over the lane batch); on CUDA tensors it launches
the kernel, or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from consensus_clustering_tpu_torch.ops import _build
from consensus_clustering_tpu_torch.ops.fused_block import (
    lanes_per_block,
    row_sqdist_plain,
    tile_layout,
    tile_smem_bytes,
)

#: Rows per block of the kernel, and of a partial sum (CC_TILE).
TILE_ROWS = 128
#: Shared memory one block may use on an H100 (227 KB).
MAX_SMEM_BYTES = 232448
MAX_LANES = 65535
#: Words of a block beside the rows and the centroid chunk: the tile's
#: min-distances and labels.
_EXTRA_WORDS = 2 * TILE_ROWS

#: Kernel launches since the count was last set to 0 (a step's tile kernel
#: and its reduction count as one).
launch_count = 0


def smem_bytes(d: int, k_max: int) -> int:
    """The least shared memory one block needs (csrc/lloyd.cu with the
    smallest chunk of centroid slots); a larger k_max is chunked."""
    return tile_smem_bytes(d, k_max, _EXTRA_WORDS)


def pairwise_sqdist(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Batched (..., n, k_max) ``max(|x|^2 - 2 x.c + |c|^2, 0)``.

    x (..., n, d) and centroids (..., k_max, d); the cross term is one
    full-precision GEMM (TF32 is off package-wide).
    """
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    c_sq = torch.sum(centroids * centroids, dim=-1)
    cross = torch.matmul(x, centroids.transpose(-1, -2))
    return torch.clamp(x_sq - 2.0 * cross + c_sq.unsqueeze(-2), min=0.0)


def masked_sqdist(
    x: torch.Tensor, centroids: torch.Tensor, k: int
) -> torch.Tensor:
    """:func:`pairwise_sqdist` with slots >= k set to +inf."""
    d = pairwise_sqdist(x, centroids)
    k_max = centroids.shape[-2]
    valid = torch.arange(k_max, device=x.device) < k
    return torch.where(valid, d, torch.full_like(d, float("inf")))


def bucket_far_points(d_min: torch.Tensor, k_max: int) -> torch.Tensor:
    """(L, k_max) relocation candidates from (L, n) min-distances.

    Row i falls in bucket i mod k_max; a bucket's candidate is its farthest
    row (the lowest one on ties), clamped to n - 1 for a bucket without
    rows.  Sort-free, and distinct picks by construction.
    """
    lanes, n = d_min.shape
    n_row = -(-n // k_max)
    pad = n_row * k_max - n
    if pad:
        d_min = torch.cat(
            [d_min, d_min.new_full((lanes, pad), float("-inf"))], dim=1
        )
    far_row = torch.argmax(d_min.reshape(lanes, n_row, k_max), dim=1)
    slot = torch.arange(k_max, device=d_min.device)
    return torch.clamp(far_row * k_max + slot, max=n - 1)


def lloyd_step_plain(
    x: torch.Tensor, lane_src: torch.Tensor, centroids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: distances by GEMM, one-hot GEMM sums."""
    k_max = centroids.shape[1]
    xl = x[lane_src.long()]
    d = masked_sqdist(xl, centroids, k)
    labels = torch.argmin(d, dim=-1)
    onehot = torch.nn.functional.one_hot(labels, k_max).to(x.dtype)
    counts = onehot.sum(dim=1)
    sums = torch.matmul(onehot.transpose(1, 2), xl)
    far_idx = bucket_far_points(d.min(dim=-1).values, k_max)
    return sums, counts, far_idx


def lloyd_step_ordered_plain(
    x: torch.Tensor, lane_src: torch.Tensor, centroids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic, op by op: the plain version the kernel
    equals bit for bit on any data.

    Distances by :func:`.fused_block.row_sqdist_plain` (d summed in
    ascending order, every product and sum rounded on its own); a slot's
    partial sum over each 128-row tile taken as 128 ascending elementwise
    steps from 0.0; the tiles summed in ascending order from 0.0; the far
    points by :func:`bucket_far_points`.  Adding 0.0 for a row of another
    slot leaves a partial sum as it was, so the steps are the kernel's
    adds.  Nothing on the main path calls it.
    """
    lanes = lane_src.shape[0]
    _, n, d = x.shape
    k_max = centroids.shape[1]
    xl = x[lane_src.long()]
    best = row_sqdist_plain(xl, centroids, k).min(dim=-1)
    labels, d_min = best.indices, best.values
    n_tiles = -(-n // TILE_ROWS)
    pad = n_tiles * TILE_ROWS - n
    rows = torch.cat([xl, torch.ones_like(xl[..., :1])], dim=-1)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
    labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    rows = rows.reshape(lanes, n_tiles, TILE_ROWS, 1, d + 1)
    hit = (labels.reshape(lanes, n_tiles, TILE_ROWS, 1)
           == torch.arange(k_max, device=x.device))[..., None]
    part = torch.zeros((lanes, n_tiles, k_max, d + 1), dtype=x.dtype,
                       device=x.device)
    for r in range(TILE_ROWS):
        part = part + torch.where(hit[:, :, r], rows[:, :, r], 0.0)
    total = torch.zeros((lanes, k_max, d + 1), dtype=x.dtype,
                        device=x.device)
    for t in range(n_tiles):
        total = total + part[:, t]
    return total[..., :d], total[..., d], bucket_far_points(d_min, k_max)


def _library():
    lib = _build.load("lloyd")
    if not getattr(lib, "_cc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cc_lloyd_step.argtypes = [
            p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p, p, p, p, p,
        ]
        lib.cc_lloyd_step.restype = ctypes.c_int
        lib.cc_error_string.argtypes = [ctypes.c_int]
        lib.cc_error_string.restype = ctypes.c_char_p
        lib._cc_typed = True
    return lib


def lloyd_step_kernel(
    x: torch.Tensor, lane_src: torch.Tensor, centroids: torch.Tensor, k: int,
    per_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/lloyd.cu`` on PyTorch's current stream; ``per_block``
    lanes a block (default :func:`.fused_block.lanes_per_block`)."""
    global launch_count
    if x.device.type != "cuda":
        raise ValueError(f"the Lloyd kernel needs CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or centroids.dtype != torch.float32:
        raise ValueError(
            "the Lloyd kernel is float32-only (the f64 parity path runs "
            f"on the CPU), got {x.dtype} / {centroids.dtype}"
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
    layout = tile_layout(d, k_max, _EXTRA_WORDS)
    if layout is None:
        raise ValueError(
            f"d={d}, k_max={k_max} need {smem_bytes(d, k_max)} bytes of "
            f"shared memory per block; the kernel's layout holds "
            f"{MAX_SMEM_BYTES}"
        )
    xs, ks, cg, vec = layout
    x = x.contiguous()
    centroids = centroids.contiguous()
    lane_src = lane_src.to(device=x.device, dtype=torch.int32).contiguous()
    n_tiles = -(-n // TILE_ROWS)
    dev = x.device
    # One scratch buffer: partial sums, then the far values and rows.
    part_words = lanes * n_tiles * k_max
    scratch = torch.empty(part_words * (d + 3), dtype=torch.float32,
                          device=dev)
    part_sums = scratch.data_ptr()
    part_fval = part_sums + 4 * part_words * (d + 1)
    part_fidx = part_fval + 4 * part_words
    sums = torch.empty((lanes, k_max, d), dtype=torch.float32, device=dev)
    counts = torch.empty((lanes, k_max), dtype=torch.float32, device=dev)
    far_idx = torch.empty((lanes, k_max), dtype=torch.int64, device=dev)
    lib = _library()
    # Launch on the tensors' card: the stream is that card's, and the
    # library reads the current device (its shared-memory reservations).
    with torch.cuda.device(dev):
        status = lib.cc_lloyd_step(
            x.data_ptr(), lane_src.data_ptr(), centroids.data_ptr(), lanes,
            per_block or lanes_per_block(lanes, b, n), n, d, k_max, int(k), xs,
            ks, cg,
            int(vec), part_sums, part_fval, part_fidx, sums.data_ptr(),
            counts.data_ptr(), far_idx.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if status != 0:
        raise RuntimeError(
            f"Lloyd kernel launch failed: {lib.cc_error_string(status).decode()}"
        )
    launch_count += 1
    return sums, counts, far_idx


def lloyd_step(
    x: torch.Tensor, lane_src: torch.Tensor, centroids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd step for every lane.

    Args:
      x: (B, n, d) resamples.
      lane_src: (L,) resample of each lane.
      centroids: (L, k_max, d) current centroids.
      k: active slots; slots >= k take no rows.

    Returns:
      (sums (L, k_max, d), counts (L, k_max), far_idx (L, k_max) int64).
    """
    if x.device.type == "cpu":
        return lloyd_step_plain(x, lane_src, centroids, k)
    return lloyd_step_kernel(x, lane_src, centroids, k)
