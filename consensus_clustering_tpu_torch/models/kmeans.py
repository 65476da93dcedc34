"""KMeans over a batch of subsamples: greedy k-means++, Lloyd, best of n_init.

The port of the reference package's ``models/kmeans.py``, with its ``vmap``
written out as batch dimensions: ``x`` is (B, n, d), one subsample per
resample, and each resample runs ``n_init`` restarts, so a call carries
B * n_init lanes.

- k-means++ draws 2 + ceil(ln k_max) candidates per step from the
  Gumbel-max of log D^2 (:func:`..ops.kmeanspp.draw_candidates`: one CUDA
  kernel a step on the card, the ``rng`` composition on the CPU) and keeps
  the one with the least pooled potential;
  steps run for j < k only (a traced trip count in the reference), and
  slots >= k keep the duplicate of slot 0.
- Lloyd stops a lane when its squared centre shift falls to
  ``tol * mean(var(x))`` or after ``max_iter`` steps.  Every step calls
  :func:`..ops.lloyd.lloyd_step` (the CUDA kernel on the card, the plain
  version on the CPU) on the lanes still running; a stopped lane is frozen,
  as a converged lane of the reference's vmapped ``while_loop`` is, so any
  grouping of the lanes gives the same centroids and labels.
- Empty clusters respawn on the strided-bucket far points.
- The restart with the lowest inertia wins.

Each phase is a host range of :func:`..obs.tracing.region`
(``cc.kmeans.seed``, ``cc.kmeans.lloyd`` with the step's blocking read
``cc.kmeans.lloyd.wait`` inside it, ``cc.kmeans.assign``), and the Lloyd
loop counts its fits, steps and lanes (:func:`lloyd_counts`).

k-means++ runs ``torch.matmul`` products, as they are XLA GEMMs in the
reference.  The final assignment (labels, and the inertia that picks the
restart) goes through :func:`..ops.fused_block.assign_labels`: on the card
the kernel that shares its distance routine with the Lloyd kernel and the
fused assign+pack kernel, on the CPU a per-row reduction over d that no
other row can change.  So the fused block step's labels are the final
assignment's own, bit for bit (``supports_fused_assign``).  float64 is the
CPU parity path only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.obs.tracing import region
from consensus_clustering_tpu_torch.ops.fused_block import assign_labels
from consensus_clustering_tpu_torch.ops.kmeanspp import (
    draw_candidates,
    seed_keys,
)
from consensus_clustering_tpu_torch.ops.lloyd import lloyd_step

#: The Lloyd loop's counts since the process started (:func:`lloyd_counts`).
_lloyd_totals = {"fits": 0, "steps": 0, "lane_steps": 0, "lane_slots": 0}


def lloyd_counts() -> Dict[str, int]:
    """The Lloyd loop's counts so far: ``fits`` (runs of the loop),
    ``steps`` (its host trips that stepped lanes, one
    :func:`..ops.lloyd.lloyd_step` each), ``lane_steps`` (the lanes those
    steps ran) and ``lane_slots`` (each fit's steps times the lanes it
    started with), so ``lane_steps / lane_slots`` is the share of a
    step's lanes still running.  Host integers only: counting reads
    nothing from the device."""
    return dict(_lloyd_totals)


def lloyd_since(before: Dict[str, int]) -> Dict[str, int]:
    """Each of :func:`lloyd_counts` since ``before`` (an earlier reading)."""
    return {name: n - before[name] for name, n in _lloyd_totals.items()}


def _working_dtype(x: torch.Tensor) -> torch.Tensor:
    """float32 unless x is float64; float64 only on the CPU."""
    if x.dtype != torch.float64:
        return x.to(torch.float32)
    if x.device.type != "cpu":
        raise ValueError(
            "float64 is the CPU parity path: the port's CUDA kernels are "
            "float32-only"
        )
    return x


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, d), idx (B, ...) -> (B, ..., d) rows of each resample."""
    b = torch.arange(x.shape[0], device=x.device)
    b = b.reshape((-1,) + (1,) * (idx.dim() - 1))
    return x[b, idx]


@region("kmeans.seed")
def _kmeanspp_init(
    keys: torch.Tensor, x: torch.Tensor, k: int, k_max: int
) -> torch.Tensor:
    """(B, R, k_max, d) greedy k-means++ seeds for keys (B, R, 2)."""
    bsz, restarts = keys.shape[:2]
    n, d = x.shape[1:]
    n_trials = 2 + int(math.ceil(math.log(max(k_max, 2))))
    key_rest, first = seed_keys(keys, n)  # (B, R, 2), (B, R)
    x_first = _gather_rows(x, first)  # (B, R, d)
    centroids = x_first[:, :, None, :].expand(bsz, restarts, k_max, d).clone()
    d2 = torch.stack(
        [((x - x_first[:, r, None, :]) ** 2).sum(-1) for r in range(restarts)],
        dim=1,
    )  # (B, R, n)
    x_sq = (x * x).sum(-1)  # (B, n)
    for j in range(1, min(k, k_max)):
        cand_idx = draw_candidates(key_rest, j, d2, n_trials)  # (B, R, T)
        cand = _gather_rows(x, cand_idx)  # (B, R, T, d)
        cross = torch.matmul(
            cand.reshape(bsz, restarts * n_trials, d), x.transpose(1, 2)
        ).reshape(bsz, restarts, n_trials, n)
        cand_sq = (cand * cand).sum(-1)
        cand_d2 = torch.clamp(
            cand_sq[..., None] - 2.0 * cross + x_sq[:, None, None, :], min=0.0
        )
        pooled = torch.minimum(cand_d2, d2[:, :, None, :])
        best = torch.argmin(pooled.sum(-1), dim=-1)  # (B, R)
        centroids[:, :, j] = torch.gather(
            cand, 2, best[..., None, None].expand(bsz, restarts, 1, d)
        ).squeeze(2)
        d2 = torch.gather(
            pooled, 2, best[..., None, None].expand(bsz, restarts, 1, n)
        ).squeeze(2)
    return centroids


def _apply_update(x, lane_src, centroids, sums, counts, far_idx, valid):
    """Mean update, empty-cluster respawn on the far points, centre shift."""
    k_max = centroids.shape[1]
    keep = (counts > 0) & valid
    new = torch.where(
        keep[..., None], sums / torch.clamp(counts, min=1.0)[..., None],
        centroids,
    )
    empty = valid & (counts == 0)
    rank = torch.clamp(torch.cumsum(empty.long(), dim=-1) - 1, 0, k_max - 1)
    respawn = x[lane_src[:, None], torch.gather(far_idx, 1, rank)]
    new = torch.where(empty[..., None], respawn, new)
    shift = ((new - centroids) ** 2).sum(dim=(1, 2))
    return new, shift


@dataclasses.dataclass(frozen=True)
class KMeans:
    """Batched KMeans implementing :class:`..models.protocol.Clusterer`.

    ``n_init`` restarts (best inertia wins), ``max_iter`` Lloyd cap, and
    ``tol``, the centre-shift tolerance relative to the mean per-feature
    variance of each subsample (sklearn's convention).
    """

    n_init: int = 1
    max_iter: int = 100
    tol: float = 1e-4

    # The fused block contract: fit's labels are exactly the nearest of
    # the returned centroids under the shared distance routine (lowest
    # slot on ties, slots >= k at +inf), so the streaming engine may
    # recompute them inside the fused assign+pack kernel.
    supports_fused_assign = True

    def _restart_keys(self, keys: torch.Tensor) -> torch.Tensor:
        if self.n_init == 1:
            return keys[:, None, :]
        return rng.split(keys, self.n_init)

    def init_centroids(
        self, keys: torch.Tensor, x: torch.Tensor, k: int, k_max: int
    ) -> torch.Tensor:
        """(B, n_init, k_max, d) k-means++ seeds; :meth:`fit` from these is
        identical to :meth:`fit` seeding itself on the same keys."""
        x = _working_dtype(x)
        return _kmeanspp_init(self._restart_keys(keys), x, int(k), k_max)

    @region("kmeans.lloyd")
    def _lloyd(self, x, centroids, k, tol_abs):
        bsz, restarts, k_max, d = centroids.shape
        lanes = bsz * restarts
        cen = centroids.reshape(lanes, k_max, d).clone()
        # int32: the kernel's index type, so no step converts it.
        lane_src = torch.arange(
            bsz, dtype=torch.int32, device=x.device
        ).repeat_interleave(restarts)
        tol_lane = tol_abs[lane_src]
        shift = torch.full((lanes,), float("inf"), dtype=x.dtype, device=x.device)
        iters = torch.zeros(lanes, dtype=torch.int64, device=x.device)
        valid = torch.arange(k_max, device=x.device) < k
        steps = lane_steps = 0
        while True:
            active = (shift > tol_lane) & (iters < self.max_iter)
            with region("kmeans.lloyd.wait"):
                idx = torch.nonzero(active).squeeze(1)
                n_active = idx.numel()
            if n_active == 0:
                break
            steps += 1
            lane_steps += n_active
            src = lane_src[idx]
            cur = cen[idx]
            sums, counts, far_idx = lloyd_step(x, src, cur, k)
            new, step_shift = _apply_update(
                x, src, cur, sums, counts, far_idx, valid
            )
            cen[idx] = new
            shift[idx] = step_shift
            iters[idx] += 1
        _lloyd_totals["fits"] += 1
        _lloyd_totals["steps"] += steps
        _lloyd_totals["lane_steps"] += lane_steps
        _lloyd_totals["lane_slots"] += steps * lanes
        return cen.reshape(bsz, restarts, k_max, d)

    def fit(
        self,
        keys: torch.Tensor,
        x: torch.Tensor,
        k: int,
        k_max: Optional[int] = None,
        init_centroids: Optional[torch.Tensor] = None,
    ):
        """Best-of-n_init KMeans per subsample.

        Args:
          keys: (B, 2) generator keys, one per subsample.
          x: (B, n, d) subsamples.
          k: clusters; slots >= k stay empty.
          k_max: centroid slots (default k).
          init_centroids: (B, n_init, k_max, d) seeds instead of k-means++.

        Returns:
          (labels (B, n) int64, centroids (B, k_max, d)) of the best restart.
        """
        k = int(k)
        k_max = k if k_max is None else int(k_max)
        x = _working_dtype(x)
        bsz, n, d = x.shape
        if init_centroids is None:
            init_centroids = _kmeanspp_init(
                self._restart_keys(keys), x, k, k_max
            )
        elif tuple(init_centroids.shape) != (bsz, self.n_init, k_max, d):
            raise ValueError(
                f"init_centroids must have shape "
                f"{(bsz, self.n_init, k_max, d)} (B, n_init, k_max, d), got "
                f"{tuple(init_centroids.shape)}"
            )
        tol_abs = self.tol * x.var(dim=1, correction=0).mean(dim=-1)
        centroids = self._lloyd(x, init_centroids.to(x.dtype), k, tol_abs)
        with region("kmeans.assign"):
            restarts = centroids.shape[1]
            lane_src = torch.arange(
                bsz, dtype=torch.int32, device=x.device
            ).repeat_interleave(restarts)
            labels, d_min = assign_labels(
                x, lane_src, centroids.reshape(bsz * restarts, k_max, d), k
            )
            labels = labels.reshape(bsz, restarts, n)
            inertia = d_min.reshape(bsz, restarts, n).sum(dim=-1)
            best = torch.argmin(inertia, dim=-1)
            rows = torch.arange(bsz, device=x.device)
            return labels[rows, best], centroids[rows, best]

    def fit_predict(
        self,
        keys: torch.Tensor,
        x: torch.Tensor,
        k: int,
        k_max: Optional[int] = None,
        init_centroids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """(B, n) int64 labels of :meth:`fit`."""
        return self.fit(keys, x, k, k_max, init_centroids=init_centroids)[0]
