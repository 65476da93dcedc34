"""The plain reference of Monti consensus clustering with KMeans, as the
benchmark checks it.

What a sweep is (Monti et al. 2003, with the resample plan and seeding of
the JAX package this repository ports):

- key = PRNGKey(random_state); (key_resample, key_cluster) = split(key);
  resample h is the first int(subsampling * N) entries of a permutation
  drawn from fold_in(key_resample, h).
- For each K every resample is clustered from the key fold_in(key_cluster,
  K), split into n_init restart keys: greedy k-means++ (2 + ceil(ln k_max)
  candidates a step by Gumbel-max of log D^2, the one with the least pooled
  potential kept), then Lloyd until the squared centre shift falls to
  tol * mean(var(x)) or max_iter steps (empty clusters respawn on the
  strided-bucket far points), labels by the nearest centre (lowest slot on
  ties), and the restart of least inertia.
- Mij counts the resamples that hold i and j in one cluster, Iij those
  that hold both; Cij = Mij / (Iij + 1e-6) in float32; the strict upper
  triangle is binned into ``bins`` bins over [0, 1] (the last closed), with
  N(N+1)/2 zeros added to bin 0 over an N^2 total (the reference package's
  ``parity_zeros``); PAC = cdf[hi - 1] - cdf[lo].
- The sampled-pair estimate counts Mij and Iij at M pairs drawn uniformly
  from the upper triangle (key fold_in(PRNGKey(random_state), "pair")) and
  maps their empirical CDF onto the N^2 population.

Everything is plain torch: distances by full-precision GEMM (TF32 is
switched off for the duration of a call), counts by 0/1 GEMMs, whose
float32 sums of integers below 2^24 are exact.  Nothing here imports the
measured program or reads anything it made.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference import threefry

#: fold_in tag of the pair sample ("pair" in ASCII).
PAIR_TAG = 0x70616972
#: Rows of Cij binned at once.
ROW_BLOCK = 2048


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """float32 matrix products at full precision, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


@contextlib.contextmanager
def tf32() -> Iterator[None]:
    """float32 matrix products in TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def subsample_rows(n: int, subsampling: float) -> int:
    return int(subsampling * n)


def pac_bins(pac_interval: Sequence[float], bins: int):
    """(lo, hi) bin indices: int(u / dbin) with dbin in float64."""
    dbin = np.linspace(0.0, 1.0, bins + 1)[1]
    return int(pac_interval[0] / dbin), int(pac_interval[1] / dbin)


def sweep_keys(random_state: int, device):
    pair = threefry.split(threefry.prng_key(random_state, device))
    return pair[0], pair[1]


def resample_plan(key_resample: torch.Tensor, n: int, h: int,
                  n_sub: int) -> torch.Tensor:
    """(H, n_sub) int64 subsample indices."""
    keys = threefry.fold_in(key_resample,
                            torch.arange(h, device=key_resample.device))
    return threefry.permutation(keys, n)[:, :n_sub].contiguous()


# -- KMeans ---------------------------------------------------------------


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, d), idx (B, ...) -> (B, ..., d)."""
    b = torch.arange(x.shape[0], device=x.device)
    return x[b.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def kmeanspp(keys: torch.Tensor, x: torch.Tensor, k: int,
             k_max: int) -> torch.Tensor:
    """(B, R, k_max, d) greedy k-means++ seeds for keys (B, R, 2) on x
    (B, n, d); slots >= k repeat slot 0."""
    bsz, restarts = keys.shape[:2]
    n, d = x.shape[1:]
    trials = 2 + int(math.ceil(math.log(max(k_max, 2))))
    pair = threefry.split(keys)
    first = threefry.randint(pair[..., 0, :], (), 0, n).long()
    x_first = _rows(x, first)
    cen = x_first[:, :, None, :].expand(bsz, restarts, k_max, d).clone()
    d2 = torch.stack([((x - x_first[:, r, None, :]) ** 2).sum(-1)
                      for r in range(restarts)], dim=1)
    x_sq = (x * x).sum(-1)
    for j in range(1, min(k, k_max)):
        kj = threefry.fold_in(pair[..., 1, :], j)
        logits = torch.where(d2 > 0, torch.log(torch.clamp(d2, min=1e-30)),
                             torch.full_like(d2, float("-inf")))
        cand_idx = threefry.categorical(kj, logits, trials)
        cand = _rows(x, cand_idx)  # (B, R, T, d)
        cross = torch.matmul(cand.reshape(bsz, restarts * trials, d),
                             x.transpose(1, 2)).reshape(bsz, restarts,
                                                        trials, n)
        cand_d2 = torch.clamp((cand * cand).sum(-1)[..., None] - 2.0 * cross
                              + x_sq[:, None, None, :], min=0.0)
        pooled = torch.minimum(cand_d2, d2[:, :, None, :])
        best = torch.argmin(pooled.sum(-1), dim=-1)
        cen[:, :, j] = torch.gather(
            cand, 2, best[..., None, None].expand(bsz, restarts, 1, d)
        ).squeeze(2)
        d2 = torch.gather(
            pooled, 2, best[..., None, None].expand(bsz, restarts, 1, n)
        ).squeeze(2)
    return cen


def far_points(d_min: torch.Tensor, k_max: int) -> torch.Tensor:
    """(L, k_max): row i lies in bucket i mod k_max; each bucket's row of
    largest min-distance (lowest row on ties), clamped to n - 1."""
    lanes, n = d_min.shape
    per = -(-n // k_max)
    pad = per * k_max - n
    if pad:
        d_min = torch.cat([d_min, d_min.new_full((lanes, pad),
                                                 float("-inf"))], 1)
    far = torch.argmax(d_min.reshape(lanes, per, k_max), dim=1)
    return torch.clamp(far * k_max + torch.arange(k_max, device=d_min.device),
                       max=n - 1)


def nearest(x: torch.Tensor, c: torch.Tensor, k: int):
    """Labels and least distances (H, n, R) of the rows of x (H, n, d) to
    each of the R lanes' centres c (H, R, k_max, d): squared distances
    ``|x|^2 - 2 x.c + |c|^2`` by one GEMM in the precision in force, slots
    >= k left out, the lowest slot on ties."""
    h, n, d = x.shape
    r, k_max = c.shape[1:3]
    x_sq = (x * x).sum(-1)
    c_sq = (c * c).sum(-1)  # (H, R, k_max)
    cross = torch.matmul(x, c.reshape(h, r * k_max, d).transpose(1, 2))
    g = torch.clamp(x_sq[..., None] - 2.0 * cross
                    + c_sq.reshape(h, 1, r * k_max), min=0.0)
    g = g.reshape(h, n, r, k_max)
    g[..., k:] = float("inf")
    best = g.min(dim=-1)
    return best.indices, best.values


def apply_update(x, lane_src, centroids, sums, counts, far_idx, valid):
    """The mean update, empty clusters respawned on the far points, and
    each lane's squared centre shift."""
    k_max = centroids.shape[1]
    keep = (counts > 0) & valid
    new = torch.where(keep[..., None],
                      sums / torch.clamp(counts, min=1.0)[..., None],
                      centroids)
    empty = valid & (counts == 0)
    rank = torch.clamp(torch.cumsum(empty.long(), dim=-1) - 1, 0, k_max - 1)
    respawn = x[lane_src[:, None], torch.gather(far_idx, 1, rank)]
    new = torch.where(empty[..., None], respawn, new)
    shift = ((new - centroids) ** 2).sum(dim=(1, 2))
    return new, shift


def lloyd(x: torch.Tensor, cen: torch.Tensor, k: int, tol: torch.Tensor,
          max_iter: int) -> torch.Tensor:
    """Lloyd from cen (H, R, k_max, d) for every lane at once: a lane
    moves while its last squared shift exceeds its tolerance ``tol`` (H,)
    and it has made fewer than max_iter steps.  Distances by GEMM, each
    cluster's sum by a one-hot GEMM."""
    h, r, k_max, d = cen.shape
    c = cen.reshape(h * r, k_max, d).clone()
    lane_src = torch.arange(h, device=x.device).repeat_interleave(r)
    tol = tol[lane_src]
    shift = torch.full((h * r,), float("inf"), dtype=x.dtype, device=x.device)
    iters = torch.zeros(h * r, dtype=torch.int64, device=x.device)
    valid = torch.arange(k_max, device=x.device) < k
    while True:
        active = (shift > tol) & (iters < max_iter)
        if not bool(active.any()):
            break
        labels, d_min = nearest(x, c.reshape(h, r, k_max, d), k)
        lab = labels.permute(0, 2, 1).reshape(h * r, -1)
        onehot = torch.nn.functional.one_hot(lab, k_max).to(x.dtype)
        counts = onehot.sum(1)
        sums = torch.matmul(onehot.transpose(1, 2), x[lane_src])
        far = torch.zeros((h * r, k_max), dtype=torch.int64, device=x.device)
        # Far points are read only where a moving lane's cluster is empty.
        needs = torch.nonzero(active & ((counts == 0) & valid).any(-1))
        for lane in needs.squeeze(1).tolist():
            hi, ri = divmod(lane, r)
            far[lane] = far_points(d_min[hi, :, ri][None], k_max)[0]
        new, shift_new = apply_update(x, lane_src, c, sums, counts, far,
                                      valid)
        shift = torch.where(active, shift_new, shift)
        c = torch.where(active[:, None, None], new, c)
        iters += active.long()
    return c.reshape(h, r, k_max, d)


def kmeans(key_k: torch.Tensor, x: torch.Tensor, k: int, k_max: int,
           clusterer: Dict, group: int):
    """Labels (H, n) and centres (H, k_max, d) of the best restart (least
    inertia, the first on ties) for subsamples x (H, n, d), every
    subsample seeded from the one key ``key_k``: k-means++ and the
    tolerance per group of ``group`` subsamples, then Lloyd."""
    h, n, _ = x.shape
    n_init = int(clusterer["n_init"])
    seeds, tols = [], []
    for s in range(0, h, group):
        xg = x[s:s + group]
        keys = key_k.expand(xg.shape[0], 2)
        keys = (keys[:, None, :] if n_init == 1
                else threefry.split(keys, n_init))
        seeds.append(kmeanspp(keys, xg, k, k_max))
        tols.append(float(clusterer["tol"])
                    * xg.var(dim=1, correction=0).mean(dim=-1))
    cen = lloyd(x, torch.cat(seeds), k, torch.cat(tols),
                int(clusterer["max_iter"]))
    labels, d_min = nearest(x, cen, k)
    pick = torch.argmin(d_min.sum(dim=1), dim=-1)  # (H,)
    rows = torch.arange(h, device=x.device)
    return labels.permute(0, 2, 1)[rows, pick], cen[rows, pick]


def cluster(x: torch.Tensor, indices: torch.Tensor,
            key_cluster: torch.Tensor, k: int, k_max: int, clusterer: Dict,
            group: Optional[int], precision: str = "float32"):
    """Labels (H, n_sub) and centres (H, k_max, d) of every resample for
    one K (``group``: subsamples seeded together, default all).

    precision "float32": every product at full float32 precision; "tf32":
    every GEMM in TF32 (the control)."""
    with full_f32() if precision == "float32" else tf32():
        return kmeans(threefry.fold_in(key_cluster, k), x[indices], k,
                      k_max, clusterer, int(group or len(indices)))


def centroid_gaps(program: torch.Tensor, reference: torch.Tensor,
                  k: int) -> torch.Tensor:
    """(H,) relative gap of each lane's first k centres:
    |program - reference| / |reference| over the lane's k x d values."""
    p = program[:, :k].to(reference.dtype)
    r = reference[:, :k]
    return ((p - r).flatten(1).norm(dim=1)
            / r.flatten(1).norm(dim=1).clamp(min=1e-30))


# -- counts and curves ----------------------------------------------------


def _one_hot_columns(indices: torch.Tensor, labels: torch.Tensor, n: int,
                     width: int) -> torch.Tensor:
    """(n, H * width) float32 with a 1 at (indices[h, s], h * width +
    labels[h, s])."""
    h = indices.shape[0]
    out = torch.zeros((n, h * width), dtype=torch.float32,
                      device=indices.device)
    col = torch.arange(h, device=indices.device)[:, None] * width + labels
    out[indices.reshape(-1), col.reshape(-1)] = 1.0
    return out


def edges_f32(bins: int) -> torch.Tensor:
    return torch.from_numpy(np.linspace(0.0, 1.0, bins + 1)
                            .astype(np.float32))


def bin_values(values: torch.Tensor, bins: int) -> torch.Tensor:
    """Bin index of each value in [0, 1]: edges[b] <= v < edges[b + 1], the
    last bin closed."""
    edges = edges_f32(bins).to(values.device)
    idx = torch.bucketize(values, edges, right=True) - 1
    return torch.clamp(idx, 0, bins - 1)


def exact_hist_counts(indices: torch.Tensor, labels: torch.Tensor, n: int,
                      bins: int) -> torch.Tensor:
    """(bins,) int64 counts of Cij over the strict upper triangle."""
    width = int(labels.max()) + 1
    with full_f32():
        a = _one_hot_columns(indices, labels, n, width)
        s = _one_hot_columns(indices, torch.zeros_like(labels), n, 1)
        eps = torch.tensor(1e-6, dtype=torch.float32, device=a.device)
        counts = torch.zeros(bins, dtype=torch.int64, device=a.device)
        for r0 in range(0, n - 1, ROW_BLOCK):
            r1 = min(n - 1, r0 + ROW_BLOCK)
            mij = a[r0:r1] @ a[r0 + 1:].T
            iij = s[r0:r1] @ s[r0 + 1:].T
            cij = mij / (iij + eps)
            del mij, iij
            # Row i keeps columns j > i: column c of the slice is j = r0+1+c.
            upper = (torch.arange(r0 + 1, n, device=a.device)[None, :]
                     > torch.arange(r0, r1, device=a.device)[:, None])
            counts += torch.bincount(bin_values(cij[upper], bins),
                                     minlength=bins)
            del cij, upper
    return counts


def curves(counts, n: int, pac_interval, parity_zeros: bool = True):
    """float32 (cdf, pac) from strict-upper-triangle bin counts."""
    counts = np.asarray(counts, dtype=np.int64).copy()
    if parity_zeros:
        counts[..., 0] += n * (n + 1) // 2
        total = float(n) * float(n)
    else:
        total = float(n) * (n - 1) / 2.0
    cdf = np.cumsum(counts, axis=-1).astype(np.float32) / np.float32(total)
    lo, hi = pac_bins(pac_interval, counts.shape[-1])
    return cdf, cdf[..., hi - 1] - cdf[..., lo]


def sample_pairs(random_state: int, n: int, m: int, device):
    """(i, j) int64 (m,) pairs, i < j, uniform over the upper triangle."""
    key = threefry.fold_in(threefry.prng_key(random_state, device), PAIR_TAG)
    keys = threefry.split(key)
    i = threefry.randint(keys[0], (m,), 0, n).long()
    off = threefry.randint(keys[1], (m,), 0, n - 1).long()
    j = (i + 1 + off) % n
    return torch.minimum(i, j), torch.maximum(i, j)


def pair_hist_counts(indices: torch.Tensor, labels: torch.Tensor, n: int,
                     pi: torch.Tensor, pj: torch.Tensor,
                     bins: int) -> torch.Tensor:
    """(bins,) counts of the sampled pairs' consensus values."""
    h = indices.shape[0]
    rows = torch.arange(h, device=indices.device)[:, None].expand_as(indices)
    lab = torch.zeros((h, n), dtype=torch.int64, device=indices.device)
    lab[rows, indices] = labels.long() + 1  # 0: not sampled
    li, lj = lab[:, pi], lab[:, pj]
    mij = ((li > 0) & (li == lj)).sum(0).to(torch.float32)
    iij = ((li > 0) & (lj > 0)).sum(0).to(torch.float32)
    eps = torch.tensor(1e-6, dtype=torch.float32, device=indices.device)
    return torch.bincount(bin_values(mij / (iij + eps), bins),
                          minlength=bins)


def pair_curves(counts, m: int, n: int, pac_interval,
                parity_zeros: bool = True):
    """float32 (cdf, pac) estimates from sampled-pair bin counts: the
    empirical pair CDF mapped onto the N^2 population."""
    counts = np.asarray(counts, dtype=np.int64)
    t = n * (n - 1) / 2.0
    frac = np.cumsum(counts, axis=-1) / float(m)
    if parity_zeros:
        cdf = (t * frac + n * (n + 1) / 2.0) / (float(n) * float(n))
    else:
        cdf = frac
    cdf = cdf.astype(np.float32)
    lo, hi = pac_bins(pac_interval, counts.shape[-1])
    return cdf, cdf[..., hi - 1] - cdf[..., lo]


def best_k(ks: List[int], pacs: List[float]) -> int:
    """The largest K whose PAC is within 1e-3 of the least."""
    pac = np.asarray(pacs, np.float64)
    return int(max(k for k, p in zip(ks, pac) if p <= pac.min() + 1e-3))
