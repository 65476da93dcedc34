"""Gaussian mixture (full-covariance EM) over a batch of subsamples.

The port of the reference package's ``models/gmm.py``, with its ``vmap``
over resamples and restarts written out as a lane axis: a call on (B, n, d)
subsamples runs B * n_init lanes.

- Each restart starts from ``KMeans(n_init=1, max_iter=init_kmeans_iters)``
  labels (the port's KMeans, so its Lloyd steps and final assignment run
  the card's kernels), as sklearn's ``init_params='kmeans'``.
- Component slots >= k get zero weight (-inf log-weight) and identity
  covariance, so every K shares the shapes.
- Each lane iterates E and M steps until its mean log-likelihood moves by
  at most ``tol`` or after ``max_iter`` steps.  Every step runs on all
  lanes and a stopped lane's state is kept by ``torch.where``, as the
  reference's vmapped ``while_loop`` keeps a finished lane's: the batch an
  op sees stays the lanes of the call, whichever lanes are still running.
- The restart with the highest final lower bound wins.

A covariance that is not positive definite (every component at n_sub < d
in float32, corr.csv's case) gets a NaN Cholesky factor, as
``jnp.linalg.cholesky`` returns: ``torch.linalg.cholesky_ex`` reports it
without raising or reading back to the host.  The lane's lower bound is
then NaN, so its loop stops (``abs(NaN) > tol`` is False), and the argmax
over restarts picks a NaN restart first, as ``jnp.argmax`` does.
float64 is the CPU parity path only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.models.kmeans import KMeans, _working_dtype

_LOG_2PI = 1.8378770664093453


def _cholesky_nan(cov: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors, all NaN where a matrix is not positive
    definite (``jnp.linalg.cholesky``'s result)."""
    chol, info = torch.linalg.cholesky_ex(cov)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)


def _masked_log_prob(x, means, chol, log_weights, valid):
    """(L, n, k_max) log [pi_j N(x | mu_j, Sigma_j)], -inf for invalid slots.

    x (L, n, d), means (L, K, d), chol (L, K, d, d), log_weights (L, K).
    """
    d = x.shape[-1]
    diff = (x[:, None, :, :] - means[:, :, None, :]).transpose(-1, -2)
    z = torch.linalg.solve_triangular(chol, diff, upper=False)  # (L, K, d, n)
    maha = (z * z).sum(-2)  # (L, K, n)
    log_det = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    log_gauss = -0.5 * (d * _LOG_2PI + log_det[..., None] + maha)
    log_p = log_gauss.transpose(1, 2) + log_weights[:, None, :]
    neg_inf = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    return torch.where(valid, log_p, neg_inf)


@dataclasses.dataclass(frozen=True)
class GaussianMixture:
    """Full-covariance GMM implementing :class:`.protocol.Clusterer`.

    ``n_init`` restarts (the best final lower bound wins), ``max_iter`` EM
    cap, ``tol`` on the change in mean log-likelihood, ``reg_covar``
    diagonal jitter and ``init_kmeans_iters``, the k-means init's Lloyd
    cap: the reference's knobs.
    """

    n_init: int = 1
    max_iter: int = 100
    tol: float = 1e-3
    reg_covar: float = 1e-6
    init_kmeans_iters: int = 10

    def _m_step(self, x, resp, valid):
        """resp (L, n, K) -> (means, Cholesky factors, log-weights)."""
        d = x.shape[-1]
        eye = torch.eye(d, dtype=x.dtype, device=x.device)
        nk = resp.sum(1) + 1e-10  # (L, K)
        means = torch.matmul(resp.transpose(1, 2), x) / nk[..., None]
        diff = x[:, None, :, :] - means[:, :, None, :]  # (L, K, n, d)
        weighted = resp.transpose(1, 2)[..., None] * diff
        cov = torch.matmul(weighted.transpose(-1, -2), diff) / nk[..., None, None]
        cov = cov + self.reg_covar * eye
        cov = torch.where(valid[..., None, None], cov, eye)
        chol = _cholesky_nan(cov)
        neg_inf = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
        total = (nk * valid).sum(-1, keepdim=True)
        log_w = torch.where(valid, torch.log(nk / total), neg_inf)
        return means, chol, log_w

    def _e_step(self, x, params, valid):
        log_p = _masked_log_prob(x, *params, valid)
        log_norm = torch.logsumexp(log_p, dim=-1, keepdim=True)
        return torch.exp(log_p - log_norm), log_norm[..., 0].mean(-1)

    def em(self, x: torch.Tensor, labels0: torch.Tensor, k: int, k_max: int):
        """EM from initial labels, per lane.

        Args:
          x: (L, n, d) one subsample per lane.
          labels0: (L, n) initial labels in [0, k).

        Returns:
          (labels (L, n) int64, lower bound (L,)) at each lane's stop.
        """
        valid = torch.arange(k_max, device=x.device) < k
        resp0 = torch.nn.functional.one_hot(labels0.long(), k_max).to(x.dtype)
        params = self._m_step(x, resp0, valid)
        lanes = x.shape[0]
        lb_prev = torch.full((lanes,), -1e30, dtype=x.dtype, device=x.device)
        lb_curr = torch.full((lanes,), 1e30, dtype=x.dtype, device=x.device)
        iters = torch.zeros(lanes, dtype=torch.int64, device=x.device)
        while True:
            active = ((lb_curr - lb_prev).abs() > self.tol) & (
                iters < self.max_iter)
            if not bool(active.any()):
                break
            resp, lb_new = self._e_step(x, params, valid)
            params = [
                torch.where(active.view(-1, *[1] * (q.dim() - 1)), q, p)
                for p, q in zip(params, self._m_step(x, resp, valid))
            ]
            lb_prev = torch.where(active, lb_curr, lb_prev)
            lb_curr = torch.where(active, lb_new, lb_curr)
            iters = iters + active
        log_p = _masked_log_prob(x, *params, valid)
        return torch.argmax(log_p, dim=-1), lb_curr

    def fit_predict(self, keys: torch.Tensor, x: torch.Tensor, k: int,
                    k_max: Optional[int] = None) -> torch.Tensor:
        """(B, n) int64 labels of the best restart per subsample."""
        k = int(k)
        k_max = k if k_max is None else int(k_max)
        x = _working_dtype(x)
        bsz, n, d = x.shape
        restarts = self.n_init
        rkeys = keys if restarts == 1 else rng.split(keys, restarts).reshape(
            bsz * restarts, 2)
        xl = x.repeat_interleave(restarts, dim=0) if restarts > 1 else x
        labels0 = KMeans(n_init=1, max_iter=self.init_kmeans_iters
                         ).fit_predict(rkeys, xl, k, k_max)
        labels, lb = self.em(xl, labels0, k, k_max)
        if restarts == 1:
            return labels
        best = torch.argmax(lb.reshape(bsz, restarts), dim=-1)
        rows = torch.arange(bsz, device=x.device)
        return labels.reshape(bsz, restarts, n)[rows, best]

