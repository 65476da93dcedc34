"""Spectral clustering over a batch of subsamples.

The port of the reference package's ``models/spectral.py``: RBF (or
precomputed) affinity, the symmetric normalised adjacency
``D^-1/2 A D^-1/2``, its top ``k_max`` eigenvectors, a diffusion scale by
``D^-1/2``, columns >= k zeroed, rows normalised, then the port's
:class:`~.kmeans.KMeans` on the embedding (so its Lloyd steps and final
assignment run the card's kernels).

The eigenvectors come from a dense ``torch.linalg.eigh`` or, with
``solver="lobpcg"`` and ``n > 5 * k_max``, from :func:`lobpcg_standard`, a
copy of the iteration of ``jax.experimental.sparse.linalg.lobpcg_standard``
(always-orthonormal basis, SVQB orthonormalisation, the same stopping
rule) for one matrix, started from :func:`..rng.normal` draws.
Eigenvector signs and the order within near-equal eigenvalues differ
between implementations, so the labels match the reference's in
agreement (ARI), not bit for bit.  The eigensolver runs one lane at a
time, so that a lane's labels do not depend on its batch
(:meth:`SpectralClustering.fit_predict`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.models.agglomerative import (
    pairwise_sq_euclidean,
)
from consensus_clustering_tpu_torch.models.kmeans import KMeans


def rbf_affinity(x: torch.Tensor, gamma: Optional[float] = None):
    """exp(-gamma ||xi - xj||^2) per lane; gamma defaults to 1.0."""
    if gamma is None:
        gamma = 1.0
    return torch.exp(-gamma * pairwise_sq_euclidean(x))


# -- LOBPCG (the algorithm of jax.experimental.sparse.linalg) -------------


def _col_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=0, keepdim=True)


def _eigh_descending(a: torch.Tensor):
    w, v = torch.linalg.eigh(a)
    return w.flip(-1), v.flip(-1)


def _svqb(x: torch.Tensor) -> torch.Tensor:
    """An orthonormal basis of the columns of x by SVQB; directions whose
    eigenvalue in x^T x falls under eps times the largest are zeroed."""
    norms = _col_norms(x)
    x = x / torch.where(norms == 0, 1.0, norms)
    inner = x.T @ x
    w, v = _eigh_descending(inner)
    tau = torch.finfo(x.dtype).eps * w[0]
    sqrted = torch.where(tau > 0, torch.maximum(w, tau), 1.0) ** -0.5
    keep = (w > tau) & (torch.diagonal(inner) > 0.0)
    ortho = x @ (v * sqrted) * keep.to(x.dtype)
    norms = _col_norms(ortho)
    return ortho / torch.where(keep & (norms > 0.0), norms, 1.0)


def _orthonormalize(x: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        x = _svqb(x)
    return x


def _project_out(basis: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The part of ``u`` orthogonal to ``basis``, orthonormal, with columns
    that may carry ``basis`` components back in zeroed."""
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
        u = _orthonormalize(u)
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    return u * (_col_norms(u) >= 0.99).to(u.dtype)


def _extend_basis(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, m) columns orthonormal to the orthonormal x (n, k), by a block
    Householder reflector (deterministic)."""
    n, k = x.shape
    upper, lower = x[:k], x[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, lower])
    other = torch.zeros((n - k, m), dtype=x.dtype, device=x.device)
    other[:m] = torch.eye(m, dtype=x.dtype, device=x.device)
    w = y @ (vt.T * (2 * (1 + s)) ** -0.5)
    h = -2 * (w @ (w[k:].T @ other))
    h[k:] += other
    return h


def lobpcg_standard(a: torch.Tensor, x: torch.Tensor, m: int = 100):
    """Top-k eigenpairs of a symmetric ``a`` (n, n) from a start block ``x``
    (n, k), ``5 k < n``: ``(theta (k,), vectors (n, k), iterations)``,
    largest first.

    It stops after ``m`` iterations or once every residual
    ``|A v - lambda v|`` is under ``eps * 10 * n * (lambda + |A v|)``, with
    ``eps`` the dtype's.
    """
    n, k = x.shape
    if k == 0 or 5 * k >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    tol = torch.finfo(x.dtype).eps
    x = _orthonormalize(x)
    p = _extend_basis(x, k)
    ax = a @ x
    theta = (x * ax).sum(0)
    r = ax - theta * x
    iters = 0
    while iters < m:
        xpr = torch.cat([x, p, _project_out(torch.cat([x, p], 1), r)], 1)
        th, q = _eigh_descending(xpr.T @ (a @ xpr))
        b = q[:, :k]
        x = xpr @ (b / _col_norms(b))
        x = x / _col_norms(x)
        qq, _ = torch.linalg.qr(q[:k, k:].T)
        p = xpr @ (q[:, k:] @ qq)
        norm_p = _col_norms(p)
        p = p / torch.where(norm_p == 0, 1.0, norm_p)
        ax = a @ x
        theta = th[:k]
        r = ax - theta * x
        iters += 1
        reltol = (torch.linalg.vector_norm(ax, dim=0) + theta) * n * 10
        if bool((torch.linalg.vector_norm(r, dim=0) < tol * reltol).all()):
            break
    return theta, x, iters


@dataclasses.dataclass(frozen=True)
class SpectralClustering:
    """Spectral clusterer implementing :class:`.protocol.Clusterer`.

    ``affinity``: 'rbf' on the subsample's features, or 'precomputed'
    (each subsample is its own affinity matrix).  ``gamma`` as sklearn.
    ``n_init`` goes to the embedding's KMeans.  ``solver``: 'dense'
    (``eigh``) or 'lobpcg' (``lobpcg_iters`` iterations at most), which
    takes ``eigh`` at ``n <= 5 * k_max``.
    """

    affinity: str = "rbf"
    gamma: Optional[float] = None
    n_init: int = 3
    solver: str = "dense"
    lobpcg_iters: int = 64

    def _embedding(self, key, x, k, k_max):
        """The row-normalised (1, n, k_max) embedding of one lane (1, n, d)
        from its eigenvector key (1, 2)."""
        if self.affinity == "rbf":
            a = rbf_affinity(x, self.gamma)
        elif self.affinity == "precomputed":
            a = x
        else:
            raise ValueError(f"unknown affinity {self.affinity!r}")
        deg = a.sum(-1)
        inv_sqrt = torch.rsqrt(torch.clamp(deg, min=1e-12))
        a_norm = a * inv_sqrt[..., :, None] * inv_sqrt[..., None, :]
        n = a_norm.shape[-1]
        if self.solver == "lobpcg" and n > 5 * k_max:
            x0 = rng.normal(key[0], (n, k_max), torch.float32)
            vecs = lobpcg_standard(a_norm[0], x0, m=self.lobpcg_iters)[1]
            vecs = vecs[None]
        elif self.solver in ("dense", "lobpcg"):
            vecs = _eigh_descending(a_norm)[1][..., :k_max]
        else:
            raise ValueError(f"unknown solver {self.solver!r}")
        emb = vecs * inv_sqrt[..., None]
        col_valid = torch.arange(k_max, device=x.device) < k
        emb = torch.where(col_valid, emb, 0.0)
        norms = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return emb / torch.clamp(norms, min=1e-12)

    def fit_predict(self, keys: torch.Tensor, x: torch.Tensor, k: int,
                    k_max: Optional[int] = None) -> torch.Tensor:
        """(B, n) int64 labels for (B, n, d) subsamples (or affinities).

        The embeddings are computed one lane at a time: on the card a
        batched QR rounds a batch of one differently from a larger batch,
        and LOBPCG turns such a difference into another basis of a
        near-degenerate eigenspace, so a batched solve would make a lane's
        labels depend on which lanes share its batch.  The embedding's
        KMeans runs on all lanes at once.
        """
        k = int(k)
        k_max = k if k_max is None else int(k_max)
        x = x.to(torch.float32)
        pair = rng.split(keys)
        emb = torch.cat([
            self._embedding(pair[i:i + 1, 0], x[i:i + 1], k, k_max)
            for i in range(x.shape[0])
        ])
        return KMeans(n_init=self.n_init).fit_predict(pair[:, 1], emb, k,
                                                      k_max)
