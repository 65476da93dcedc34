"""The port's integer and analysis ops against the reference package's.

Iij, Mij (with -1 padding), Cij, histogram counts and the CDF/PAC curves
must be bit-identical given the same inputs.  The reference histogram runs
both through its Pallas kernel in interpret mode and through its XLA path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_clustering_tpu.ops import analysis as jax_analysis
from consensus_clustering_tpu.ops.coassoc import (
    coassociation_counts as jax_coassoc,
)
from consensus_clustering_tpu.ops.pallas_hist import (
    consensus_hist_counts as jax_hist,
)
from consensus_clustering_tpu.ops.resample import (
    cosample_counts as jax_cosample,
)
from consensus_clustering_tpu_torch.ops import analysis, hist
from consensus_clustering_tpu_torch.ops.coassoc import coassociation_counts
from consensus_clustering_tpu_torch.ops.resample import (
    cosample_counts,
    indicator_matrix,
)


def _plan(seed, n, h, n_sub, pad_rows=0):
    rs = np.random.default_rng(seed)
    idx = np.stack([rs.permutation(n)[:n_sub] for _ in range(h)])
    if pad_rows:
        idx[-pad_rows:] = -1
    return idx.astype(np.int32)


@pytest.mark.parametrize("n,h,n_sub,pad", [(29, 30, 23, 0), (120, 32, 96, 3),
                                           (200, 17, 200, 0)])
def test_cosample_counts_bit_identical(n, h, n_sub, pad):
    idx = _plan(n + h, n, h, n_sub, pad)
    ref = np.asarray(jax_cosample(jnp.asarray(idx), n))
    got = cosample_counts(torch.tensor(idx, dtype=torch.int64), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_indicator_drops_padding():
    idx = torch.tensor([[0, 2, -1], [1, 5, 3]])
    r = indicator_matrix(idx, 4)
    np.testing.assert_array_equal(
        r.numpy(), [[1, 0, 1, 0], [0, 1, 0, 1]]
    )


@pytest.mark.parametrize(
    "n,h,n_sub,k_max,k,chunk",
    [(29, 30, 23, 14, 5, 8), (120, 32, 96, 6, 6, 5), (150, 9, 120, 4, 2, 4),
     (64, 11, 64, 3, 3, 100)],
)
def test_coassociation_counts_bit_identical(n, h, n_sub, k_max, k, chunk):
    rs = np.random.default_rng(n * k)
    idx = _plan(n, n, h, n_sub)
    labels = rs.integers(0, k, size=(h, n_sub)).astype(np.int32)
    labels[-2:] = -1  # padded resamples contribute nothing
    ref = np.asarray(jax_coassoc(
        jnp.asarray(labels), jnp.asarray(idx), n, k_max, chunk
    ))
    got = coassociation_counts(
        torch.tensor(labels, dtype=torch.int64),
        torch.tensor(idx, dtype=torch.int64), n, k_max, chunk,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def _counts_pair(seed, n, h):
    rs = np.random.default_rng(seed)
    iij = rs.integers(0, h + 1, size=(n, n)).astype(np.int32)
    iij = np.minimum(iij, iij.T)
    mij = np.floor(iij * rs.random((n, n))).astype(np.int32)
    mij = np.minimum(mij, mij.T)
    # exact bin-edge ratios: 6/40 rounds to 0.14999999 in f32
    iij[:8, :8] = 40
    mij[:8, :8] = np.arange(64).reshape(8, 8) % 41
    return mij, iij


@pytest.mark.parametrize("n,h", [(57, 40), (130, 500)])
def test_consensus_matrix_bit_identical(n, h):
    mij, iij = _counts_pair(n, n, h)
    ref = np.asarray(jax_analysis.consensus_matrix(
        jnp.asarray(mij), jnp.asarray(iij)
    ))
    got = analysis.consensus_matrix(torch.tensor(mij), torch.tensor(iij))
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32), ref.view(np.uint32)
    )


@pytest.mark.parametrize(
    "n,rows,row_offset,n_valid,bins",
    [(57, 57, 0, 57, 20), (130, 130, 0, 120, 20), (130, 41, 37, 125, 20),
     (90, 90, 0, 90, 7), (64, 64, 0, 64, 128)],
)
def test_hist_counts_bit_identical(n, rows, row_offset, n_valid, bins):
    mij, iij = _counts_pair(rows + n, n, 40)
    cij = analysis.consensus_matrix(torch.tensor(mij), torch.tensor(iij))
    block = cij[row_offset:row_offset + rows]
    got = hist.consensus_hist_counts(block, n_valid, row_offset, bins)
    ref_kernel = jax_hist(
        jnp.asarray(block.numpy()), n_valid, row_offset, bins,
        use_pallas=True, interpret=True,
    )
    ref_xla = jax_hist(
        jnp.asarray(block.numpy()), n_valid, row_offset, bins,
        use_pallas=False,
    )
    g = row_offset + np.arange(rows)[:, None]
    c = np.arange(n)[None, :]
    mask = (c > g) & (g < n_valid) & (c < n_valid)
    ref_np, _ = np.histogram(block.numpy()[mask], bins=bins, range=(0, 1))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_kernel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_xla))
    np.testing.assert_array_equal(got.numpy(), ref_np)


def test_hist_rejects_too_many_bins():
    with pytest.raises(ValueError, match="bins"):
        hist.consensus_hist_counts(torch.zeros(4, 4), 4, 0, 129)


@pytest.mark.parametrize("parity_zeros", [True, False])
@pytest.mark.parametrize("n,bins,pac", [(29, 20, (0.1, 0.9)),
                                        (5000, 20, (0.1, 0.9)),
                                        (150, 16, (0.05, 0.95))])
def test_cdf_pac_from_counts_bit_identical(n, bins, pac, parity_zeros):
    # The reference function itself, run eagerly.  (Inside a jit, XLA turns
    # the divide by the constant N^2 into a multiply by its reciprocal, so
    # the reference SWEEP's curves can sit one f32 ulp away; the sweep
    # parity tests hold PAC to a band for that reason.)
    rs = np.random.default_rng(n + bins)
    counts = rs.multinomial(n * (n - 1) // 2, np.ones(bins) / bins)
    counts = counts.astype(np.int32)
    lo, hi = analysis.pac_indices(pac, bins)
    assert (lo, hi) == jax_analysis.pac_indices(pac, bins)
    ref = jax_analysis.cdf_pac_from_counts(
        jnp.asarray(counts), n, lo, hi, parity_zeros
    )
    got = analysis.cdf_pac_from_counts(
        torch.tensor(counts), n, lo, hi, parity_zeros
    )
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(
            np.asarray(g.numpy()).view(np.uint32),
            np.asarray(r).view(np.uint32),
        )


def test_host_analysis_helpers_match_reference():
    rs = np.random.default_rng(4)
    cdfs = np.sort(rs.random((6, 20)), axis=1)
    areas = analysis.area_under_cdf(cdfs)
    np.testing.assert_allclose(
        areas, np.asarray(jax_analysis.area_under_cdf(jnp.asarray(cdfs))),
        rtol=1e-6,
    )
    np.testing.assert_array_equal(
        analysis.delta_k(areas), jax_analysis.delta_k(areas)
    )
    ks = [2, 3, 4, 5, 6, 7]
    pac = [0.3, 0.0005, 0.0, 0.2, 0.0009, 0.4]
    for mode in ("PAC", "delta_k"):
        assert analysis.select_best_k(
            mode, ks, pac, analysis.delta_k(areas)
        ) == jax_analysis.select_best_k(mode, ks, pac, jax_analysis.delta_k(
            areas))
    np.testing.assert_array_equal(
        analysis.bin_edges(20), jax_analysis.bin_edges(20)
    )


@pytest.mark.parametrize(
    "n,rows,row_offset,n_valid,bins",
    [(57, 57, 0, 57, 20),      # a full matrix
     (130, 41, 37, 125, 20),   # ragged rows inside, n_valid below C
     (130, 64, 96, 120, 7),    # rows past N: the last 34 count nothing
     (130, 20, 140, 130, 20),  # row_offset past N: nothing counts
     (90, 90, 0, 90, 7)],
)
def test_hist_from_counts_bit_identical(n, rows, row_offset, n_valid, bins):
    # Mij/Iij int32 tiles with a band of exact edge ratios (6/40 and the
    # like): the count entry against the reference's consensus_matrix, then
    # its Pallas histogram in interpret mode.
    mij, iij = _counts_pair(rows + n + bins, max(n, row_offset + rows), 40)
    mij = mij[row_offset:row_offset + rows, :n]
    iij = iij[row_offset:row_offset + rows, :n]
    ref = np.asarray(jax_hist(
        jax_analysis.consensus_matrix(
            jnp.asarray(mij), jnp.asarray(iij), row_offset=row_offset),
        n_valid, row_offset, bins, use_pallas=True, interpret=True,
    ))
    out = torch.full((bins,), 7, dtype=torch.int64)
    got = hist.consensus_hist_from_counts(
        torch.tensor(mij), torch.tensor(iij), n_valid, row_offset, bins, out)
    assert got is out and out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64) + 7)


def test_hist_from_counts_refuses_cpu_tensors_at_the_kernel():
    m = torch.zeros(4, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hist.consensus_hist_from_counts_kernel(
            m, m, 4, 0, 20, torch.zeros(20, dtype=torch.int64))
    with pytest.raises(ValueError, match="bins"):
        hist.consensus_hist_from_counts(
            m, m, 4, 0, 129, torch.zeros(129, dtype=torch.int64))


def _kernel_bin(values: np.ndarray, bins: int) -> np.ndarray:
    """The kernel's bin rule (csrc/hist.cu) on the host, in f32: p = v *
    bins, b = int(p) (bins - 1 where p == bins); within 2^-10 of an
    integer, one step down if v < e[b] or up if v >= e[b + 1]; -1 outside
    [e[0], e[bins]]."""
    e = analysis.hist_edges(bins)
    v = np.asarray(values, np.float32)
    p = v * np.float32(bins)
    b = np.clip(p.astype(np.int32), 0, bins - 1)
    frac = p - b.astype(np.float32)
    near = (p < bins) & (((frac < 2.0**-10) & (b > 0))
                         | (frac > 1 - 2.0**-10))
    down = near & (v < e[b])
    up = near & ~down & (b + 1 < bins) & (v >= e[np.minimum(b + 1, bins)])
    b = b - down + up
    return np.where((v >= e[0]) & (v <= e[bins]), b, -1)


@pytest.mark.parametrize("bins", [1, 3, 7, 20, 100, 128])
def test_kernel_bin_rule_matches_np_histogram_at_every_edge(bins):
    # Every f32 edge and its two neighbours on each side.
    vals = []
    for e in analysis.hist_edges(bins):
        lo = hi = e
        vals.append(e)
        for _ in range(2):
            lo = np.nextafter(lo, np.float32(-1))
            hi = np.nextafter(hi, np.float32(2))
            vals += [lo, hi]
    vals = np.array(vals, np.float32)
    got = _kernel_bin(vals, bins)
    for v, b in zip(vals, got):
        counts, _ = np.histogram([v], bins=bins, range=(0, 1))
        assert b == (int(np.argmax(counts)) if counts.sum() else -1), v
    # Away from the edges the guess alone decides: counts of random values.
    rand = np.random.default_rng(bins).random(20000).astype(np.float32)
    ref, _ = np.histogram(rand, bins=bins, range=(0, 1))
    np.testing.assert_array_equal(
        np.bincount(_kernel_bin(rand, bins), minlength=bins), ref)
