"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; without them each one
skips (the decision is made inside the fixture, never at import).  Run on
the GPU machine with ``python -m pytest --noconftest
tests/test_torch_cuda.py -q``: the suite's conftest imports JAX, which the
port's machine need not have, and nothing here uses its fixtures.
"""

import numpy as np
import pytest
import torch

from consensus_clustering_tpu_torch.ops import hist, lloyd
from consensus_clustering_tpu_torch.ops.analysis import consensus_matrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,rows,off,n_valid", [(300, 300, 0, 300),
                                                (517, 129, 200, 500)])
def test_hist_kernel_equals_plain(cuda, n, rows, off, n_valid):
    g = torch.Generator(device=cuda).manual_seed(n)
    iij = torch.randint(1, 41, (n, n), generator=g, device=cuda)
    mij = torch.floor(iij * torch.rand((n, n), generator=g, device=cuda))
    cij = consensus_matrix(mij.int(), iij.int())[off:off + rows]
    got = hist.consensus_hist_counts(cij, n_valid, off, 20)
    ref = hist.consensus_hist_counts_plain(cij, n_valid, off, 20)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("b,n,d,n_init,k_max,k", [(4, 1000, 50, 3, 20, 20),
                                                  (3, 257, 9, 2, 7, 4)])
def test_lloyd_kernel_equals_plain_on_quantised_data(cuda, b, n, d, n_init,
                                                     k_max, k):
    g = torch.Generator(device=cuda).manual_seed(b * n)
    x = torch.round(torch.randn((b, n, d), generator=g, device=cuda) * 16) / 8
    src = torch.arange(b, device=cuda).repeat_interleave(n_init)
    pick = torch.randint(0, n, (b * n_init, k_max), generator=g, device=cuda)
    cen = x[src[:, None], pick]
    got = lloyd.lloyd_step(x, src, cen, k)
    ref = lloyd.lloyd_step_plain(x, src, cen, k)
    for a, r in zip(got, ref):
        assert torch.equal(a, r.to(a.dtype))


def test_small_fit_matches_cpu(cuda):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs

    x, _ = make_blobs(n_samples=200, n_features=6, centers=3,
                      cluster_std=1.5, random_state=2)
    fits = [
        ConsensusClustering(K_range=range(2, 5), n_iterations=20,
                            random_state=3, device=dev).fit(x)
        for dev in ("cuda", "cpu")
    ]
    np.testing.assert_array_equal(fits[0].cdf_at_K_data[2]["iij"],
                                  fits[1].cdf_at_K_data[2]["iij"])
    for k in range(2, 5):
        assert abs(fits[0].cdf_at_K_data[k]["pac_area"]
                   - fits[1].cdf_at_K_data[k]["pac_area"]) <= 0.02
