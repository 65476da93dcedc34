"""The k-means++ draw wrapper (``ops/kmeanspp``) on the CPU.

Its CPU route is the plain version, which must be the ``rng`` composition
the seeding ran before it had a kernel: the JAX-parity tests of KMeans rest
on that.  The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.ops import kmeanspp
from consensus_clustering_tpu_torch.parallel.sweep import KERNELS


def _keys(seed, batch):
    keys = rng.prng_key(seed)
    for width in batch:
        keys = rng.split(keys, width)
    return keys


def _d2(seed, shape, dtype):
    g = torch.Generator().manual_seed(seed)
    d2 = torch.rand(shape, generator=g, dtype=torch.float64) * 20
    d2[torch.rand(shape, generator=g) < 0.2] = 0.0
    d2[..., 1::7] = 1e-35
    return d2.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("batch,n,trials", [((4, 3), 257, 5), ((2,), 40, 3),
                                            ((3, 2), 1001, 11)])
def test_cpu_draws_are_the_rng_composition(batch, n, trials, dtype):
    key_rest = _keys(n, batch)
    d2 = _d2(n, batch + (n,), dtype)
    d2[(0,) * len(batch)] = 0.0  # a lane of -inf logits draws index 0
    for j in (1, 2, 5, 19):
        logits = torch.where(d2 > 0, torch.log(torch.clamp(d2, min=1e-30)),
                             torch.tensor(float("-inf"), dtype=dtype))
        want = rng.categorical(rng.fold_in(key_rest, j), logits, trials)
        got = kmeanspp.draw_candidates(key_rest, j, d2, trials)
        assert got.shape == batch + (trials,) and got.dtype == torch.int64
        assert torch.equal(got, want), j
        assert not got[(0,) * len(batch)].any()


@pytest.mark.parametrize("batch,n", [((4, 3), 257), ((1,), 1), ((2, 2), 99)])
def test_cpu_seed_keys_are_split_and_randint(batch, n):
    keys = _keys(n + 1, batch)
    key_rest, first = kmeanspp.seed_keys(keys, n)
    pair = rng.split(keys)
    assert torch.equal(key_rest, pair[..., 1, :])
    assert torch.equal(first, rng.randint(pair[..., 0, :], (), 0, n).long())
    assert first.dtype == torch.int64 and bool(((0 <= first) &
                                                (first < n)).all())


@pytest.mark.parametrize("keys_shape,d2_shape,trials,match", [
    ((4, 3, 3), (4, 3, 50), 5, "generator keys"),   # keys not (..., 2)
    ((4, 3, 2), (4, 50), 5, "lanes"),               # D^2 lacks a lane dim
    ((4, 3, 2), (4, 2, 50), 5, "lanes"),            # other lane count
    ((4, 3, 2), (4, 3, 2, 50), 5, "lanes"),         # one dim too many
    ((4, 3, 2), (4, 3, 0), 5, "n >= 1"),            # no points
    ((4, 3, 2), (4, 3, 50), 0, "n_trials >= 1"),    # no trials
])
def test_draw_refuses_malformed_inputs(keys_shape, d2_shape, trials, match):
    keys = torch.zeros(keys_shape, dtype=torch.int64)
    d2 = torch.ones(d2_shape)
    with pytest.raises(ValueError, match=match):
        kmeanspp.draw_candidates(keys, 1, d2, trials)


@pytest.mark.parametrize("call", [
    lambda: kmeanspp.draw_candidates_kernel(
        torch.zeros((2, 2), dtype=torch.int64), 1, torch.ones(2, 9), 3),
    lambda: kmeanspp.seed_keys_kernel(torch.zeros((2, 2), dtype=torch.int64),
                                      9),
    lambda: kmeanspp.seed_keys(torch.zeros((2, 2), dtype=torch.int32), 9),
])
def test_kernel_entries_refuse_cpu_tensors_and_bad_keys(call):
    before = kmeanspp.launch_count
    with pytest.raises(ValueError, match="CUDA|generator keys"):
        call()
    assert kmeanspp.launch_count == before


def test_sweeps_build_the_draw_kernel():
    assert "kmeanspp" in KERNELS
