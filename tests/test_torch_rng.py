"""The port's counter-based generator against ``jax.random``.

Key data, raw bits, integer draws and permutations must be bit-identical:
the resample plan of the port equals the reference package's only if they
are.  Gumbel noise goes through ``log``, whose f32 result differs between
torch and XLA in the last ulp for some inputs, so categorical draws are
held to agreement on at least 99.9% of draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_clustering_tpu.ops.resample import (
    resample_indices as jax_resample_indices,
)
from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.convert import key_from_jax
from consensus_clustering_tpu_torch.ops.resample import resample_indices

SEEDS = [0, 1, 23, 4096, 2**31 - 1]


def _kd(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_split(seed):
    key = jax.random.PRNGKey(seed)
    tkey = rng.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), _kd(key))
    for data in (0, 7, 2**31 + 5):
        np.testing.assert_array_equal(
            rng.fold_in(tkey, data).numpy(),
            _kd(jax.random.fold_in(key, np.uint32(data))),
        )
    for num in (2, 3, 5):
        ref = _kd(jax.random.split(key, num))  # jaxlint: disable=JL001 -- one key, several split widths on purpose
        np.testing.assert_array_equal(rng.split(tkey, num).numpy(), ref)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 11), (2, 3, 4)])
def test_random_bits(seed, shape):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        rng.random_bits(rng.prng_key(seed), shape).numpy(),
        np.asarray(jax.random.bits(key, shape)).astype(np.int64),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize(
    "shape,lo,hi", [((), 0, 4000), ((50,), 3, 100_000), ((4, 5), -7, 9)]
)
def test_randint(seed, shape, lo, hi):
    key = jax.random.PRNGKey(seed)
    ref = jax.random.randint(key, shape, lo, hi, dtype=jnp.int32)
    got = rng.randint(rng.prng_key(seed), shape, lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 29, 200, 1625, 5000])
def test_permutation(seed, n):
    # n = 5000 takes two shuffle rounds (ceil(3 ln n / ln(2^32 - 1)) = 2).
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        rng.permutation(rng.prng_key(seed), n).numpy(),
        np.asarray(jax.random.permutation(key, n)),
    )


@pytest.mark.parametrize(
    "seed,n,h,n_sub,h_start",
    [(23, 29, 30, 23, 0), (3, 5000, 4, 4000, 0), (7, 200, 12, 160, 9),
     (11, 150, 5, 150, 2**32 - 2)],
)
def test_resample_indices(seed, n, h, n_sub, h_start):
    key = jax.random.PRNGKey(seed)
    ref = jax_resample_indices(key, n, h, n_sub, h_start=h_start)
    got = resample_indices(key_from_jax(_kd(key)), n, h, n_sub, h_start)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits(seed):
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.uniform(key, (999,)))
    got = rng.uniform(rng.prng_key(seed), (999,)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_agreement(seed):
    key = jax.random.PRNGKey(seed)
    logits = np.log(
        np.random.default_rng(seed).random(300) + 1e-3
    ).astype(np.float32)
    logits[::17] = -np.inf  # chosen points: never drawn again
    ref = np.asarray(
        jax.random.categorical(key, jnp.asarray(logits), shape=(5000,))
    )
    got = rng.categorical(rng.prng_key(seed), torch.tensor(logits), 5000)
    assert (got.numpy() == ref).mean() >= 0.999
    assert not np.isin(got.numpy(), np.arange(0, 300, 17)).any()


def test_batched_keys_match_per_key_draws():
    # A batch of keys gives, row by row, the draws of each key alone.
    keys = rng.fold_in(rng.prng_key(5), torch.arange(6))
    batch = rng.permutation(keys, 77)
    for i in range(6):
        np.testing.assert_array_equal(
            batch[i].numpy(), rng.permutation(keys[i], 77).numpy()
        )
