"""The port's bit-planes and popcount counts against the reference package's.

- pack_bits/unpack_bits, pack_label_planes and pack_cosample_planes (with a
  row0 that crosses a word and sets bit 31): bit-identical to the
  reference's uint32 planes (compared through ``.view(np.int32)``).
- popcount_accumulate (the plain version of kernel B3) equals the
  reference's lax popcount and its Pallas kernel in interpret mode, on
  ragged shapes.
- coassoc_counts_packed / cosample_counts_packed equal the reference's
  packed counts and the port's dense one-hot counts, row blocks included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_clustering_tpu.ops import bitpack as jax_bitpack
from consensus_clustering_tpu.ops.pallas_coassoc import (
    packed_coassoc_counts as jax_packed_coassoc_counts,
)
from consensus_clustering_tpu_torch.ops import bitpack, popcount
from consensus_clustering_tpu_torch.ops.coassoc import coassociation_counts
from consensus_clustering_tpu_torch.ops.resample import cosample_counts


def _bits(x):
    """A reference uint32 array as the port's int32 bit patterns."""
    return np.asarray(x).view(np.int32)


def _plan(seed, n, h, n_sub, k, k_max):
    rs = np.random.default_rng(seed)
    idx = np.stack([rs.permutation(n)[:n_sub] for _ in range(h)])
    labels = rs.integers(0, k, size=(h, n_sub))
    labels[0, :3] = -1            # dropped: negative label
    labels[1, :2] = k_max + 1     # dropped: label >= k_max
    idx[2, :4] = -1               # dropped: padded index
    return labels.astype(np.int32), idx.astype(np.int32)


def _random_words(rs, shape):
    return rs.integers(-2**31, 2**31, size=shape, dtype=np.int64).astype(
        np.int32)


def test_pack_bits_round_trip_and_bit31():
    rs = np.random.default_rng(0)
    bits = rs.integers(0, 2, size=(3, 75)).astype(np.int32)
    bits[:, 31] = 1
    ref = _bits(jax_bitpack.pack_bits(jnp.asarray(bits)))
    got = bitpack.pack_bits(torch.tensor(bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got[:, 0] < 0).all()  # bit 31 is the sign bit
    np.testing.assert_array_equal(bitpack.unpack_bits(got, 75).numpy(), bits)


@pytest.mark.parametrize("h,row0,n_words", [(13, 0, None), (6, 29, 2),
                                            (40, 5, 3), (9, 63, 3)])
def test_pack_label_planes_bit_identical(h, row0, n_words):
    labels, idx = _plan(h + row0, 57, h, 41, 4, 5)
    ref = jax_bitpack.pack_label_planes(
        jnp.asarray(labels), jnp.asarray(idx), 5, 57,
        n_words=n_words, row0=jnp.int32(row0) if n_words else row0,
    )
    got = bitpack.pack_label_planes(
        torch.tensor(labels), torch.tensor(idx), 5, 57, n_words=n_words,
        row0=row0,
    )
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), _bits(ref))
    cop_ref = jax_bitpack.pack_cosample_planes(
        jnp.asarray(idx), 57, n_words=n_words,
        row0=jnp.int32(row0) if n_words else row0,
    )
    cop = bitpack.pack_cosample_planes(torch.tensor(idx), 57,
                                       n_words=n_words, row0=row0)
    np.testing.assert_array_equal(cop.numpy(), _bits(cop_ref))


def test_popcount32_edges():
    words = torch.tensor([0, -1, -2**31, 2**31 - 1, 0x55555555, 1],
                         dtype=torch.int32)
    np.testing.assert_array_equal(bitpack.popcount32(words).numpy(),
                                  [0, 32, 1, 31, 16, 1])


@pytest.mark.parametrize("l_words,r,c,chunk", [(13, 264, 300, 4),
                                               (7, 9, 33, 3), (1, 5, 5, 4),
                                               (40, 17, 130, 8)])
def test_popcount_plain_matches_reference_kernel(l_words, r, c, chunk):
    rs = np.random.default_rng(l_words * r + c)
    rows = _random_words(rs, (l_words, r))
    cols = _random_words(rs, (l_words, c))
    ref_kernel = jax_packed_coassoc_counts(
        jnp.asarray(rows.view(np.uint32)), jnp.asarray(cols.view(np.uint32)),
        use_kernel=True, interpret=True,
    )
    ref_lax = jax_bitpack.popcount_accumulate(
        jnp.asarray(rows.view(np.uint32)), jnp.asarray(cols.view(np.uint32)))
    got = bitpack.popcount_accumulate(torch.tensor(rows), torch.tensor(cols),
                                      word_chunk=chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_kernel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_lax))
    # The CPU wrapper is the plain version, and a column slice (the
    # engine's row tile) counts like a copy.
    sliced = popcount.packed_coassoc_counts(
        torch.tensor(cols)[:, 1:r + 1] if c > r else torch.tensor(cols),
        torch.tensor(cols))
    ref_sliced = bitpack.popcount_accumulate(
        torch.tensor(cols)[:, 1:r + 1].contiguous() if c > r
        else torch.tensor(cols), torch.tensor(cols))
    np.testing.assert_array_equal(sliced.numpy(), ref_sliced.numpy())


@pytest.mark.parametrize("n,h,n_sub,k,k_max", [(29, 30, 23, 5, 14),
                                               (120, 70, 96, 6, 6)])
def test_packed_counts_equal_reference_and_dense(n, h, n_sub, k, k_max):
    labels, idx = _plan(n, n, h, n_sub, k, k_max)
    lt, it = torch.tensor(labels), torch.tensor(idx)
    mij = bitpack.coassoc_counts_packed(lt, it, n, k_max)
    iij = bitpack.cosample_counts_packed(it, n)
    ref_mij = jax_bitpack.coassoc_counts_packed(
        jnp.asarray(labels), jnp.asarray(idx), n, k_max)
    ref_iij = jax_bitpack.cosample_counts_packed(jnp.asarray(idx), n)
    np.testing.assert_array_equal(mij.numpy(), np.asarray(ref_mij))
    np.testing.assert_array_equal(iij.numpy(), np.asarray(ref_iij))
    np.testing.assert_array_equal(
        mij.numpy(), coassociation_counts(lt, it, n, k_max).numpy())
    np.testing.assert_array_equal(iij.numpy(), cosample_counts(it, n).numpy())
    block = bitpack.coassoc_counts_packed(lt, it, n, k_max, n_cols=n + 7,
                                          row_start=3, n_rows=11)
    np.testing.assert_array_equal(block[:, :n].numpy(), mij[3:14].numpy())
    assert not block[:, n:].any()
    iblock = bitpack.cosample_counts_packed(it, n, row_start=5, n_rows=4)
    np.testing.assert_array_equal(iblock.numpy(), iij[5:9].numpy())
    with pytest.raises(ValueError, match="together"):
        bitpack.cosample_counts_packed(it, n, row_start=5)
