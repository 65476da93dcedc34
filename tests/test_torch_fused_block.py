"""The port's final assignment and fused assign+pack step (kernel B4's plain
version) against the reference package's, and against its own label path.

- On data quantised to multiples of 1/8 every distance is exact, so the
  reference's interpreted Pallas kernel and the port's plain version agree
  on every label: planes bit-identical, several shapes (ragged column
  tile, a row0 that crosses a word, k < k_max, an invalid lane).
- On raw blobs the fused planes equal the port's unfused route
  (assign_labels, then pack_label_planes) bit for bit: both take their
  labels from the same row-independent distance routine.
- The routine's distances do not depend on which rows share the call, and
  KMeans' labels are the nearest of its returned centroids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consensus_clustering_tpu.ops.bitpack import (
    pack_cosample_planes as jax_pack_cosample_planes,
)
from consensus_clustering_tpu.ops.pallas_fused_block import (
    fused_assign_pack as jax_fused_assign_pack,
    fused_planes_reference as jax_fused_planes_reference,
)
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.ops import fused_block
from consensus_clustering_tpu_torch.ops.bitpack import (
    pack_cosample_planes,
    pack_label_planes,
    packed_width,
)


def _case(seed, n_cols, d, k_max, lanes, row0, quantised):
    rs = np.random.default_rng(seed)
    if quantised:
        x = (np.round(rs.normal(size=(n_cols, d)) * 16) / 8).astype(np.float32)
        cents = x[rs.integers(0, n_cols, size=(lanes, k_max))]
    else:
        x, _ = make_blobs(n_samples=n_cols, n_features=d, centers=k_max,
                          cluster_std=1.5, random_state=seed)
        x = x.astype(np.float32)
        cents = (x[rs.integers(0, n_cols, size=(lanes, k_max))]
                 + rs.normal(size=(lanes, k_max, d)).astype(np.float32))
    n_sub = max(2, int(0.8 * n_cols))
    idx = np.stack([np.sort(rs.permutation(n_cols)[:n_sub])
                    for _ in range(lanes)]).astype(np.int32)
    if lanes > 1:
        idx[-1] = -1  # a lane past h_total owns no bits
    n_words = packed_width(row0 + lanes + 3)
    return x, cents.astype(np.float32), idx, n_words


@pytest.mark.parametrize(
    "n_cols,d,k_max,lanes,row0,k",
    [(77, 3, 4, 5, 2, 3), (300, 7, 5, 13, 3, 4), (130, 4, 3, 8, 0, 3),
     (200, 6, 8, 29, 37, 8)],
)
def test_plain_equals_reference_kernel_on_quantised_data(n_cols, d, k_max,
                                                         lanes, row0, k):
    x, cents, idx, n_words = _case(n_cols, n_cols, d, k_max, lanes, row0,
                                   True)
    cop = jax_pack_cosample_planes(jnp.asarray(idx), n_cols, n_words=n_words,
                                   row0=row0)
    args = (jnp.asarray(x), jnp.asarray(cents), jnp.int32(k), cop,
            jnp.int32(row0))
    ref = np.asarray(jax_fused_assign_pack(*args, n_words=n_words,
                                           interpret=True))
    ref_lax = np.asarray(jax_fused_planes_reference(*args, n_words=n_words))
    got = fused_block.fused_assign_pack(
        torch.tensor(x), torch.tensor(cents), k,
        torch.tensor(np.asarray(cop).view(np.int32)), row0, n_words=n_words,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.view(np.int32))
    np.testing.assert_array_equal(got.numpy(), ref_lax.view(np.int32))


def _unfused(x, cents, k, idx, row0, n_words):
    lanes = cents.shape[0]
    labels, _ = fused_block.assign_labels(
        x[None], torch.zeros(lanes, dtype=torch.int64), cents, k)
    gathered = torch.gather(labels, 1, idx.clamp(min=0))
    gathered[idx < 0] = -1
    return pack_label_planes(gathered, idx, cents.shape[1], x.shape[0],
                             n_words=n_words, row0=row0)


@pytest.mark.parametrize("seed,row0,k", [(0, 0, 6), (1, 30, 4), (2, 7, 6)])
def test_fused_equals_unfused_route_on_raw_blobs(seed, row0, k):
    x, cents, idx, n_words = _case(seed, 180, 8, 6, 20, row0, False)
    xt, ct, it = torch.tensor(x), torch.tensor(cents), torch.tensor(idx)
    cop = pack_cosample_planes(it, 180, n_words=n_words, row0=row0)
    got = fused_block.fused_assign_pack(xt, ct, k, cop, row0,
                                        n_words=n_words)
    np.testing.assert_array_equal(
        got.numpy(), _unfused(xt, ct, k, it, row0, n_words).numpy())
    assert got.any()


def test_row_distances_do_not_depend_on_the_row_set():
    rs = np.random.default_rng(5)
    x = torch.tensor(rs.normal(size=(2, 97, 11)).astype(np.float32))
    c = torch.tensor(rs.normal(size=(2, 6, 11)).astype(np.float32))
    full = fused_block.row_sqdist_plain(x, c, 5)
    rows = torch.tensor([96, 3, 40, 41])
    part = fused_block.row_sqdist_plain(x[:, rows], c, 5)
    np.testing.assert_array_equal(part.numpy(), full[:, rows].numpy())
    assert torch.isinf(full[..., 5]).all()
    labels, d_min = fused_block.assign_labels(
        x, torch.tensor([1, 0, 1]), c[[1, 0, 1]], 5)
    np.testing.assert_array_equal(labels[0].numpy(),
                                  full[1].argmin(-1).numpy())
    np.testing.assert_array_equal(d_min[1].numpy(), full[0].min(-1).values)


def test_kmeans_labels_are_the_nearest_of_its_centroids(blobs):
    x, _ = blobs
    assert KMeans.supports_fused_assign
    xt = torch.tensor(x)[None].expand(3, -1, -1)
    keys = torch.tensor([[0, 1], [0, 2], [0, 3]])
    labels, cents = KMeans(n_init=2).fit(keys, xt, 3, 5)
    again, _ = fused_block.assign_labels(xt, torch.arange(3), cents, 3)
    np.testing.assert_array_equal(labels.numpy(), again.numpy())


def test_lane_groups_fit_shared_memory():
    assert fused_block.lane_group_size(50, 20) == 32
    assert 1 <= fused_block.lane_group_size(200, 20) < 32
    assert fused_block.lane_group_size(3000, 20) == 0
    assert (fused_block.smem_bytes_fused(50, 20, 32)
            <= fused_block.MAX_SMEM_BYTES)
    assert (fused_block.smem_bytes_assign(50, 20)
            <= fused_block.MAX_SMEM_BYTES)


@pytest.mark.parametrize("n_words,n_cols,expected", [
    (4, 5120, 2),    # the stream's block: 160 tiles x words, 2 splits
    (2, 300, 32),    # a small block: every lane its own block
    (1, 64000, 1),   # 500 tiles already fill the card
])
def test_fused_word_splits(n_words, n_cols, expected):
    assert fused_block.fused_word_splits(n_words, n_cols) == expected
