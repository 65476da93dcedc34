"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``; without them each one
skips (the decision is made inside the fixture, never at import).  Run on
the GPU machine with ``python -m pytest --noconftest
tests/test_torch_cuda.py -q``: the suite's conftest imports JAX, which the
port's machine need not have, and nothing here uses its fixtures.
"""

import json
import os

import numpy as np
import pytest
import torch

from consensus_clustering_tpu_torch import rng
from consensus_clustering_tpu_torch.ops import (
    _build,
    fused_block,
    hist,
    kmeanspp,
    lloyd,
    popcount,
)
from consensus_clustering_tpu_torch.ops.analysis import consensus_matrix
from consensus_clustering_tpu_torch.ops.bitpack import (
    pack_cosample_planes,
    pack_label_planes,
    popcount_accumulate,
)

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


def _count_tiles(cuda, rows, cols, kind):
    g = torch.Generator(device=cuda).manual_seed(rows + cols)
    iij = torch.randint(1, 501, (rows, cols), generator=g, device=cuda)
    u = torch.rand((rows, cols), generator=g, device=cuda)
    if kind == "bimodal":  # most pairs never or always co-clustered
        mij = torch.where(u < 0.8, 0, torch.where(
            u < 0.95, iij, torch.floor(iij * torch.rand(
                (rows, cols), generator=g, device=cuda))))
    else:
        mij = torch.floor(iij * u)
        iij[:, :40], mij[:, :40] = 40, torch.arange(40, device=cuda)
    return mij.int(), iij.int()


@pytest.mark.parametrize("rows,cols,off,n_valid,kind",
                         [(300, 300, 0, 300, "uniform"),
                          (129, 517, 200, 500, "uniform"),  # scalar loads
                          (256, 1024, 768, 1000, "bimodal")])
def test_hist_count_entry_equals_plain(cuda, rows, cols, off, n_valid, kind):
    mij, iij = _count_tiles(cuda, rows, cols, kind)
    got = hist.consensus_hist_from_counts(
        mij, iij, n_valid, off, 20, torch.zeros(20, dtype=torch.int64,
                                                device=cuda))
    ref = hist.consensus_hist_from_counts_plain(
        mij, iij, n_valid, off, 20, torch.zeros(20, dtype=torch.int64,
                                                device=cuda))
    assert torch.equal(got, ref) and int(ref.sum()) > 0


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


_RAW_SHAPES = [(4, 1000, 50, 3, 20, 20),    # lanes share a staged tile
               (5, 1237, 37, 2, 13, 9),     # ragged n, k < k_max
               (2, 1000, 300, 2, 40, 33)]   # wide: several slot groups


def _raw_lanes(cuda, b, n, d, n_init, k_max):
    g = torch.Generator(device=cuda).manual_seed(b * n + d)
    x = torch.randn((b, n, d), generator=g, device=cuda) * 3
    src = torch.arange(b, device=cuda,
                       dtype=torch.int32).repeat_interleave(n_init)
    pick = torch.randint(0, n, (b * n_init, k_max), generator=g, device=cuda)
    return x, src, x[src.long()[:, None], pick]


@pytest.mark.parametrize("b,n,d,n_init,k_max,k", _RAW_SHAPES)
def test_lloyd_kernel_equals_ordered_plain_on_raw_data(cuda, b, n, d, n_init,
                                                       k_max, k):
    x, src, cen = _raw_lanes(cuda, b, n, d, n_init, k_max)
    got = lloyd.lloyd_step_kernel(x, src, cen, k)
    ref = lloyd.lloyd_step_ordered_plain(x, src, cen, k)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


@pytest.mark.parametrize("b,n,d,n_init,k_max,k", _RAW_SHAPES)
def test_assign_kernel_equals_plain_on_raw_data(cuda, b, n, d, n_init, k_max,
                                                k):
    x, src, cen = _raw_lanes(cuda, b, n, d, n_init, k_max)
    got = fused_block.assign_labels_kernel(x, src, cen, k)
    ref = fused_block.assign_labels_plain(x, src, cen, k)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_scalar_layout_kernels_equal_plain_on_raw_data(cuda):
    # d 445, k_max 2: the slots fit only unpadded, read one at a time.
    b, n, d, n_init, k_max, k = 2, 300, 445, 2, 2, 2
    for extra in (2 * lloyd.TILE_ROWS, 0):  # B2's layout, the assignment's
        assert not fused_block.tile_layout(d, k_max, extra)[3]
    x, src, cen = _raw_lanes(cuda, b, n, d, n_init, k_max)
    got = lloyd.lloyd_step_kernel(x, src, cen, k)
    ref = lloyd.lloyd_step_ordered_plain(x, src, cen, k)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    lab, dmin = fused_block.assign_labels_kernel(x, src, cen, k)
    lab_p, dmin_p = fused_block.assign_labels_plain(x, src, cen, k)
    assert torch.equal(lab, lab_p) and torch.equal(dmin, dmin_p)


# A small KMeans fit on the card, pinned from the kernels before the
# redesign of B2 and the final assignment: the same launches and labels.
_PINNED_FIT_LABELS = (
    "1320221101030001031223101311000203103002222232110311101330223122131032"
    "0002113100310212013100221100122003220122220122222130031203311332302000"
    "3010213333222230332121302303020301032303133201132322130021033121300201"
    "2333023101030003331330030323300333212100231112312330031212110310030310"
    "22210121311332202223"
)


def test_kmeans_fit_equals_pinned_result(cuda):
    from consensus_clustering_tpu_torch import make_blobs
    from consensus_clustering_tpu_torch.models.kmeans import KMeans

    x, _ = make_blobs(n_samples=300, n_features=6, centers=4,
                      cluster_std=2.5, random_state=11)
    x = torch.tensor(x, dtype=torch.float32, device=cuda)
    keys = torch.tensor([[0, 1], [0, 2]], device=cuda)
    lloyd.launch_count = 0
    fused_block.assign_launch_count = 0
    kmeanspp.launch_count = 0
    labels, cen = KMeans(n_init=2).fit(keys, torch.stack([x[:150], x[150:]]),
                                       4, 6)
    assert (lloyd.launch_count, fused_block.assign_launch_count) == (6, 1)
    # One prologue, then one draw a seeding step (j = 1, 2, 3).
    assert kmeanspp.launch_count == 1 + 3
    assert "".join(map(str, labels.flatten().tolist())) == _PINNED_FIT_LABELS
    assert float(cen.double().sum()) == -42.99229456484318


# k-means++ draws at the benchmark's step shapes: est100k's lane batch (16
# resamples x 3 restarts of 80,000 rows), blobs20k's (16,000 rows), and a
# ragged n.  T = 5 is 2 + ceil(ln k_max) for k_max 20 and 10.
_DRAW_SHAPES = [(16, 3, 80_000, 5), (16, 3, 16_000, 5), (3, 2, 1_001, 5)]


def _draw_d2(cuda, b, r, n, kind):
    g = torch.Generator(device=cuda).manual_seed(n + b)
    d2 = torch.rand((b, r, n), generator=g, device=cuda) * 50
    if kind == "zeros":  # points that are centres already
        d2[torch.rand((b, r, n), generator=g, device=cuda) < 0.3] = 0.0
    elif kind == "zero_lane":  # every logit -inf: index 0
        d2[1, 0] = 0.0
    elif kind == "tiny":  # below the 1e-30 clamp, and denormals
        d2[..., ::3] = 1e-33
        d2[..., 1::5] = 1e-44
    elif kind == "huge":  # near float32's max
        d2[..., ::4] = 3.4e38
    return d2


@pytest.mark.parametrize("kind", ["uniform", "zeros", "zero_lane", "tiny",
                                  "huge"])
@pytest.mark.parametrize("b,r,n,trials", _DRAW_SHAPES)
def test_kmeanspp_draw_kernel_equals_plain(cuda, b, r, n, trials, kind):
    d2 = _draw_d2(cuda, b, r, n, kind)
    keys = rng.split(rng.split(rng.prng_key(n, cuda), b), r)
    key_rest, _ = kmeanspp.seed_keys_plain(keys, n)
    for j in (1, 2, 19):
        got = kmeanspp.draw_candidates_kernel(key_rest, j, d2, trials)
        ref = kmeanspp.draw_candidates_plain(key_rest, j, d2, trials)
        assert torch.equal(got, ref), j
    if kind == "zero_lane":
        assert torch.equal(got[1, 0], torch.zeros_like(got[1, 0]))


@pytest.mark.parametrize("lanes,n", [(48, 80_000), (1, 1), (1000, 16_000),
                                     (7, 2**31 - 1)])
def test_kmeanspp_prologue_equals_split_and_randint(cuda, lanes, n):
    keys = rng.split(rng.prng_key(lanes, cuda), lanes).reshape(-1, 1, 2)
    got = kmeanspp.seed_keys_kernel(keys, n)
    ref = kmeanspp.seed_keys_plain(keys, n)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


_LOGF_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
__global__ void logf_kernel(const float* x, float* y, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = logf(x[i]);
}
extern "C" int cc_logf(const float* x, float* y, long long n, void* s) {
  logf_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)s>>>(
      x, y, n);
  return (int)cudaGetLastError();
}
"""


def test_logf_equals_torch_log_on_every_positive_float(cuda, tmp_path):
    """The draw kernel's ``logf``, built as the port's kernels are, rounds
    as ``torch.log`` does on the card, over every positive finite float32
    (bit patterns 1 .. 0x7F7FFFFF): the draws rest on it."""
    import ctypes
    import subprocess

    src, lib_path = tmp_path / "logf.cu", tmp_path / "liblogf.so"
    src.write_text(_LOGF_SOURCE)
    subprocess.run(_build.nvcc_command(_build.find_nvcc(), str(src),
                                       str(lib_path)), check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.cc_logf.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong,
                                                    ctypes.c_void_p]
    lib.cc_logf.restype = ctypes.c_int
    chunk, top = 2**27, 0x7F7FFFFF
    stream = torch.cuda.current_stream().cuda_stream
    for lo in range(1, top + 1, chunk):
        bits = torch.arange(lo, min(lo + chunk, top + 1), dtype=torch.int32,
                            device=cuda)
        x = bits.view(torch.float32)
        y = torch.empty_like(x)
        assert lib.cc_logf(x.data_ptr(), y.data_ptr(), x.numel(),
                           stream) == 0
        ref = torch.log(x)
        same = y.view(torch.int32) == ref.view(torch.int32)
        assert bool(same.all()), bits[~same][:8].tolist()


def test_small_fit_matches_cpu(cuda):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs

    x, _ = make_blobs(n_samples=200, n_features=6, centers=3,
                      cluster_std=1.5, random_state=2)
    fits = [
        ConsensusClustering(K_range=range(2, 5), n_iterations=20,
                            random_state=3, device=dev, plot_cdf=False).fit(x)
        for dev in ("cuda", "cpu")
    ]
    np.testing.assert_array_equal(fits[0].cdf_at_K_data[2]["iij"],
                                  fits[1].cdf_at_K_data[2]["iij"])
    for k in range(2, 5):
        assert abs(fits[0].cdf_at_K_data[k]["pac_area"]
                   - fits[1].cdf_at_K_data[k]["pac_area"]) <= 0.02


@pytest.mark.parametrize("l_words,r,c,col0", [(400, 256, 5120, 1024),
                                              (13, 264, 300, 0),
                                              (20, 64, 1000, 936)])
def test_popcount_kernel_equals_plain(cuda, l_words, r, c, col0):
    g = torch.Generator(device=cuda).manual_seed(l_words + r)
    cols = torch.randint(-2**31, 2**31 - 1, (l_words, c), generator=g,
                         device=cuda, dtype=torch.int32)
    rows = cols[:, col0:col0 + r] if col0 + r <= c else torch.randint(
        -2**31, 2**31 - 1, (l_words, r), generator=g, device=cuda,
        dtype=torch.int32)
    got = popcount.packed_coassoc_counts(rows, cols)
    assert torch.equal(got, popcount_accumulate(rows, cols))


@pytest.mark.parametrize("l_words,c,n,block", [(400, 5120, 5000, 3),
                                               (20, 5120, 5000, 2),
                                               (8, 384, 300, 1)])
def test_popcount_kernel_at_the_sentinel_spot_rows(cuda, l_words, c, n,
                                                   block):
    """The packed sentinel's shape: its 16 sampled columns, gathered,
    against every column of the same words."""
    from consensus_clustering_tpu_torch.resilience import integrity

    g = torch.Generator(device=cuda).manual_seed(l_words + block)
    cols = torch.randint(-2**31, 2**31 - 1, (l_words, c), generator=g,
                         device=cuda, dtype=torch.int32)
    idx = torch.as_tensor(integrity.sentinel_sample_rows(n, block),
                          dtype=torch.int64, device=cuda)
    got = popcount.packed_coassoc_counts(cols[:, idx], cols)
    assert got.shape == (16, c)
    assert torch.equal(got, popcount_accumulate(cols[:, idx], cols))


@pytest.mark.parametrize("n_cols,d,lanes,k_max,k,n_words,row0",
                         [(5120, 50, 100, 20, 7, 4, 0),
                          (300, 7, 13, 5, 4, 2, 3),
                          # lanes that do not fill a word, and straddle two
                          (640, 24, 45, 9, 5, 2, 17),
                          # slots that fit only unpadded: the scalar layout
                          (300, 445, 13, 2, 2, 1, 5)])
def test_fused_kernel_equals_plain_and_unfused(cuda, n_cols, d, lanes, k_max,
                                               k, n_words, row0):
    g = torch.Generator(device=cuda).manual_seed(n_cols)
    x = torch.randn((n_cols, d), generator=g, device=cuda) * 3
    idx = torch.stack([torch.randperm(n_cols, generator=g, device=cuda)
                       [:int(0.8 * n_cols)] for _ in range(lanes)])
    cop = pack_cosample_planes(idx, n_cols, n_words=n_words, row0=row0)
    for xs in (torch.round(x * 8) / 8, x):
        cents = xs[torch.randint(0, n_cols, (lanes, k_max), generator=g,
                                 device=cuda)]
        got = fused_block.fused_assign_pack(xs, cents, k, cop, row0,
                                            n_words=n_words)
        assert torch.equal(got, fused_block.fused_planes_plain(
            xs, cents, k, cop, row0, n_words))
        labels, _ = fused_block.assign_labels(
            xs[None], torch.zeros(lanes, dtype=torch.int64, device=cuda),
            cents, k)
        unfused = pack_label_planes(torch.gather(labels, 1, idx), idx, k_max,
                                    n_cols, n_words=n_words, row0=row0)
        assert torch.equal(got, unfused)


def test_assign_kernel_equals_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((4, 1000, 50), generator=g, device=cuda)
    src = torch.arange(4, device=cuda).repeat_interleave(3)
    cents = x[src[:, None], torch.randint(0, 1000, (12, 20), generator=g,
                                          device=cuda)]
    got = fused_block.assign_labels(x, src, cents, 17)
    ref = fused_block.assign_labels_plain(x, src, cents, 17)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_streamed_packed_fit_equals_monolithic_on_the_card(cuda):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs

    x, _ = make_blobs(n_samples=200, n_features=6, centers=3,
                      cluster_std=1.5, random_state=2)
    kwargs = dict(K_range=range(2, 5), n_iterations=20, random_state=3,
                  device="cuda")
    mono = ConsensusClustering(**kwargs, plot_cdf=False).fit(x)
    stream = ConsensusClustering(**kwargs, stream_h_block=6,
                                 accum_repr="packed", plot_cdf=False).fit(x)
    assert stream.metrics_["timing"] == {
        "packed_kernel": "cuda", "fuse_block": "fused",
        "fused_kernel": "cuda"}
    assert all(n > 0 for n in stream.metrics_["kernel_launches"].values())
    for k in range(2, 5):
        assert stream.cdf_at_K_data[k]["pac_area"] == (
            mono.cdf_at_K_data[k]["pac_area"])
        for name in ("mij", "iij", "hist", "cdf"):
            np.testing.assert_array_equal(stream.cdf_at_K_data[k][name],
                                          mono.cdf_at_K_data[k][name])


def _stream_state_on_card(cuda, accum_repr, n_blocks):
    """The streaming engine's state after ``n_blocks`` blocks of 16 at the
    stream_small size (N=300, K=2..6), on the card."""
    from consensus_clustering_tpu_torch import make_blobs, rng
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.parallel.streaming import (
        StreamingSweep,
    )

    x, _ = make_blobs(n_samples=300, n_features=8, centers=4,
                      cluster_std=2.0, random_state=5)
    config = SweepConfig(n_samples=300, n_features=8, k_values=(2, 3, 4, 5, 6),
                         n_iterations=60, store_matrices=False,
                         stream_h_block=16, accum_repr=accum_repr)
    engine = StreamingSweep(KMeans(n_init=2), config, device=cuda)
    engine.warmup()
    xd = torch.as_tensor(x, dtype=torch.float32, device=cuda)
    key = rng.prng_key(7, cuda)
    state = engine.init_state()
    for b in range(n_blocks):
        engine.step(state, xd, key, b * 16, 60)
    return engine, state


@pytest.mark.parametrize("accum_repr", ["dense", "packed"])
def test_sentinels_on_the_card_equal_their_cpu_run(cuda, accum_repr):
    from consensus_clustering_tpu_torch.resilience import integrity

    engine, state = _stream_state_on_card(cuda, accum_repr, 3)
    # The sentinel reads the state as the frames hold it (cropped to N).
    flat = {k: v.contiguous() for k, v in engine.gather_state(state).items()}
    name = "planes" if accum_repr == "packed" else "mij"
    for flips in (0, 2):
        if flips:
            integrity.flip_array_bits(flat[name], flips, seed=5)
        before = popcount.launch_count
        got = engine._integrity_stats(flat, 48, 2)
        launched = popcount.launch_count - before
        cpu = engine._integrity_stats({k: v.cpu() for k, v in flat.items()},
                                      48, 2)
        assert got == cpu
        assert bool(any(got.values())) == bool(flips)
        # The packed sentinel's spot rows go through B3: one launch for
        # Iij and one for each K.
        assert launched == (6 if accum_repr == "packed" else 0)


def test_kill_and_resume_on_the_card_equals_uninterrupted(cuda, tmp_path):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    from consensus_clustering_tpu_torch import make_blobs
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.parallel.streaming import (
        StreamingSweep,
    )
    from consensus_clustering_tpu_torch.resilience import (
        InjectedFault,
        StreamCheckpointer,
        faults,
    )

    x, _ = make_blobs(n_samples=300, n_features=8, centers=4,
                      cluster_std=2.0, random_state=5)
    config = SweepConfig(n_samples=300, n_features=8, k_values=(2, 3, 4, 5, 6),
                         n_iterations=60, store_matrices=True,
                         stream_h_block=16, accum_repr="packed")
    engine = StreamingSweep(KMeans(n_init=2), config, device=cuda)
    ref = engine.run(x, 7, 60)
    ck = StreamCheckpointer(str(tmp_path))
    faults.configure("block_start=2")
    try:
        with pytest.raises(InjectedFault):
            engine.run(x, 7, 60, checkpointer=ck, integrity_check_every=1)
    finally:
        faults.clear()
    got = engine.run(x, 7, 60, checkpointer=ck, integrity_check_every=1)
    ck.close()
    assert got["streaming"]["resumed_from_block"] == 2
    assert got["streaming"]["integrity_checks"] == 2
    for name in ("hist", "cdf", "pac_area", "mij", "iij", "cij"):
        np.testing.assert_array_equal(got[name], ref[name])


def _fits_on_both(x, **kwargs):
    from consensus_clustering_tpu_torch import ConsensusClustering
    from consensus_clustering_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )

    fits, launches = {}, {}
    for dev in ("cuda", "cpu"):
        reset_launch_counts()
        fits[dev] = ConsensusClustering(device=dev, store_matrices=True,
                                        progress=False, **kwargs,
                                        plot_cdf=False).fit(x)
        launches[dev] = launch_counts()
    return fits, launches


def _assert_card_matches_cpu(fits, ks, exact_mij=False):
    gpu, cpu = fits["cuda"].cdf_at_K_data, fits["cpu"].cdf_at_K_data
    np.testing.assert_array_equal(gpu[ks[0]]["iij"], cpu[ks[0]]["iij"])
    for k in ks:
        if exact_mij:
            np.testing.assert_array_equal(gpu[k]["mij"], cpu[k]["mij"])
        assert abs(gpu[k]["pac_area"] - cpu[k]["pac_area"]) <= 0.02


def test_gmm_on_the_card_matches_cpu(cuda):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    from consensus_clustering_tpu_torch import GaussianMixture, make_blobs

    x, _ = make_blobs(n_samples=200, n_features=4, centers=3,
                      cluster_std=1.5, random_state=2)
    fits, launches = _fits_on_both(
        x.astype(np.float32), clusterer=GaussianMixture(n_init=2),
        clusterer_options={}, K_range=(2, 3, 4), n_iterations=20,
        random_state=3)
    _assert_card_matches_cpu(fits, (2, 3, 4))
    assert launches["cuda"]["lloyd"] > 0 and launches["cuda"]["assign"] > 0
    assert launches["cuda"]["hist"] == 3
    assert launches["cpu"] == dict.fromkeys(launches["cpu"], 0)


def test_gmm_nan_lane_on_the_card(cuda):
    from consensus_clustering_tpu_torch.models.gmm import GaussianMixture

    rs = np.random.default_rng(0)
    centres = np.repeat(rs.normal(size=(3, 4)).astype(np.float32) * 5, 10, 0)
    x = np.stack([centres, centres + rs.normal(size=(30, 4)).astype(
        np.float32)])
    labels0 = torch.tensor(np.tile(np.repeat(np.arange(3), 10), (2, 1)))
    gmm = GaussianMixture(reg_covar=0.0)
    got = gmm.em(torch.tensor(x, device=cuda), labels0.to(cuda), 3, 4)
    ref = gmm.em(torch.tensor(x), labels0, 3, 4)
    assert torch.isnan(got[1][0]) and torch.isfinite(got[1][1])
    np.testing.assert_array_equal(got[0].cpu().numpy(), ref[0].numpy())


def test_agglomerative_on_the_card_matches_cpu(cuda):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    from consensus_clustering_tpu_torch import (
        AgglomerativeClustering,
        load_corr,
    )
    from consensus_clustering_tpu_torch.models.agglomerative import (
        agglomerate,
    )

    fits, launches = _fits_on_both(
        load_corr(transform=True),
        clusterer=AgglomerativeClustering("average"), K_range=(2, 3, 4, 5),
        n_iterations=40, random_state=23)
    _assert_card_matches_cpu(fits, (2, 3, 4, 5))
    assert launches["cuda"]["hist"] == 4
    # The same tie-heavy distances: labels identical on both devices (the
    # argmin takes the lowest flat index on the card too).
    rs = np.random.default_rng(3)
    m = rs.integers(0, 6, size=(4, 40, 40))
    m = np.minimum(m, m.transpose(0, 2, 1))
    dist = torch.tensor(1.0 - m / 5.0, dtype=torch.float32)
    for linkage in ("single", "complete", "average", "ward"):
        for k in (2, 7):
            got = agglomerate(dist.to(cuda), k, linkage).cpu()
            assert torch.equal(got, agglomerate(dist, k, linkage))


class _HostLloyd:
    """A numpy host clusterer, so that the test needs no sklearn."""

    def fit_predict_host(self, seed, x, k):
        x = np.asarray(x, np.float64)
        centres = x[np.random.RandomState(seed).choice(len(x), k, False)]
        for _ in range(100):
            labels = ((x[:, None] - centres[None]) ** 2).sum(-1).argmin(1)
            new = np.stack([x[labels == j].mean(0) if (labels == j).any()
                            else centres[j] for j in range(k)])
            if np.array_equal(new, centres):
                break
            centres = new
        return labels.astype(np.int32)


def test_host_backend_on_the_card_matches_cpu(cuda):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    from consensus_clustering_tpu_torch import load_corr

    fits, launches = _fits_on_both(
        load_corr(transform=True), clusterer=_HostLloyd(),
        K_range=(2, 3, 4), n_iterations=20, random_state=23)
    _assert_card_matches_cpu(fits, (2, 3, 4), exact_mij=True)
    assert launches["cuda"]["hist"] == 3
    assert launches["cuda"]["lloyd"] == 0  # labels on the host


def test_spectral_on_the_card(cuda):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    """The three blobs are disconnected in the affinity graph, so the top
    eigenvalue has multiplicity 3.  At K=3 the embedding spans that whole
    eigenspace and the labels are determined: Mij equal to the CPU's.  At
    K=2 it takes two columns of an arbitrary basis of it, which rounding
    picks (one ulp of input moves PAC there on the CPU alone,
    ``tests/test_torch_models.py::test_spectral_rounding_picks_the_basis_
    below_the_component_count``), so K=2 is held to nothing across
    devices."""
    from consensus_clustering_tpu_torch import SpectralClustering, make_blobs

    x, _ = make_blobs(n_samples=300, n_features=5, centers=3,
                      cluster_std=1.0, random_state=1)
    fits, launches = _fits_on_both(
        x.astype(np.float32),
        clusterer=SpectralClustering(gamma=0.2, solver="lobpcg"),
        K_range=(2, 3, 4), n_iterations=10, random_state=5)
    _assert_card_matches_cpu(fits, (3, 4))
    np.testing.assert_array_equal(fits["cuda"].cdf_at_K_data[3]["mij"],
                                  fits["cpu"].cdf_at_K_data[3]["mij"])
    assert np.isfinite(fits["cuda"].cdf_at_K_data[2]["pac_area"])
    assert launches["cuda"]["lloyd"] > 0 and launches["cuda"]["assign"] > 0


def test_clusterers_group_invariantly_on_the_card(cuda):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    """Labels are a per-resample function on the card too: cluster_batch
    groups give the counts of one batch (the spectral eigensolver once
    did not: a batched QR of one lane rounds apart from a larger batch)."""
    from consensus_clustering_tpu_torch import (
        AgglomerativeClustering,
        ConsensusClustering,
        GaussianMixture,
        SpectralClustering,
        make_blobs,
    )

    x, _ = make_blobs(n_samples=500, n_features=30, centers=6,
                      cluster_std=3.0, random_state=0)
    x = x.astype(np.float32)
    for clusterer in (GaussianMixture(n_init=2),
                      AgglomerativeClustering("average"),
                      SpectralClustering(gamma=0.02, solver="lobpcg")):
        fits = [ConsensusClustering(
            clusterer=clusterer, clusterer_options={}, K_range=(2, 4, 6),
            n_iterations=13, random_state=23, store_matrices=True,
            cluster_batch=batch, device=cuda,
            plot_cdf=False).fit(x) for batch in (None, 4)]
        for k in (2, 4, 6):
            np.testing.assert_array_equal(fits[0].cdf_at_K_data[k]["mij"],
                                          fits[1].cdf_at_K_data[k]["mij"])


@pytest.mark.parametrize("rows,col0", [(256, 49_920), (2048, 0)])
def test_popcount_kernel_at_100k_columns(cuda, rows, col0):
    """B3 at the estimator refinement's width: a row tile of K=8's 32
    cluster-plane words against all 100,000 columns."""
    g = torch.Generator(device=cuda).manual_seed(rows)
    cols = torch.randint(-2**31, 2**31 - 1, (32, 100_000), generator=g,
                         device=cuda, dtype=torch.int32)
    tile = cols[:, col0:col0 + rows]
    got = popcount.packed_coassoc_counts_kernel(tile, cols)
    for c in range(0, 100_000, 10_000):
        assert torch.equal(got[:, c:c + 10_000],
                           popcount_accumulate(tile, cols[:, c:c + 10_000]))


@pytest.mark.parametrize("off", [0, 50_000, 99_000])
def test_hist_count_entry_at_100k_columns(cuda, off):
    """B1's count entry on a (1000, 100,000) int32 tile at a row offset in
    the triangle: equal to the plain version, every pair counted once."""
    n, rows = 100_000, 1000
    mij, iij = _count_tiles(cuda, rows, n, "bimodal")
    got = torch.zeros(20, dtype=torch.int64, device=cuda)
    ref = torch.zeros(20, dtype=torch.int64, device=cuda)
    hist.consensus_hist_from_counts_kernel(mij, iij, n, off, 20, got)
    hist.consensus_hist_from_counts_plain(mij, iij, n, off, 20, ref)
    assert torch.equal(got, ref)
    assert int(got.sum()) == sum(max(0, n - 1 - (off + r))
                                 for r in range(rows))


def test_estimate_on_the_card(cuda):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    """A small estimate on the card: every sampled pair's counts equal the
    card's dense Mij/Iij there, on both pair paths; the refinement's tiled
    curve equals the dense curve of its K; B2, the assignment, B3 and B1
    launched."""
    from consensus_clustering_tpu_torch import make_blobs
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.estimator.engine import (
        PairConsensusEngine,
    )
    from consensus_clustering_tpu_torch.estimator.tiled import (
        exact_curves_for_k,
    )
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.ops import launch_counts
    from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

    x, _ = make_blobs(n_samples=400, n_features=6, centers=4,
                      cluster_std=1.0, random_state=3)
    x = x.astype(np.float32)
    config = SweepConfig(n_samples=400, n_features=6, k_values=(2, 4, 6),
                         n_iterations=40, store_matrices=True)
    dense = run_sweep(KMeans(n_init=2), config, x, 11, device=cuda)
    before = launch_counts()
    for path in ("dense", "packed"):
        est_config = SweepConfig(
            n_samples=400, n_features=6, k_values=(2, 4, 6),
            n_iterations=40, store_matrices=False, stream_h_block=16,
            accum_repr=path)
        out = PairConsensusEngine(KMeans(n_init=2), est_config,
                                  n_pairs=5000, device=cuda).run(
            x, 11, 40, return_state=True)
        ps = out["pair_state"]
        pi, pj = ps["pair_i"], ps["pair_j"]
        np.testing.assert_array_equal(ps["iij"], dense["iij"][pi, pj])
        np.testing.assert_array_equal(
            ps["mij"], np.stack([m[pi, pj] for m in dense["mij"]]))
    exact = exact_curves_for_k(KMeans(n_init=2), est_config, x, 11, 4,
                               tile_rows=96, device=cuda)
    np.testing.assert_array_equal(exact["cdf"], dense["cdf"][1])
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    assert all(launched[k] > 0 for k in ("lloyd", "assign", "popcount",
                                         "hist")), launched


def test_service_answers_a_job_on_the_card_and_fuses_bit_for_bit(cuda, tmp_path):
    """A small job over HTTP through the port's service on the card (its
    default executor), then two same-bucket jobs through ``run_fused``
    equal to their solo runs on the card."""
    import json
    import time
    import urllib.request

    from consensus_clustering_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from consensus_clustering_tpu_torch.serve import (
        ConsensusService,
        JobSpec,
    )

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, .3, (150, 5)),
                        rng.normal(3, .3, (150, 5))]).astype(np.float32)
    svc = ConsensusService(store_dir=str(tmp_path), port=0).start()
    try:
        base = f"http://127.0.0.1:{svc.port}"
        body = {"data": x.tolist(), "config": {
            "k": [2, 3, 4], "iterations": 32, "stream_h_block": 16,
            "accum_repr": "packed"}}
        reset_launch_counts()
        req = urllib.request.Request(base + "/jobs", json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        job = json.loads(urllib.request.urlopen(req, timeout=60).read())
        for _ in range(1200):
            rec = json.loads(urllib.request.urlopen(
                f"{base}/jobs/{job['job_id']}", timeout=60).read())
            if rec["status"] not in ("queued", "running"):
                break
            time.sleep(0.05)
        assert rec["status"] == "done", rec.get("error")
        result = rec["result"]
        assert result["backend"] == "torch-cuda"
        assert result["memory"]["measurement_source"] == "device"
        assert result["memory"]["measured_bytes"] > 0
        launches = launch_counts()
        assert all(launches[k] > 0 for k in (
            "lloyd", "assign", "popcount", "fused_block", "hist")), launches
        executor = svc.executor
        specs = [JobSpec(k_values=(2, 3, 4), n_iterations=32, seed=s,
                         stream_h_block=16, accum_repr="packed")
                 for s in (101, 102)]
        xs = [x, x[::-1].copy()]
        solo = [executor.run(s, xx) for s, xx in zip(specs, xs)]
        fused = executor.run_fused(specs, xs)
        for f, s in zip(fused, solo):
            assert f["result_fingerprint"] == s["result_fingerprint"]
            assert f["pac_area"] == s["pac_area"]
    finally:
        svc.stop()


@pytest.mark.parametrize("shape,accum_repr,stream", [
    ((2, 2, 2), "dense", None), ((1, 2, 2), "packed", 16),
    ((1, 4, 1), "packed", None)])
def test_virtual_mesh_on_the_card_equals_one_device(cuda, shape, accum_repr,  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
                                                    stream):
    """The card repeated as a (k, h, n) mesh: every shard's lanes, row
    blocks and merges, with B1 at row offsets and B3/B4 on column-sharded
    planes, equal to one device bit for bit."""
    from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs
    from consensus_clustering_tpu_torch.parallel import resample_mesh

    x, _ = make_blobs(n_samples=301, n_features=8, centers=4,
                      cluster_std=2.0, random_state=5)
    kw = dict(K_range=(2, 3, 4, 5), n_iterations=45, random_state=7,
              cluster_batch=8, accum_repr=accum_repr, stream_h_block=stream,
              store_matrices=True)
    one = ConsensusClustering(device=cuda, **kw, plot_cdf=False).fit(x)
    k, h, n = shape
    mesh = resample_mesh([torch.device("cuda", 0)] * (k * h * n),
                         row_shards=n, k_shards=k)
    got = ConsensusClustering(mesh=mesh, k_interleave=k > 1, **kw,
                              plot_cdf=False).fit(x)
    for kk in kw["K_range"]:
        for name in ("pac_area", "hist", "mij", "iij", "cij"):
            np.testing.assert_array_equal(got.cdf_at_K_data[kk][name],
                                          one.cdf_at_K_data[kk][name])
    assert got.metrics_["kernel_launches"]["hist" if stream is None
                                           else "popcount"] > 0


def test_plotting_fit_on_the_card(cuda, tmp_path, monkeypatch):  # jaxlint: disable=JL018 -- GPU only; skipped on the CPU
    """``plot_cdf=True`` on the card draws the fit's curves once, after
    the kernels ran, and ``run --plot-dir`` labels the heatmap there."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs
    from consensus_clustering_tpu_torch.cli import main
    from consensus_clustering_tpu_torch.ops import reset_launch_counts

    shown = []
    monkeypatch.setattr(plt, "show", lambda *a, **k: shown.append(1))
    plt.close("all")
    x, _ = make_blobs(n_samples=301, n_features=8, centers=4,
                      cluster_std=2.0, random_state=5)
    reset_launch_counts()
    cc = ConsensusClustering(K_range=(2, 3, 4, 5), n_iterations=20,
                             random_state=7, device=cuda,
                             plot_cdf=True).fit(x)
    assert cc.metrics_["kernel_launches"]["hist"] == 4
    (num,) = plt.get_fignums()
    assert [list(line.get_ydata()) for line in plt.figure(num).axes[0]
            .get_lines()] == [[0.0] + list(cc.cdf_at_K_data[k]["cdf"])
                              for k in (2, 3, 4, 5)]
    assert shown == [1]
    plt.close("all")
    main(["run", "--dataset", "blobs", "--n-samples", "301", "--n-features",
          "8", "--k", "2:5", "--iterations", "20", "--seed", "7",
          "--out", str(tmp_path / "run.json"),
          "--plot-dir", str(tmp_path / "plots")])
    best = json.loads((tmp_path / "run.json").read_text())["best_k"]
    assert sorted(os.listdir(tmp_path / "plots")) == [
        "cdf.png", f"consensus_matrix_K{best}.png", "delta_k.png"]
