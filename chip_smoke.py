#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``consensus_clustering_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:  ``python3 chip_smoke.py``.  Phases, each printing JSON lines:

1. env      — the card's name and power limit (nvidia-smi), torch/CUDA
              versions, and the seconds to build both kernels from csrc/
              (one nvcc per source, started together);
2. kernels  — each kernel against its plain PyTorch version on the card, at
              the shapes the main path gives it and at a ragged shape, with
              kernel, plain and bound times;
3. headline — ``ConsensusClustering.fit`` on make_blobs N=5000 d=50, H=500,
              K=2..20, KMeans(n_init=3), cluster_batch=16, chunk_size=4,
              with the kernels' launch counts set to 0 just before: PAC
              finite, in [0, 1], falling to its minimum at the data's 8
              blobs;
4. small    — the same fit on a small input on the card and on the CPU
              (plain versions): Iij identical, PAC within 0.02 per K;
5. corr     — corr.csv, K=2..14, H=30, seed 23: PAC inside the golden
              bands of tests/fixtures/reference_goldens.json, iij.sum()
              equal to the golden.

Then a ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero without
that line; so does a machine without CUDA.  ``--phases env,kernels`` runs a
subset (the default is all of them).
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "kernels", "headline", "small", "corr")

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

FAILURES = []


def emit(obj):
    print(json.dumps(obj, default=float), flush=True)


def check(ok, what):
    if not ok:
        FAILURES.append(what)
        emit({"check_failed": what})
    return ok


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "nvidia-smi unavailable: " + out.stderr.strip()
    )


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` launches (warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# -- phase 1 -------------------------------------------------------------


def phase_env(torch):
    from consensus_clustering_tpu_torch.ops import _build

    line = smi_line()
    print(line, flush=True)
    t0 = time.perf_counter()
    reports = _build.build(["hist", "lloyd"])
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in text.splitlines() if "Used" in ln]
        for name, text in reports.items()
    }
    emit({"phase": "env", "nvidia_smi": line, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "build_seconds": build_s, "ptxas": ptxas})
    check_matmul_precision(torch)


def check_matmul_precision(torch):
    """The package pins full-f32 GEMMs at import; hold cuBLAS to it.

    A (512 x 512) @ (512 x 512) float32 product against float64: full f32
    keeps the relative error near 1e-7, TF32 (ten mantissa bits) near
    1e-3.  Also times the co-association GEMM of the headline (a
    (5000 x 80) one-hot Gram update) and reports its rate.
    """
    g = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((512, 512), generator=g, device="cuda")
    b = torch.randn((512, 512), generator=g, device="cuda")
    ref = a.double() @ b.double()
    rel = float(((a @ b).double() - ref).abs().max() / ref.abs().max())
    c = (torch.rand((80, 5000), generator=g, device="cuda") < 0.05).float()
    acc = torch.zeros((5000, 5000), device="cuda")
    ms = cuda_ms(torch, lambda: acc.addmm_(c.T, c), 10)
    emit({"phase": "env", "matmul_fp32_rel_err": rel,
          "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision(),
          "mij_gemm_ms": ms,
          "mij_gemm_tflops": 2 * 5000 * 5000 * 80 / (ms * 1e-3) / 1e12})
    check(rel < 1e-5, f"float32 matmul is not full precision: rel err {rel}")


# -- phase 2 -------------------------------------------------------------


def _cij_block(torch, n, seed):
    """A realistic (N, N) Cij: integer Mij <= Iij <= H=500, a band of exact
    bin-edge ratios (6/40 = 0.15 and the like), diagonal 1."""
    from consensus_clustering_tpu_torch.ops.analysis import consensus_matrix

    g = torch.Generator(device="cuda").manual_seed(seed)
    iij = torch.randint(1, 501, (n, n), generator=g, device="cuda")
    frac = torch.rand((n, n), generator=g, device="cuda")
    mij = torch.floor(iij * frac).to(torch.int32)
    edge_cols = slice(0, 40)
    iij[:, edge_cols] = 40
    mij[:, edge_cols] = torch.arange(40, device="cuda", dtype=torch.int32) % 41
    return consensus_matrix(mij, iij.to(torch.int32))


def phase_kernels(torch, results):
    from consensus_clustering_tpu_torch import rng
    from consensus_clustering_tpu_torch.data import make_blobs
    from consensus_clustering_tpu_torch.ops import hist, lloyd
    from consensus_clustering_tpu_torch.ops.resample import resample_indices

    n = 5000
    bins = 20
    cij = _cij_block(torch, n, seed=0)
    cases = [("full", cij, n, 0), ("ragged", cij[1234:2011], 4990, 1234)]
    worst = 0
    for name, block, n_valid, off in cases:
        got = hist.consensus_hist_counts_kernel(block, n_valid, off, bins)
        ref = hist.consensus_hist_counts_plain(block, n_valid, off, bins)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"hist kernel != plain ({name}): {got.tolist()} vs "
                        f"{ref.tolist()}")
        emit({"phase": "kernels", "kernel": "hist", "case": name,
              "shape": list(block.shape), "row_offset": off,
              "n_valid": n_valid, "counted": int(ref.sum()),
              "max_abs_err": err})
    k_ms = cuda_ms(torch, lambda: hist.consensus_hist_counts_kernel(
        cij, n, 0, bins), 20)
    p_ms = cuda_ms(torch, lambda: hist.consensus_hist_counts_plain(
        cij, n, 0, bins), 3)
    pairs = n * (n - 1) // 2
    b_ms, b_by = bound_ms(pairs * 4 + (bins + 1) * 4 + bins * 4,
                          pairs * (3 + math.ceil(math.log2(bins))))
    results["hist"] = {
        "name": "hist", "route": "cuda",
        "source": "consensus_clustering_tpu_torch/csrc/hist.cu",
        "replaces": "consensus_clustering_tpu/ops/pallas_hist.py:47",
        "launches": None, "max_abs_err": worst, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": [n, n],
    }
    emit({"phase": "kernels", "kernel": "hist", "timing_shape": [n, n],
          "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
          "bound_by": b_by, "library_ms": None,
          "library_note": "no single PyTorch call computes it: torch.histc "
                          "bins by scaled floor, not by edge membership, "
                          "and takes no triangle mask"})

    # Lloyd: the headline lane batch is 16 resamples x n_init 3 of
    # 4000 x 50 rows, k_max = 20 — drawn with the port's resample plan.
    x_np, y_np = make_blobs(n_samples=5000, n_features=50, centers=8,
                            cluster_std=3.0, random_state=0)
    x_all = torch.tensor(x_np, dtype=torch.float32, device="cuda")
    idx = resample_indices(rng.prng_key(23, "cuda"), 5000, 16, 4000)
    g = torch.Generator(device="cuda").manual_seed(1)

    def lanes_from(xs, n_init, k_max):
        bsz, rows = xs.shape[:2]
        src = torch.arange(bsz, device="cuda").repeat_interleave(n_init)
        pick = torch.stack([
            torch.randperm(rows, generator=g, device="cuda")[:k_max]
            for _ in range(bsz * n_init)
        ])
        return src, xs[src[:, None], pick]

    def compare(name, xs, src, cen, k, exact):
        sk, ck, fk = lloyd.lloyd_step_kernel(xs, src, cen, k)
        sp, cp, fp = lloyd.lloyd_step_plain(xs, src, cen, k)
        torch.cuda.synchronize()
        counts_eq = bool(torch.equal(ck, cp))
        far_eq = bool(torch.equal(fk, fp))
        err = float((sk - sp).abs().max())
        if exact:
            sums_ok = bool(torch.allclose(sk, sp, rtol=1e-6, atol=0.0))
        else:
            # rtol 1e-5 of the sum's own error scale, sum_i |x_i| per entry
            labels = lloyd.masked_sqdist(xs[src], cen, k).argmin(-1)
            onehot = torch.nn.functional.one_hot(labels, cen.shape[1])
            scale = onehot.float().transpose(1, 2) @ xs[src].abs()
            sums_ok = bool(((sk - sp).abs() <= 1e-5 * scale).all())
        check(counts_eq, f"lloyd counts != plain ({name})")
        check(sums_ok, f"lloyd sums != plain ({name}), max abs err {err}")
        if exact:
            check(far_eq, f"lloyd far_idx != plain ({name})")
        emit({"phase": "kernels", "kernel": "lloyd", "case": name,
              "x": list(xs.shape), "lanes": int(src.shape[0]),
              "k_max": int(cen.shape[1]), "k": k, "counts_equal": counts_eq,
              "far_idx_equal": far_eq,
              "far_idx_mismatches": int((fk != fp).sum()),
              "sums_max_abs_err": err,
              "sums_tolerance": "exact (rtol 1e-6)" if exact else
                                "|err| <= 1e-5 * sum|x| per entry"})
        return err

    xq = torch.round(x_all[idx] * 8) / 8  # multiples of 1/8: exact sums
    src, cen = lanes_from(xq, 3, 20)
    worst = compare("headline quantised", xq, src, cen, 20, True)
    # Raw blobs with 20 well-separated centres, centroids at the centre
    # means: no label sits near a tie, so labels must agree exactly.
    x20_np, y20_np = make_blobs(n_samples=5000, n_features=50, centers=20,
                                cluster_std=3.0, random_state=1)
    x20 = torch.tensor(x20_np, dtype=torch.float32, device="cuda")
    means = torch.stack([
        x20[torch.tensor(y20_np == c, device="cuda")].mean(0)
        for c in range(20)
    ])
    xr = x20[idx]
    src_r = torch.arange(16, device="cuda").repeat_interleave(3)
    cen_r = means.expand(48, 20, 50).contiguous()
    worst = max(worst, compare("headline raw blobs", xr, src_r, cen_r, 20,
                               False))
    xg = torch.round(torch.randn((5, 1237, 37), generator=g,
                                 device="cuda") * 24) / 8
    src_g, cen_g = lanes_from(xg, 2, 13)
    worst = max(worst, compare("ragged quantised", xg, src_g, cen_g, 9, True))

    k_ms = cuda_ms(torch, lambda: lloyd.lloyd_step_kernel(xr, src_r, cen_r,
                                                          20), 20)
    p_ms = cuda_ms(torch, lambda: lloyd.lloyd_step_plain(xr, src_r, cen_r,
                                                         20), 5)
    bsz, rows, d = xr.shape
    lanes, k_max = 48, 20
    n_bytes = 4 * (bsz * rows * d + lanes * k_max * d + lanes + lanes *
                   k_max * (d + 2))
    n_ops = lanes * rows * (2 * d * k_max + 3 * k_max + 2 * d + d)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    results["lloyd"] = {
        "name": "lloyd", "route": "cuda",
        "source": "consensus_clustering_tpu_torch/csrc/lloyd.cu",
        "replaces": "consensus_clustering_tpu/ops/pallas_lloyd.py:54",
        "launches": None, "max_abs_err": worst, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": [lanes, rows, d, k_max],
    }
    emit({"phase": "kernels", "kernel": "lloyd",
          "timing_shape": [lanes, rows, d, k_max], "kernel_ms": k_ms,
          "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
          "library_ms": None,
          "library_note": "no single PyTorch call computes a fused "
                          "assign + accumulate step"})


# -- phase 3 -------------------------------------------------------------


def phase_headline(torch, results):
    from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs
    from consensus_clustering_tpu_torch.ops import hist, lloyd

    x, _ = make_blobs(n_samples=5000, n_features=50, centers=8,
                      cluster_std=3.0, random_state=0)
    x = x.astype(np.float32)
    ks = list(range(2, 21))
    cc = ConsensusClustering(
        K_range=range(2, 21), n_iterations=500, random_state=23,
        store_matrices=False, chunk_size=4, cluster_batch=16,
    )
    hist.launch_count = 0
    lloyd.launch_count = 0
    t0 = time.perf_counter()
    cc.fit(x)
    wall = time.perf_counter() - t0
    launches = {"hist": hist.launch_count, "lloyd": lloyd.launch_count}
    pac = np.array([cc.cdf_at_K_data[k]["pac_area"] for k in ks])
    m = cc.metrics_
    emit({"phase": "headline", "nvidia_smi": smi_line(),
          "config": "make_blobs N=5000 d=50 centers=8 std=3, H=500, "
                    "K=2..20, KMeans(n_init=3), cluster_batch=16, "
                    "chunk_size=4, seed 23",
          "wall_seconds": wall, "run_seconds": m["run_seconds"],
          "resamples_per_second": m["resamples_per_second"],
          "peak_device_bytes": m["device_memory"]["peak_bytes_in_use"],
          "launches": launches, "pac": pac.round(6).tolist(),
          "best_k": cc.best_k_})
    for name in ("hist", "lloyd"):
        if name in results:
            results[name]["launches"] = launches[name]
    check(launches["hist"] == len(ks), f"hist launches {launches['hist']}")
    check(launches["lloyd"] > 0, "the Lloyd kernel never launched")
    check(m["kernel_launches"] == launches, "metrics_ launch counts differ")
    check(bool(np.isfinite(pac).all() and (pac >= 0).all()
               and (pac <= 1).all()), f"PAC not finite in [0, 1]: {pac}")
    # The data hold 8 blobs: the curve falls (within 0.02) from K=2 to its
    # elbow at K=8, which sits at the minimum (+0.02).  Past it PAC rises a
    # little, as splitting true blobs makes co-clustering ambiguous.
    elbow = ks.index(8)
    head = pac[:elbow + 1]
    check(all(a >= b - 0.02 for a, b in zip(head, head[1:])),
          f"PAC rises before the elbow at K=8: {head}")
    check(pac[elbow] <= pac.min() + 0.02,
          f"PAC(K=8)={pac[elbow]} is not at the minimum {pac.min()}")


# -- phase 4 -------------------------------------------------------------


def phase_small(torch):
    from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs

    x, _ = make_blobs(n_samples=300, n_features=8, centers=4,
                      cluster_std=2.0, random_state=5)
    x = x.astype(np.float32)
    fits = {}
    for device in ("cuda", "cpu"):
        fits[device] = ConsensusClustering(
            K_range=range(2, 7), n_iterations=40, random_state=7,
            store_matrices=True, cluster_batch=16, device=device,
        ).fit(x)
    ks = list(range(2, 7))
    gpu, cpu = fits["cuda"].cdf_at_K_data, fits["cpu"].cdf_at_K_data
    iij_eq = bool((gpu[2]["iij"] == cpu[2]["iij"]).all())
    pac_gap = max(abs(gpu[k]["pac_area"] - cpu[k]["pac_area"]) for k in ks)
    mij_eq = [bool((gpu[k]["mij"] == cpu[k]["mij"]).all()) for k in ks]
    emit({"phase": "small", "iij_equal": iij_eq, "max_pac_gap": pac_gap,
          "mij_equal_per_k": mij_eq})
    check(iij_eq, "small: Iij differs between the card and the CPU")
    check(pac_gap <= 0.02, f"small: PAC gap {pac_gap} > 0.02")


# -- phase 5 -------------------------------------------------------------


def phase_corr(torch):
    from consensus_clustering_tpu_torch import ConsensusClustering, load_corr

    with open(os.path.join(REPO, "tests", "fixtures",
                           "reference_goldens.json")) as f:
        goldens = json.load(f)
    ks = list(range(2, 15))
    cc = ConsensusClustering(K_range=range(2, 15), random_state=23,
                             n_iterations=30, store_matrices=True)
    cc.fit(load_corr(transform=True))
    ours = np.array([cc.cdf_at_K_data[k]["pac_area"] for k in ks])
    ref = np.array([goldens["kmeans_pac"][str(k)] for k in ks])
    band = np.maximum(0.02, 0.25 * ref)
    iij_sum = int(cc.cdf_at_K_data[2]["iij"].astype(np.int64).sum())
    tail = ours[2:]
    emit({"phase": "corr", "pac": ours.round(6).tolist(),
          "golden": ref.round(6).tolist(), "iij_sum": iij_sum,
          "golden_iij_sum": goldens["iij_sum"]})
    check(bool((np.abs(ours - ref) <= band).all()),
          "corr: PAC outside the golden bands")
    check(iij_sum == goldens["iij_sum"], f"corr: iij sum {iij_sum}")
    check(all(a >= b - 0.02 for a, b in zip(tail, tail[1:])),
          "corr: PAC tail (K >= 4) not monotone within 0.02")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES))
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import consensus_clustering_tpu_torch  # noqa: F401  (fails outside the repo)

    results = {}
    if "env" in phases:
        phase_env(torch)
    if "kernels" in phases:
        phase_kernels(torch, results)
    if "headline" in phases:
        phase_headline(torch, results)
    if "small" in phases:
        phase_small(torch)
    if "corr" in phases:
        phase_corr(torch)

    if FAILURES:
        print("chip_smoke FAILED: " + "; ".join(FAILURES), file=sys.stderr)
        return 1
    emit({"kernels": [results[k] for k in ("hist", "lloyd") if k in results]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
