#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``consensus_clustering_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:  ``python3 chip_smoke.py``.  Phases, each printing JSON lines:

1. env          — the card's name and power limit (nvidia-smi), torch/CUDA
                  versions, matplotlib's (null when it does not
                  import), and the seconds to build the five kernel
                  sources from csrc/ (one nvcc per source, started
                  together);
2. kernels      — each kernel against its plain PyTorch version on the
                  card, at the shapes the main paths give it and at a
                  ragged shape, with kernel, plain and bound times; B1's
                  Cij and count entries also at the stream's first and
                  last 256 x 5120 row tiles, B3 also at the packed
                  sentinel's 16 spot rows, a bimodal Cij (as at the
                  headline's K = 8) and values beside every bin edge;
                  B2 and the final assignment bit for bit against the
                  plain versions that repeat their arithmetic, on raw
                  data, also at a wide, a slot-chunked, a shuffled-lanes
                  and a scalar-layout case; the k-means++ draws and
                  prologue bit for bit at the benchmark's seeding step
                  shapes.  Every kernel's ``ms`` is
                  its device time over CUDA-graph replays of its wrapper
                  (the wrapper's host work, tens of microseconds, not
                  timed), ``eager_ms`` that of back-to-back calls;
3. headline     — the dense ``ConsensusClustering.fit`` on make_blobs
                  N=5000 d=50, H=500, K=2..20, KMeans(n_init=3),
                  cluster_batch=16, chunk_size=4, with the kernels' launch
                  counts set to 0 just before: PAC finite, in [0, 1],
                  falling to its minimum at the data's 8 blobs;
4. stream       — the same fit through the streaming engine,
                  ``stream_h_block=100, accum_repr="packed",
                  fuse_block="auto"``, counts set to 0 just before: fused
                  on the card, every kernel launched, and per-K hist and
                  PAC equal to the headline's bit for bit.  Both fits'
                  launch counts and per-K PAC must equal the values
                  pinned from the kernels before the redesign of B2
                  and the final assignment (``PINNED_*``);
5. resume       — the stream's fit with ``checkpoint_dir`` and
                  ``integrity_check_every=1``, the port's faults armed
                  with ``block_start=3``: the first fit raises after
                  blocks 0-2, a second resumes from block 3 (2 sentinel
                  checks), its per-K PAC equal to ``PINNED_PAC`` and its
                  hist to the stream's; the two fits' launches sum to the
                  stream's pins plus the packed sentinel's B3 launches.
                  Prints both walls, the ring's seconds and bytes a
                  generation, the host copy, the restore and the packed
                  sentinel's ms; B3's counts at the sentinel's spot rows
                  (generation 2's words, Iij and every K) must equal the
                  plain popcount's;
6. small        — a small dense fit on the card and on the CPU (plain
                  versions): Iij identical, PAC within 0.02 per K;
7. stream_small — N=300, H=60, K=2..6, blocks of 16 on the card: streamed
                  dense == monolithic dense, packed == dense, fused planes
                  == unfused planes, bit for bit; card vs CPU Iij and
                  co-sample planes identical, PAC within 0.02 per K;
8. resilience_small — at the stream_small size: an accumulator bitflip
                  caught and recovered (dense, packed), a lying payload
                  refused at resume, a subprocess killed (exit 137) and
                  resumed, per-K resume of a monolithic fit, the progress
                  callback, and the dense sentinel at the dense stream's
                  full shape (19 x 5000 x 5000) against its CPU run;
9. corr         — corr.csv, K=2..14, H=30, seed 23: PAC inside the golden
                  bands of tests/fixtures/reference_goldens.json, iij.sum()
                  equal to the golden;
10. clusterers  — the clusterer family at the JAX package's bench sizes,
                  each fit with the launch counts set to 0 just before and
                  its wall, rate, launches and nvidia-smi line printed:
                  ``gmm`` (make_blobs N=2000 d=16, GaussianMixture(n_init=2),
                  H=100, K=2..10, through ``fit_predict``: PAC finite in
                  [0, 1], the exact agglomerative labels regime at N=2000,
                  ARI against the blobs' truth >= 0.95; then H=20 one
                  resample a group with the same Mij as one group, and
                  the one-group fit's Iij equal to the CPU run's, PAC
                  within 0.02 per K and Mij equal at K=8),
                  ``agglo`` (corr.csv, average linkage, H=500, K=2..10: Iij
                  equal to the CPU run's, PAC within 0.02 per K),
                  ``spectral`` (make_blobs N=2000 d=30, gamma 0.02, LOBPCG,
                  H=50, K=2..10: PAC finite, B2 and the assignment
                  launched; then H=10, K=2,5,8 in groups of 4 resamples
                  with the same Mij as one group, and the one-group fit's
                  Iij equal to the CPU run's, PAC within 0.02 per K (a
                  statistical gate below K=8, the blob count) and Mij
                  equal at K=8),
                  ``host`` (corr.csv, a
                  numpy Lloyd host clusterer, so that no sklearn is
                  needed, H=100, K=2..10: Mij and Iij equal to the CPU
                  run's),
                  ``labels`` (consensus labels of the headline at K=8, the
                  spectral regime above 4096 items: PAC equal to the pinned
                  0.0, ARI against the blobs' truth >= 0.95) and ``k_batch``
                  (the stream_small fit in batches of 2 Ks equal to one
                  batch bit for bit);
11. estimate    — the sampled-pair estimator at its own scale through the
                  API: the headline generator at N=100,000, H=100,
                  K=2..20, ``mode="auto"`` (it must resolve to
                  ``estimate`` against the card's own memory),
                  ``stream_h_block=100``, packed pairs, 2^17 pairs,
                  ``exact_best_k``: PAC in [0, 1], best K 8, the refined
                  K=8 PAC within the disclosed bound of the estimate, B2
                  and the assignment launched in the estimate, B3 and B1's
                  count entry in the refinement; prints run and refine
                  seconds, resamples/s and peak device memory;
12. estimate_check — the estimator on the headline data (N=5000, H=100,
                  blocks of 50): every sampled pair's counts equal the
                  packed stream's captured planes at the pair (dense and
                  packed pair paths), the PAC error under the disclosed
                  bound per K, and a run cut by ``block_start=1`` resumed
                  from the ring bit for bit;
13. refine      — ``exact_curves_for_k`` at the headline (N=5000, H=500,
                  K=8): PAC equal to ``PINNED_PAC``, the CDF equal to the
                  headline's, the kernel route equal to the plain route on
                  the card;
14. append      — a parent of the headline blobs' first 4,000 rows
                  (H=400, packed, fused) bootstrapped into a plane store,
                  then all 5,000 rows appended with 100 new resamples:
                  Iij accounting exact, merged curves on the card equal to
                  the plain route on the card, generation 1 reloads and
                  verifies, no refresh recommended; prints the append's
                  seconds beside the from-scratch stream's;
15. serve       — the port's ``ConsensusService`` on the card (the port's
                  ``SweepExecutor`` on ``cuda``, ``fusion_max=2``, the fair
                  schedule, the budget from ``resolve_memory_budget``),
                  spoken to over HTTP on 127.0.0.1 with the headline data
                  as JSON: A, the headline stream as a job (H=500, packed,
                  blocks of 100: PAC equal to ``PINNED_PAC``, the memory
                  measured on the device); A again (from the store, no
                  run); B and C (H=200, seeds 101 and 102, queued behind A:
                  fused, each equal to a solo ``executor.run`` of its
                  spec); D (``progressive``, H=100: the estimate, then its
                  refinement, inside the disclosed bound); E (1,000 rows of
                  another seed's blobs appended to A's plane store, H=100:
                  equal to ``run_append`` on a copy of the store);
                  ``/healthz``, ``/metrics`` (counters equal to the requests)
                  and ``/metrics.prom`` (parses).  Prints each request's
                  HTTP codes and seconds (POST, queue wait, run, the rest
                  of the attempt) and the kernels' launches in the phase,
                  every one of which must be > 0.
                  The ``kernels`` phase also holds B2 and the assignment
                  at the estimator's 48 lanes of 80,000 rows, and B3 and
                  B1's count entry at the refinement's 2,048 x 100,000
                  tiles;
16. cli         — the command line, each subcommand in a process of its
                  own: ``run`` at the headline's width (make_blobs N=5000
                  d=50 seed 23, H=100, K=2..20, packed, blocks of 100,
                  fused: per-K PAC equal to the library's fit of the same
                  arguments bit for bit, every kernel launched) and on
                  corr.csv (K=2..14, H=100, dense: inside the golden
                  bands, B1 launched); ``autotune run --shapes smoke``
                  (every gate holds, records carry the card's name) and
                  ``show``, with ``ConsensusClustering(autotune=True)``
                  at the ``stream_h_block`` and ``max_iter`` smoke
                  buckets disclosing the records' tiers, PAC equal to the
                  fit with the value pinned by hand; ``serve`` with that
                  store answering the run's job (PAC equal to the run's,
                  then from the store) and a second job (seed 24, H=2000),
                  ``serve-admin`` ``show`` (footprints, while the second
                  job is queued or running),
                  ``list``, ``trace``, ``report`` and ``bundle`` (the job
                  record inside), then SIGINT (exit 0 within 10 s);
                  ``lint --pack all --json`` on the CI gate's paths
                  (exit 0, no new finding against the committed baseline,
                  no error) beside ``bench``, refused naming A18.  Prints each step's wall time (for ``run``,
                  the wall minus ``run_seconds``: process start and
                  kernel load);
17. plot        — plotting at the cli phase's dense headline width
                  (make_blobs N=5000 d=50 seed 23, H=100, K=2..20,
                  KMeans(n_init=3)): the library ``fit`` with
                  ``plot_cdf=True, store_matrices=True`` (counts set to 0
                  just before) and ``run --plot-dir`` in a subprocess:
                  per-K PAC equal bit for bit, B1, B2 and the assignment
                  launched in both.  With matplotlib, the heatmap labels'
                  spectral KMeans launches B2 and the assignment in the
                  subprocess, the fit's figure draws
                  one curve per K (``[0] + cdf``), the run writes
                  ``cdf.png``, ``delta_k.png`` and
                  ``consensus_matrix_K{best}.png``, the first two equal
                  byte for byte to the figures drawn in this process, and
                  the heatmap's image is Cij in the order of its labels.
                  Without it, the fit raises ``ImportError`` after the
                  sweep (results set) and the run prints its JSON and exits
                  non-zero, as the reference does; the phase says so;
18. mesh        — multi-device sweeps on virtual meshes (the card
                  repeated): the dense headline on (k=2, h=2, n=2) with
                  ``k_interleave`` and the packed fused stream (blocks of
                  100) on (h=2, n=2), each through the API with the
                  counts set to 0 just before, per-K PAC equal to
                  ``PINNED_PAC`` and launches equal to their pins; the
                  estimator at N=100,000 (H cut to 20) on (h=2, n=2), its
                  curves and pair counts equal to its one-device run; H=17
                  over two 'h' shards with ``cluster_batch=8`` (a Lloyd
                  group of one lane), Mij equal to one device's; two gloo
                  processes sharing the card, the dense sweep at the
                  headline's width (H cut to 100) with 'h' across them,
                  equal to one process; then two more that run, each
                  equal to one process bit for bit, the dense sweep
                  with 'n' across them (``row_shards=2``), the packed
                  fused stream at the headline's width (H cut to 200,
                  blocks of 100, a ring each: only rank 0 writes) with
                  'n' across them, and the estimator at N=100,000 (H=20)
                  with 'h' across them.  The ``kernels`` phase adds B1's
                  mesh row blocks (N=5000 over 3 and 2 row shards, N=29
                  over 8).  Copies between cards and NCCL are not
                  exercised: the machine has one card.

``--phases env,mesh_cards`` (not in the default run) needs four cards: the
mesh phase's dense and stream runs on distinct cards (the same pins) and
four NCCL processes with a card each, the dense sweep and the packed
fused stream on (h=2, n=2), each equal to one process.

Then a ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero without
that line; so does a machine without CUDA.  ``--phases env,kernels`` (or
``--phases stream``) runs a subset (the default is all of them); the
stream phase compares with the headline, and resume with the stream, only
when both run in one call, and otherwise says ``"not run"`` for that
comparison.
"""

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("env", "kernels", "headline", "stream", "resume", "small",
          "stream_small", "resilience_small", "corr", "clusterers",
          "estimate", "estimate_check", "refine", "append", "serve", "cli",
          "plot", "mesh")
KERNEL_NAMES = ("hist", "lloyd", "popcount", "fused_block", "assign")

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# outside the tensor cores.  POPC: 16 results per clock per SM on compute
# capability 9.0 (the CUDA programming guide's arithmetic-instruction
# throughput table), 132 SMs, 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
POPC_PER_S = 16 * 132 * 1.98e9
# 32-bit integer add, shift, funnel shift and logic: 64 results per clock
# per SM on compute capability 9.0 (the same table).
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 instructions of one k-means++ draw: threefry2x32's 72 (two initial
# adds, 20 rounds of add, funnel shift and xor, 5 two-add key injections),
# the counter's add, and the uniform's xor, shift and or.
KMEANSPP_HASH_OPS = 76

HEADLINE = dict(K_range=range(2, 21), n_iterations=500, random_state=23,
                store_matrices=False, chunk_size=4, cluster_batch=16)
STREAM = dict(stream_h_block=100, accum_repr="packed", fuse_block="auto")

# Pinned from the kernels before the redesign of B2 and the final
# assignment (commit 5f1b481, run by this script on an NVIDIA H100 80GB
# HBM3 at 700 W): the launch counts of the headline and the stream, and
# their per-K PAC (equal in both).  The redesign keeps every bit, so every
# later run must equal them exactly; a change that moves the bits on
# purpose re-pins them.
PINNED_LAUNCHES = {
    "headline": {"hist": 19, "lloyd": 17287, "popcount": 0,
                 "fused_block": 0, "assign": 608},
    "stream": {"hist": 1900, "lloyd": 18541, "popcount": 2000,
               "fused_block": 95, "assign": 665},
    # The mesh phase's runs, pinned from its first run on the card (an
    # NVIDIA H100 80GB HBM3 at 700 W): the shards' Lloyd groups differ
    # from one device's, so B2, the assignment and B4 launch more often,
    # B1 once a row block.
    "mesh_dense": {"hist": 38, "lloyd": 17355, "popcount": 0,
                   "fused_block": 0, "assign": 608},
    "mesh_stream": {"hist": 1900, "lloyd": 21008, "popcount": 2000,
                    "fused_block": 380, "assign": 760},
}
PINNED_PAC = [
    0.15632814168930054, 0.14219361543655396, 0.11298960447311401,
    0.06537121534347534, 0.0448077917098999, 0.015815556049346924, 0.0,
    0.007634401321411133, 0.0428505539894104, 0.05942767858505249,
    0.06196880340576172, 0.062322378158569336, 0.062380969524383545,
    0.06239485740661621, 0.062399327754974365, 0.06239980459213257,
    0.06239676475524902, 0.062391817569732666, 0.06235170364379883,
]

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


def device_ms(torch, fn, reps):
    """Mean device milliseconds of one call of a kernel wrapper ``fn``:
    ``reps`` calls captured in a CUDA graph and replayed, so that the
    wrapper's host work (tens of microseconds, more than a short kernel
    takes) is not what is timed, as it is by :func:`cuda_ms`.  The warm
    call runs on the capture stream, so per-stream state is made outside
    the graph."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def headline_data():
    from consensus_clustering_tpu_torch import make_blobs

    x, _ = make_blobs(n_samples=5000, n_features=50, centers=8,
                      cluster_std=3.0, random_state=0)
    return x.astype(np.float32)


# -- phase 1 -------------------------------------------------------------


def phase_env(torch):
    from consensus_clustering_tpu_torch.ops import _build

    line = smi_line()
    print(line, flush=True)
    t0 = time.perf_counter()
    from consensus_clustering_tpu_torch.parallel.sweep import KERNELS

    reports = _build.build(KERNELS)
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in text.splitlines()
               if "Used" in ln or "spill" in ln or "entry function" in ln]
        for name, text in reports.items()
    }
    try:
        import matplotlib

        mpl = matplotlib.__version__
    except ImportError:
        mpl = None
    emit({"phase": "env", "nvidia_smi": line, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matplotlib": mpl,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "built": list(KERNELS), "build_seconds": build_s,
          "ptxas": ptxas})
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


def count_tiles(torch, n_rows, n_cols, seed, kind):
    """int32 (Mij, Iij) of an (n_rows, n_cols) block, Iij in [1, 500]
    (H = 500), torch only (kernel_phases.py builds them for any checkout):

    - ``uniform``: Mij = floor(Iij * U[0, 1)), so Cij spreads over every
      bin, with a band of exact bin-edge ratios (6/40 = 0.15 and the like)
      in the first 40 columns;
    - ``bimodal``: a consensus matrix at the data's true K (the headline's
      K = 8, PAC 0): 80% of pairs never co-clustered (bin 0), 12% always
      (Cij = 0.999999..., bin 19), 4% each in [0, 0.1) and [0.9, 1];
    - ``edges``: ratios on and beside every edge of 20 bins, Iij a
      multiple of 20 and Mij = Iij * b / 20 + {-1, 0, 1}.
    """
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n_rows, n_cols)
    iij = torch.randint(1, 501, shape, generator=g, device="cuda")
    if kind == "uniform":
        frac = torch.rand(shape, generator=g, device="cuda")
        mij = torch.floor(iij * frac)
        iij[:, :40] = 40
        mij[:, :40] = torch.arange(40, device="cuda") % 41
    elif kind == "bimodal":
        u = torch.rand(shape, generator=g, device="cuda")
        r = torch.rand(shape, generator=g, device="cuda")
        low = torch.floor(iij * 0.1 * r)
        high = torch.minimum(torch.ceil(iij * (0.9 + 0.1 * r)), iij)
        mij = torch.where(u < 0.8, torch.zeros_like(low), torch.where(
            u < 0.92, iij.to(low.dtype), torch.where(u < 0.96, low, high)))
    elif kind == "edges":
        iij = (iij % 25 + 1) * 20
        b = torch.randint(0, 21, shape, generator=g, device="cuda")
        step = torch.randint(-1, 2, shape, generator=g, device="cuda")
        mij = torch.clamp(iij // 20 * b + step, 0)
        mij = torch.minimum(mij, iij)
    else:
        raise ValueError(kind)
    return mij.to(torch.int32), iij.to(torch.int32)


def edge_values(torch, bins):
    """Every f32 bin edge and its two neighbours on each side, tiled into
    a (64, 4096) Cij block."""
    edges = np.linspace(0.0, 1.0, bins + 1).astype(np.float32)
    vals = []
    for e in edges:
        lo = hi = e
        vals.append(e)
        for _ in range(2):
            lo = np.nextafter(lo, np.float32(-1))
            hi = np.nextafter(hi, np.float32(2))
            vals += [lo, hi]
    v = torch.tensor(np.array(vals, np.float32), device="cuda")
    return v.repeat(64 * 4096 // v.numel() + 1)[:64 * 4096].reshape(64, 4096)


def _cij_block(torch, n, seed, kind="uniform"):
    """(Mij, Iij, Cij) of an (N, N) block of :func:`count_tiles`."""
    from consensus_clustering_tpu_torch.ops.analysis import consensus_matrix

    mij, iij = count_tiles(torch, n, n, seed, kind)
    return mij, iij, consensus_matrix(mij, iij)


def phase_kernels(torch, results):
    kernels_hist(torch, results)
    kernels_lloyd_assign(torch, results)
    kernels_popcount(torch, results)
    kernels_fused(torch, results)
    kernels_estimate_shapes(torch, results)
    kernels_kmeanspp(torch, results)


def kernels_hist(torch, results):
    """B1's two entries, each held bit for bit against its plain version:
    the Cij entry (the dense sweep's) and the count entry (the stream's
    evaluation: int32 Mij and Iij tiles, Cij formed in registers), at the
    full 5000 x 5000 matrix, a ragged row block, the stream's first and
    last 256 x 5120 row tiles (N = 5000: the last tile's rows 5000-5119
    and every tile's columns >= 5000 lie past N, random here, not zero,
    and must be dropped), a bimodal matrix as at the headline's K = 8, and
    ratios on and beside every bin edge (the Cij entry: every f32 edge
    and its two neighbours on each side).  Timed on the uniform and the
    bimodal matrix and tile."""
    from consensus_clustering_tpu_torch.ops import hist

    n, bins, tile_r, n_pad2 = 5000, 20, 256, 5120
    counts = {kind: _cij_block(torch, n, 0, kind)
              for kind in ("uniform", "bimodal", "edges")}
    pad = {kind: _cij_block(torch, n_pad2, 1, kind)
           for kind in ("uniform", "bimodal")}
    edge_cij = edge_values(torch, bins)
    # A mesh's row blocks (the 'n' axis pads N to n_local * row_shards):
    # N = 5000 over 3 row shards (n_local 1667, n_pad 5001, the last block
    # at row 3334 holds the padding row 5000), corr.csv's N = 29 over 8
    # (n_local 4, n_pad 32: one valid row in the last block, at 28), and
    # the dense mesh phase's 2 shards (rows 2500-4999 at offset 2500).
    mesh3 = _cij_block(torch, 5001, 2)
    # count_tiles writes 40 fixed columns: cut the 32-wide block from 64.
    mesh8 = tuple(t[:32, :32].contiguous() for t in _cij_block(torch, 64, 3))
    rows = [("full", counts["uniform"], slice(None), n, 0),
            ("mesh row block 2 of 3", mesh3, slice(3334, 5001), n, 3334),
            ("mesh row block 0 of 3", mesh3, slice(0, 1667), n, 0),
            ("mesh corr row block 7 of 8", mesh8, slice(28, 32), 29, 28),
            ("mesh row block 1 of 2", counts["uniform"], slice(2500, 5000),
             n, 2500),
            ("ragged", counts["uniform"], slice(1234, 2011), 4990, 1234),
            ("stream tile 0", pad["uniform"], slice(0, tile_r), n, 0),
            ("stream tile 19", pad["uniform"], slice(n_pad2 - tile_r, None),
             n, n_pad2 - tile_r),
            ("bimodal", counts["bimodal"], slice(None), n, 0),
            ("bimodal stream tile 0", pad["bimodal"], slice(0, tile_r), n, 0),
            ("edge ratios", counts["edges"], slice(None), n, 0)]
    worst = 0

    def held(entry, name, got, ref, **line):
        nonlocal worst
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"hist {entry} != plain ({name}): {got.tolist()} vs "
                        f"{ref.tolist()}")
        emit({"phase": "kernels", "kernel": "hist", "entry": entry,
              "case": name, "counted": int(ref.sum()), "max_abs_err": err,
              **line})

    for name, (mij, iij, cij), rs, n_valid, off in rows:
        block = cij[rs]
        held("cij", name, hist.consensus_hist_counts_kernel(
            block, n_valid, off, bins), hist.consensus_hist_counts_plain(
            block, n_valid, off, bins), shape=list(block.shape),
            row_offset=off, n_valid=n_valid)
        zeros = torch.zeros(bins, dtype=torch.int64, device="cuda")
        held("counts", name, hist.consensus_hist_from_counts_kernel(
            mij[rs], iij[rs], n_valid, off, bins, zeros.clone()),
            hist.consensus_hist_from_counts_plain(
                mij[rs], iij[rs], n_valid, off, bins, zeros.clone()),
            shape=list(block.shape), row_offset=off, n_valid=n_valid)
    held("cij", "edge neighbours", hist.consensus_hist_counts_kernel(
        edge_cij, 4096, 0, bins), hist.consensus_hist_counts_plain(
        edge_cij, 4096, 0, bins), shape=list(edge_cij.shape))

    pairs = n * (n - 1) // 2
    t_pairs = sum(n - 1 - i for i in range(tile_r))  # tile 0: i < j < N
    log_bins = math.ceil(math.log2(bins))

    def timed(fn, plain, reps, n_pairs=pairs, per_pair=4, extra_ops=0):
        # Out: int32 counts (the Cij entry), int64 (the count entry).
        out_bytes = bins * (8 if per_pair == 8 else 4)
        b_ms, b_by = bound_ms(n_pairs * per_pair + (bins + 1) * 4 + out_bytes,
                              n_pairs * (3 + log_bins + extra_ops))
        out = {"ms": device_ms(torch, fn, reps),
               "eager_ms": cuda_ms(torch, fn, reps),
               "bound_ms": b_ms, "bound_by": b_by}
        out["plain_ms"] = cuda_ms(torch, plain, 3)
        return out

    def cij_entry(cij, rows_=slice(None)):
        block = cij[rows_]
        return (lambda: hist.consensus_hist_counts_kernel(block, n, 0, bins),
                lambda: hist.consensus_hist_counts_plain(block, n, 0, bins))

    def count_entry(mij, iij):
        m, i = mij[:tile_r], iij[:tile_r]
        out = torch.zeros(bins, dtype=torch.int64, device="cuda")
        return (lambda: hist.consensus_hist_from_counts_kernel(
                    m, i, n, 0, bins, out),
                lambda: hist.consensus_hist_from_counts_plain(
                    m, i, n, 0, bins, out))

    tile = slice(0, tile_r)
    full = timed(*cij_entry(counts["uniform"][2]), 20)
    # The dense mesh phase's row block: rows 2500-4999 of 5000 at offset
    # 2500, the pairs i < j < N of those rows.
    block_pairs = sum(n - 1 - i for i in range(2500, n))
    half = counts["uniform"][2][2500:]
    row_block = timed(
        lambda: hist.consensus_hist_counts_kernel(half, n, 2500, bins),
        lambda: hist.consensus_hist_counts_plain(half, n, 2500, bins), 20,
        n_pairs=block_pairs)
    bimodal = timed(*cij_entry(counts["bimodal"][2]), 20)
    tile_u = timed(*cij_entry(pad["uniform"][2], tile), 50, n_pairs=t_pairs)
    tile_b = timed(*cij_entry(pad["bimodal"][2], tile), 50, n_pairs=t_pairs)
    # The count entry reads 8 bytes a pair and adds the divide's operations
    # (two conversions, an add, a divide) to the bin's.
    cnt_u = timed(*count_entry(*pad["uniform"][:2]), 50, n_pairs=t_pairs,
                  per_pair=8, extra_ops=4)
    cnt_b = timed(*count_entry(*pad["bimodal"][:2]), 50, n_pairs=t_pairs,
                  per_pair=8, extra_ops=4)
    results["hist"] = {
        "name": "hist", "route": "cuda",
        "source": "consensus_clustering_tpu_torch/csrc/hist.cu",
        "replaces": "consensus_clustering_tpu/ops/pallas_hist.py:47",
        "launches": None, "max_abs_err": worst, "ms": full["ms"],
        "plain_ms": full["plain_ms"], "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"], "library_ms": None, "shape": [n, n],
        "eager_ms": full["eager_ms"], "redesigned": True,
        "bimodal": dict(bimodal, shape=[n, n]),
        "stream_tile": dict(tile_u, shape=[tile_r, n_pad2]),
        "stream_tile_bimodal": dict(tile_b, shape=[tile_r, n_pad2]),
        "count_entry_tile": dict(cnt_u, shape=[tile_r, n_pad2]),
        "count_entry_tile_bimodal": dict(cnt_b, shape=[tile_r, n_pad2]),
        "mesh_row_block": dict(row_block, shape=[2500, n], row_offset=2500),
    }
    emit({"phase": "kernels", "kernel": "hist", "timing": results["hist"],
          "library_note": "no single PyTorch call computes it: torch.histc "
                          "bins by scaled floor, not by edge membership, "
                          "and takes no triangle mask"})


def kernels_lloyd_assign(torch, results):
    """B2 and the final assignment on the same cases, each held bit for bit
    against the plain version that repeats its arithmetic op by op
    (``lloyd_step_ordered_plain``, ``assign_labels_plain``), on raw data:

    - the headline lane batch, 16 resamples x n_init 3 of 4000 x 50 rows
      drawn with the port's resample plan, k = k_max = 20, raw and
      quantised to 1/8 (where the GEMM plain version must agree exactly
      too; on raw blobs it agrees to 1e-5 of sum|x|);
    - a ragged case: n = 1237 (not a multiple of 128), d 37, k 9 < k_max 13;
    - a wide case: d 300, k_max 40, k 33 (several register groups a row);
    - a case whose slots are staged in shared-memory chunks: d 401,
      k_max 60, k 57;
    - the headline lane batch with lane_src shuffled, so that the lanes a
      block takes in turn come from different resamples;
    - a case whose slots only fit unpadded, read one at a time (the
      scalar layout): d 445, k_max 2, k 2;
    - the clusterer family's shapes: GMM's k-means init (200 lanes of
      1600 x 16, k_max 10) and the spectral embedding's KMeans (150 lanes
      of 1600 x 10).
    Timing at the headline lane batch on raw blobs, and at the clusterer
    family's two shapes."""
    from consensus_clustering_tpu_torch import rng
    from consensus_clustering_tpu_torch.data import make_blobs
    from consensus_clustering_tpu_torch.ops import fused_block, lloyd
    from consensus_clustering_tpu_torch.ops.resample import resample_indices

    x_np, _ = make_blobs(n_samples=5000, n_features=50, centers=8,
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

    # Raw blobs with 20 well-separated centres, centroids at the centre
    # means: no label sits near a tie, so the GEMM plain version's labels
    # agree too.
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
    xq = torch.round(x_all[idx] * 8) / 8  # multiples of 1/8: exact sums
    src_q, cen_q = lanes_from(xq, 3, 20)
    x_rag = torch.randn((5, 1237, 37), generator=g, device="cuda") * 3
    src_g, cen_g = lanes_from(x_rag, 2, 13)
    x_wide = torch.randn((2, 1000, 300), generator=g, device="cuda") * 3
    src_w, cen_w = lanes_from(x_wide, 2, 40)
    x_chunk = torch.randn((1, 300, 401), generator=g, device="cuda") * 3
    src_c, cen_c = lanes_from(x_chunk, 2, 60)
    x_scalar = torch.randn((2, 300, 445), generator=g, device="cuda") * 3
    src_s, cen_s = lanes_from(x_scalar, 2, 2)
    # The clusterer family's shapes: GMM's k-means init (100 resamples x 2
    # restarts of 1600 x 16, one lane each, k_max 10) and the spectral
    # embedding's KMeans (50 row-normalised 1600 x 10 embeddings, columns
    # >= k zero, n_init 3).
    x16_np, _ = make_blobs(n_samples=2000, n_features=16, centers=8,
                           cluster_std=3.0, random_state=0)
    x_gmm = torch.tensor(x16_np, dtype=torch.float32, device="cuda")[
        resample_indices(rng.prng_key(23, "cuda"), 2000, 100, 1600)
    ].repeat_interleave(2, dim=0)
    src_m, cen_m = lanes_from(x_gmm, 1, 10)
    emb = torch.randn((50, 1600, 10), generator=g, device="cuda")
    emb[..., 8:] = 0.0
    emb = emb / emb.norm(dim=-1, keepdim=True)
    src_e, cen_e = lanes_from(emb, 3, 10)
    clusterer_cases = [("gmm init raw", x_gmm, src_m, cen_m, 8),
                       ("spectral embedding raw", emb, src_e, cen_e, 8)]
    cases = [("headline raw blobs", xr, src_r, cen_r, 20, "band"),
             ("headline quantised", xq, src_q, cen_q, 20, "exact"),
             ("ragged raw", x_rag, src_g, cen_g, 9, None),
             ("ragged quantised", torch.round(x_rag * 8) / 8, src_g,
              torch.round(cen_g * 8) / 8, 9, "exact"),
             ("wide raw", x_wide, src_w, cen_w, 33, None),
             ("smem-chunked raw", x_chunk, src_c, cen_c, 57, None),
             # A block's 3 lanes from up to 3 resamples: rows restaged.
             ("headline raw, lanes shuffled", x_all[idx],
              src_q[torch.randperm(48, generator=g, device="cuda")], cen_q,
              20, None),
             ("scalar layout raw", x_scalar, src_s, cen_s, 2, None)]
    cases += [case + (None,) for case in clusterer_cases]
    worst_l = worst_a = 0.0
    for name, xs, src, cen, k, gemm in cases:
        got = lloyd.lloyd_step_kernel(xs, src, cen, k)
        ref = lloyd.lloyd_step_ordered_plain(xs, src, cen, k)
        lab, dmin = fused_block.assign_labels_kernel(xs, src, cen, k)
        lab_p, dmin_p = fused_block.assign_labels_plain(xs, src, cen, k)
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, ref))
        worst_l = max(worst_l, err)
        check(all(same), f"lloyd != ordered plain ({name}): sums, counts, "
                         f"far_idx equal {same}")
        lab_eq = bool(torch.equal(lab, lab_p))
        dmin_eq = bool(torch.equal(dmin, dmin_p))
        worst_a = max(worst_a, float((dmin - dmin_p).abs().max()))
        check(lab_eq and dmin_eq, f"assign kernel != plain ({name})")
        layouts = [fused_block.tile_layout(xs.shape[2], cen.shape[1], extra)
                   for extra in (2 * lloyd.TILE_ROWS, 0)]
        if name.startswith("scalar"):
            check(not any(lay[3] for lay in layouts),
                  f"{name}: not the scalar layout: {layouts}")
        line = {"phase": "kernels", "kernel": "lloyd+assign", "case": name,
                "x": list(xs.shape), "lanes": int(src.shape[0]),
                "k_max": int(cen.shape[1]), "k": k,
                "layout_lloyd_assign": layouts,
                "lloyd_equal_ordered_plain": same,
                "assign_labels_equal": lab_eq, "assign_dmin_equal": dmin_eq}
        if gemm:
            sp, cp, fp = lloyd.lloyd_step_plain(xs, src, cen, k)
            gerr = float((got[0] - sp).abs().max())
            if gemm == "exact":
                sums_ok = bool(torch.equal(got[0], sp))
            else:
                # |err| <= 1e-5 of the sum's own error scale, sum_i |x_i|
                labels = lloyd.masked_sqdist(xs[src], cen, k).argmin(-1)
                onehot = torch.nn.functional.one_hot(labels, cen.shape[1])
                scale = onehot.float().transpose(1, 2) @ xs[src].abs()
                sums_ok = bool(((got[0] - sp).abs() <= 1e-5 * scale).all())
            gemm_ok = (sums_ok and bool(torch.equal(got[1], cp))
                       and bool(torch.equal(got[2], fp)))
            check(gemm_ok, f"lloyd != GEMM plain ({name}, {gemm})")
            line.update(gemm_plain_equal=gemm_ok,
                        gemm_plain_sums_max_abs_err=gerr,
                        gemm_plain_tolerance="exact" if gemm == "exact" else
                        "|err| <= 1e-5 * sum|x| per entry")
        emit(line)

    # int32 lane_src, as KMeans passes it: no conversion is timed.
    src_r = src_r.to(torch.int32)
    k_ms = device_ms(torch, lambda: lloyd.lloyd_step_kernel(
        xr, src_r, cen_r, 20), 50)
    e_ms = cuda_ms(torch, lambda: lloyd.lloyd_step_kernel(xr, src_r, cen_r,
                                                          20), 50)
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
        "launches": None, "max_abs_err": worst_l, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": [lanes, rows, d, k_max],
        "redesigned": True, "eager_ms": e_ms,
    }
    emit({"phase": "kernels", "kernel": "lloyd",
          "timing_shape": [lanes, rows, d, k_max], "kernel_ms": k_ms,
          "eager_ms": e_ms, "plain_ms": p_ms,
          "bound_ms": b_ms,
          "bound_by": b_by, "library_ms": None,
          "library_note": "no single PyTorch call computes a fused "
                          "assign + accumulate step"})

    # The final assignment's timing: the headline's lane batch of the
    # 8-blob data, centroids drawn from its rows.
    xs = x_all[idx]
    src = torch.arange(16, device="cuda",
                       dtype=torch.int32).repeat_interleave(3)
    cents = xs[src[:, None], torch.randint(0, 4000, (48, 20), generator=g,
                                           device="cuda")]
    got = fused_block.assign_labels_kernel(xs, src, cents, 20)
    ref = fused_block.assign_labels_plain(xs, src, cents, 20)
    torch.cuda.synchronize()
    check(bool(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])),
          "assign kernel != plain (timing case)")
    a_ms = device_ms(torch, lambda: fused_block.assign_labels_kernel(
        xs, src, cents, 20), 50)
    ae_ms = cuda_ms(torch, lambda: fused_block.assign_labels_kernel(
        xs, src, cents, 20), 50)
    ap_ms = cuda_ms(torch, lambda: fused_block.assign_labels_plain(
        xs, src, cents, 20), 3)
    b_ms, b_by = bound_ms(
        4 * (16 * rows * d + lanes * 20 * d + lanes + 2 * lanes * rows),
        lanes * rows * (20 * (2 * d + 3) + 2 * d))
    results["assign"] = {
        "name": "assign", "route": "cuda",
        "source": "consensus_clustering_tpu_torch/csrc/fused_block.cu",
        "replaces": "consensus_clustering_tpu/models/kmeans.py:348 (the "
                    "final assignment, an XLA GEMM; no Pallas kernel)",
        "launches": None, "max_abs_err": worst_a,
        "ms": a_ms, "plain_ms": ap_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": [lanes, rows, d, 20],
        "redesigned": True, "eager_ms": ae_ms,
    }
    emit({"phase": "kernels", "kernel": "assign",
          "timing_shape": [lanes, rows, d, 20], "kernel_ms": a_ms,
          "eager_ms": ae_ms, "plain_ms": ap_ms, "bound_ms": b_ms,
          "bound_by": b_by,
          "library_ms": None,
          "library_note": "no single PyTorch call returns nearest labels "
                          "and distances"})

    # Both kernels at the clusterer family's shapes, beside their bounds.
    for name, xs, src, cen, k in clusterer_cases:
        src = src.to(torch.int32)
        n_x, rows, d = xs.shape
        lanes, k_max = cen.shape[:2]
        lloyd_bound = bound_ms(
            4 * (n_x * rows * d + lanes * k_max * d + lanes
                 + lanes * k_max * (d + 2)),
            lanes * rows * (2 * d * k_max + 3 * k_max + 3 * d))
        assign_bound = bound_ms(
            4 * (n_x * rows * d + lanes * k_max * d + lanes
                 + 2 * lanes * rows),
            lanes * rows * (k_max * (2 * d + 3) + 2 * d))
        for kernel, fn, plain, bound in (
                ("lloyd", lloyd.lloyd_step_kernel, lloyd.lloyd_step_plain,
                 lloyd_bound),
                ("assign", fused_block.assign_labels_kernel,
                 fused_block.assign_labels_plain, assign_bound)):
            timing = {
                "shape": [lanes, rows, d, k_max],
                "ms": device_ms(torch, lambda: fn(xs, src, cen, k), 50),
                "plain_ms": cuda_ms(torch, lambda: plain(xs, src, cen, k),
                                    3),
                "bound_ms": bound[0], "bound_by": bound[1]}
            results[kernel].setdefault("clusterer_shapes", {})[name] = timing
            emit({"phase": "kernels", "kernel": kernel, "case": name,
                  **timing})


def kernels_popcount(torch, results):
    """B3 at the stream headline's evaluation tiles (Mij: 20 K-planes x 20
    words, a 256-row tile sliced from the 5120 columns, as the engine
    passes it; Iij: 20 words), at the packed sentinel's spot rows (the 16
    sampled columns of the same words against all 5120) and at the
    reference's ragged probe shape, on random bit patterns including bit
    31; counts must be equal."""
    from consensus_clustering_tpu_torch.ops import popcount
    from consensus_clustering_tpu_torch.ops.bitpack import (
        popcount_accumulate,
        unpack_bits,
    )
    from consensus_clustering_tpu_torch.resilience.integrity import (
        sentinel_sample_rows,
    )

    g = torch.Generator(device="cuda").manual_seed(3)

    def words(n_words, n_cols):
        return torch.randint(-2**31, 2**31 - 1, (n_words, n_cols),
                             generator=g, device="cuda", dtype=torch.int32)

    mij_cols, iij_cols = words(400, 5120), words(20, 5120)
    spot = torch.as_tensor(sentinel_sample_rows(5000, 3), dtype=torch.int64,
                           device="cuda")
    cases = [
        ("mij tile", mij_cols[:, 1024:1280], mij_cols),
        ("iij tile", iij_cols[:, 4864:5120], iij_cols),
        ("sentinel mij spot rows", mij_cols[:, spot], mij_cols),
        ("sentinel iij spot rows", iij_cols[:, spot], iij_cols),
        ("ragged probe", words(13, 264), words(13, 300)),
    ]
    worst = 0
    for name, rows, cols in cases:
        got = popcount.packed_coassoc_counts_kernel(rows, cols)
        ref = popcount_accumulate(rows, cols)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"popcount kernel != plain ({name})")
        emit({"phase": "kernels", "kernel": "popcount", "case": name,
              "rows": list(rows.shape), "cols": list(cols.shape),
              "bit31_words": int((rows < 0).sum() + (cols < 0).sum()),
              "max_abs_err": err})
    rows, cols = cases[0][1], cases[0][2]
    n_words, n_rows, n_cols = rows.shape[0], rows.shape[1], cols.shape[1]
    k_ms = device_ms(torch, lambda: popcount.packed_coassoc_counts_kernel(
        rows, cols), 50)
    e_ms = cuda_ms(torch, lambda: popcount.packed_coassoc_counts_kernel(
        rows, cols), 50)
    p_ms = cuda_ms(torch, lambda: popcount_accumulate(rows, cols), 3)

    def dense_equiv():
        a = unpack_bits(rows.T.contiguous(), n_words * 32).float()
        b = unpack_bits(cols.T.contiguous(), n_words * 32).float()
        return (a @ b.T).to(torch.int32)

    d_ms = cuda_ms(torch, dense_equiv, 5)
    check(bool(torch.equal(dense_equiv(),
                           popcount_accumulate(rows, cols))),
          "popcount dense equivalent != plain")
    n_ops = n_words * n_rows * n_cols
    b_ms, b_by = bound_ms(4 * (n_words * (n_rows + n_cols) + n_rows * n_cols),
                          n_ops, POPC_PER_S)
    results["popcount"] = {
        "name": "popcount", "route": "cuda",
        "source": "consensus_clustering_tpu_torch/csrc/popcount.cu",
        "replaces": "consensus_clustering_tpu/ops/pallas_coassoc.py:66",
        "launches": None, "max_abs_err": worst, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "dense_equiv_ms": d_ms, "eager_ms": e_ms,
        "shape": [n_words, n_rows, n_cols],
    }
    emit({"phase": "kernels", "kernel": "popcount",
          "timing_shape": [n_words, n_rows, n_cols], "kernel_ms": k_ms,
          "eager_ms": e_ms, "plain_ms": p_ms, "bound_ms": b_ms,
          "bound_by": b_by,
          "bound_rate": "POPC 16/clk/SM x 132 SMs x 1.98 GHz = "
                        f"{POPC_PER_S:.4g}/s; HBM 3.35 TB/s",
          "library_ms": None, "dense_equiv_ms": d_ms,
          "library_note": "no PyTorch call computes a popcount product; "
                          "dense_equiv_ms is the same counts through "
                          "unpack_bits + a float32 one-hot matmul"})


def kernels_fused(torch, results):
    """B4 at the stream headline's block
    (5120 columns x d=50, 100 lanes, k_max 20, k 20 and 7, 4 words, row0 0;
    also at 1, 3 and 32 splits of a word's lanes), at the shard blocks of
    the ``mesh`` phase's stream on (h=2, n=2) (row shard 0's or 1's 2500
    elements in its 2560 columns; 'h' row 0's or 1's 50 lanes, gathered
    along 'n', at row0 0 or 50 of the 4-word block), the reference's
    ragged probe (300 columns, 13 lanes, d 7, k_max 5, 2 words, row0 3), a block whose
    lanes do not fill a word and straddle two (640 columns, 45 lanes at
    row0 17, d 24, k_max 9, 2 words) and a block whose slots only fit
    unpadded, read one at a time (300 columns, 13 lanes, d 445, k_max 2,
    1 word, row0 5).  On data quantised to 1/8 the planes equal the plain
    version; on raw blobs they equal the card's unfused route
    (assign_labels + pack_label_planes) on the same centroids."""
    from consensus_clustering_tpu_torch import rng
    from consensus_clustering_tpu_torch.ops import fused_block
    from consensus_clustering_tpu_torch.ops.bitpack import (
        pack_cosample_planes,
        pack_label_planes,
    )
    from consensus_clustering_tpu_torch.ops.resample import resample_indices

    g = torch.Generator(device="cuda").manual_seed(4)

    def block(x, n_cols, n_lanes, k_max, n_words, row0, seed):
        n, d = x.shape
        idx = resample_indices(rng.prng_key(seed, "cuda"), n, n_lanes,
                               int(0.8 * n))
        x_cols = torch.zeros((n_cols, d), device="cuda")
        x_cols[:n] = x
        cop = pack_cosample_planes(idx, n_cols, n_words=n_words, row0=row0)
        pick = torch.randint(0, n, (n_lanes, k_max), generator=g,
                             device="cuda")
        return x_cols, idx, cop, x[pick]

    def unfused(x_cols, idx, cents, k, cop, row0, n_words):
        lanes = cents.shape[0]
        labels, _ = fused_block.assign_labels(
            x_cols[None], torch.zeros(lanes, dtype=torch.int64,
                                      device="cuda"), cents, k)
        gathered = torch.gather(labels, 1, idx)
        return pack_label_planes(gathered, idx, cents.shape[1],
                                 x_cols.shape[0], n_words=n_words, row0=row0)

    x_head = torch.tensor(headline_data(), device="cuda")
    x_rag = torch.randn((300, 7), generator=g, device="cuda") * 3
    x_part = torch.randn((600, 24), generator=g, device="cuda") * 3
    x_scalar = torch.randn((300, 445), generator=g, device="cuda") * 3
    layout = fused_block.fused_layout(445, 2)
    check(layout is not None and not layout[2],
          f"B4 scalar case: not the scalar layout: {layout}")
    worst = 0
    for shape, x, n_cols, lanes, k_max, n_words, row0, ks in (
        ("headline", x_head, 5120, 100, 20, 4, 0, (20, 7)),
        ("mesh shard r=0 h=0", x_head[:2500], 2560, 50, 20, 4, 0, (20, 7)),
        ("mesh shard r=1 h=1", x_head[2500:], 2560, 50, 20, 4, 50, (20, 7)),
        ("ragged probe", x_rag, 300, 13, 5, 2, 3, (4,)),
        ("partial words, row0 17", x_part, 640, 45, 9, 2, 17, (9, 5)),
        ("scalar layout", x_scalar, 300, 13, 2, 1, 5, (2, 1)),
    ):
        for data in ("quantised", "raw"):
            xs = torch.round(x * 8) / 8 if data == "quantised" else x
            x_cols, idx, cop, cents = block(xs, n_cols, lanes, k_max,
                                            n_words, row0, lanes)
            for k in ks:
                got = fused_block.fused_assign_pack_kernel(
                    x_cols, cents, k, cop, row0, n_words)
                plain = fused_block.fused_planes_plain(
                    x_cols, cents, k, cop, row0, n_words)
                route = unfused(x_cols, idx, cents, k, cop, row0, n_words)
                torch.cuda.synchronize()
                eq_plain = bool(torch.equal(got, plain))
                eq_route = bool(torch.equal(got, route))
                if shape == "headline":
                    for n in (1, 3, 32):
                        other = fused_block.fused_assign_pack_kernel(
                            x_cols, cents, k, cop, row0, n_words, splits=n)
                        check(bool(torch.equal(got, other)),
                              f"B4 at {n} splits a word != default "
                              f"({data}, k={k})")
                if data == "quantised":
                    check(eq_plain, f"B4 != plain ({shape}, k={k})")
                check(eq_route, f"B4 != unfused route ({shape}, {data}, "
                                f"k={k})")
                emit({"phase": "kernels", "kernel": "fused_block",
                      "case": f"{shape} {data}", "k": k,
                      "x_cols": list(x_cols.shape), "lanes": lanes,
                      "k_max": k_max, "n_words": n_words, "row0": row0,
                      "equal_plain": eq_plain,
                      "equal_unfused_route": eq_route,
                      "nonzero_words": int((got != 0).sum())})
    # Timing at the headline block, raw data, k = 20.
    x_cols, idx, cop, cents = block(x_head, 5120, 100, 20, 4, 0, 100)
    k_ms = device_ms(torch, lambda: fused_block.fused_assign_pack_kernel(
        x_cols, cents, 20, cop, 0, 4), 20)
    e_ms = cuda_ms(torch, lambda: fused_block.fused_assign_pack_kernel(
        x_cols, cents, 20, cop, 0, 4), 20)
    p_ms = cuda_ms(torch, lambda: fused_block.fused_planes_plain(
        x_cols, cents, 20, cop, 0, 4), 3)
    n_cols, d = x_cols.shape
    sampled = int(idx.numel())  # the co-sampled (lane, column) pairs
    n_ops = sampled * 20 * (2 * d + 3) + n_cols * 2 * d + 100 * 20 * 2 * d
    n_bytes = 4 * (n_cols * d + 100 * 20 * d + 4 * n_cols + 20 * 4 * n_cols)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    results["fused_block"] = {
        "name": "fused_block", "route": "cuda",
        "source": "consensus_clustering_tpu_torch/csrc/fused_block.cu",
        "replaces": "consensus_clustering_tpu/ops/pallas_fused_block.py:69",
        "launches": None, "max_abs_err": worst, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": [n_cols, d, 100, 20, 4],
        "redesigned": True, "eager_ms": e_ms,
    }
    emit({"phase": "kernels", "kernel": "fused_block",
          "timing_shape": [n_cols, d, 100, 20, 4], "kernel_ms": k_ms,
          "eager_ms": e_ms, "plain_ms": p_ms, "bound_ms": b_ms,
          "bound_by": b_by,
          "library_ms": None,
          "library_note": "no PyTorch call computes a nearest-centroid "
                          "assignment packed into bit-planes"})


def kernels_kmeanspp(torch, results):
    """The k-means++ draws and prologue (``ops/kmeanspp``) bit for bit
    against their plain versions at the benchmark's seeding step shapes:
    16 resamples x 3 restarts (``cluster_batch=16``, ``n_init=3``) of
    80,000 rows (``est100k``: 0.8 of N=100,000) and of 16,000 rows
    (``blobs20k``), T = 5 trials (2 + ceil(ln k_max), k_max 20 and 10),
    D^2 to each lane's first centre on the 8-blob data, steps 1, 2 and 19.
    Timing of a step's draw at both shapes beside its bound (integer
    operations: draws x KMEANSPP_HASH_OPS at the int32 rate; D^2 bytes)
    and the plain version's time."""
    from consensus_clustering_tpu_torch import rng
    from consensus_clustering_tpu_torch.data import make_blobs
    from consensus_clustering_tpu_torch.ops import kmeanspp
    from consensus_clustering_tpu_torch.ops.resample import resample_indices

    timings = {}
    for name, n_all, rows in (("est100k", 100_000, 80_000),
                              ("blobs20k", 20_000, 16_000)):
        bsz, restarts, trials = 16, 3, 5
        x_np, _ = make_blobs(n_samples=n_all, n_features=50, centers=8,
                             cluster_std=3.0, random_state=0)
        x_all = torch.tensor(x_np, dtype=torch.float32, device="cuda")
        xs = x_all[resample_indices(rng.prng_key(23, "cuda"), n_all, bsz,
                                    rows)]
        keys = rng.split(rng.split(rng.prng_key(23, "cuda"), bsz), restarts)
        key_rest, first = kmeanspp.seed_keys_kernel(keys, rows)
        key_rest_p, first_p = kmeanspp.seed_keys_plain(keys, rows)
        pro_ok = bool(torch.equal(key_rest, key_rest_p)
                      and torch.equal(first, first_p))
        check(pro_ok, f"kmeanspp prologue != split + randint ({name})")
        x_first = xs[torch.arange(bsz, device="cuda")[:, None], first]
        d2 = ((xs[:, None] - x_first[:, :, None]) ** 2).sum(-1)
        same = []
        for j in (1, 2, 19):
            got = kmeanspp.draw_candidates_kernel(key_rest, j, d2, trials)
            ref = kmeanspp.draw_candidates_plain(key_rest, j, d2, trials)
            same.append(bool(torch.equal(got, ref)))
        torch.cuda.synchronize()
        check(all(same), f"kmeanspp draw != plain ({name}): steps 1, 2, 19 "
                         f"equal {same}")

        def draw():
            return kmeanspp.draw_candidates_kernel(key_rest, 1, d2, trials)

        lanes = bsz * restarts
        b_ms, b_by = bound_ms(4 * lanes * rows + 8 * lanes * trials,
                              lanes * rows * trials * KMEANSPP_HASH_OPS,
                              INT32_OPS_PER_S)
        timing = {
            "shape": [lanes, rows, trials], "ms": device_ms(torch, draw, 50),
            "eager_ms": cuda_ms(torch, draw, 50),
            "plain_ms": cuda_ms(torch, lambda: kmeanspp.draw_candidates_plain(
                key_rest, 1, d2, trials), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "prologue_ms": device_ms(
                torch, lambda: kmeanspp.seed_keys_kernel(keys, rows), 50),
            "prologue_plain_ms": cuda_ms(
                torch, lambda: kmeanspp.seed_keys_plain(keys, rows), 5)}
        timings[name] = timing
        emit({"phase": "kernels", "kernel": "kmeanspp", "case": name,
              "prologue_equal_plain": pro_ok,
              "draws_equal_plain": same, **timing})
    results["kmeanspp"] = {
        "name": "kmeanspp", "route": "cuda",
        "source": "consensus_clustering_tpu_torch/csrc/kmeanspp.cu",
        "replaces": "no Pallas kernel: consensus_clustering_tpu/models/"
                    "kmeans.py:55 (its fori_loop, compiled by XLA)",
        "launches": None, "max_abs_err": 0.0,
        "ms": timings["est100k"]["ms"],
        "plain_ms": timings["est100k"]["plain_ms"],
        "bound_ms": timings["est100k"]["bound_ms"],
        "bound_by": timings["est100k"]["bound_by"], "library_ms": None,
        "shape": timings["est100k"]["shape"], "redesigned": False,
        "eager_ms": timings["est100k"]["eager_ms"], "shapes": timings,
    }


# -- phases 3 and 4 -----------------------------------------------------


def _pac_checks(name, ks, pac):
    check(bool(np.isfinite(pac).all() and (pac >= 0).all()
               and (pac <= 1).all()), f"{name}: PAC not finite in [0, 1]: "
                                      f"{pac}")
    # The data hold 8 blobs: the curve falls (within 0.02) from K=2 to its
    # elbow at K=8, which sits at the minimum (+0.02).  Past it PAC rises a
    # little, as splitting true blobs makes co-clustering ambiguous.
    elbow = ks.index(8)
    head = pac[:elbow + 1]
    check(all(a >= b - 0.02 for a, b in zip(head, head[1:])),
          f"{name}: PAC rises before the elbow at K=8: {head}")
    check(pac[elbow] <= pac.min() + 0.02,
          f"{name}: PAC(K=8)={pac[elbow]} is not at the minimum {pac.min()}")


def _drive(torch, phase, results, pin=None, **kwargs):
    """Fit the headline data with the kernels' launch counts set to 0 just
    before; emit the run and return (fit, launches).  The launches must
    equal ``PINNED_LAUNCHES[pin or phase]``."""
    from consensus_clustering_tpu_torch import ConsensusClustering
    from consensus_clustering_tpu_torch.ops import (
        kmeanspp,
        launch_counts,
        reset_launch_counts,
    )

    x = headline_data()
    cc = ConsensusClustering(**HEADLINE, **kwargs, plot_cdf=False)
    reset_launch_counts()
    kmeanspp.launch_count = 0
    t0 = time.perf_counter()
    cc.fit(x)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if "kmeanspp" in results:
        results["kmeanspp"].setdefault("launches_by_phase", {})[phase] = (
            kmeanspp.launch_count)
    ks = list(HEADLINE["K_range"])
    pac = np.array([cc.cdf_at_K_data[k]["pac_area"] for k in ks])
    m = cc.metrics_
    emit({"phase": phase, "nvidia_smi": smi_line(),
          "config": "make_blobs N=5000 d=50 centers=8 std=3, H=500, "
                    "K=2..20, KMeans(n_init=3), cluster_batch=16, "
                    "chunk_size=4, seed 23" + "".join(
                        f", {k}={v!r}" for k, v in kwargs.items()),
          "wall_seconds": wall, "run_seconds": m["run_seconds"],
          "resamples_per_second": m["resamples_per_second"],
          "peak_device_bytes": m["device_memory"]["peak_bytes_in_use"],
          "launches": launches, "kmeanspp_launches": kmeanspp.launch_count,
          "strategy": m.get("timing", {}),
          "pac": pac.tolist(), "best_k": cc.best_k_})
    check(m["kernel_launches"] == launches,
          f"{phase}: metrics_ launch counts differ")
    _pac_checks(phase, ks, pac)
    same_pac = [float(a) == b for a, b in zip(pac, PINNED_PAC)]
    pinned = PINNED_LAUNCHES[pin or phase]
    emit({"phase": phase, "launches_equal_pinned": launches == pinned,
          "pac_equal_pinned_per_k": same_pac})
    check(launches == pinned, f"{phase}: launches {launches} != pinned "
                              f"{pinned}")
    check(all(same_pac), f"{phase}: per-K PAC differs from the pinned run "
                         f"at K={[k for k, e in zip(ks, same_pac) if not e]}")
    _record_launches(results, phase, launches)
    results[f"{phase}_wall"] = wall
    return cc, launches


def _record_launches(results, phase, launches):
    for name, n in launches.items():
        if name in results:
            results[name].setdefault("launches_by_phase", {})[phase] = n


def phase_headline(torch, results):
    cc, launches = _drive(torch, "headline", results)
    results["headline_fit"] = cc
    for name in ("hist", "lloyd", "assign"):
        if name in results:
            results[name]["launches"] = launches[name]
    check(launches["hist"] == len(HEADLINE["K_range"]),
          f"hist launches {launches['hist']}")
    check(launches["lloyd"] > 0, "the Lloyd kernel never launched")
    check(launches["assign"] > 0, "the assignment kernel never launched")


def phase_stream(torch, results):
    cc, launches = _drive(torch, "stream", results, **STREAM)
    results["stream_fit"] = cc
    ks = list(HEADLINE["K_range"])
    n_blocks, n_tiles = 5, 20
    # Per block and row tile: one Iij tile, then each K's Mij tile.
    expected = {"fused_block": len(ks) * n_blocks,
                "hist": n_tiles * len(ks) * n_blocks,
                "popcount": n_tiles * (len(ks) + 1) * n_blocks}
    s = cc.metrics_["streaming"]
    emit({"phase": "stream", "pac_trajectory": s["pac_trajectory"],
          "h_effective": s["h_effective"], "n_blocks_run": s["n_blocks_run"],
          "expected_launches": expected})
    for name in ("popcount", "fused_block"):
        if name in results:
            results[name]["launches"] = launches[name]
    check(cc.metrics_["timing"] == {"packed_kernel": "cuda",
                                    "fuse_block": "fused",
                                    "fused_kernel": "cuda"},
          f"stream: strategy {cc.metrics_['timing']}")
    check(all(n > 0 for n in launches.values()),
          f"stream: a kernel of the path never launched: {launches}")
    for name, n in expected.items():
        check(launches[name] == n,
              f"stream: {name} launches {launches[name]}, expected {n}")
    check(s["h_effective"] == 500 and s["n_blocks_run"] == n_blocks,
          f"stream: {s['n_blocks_run']} blocks, h_effective "
          f"{s['h_effective']}")
    dense = results.get("headline_fit")
    if dense is None:
        # Only a subset run (--phases without headline) gets here.
        emit({"phase": "stream", "equal_to_headline_per_k":
              "not run: the headline phase did not run in this call"})
        return
    common = [k for k in ks if k in dense.cdf_at_K_data]
    same = [bool(np.array_equal(cc.cdf_at_K_data[k]["hist"],
                                dense.cdf_at_K_data[k]["hist"]))
            and cc.cdf_at_K_data[k]["pac_area"]
            == dense.cdf_at_K_data[k]["pac_area"] for k in common]
    emit({"phase": "stream", "equal_to_headline_per_k": same})
    check(all(same), "stream: per-K hist/PAC differ from the dense headline "
                     f"at K={[k for k, e in zip(common, same) if not e]}")


# -- phase 5 -------------------------------------------------------------


def phase_resume(torch, results):
    """The stream's fit cut by a fault before block 3 and resumed from
    the ring, with the sentinel on every block: the main path of the
    resilience layer at the headline's full width."""
    from consensus_clustering_tpu_torch import ConsensusClustering
    from consensus_clustering_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from consensus_clustering_tpu_torch.resilience import (
        InjectedFault,
        faults,
    )
    from consensus_clustering_tpu_torch.resilience.blocks import decode_frame

    x = headline_data()
    ks = list(HEADLINE["K_range"])
    per_check = len(ks) + 1  # the packed sentinel's B3 launches a check
    with tempfile.TemporaryDirectory() as tmp:
        kwargs = dict(HEADLINE, **STREAM, integrity_check_every=1,
                      checkpoint_dir=tmp)
        reset_launch_counts()
        faults.configure("block_start=3")
        first_checks = None
        t0 = time.perf_counter()
        try:
            ConsensusClustering(**kwargs, plot_cdf=False).fit(x)
        except InjectedFault as e:
            first_checks = e.integrity_checks_run
        finally:
            faults.clear()
        first_wall = time.perf_counter() - t0
        ring = os.path.join(tmp, "stream")
        gens = sorted(os.listdir(ring))
        frame_bytes = [os.path.getsize(os.path.join(ring, g)) for g in gens]
        with open(os.path.join(ring, gens[-1]), "rb") as f:
            header, arrays = decode_frame(f.read())
        t0 = time.perf_counter()
        cc = ConsensusClustering(**kwargs, plot_cdf=False).fit(x)
        second_wall = time.perf_counter() - t0
        launches = launch_counts()
        left = sorted(os.listdir(tmp))
    _record_launches(results, "resume", launches)
    s = cc.metrics_["streaming"]
    writes = max(s["checkpoint_writes"], 1)
    pac = np.array([cc.cdf_at_K_data[k]["pac_area"] for k in ks])
    same_pac = [float(a) == b for a, b in zip(pac, PINNED_PAC)]
    pinned = dict(PINNED_LAUNCHES["stream"])
    pinned["popcount"] += 5 * per_check
    sentinel = _packed_sentinel_on_frame(torch, header, arrays)
    stream_wall = results.get("stream_wall")
    emit({"phase": "resume", "nvidia_smi": smi_line(),
          "first_fit_raised": first_checks is not None,
          "first_fit_checks": first_checks, "ring_after_fault": gens,
          "resumed_from_block": s["resumed_from_block"],
          "integrity_checks": s["integrity_checks"],
          "checkpoint_writes": s["checkpoint_writes"],
          "first_wall_seconds": first_wall,
          "second_wall_seconds": second_wall,
          "pair_wall_seconds": first_wall + second_wall,
          "stream_wall_seconds": stream_wall,
          "pair_over_stream": (first_wall + second_wall) / stream_wall
          if stream_wall else "not run: the stream phase did not run",
          "ring_seconds_per_generation":
              s["checkpoint_write_seconds"] / writes,
          "frame_bytes": frame_bytes,
          "host_copy_seconds_per_block":
              s["checkpoint_copy_seconds"] / writes,
          "restore_seconds": s["restore_seconds"],
          "sentinel_seconds_per_check_in_run":
              s["integrity_seconds"] / max(s["integrity_checks"], 1),
          "packed_sentinel_ms": sentinel["ms"],
          "packed_sentinel_counts": sentinel["counts"],
          "sentinel_spot_rows": {k: sentinel[f"spot_rows_{k}"] for k in (
              "max_abs_err", "count_sum", "shapes")},
          "launches": launches, "expected_launches": pinned,
          "dir_after": left})
    check(first_checks == 3, f"resume: the first fit raised with "
                             f"{first_checks} checks, expected 3")
    check(gens == ["gen-00000001.ckpt", "gen-00000002.ckpt"],
          f"resume: ring after the fault {gens}")
    check(s["resumed_from_block"] == 3 and s["integrity_checks"] == 2,
          f"resume: resumed from {s['resumed_from_block']} with "
          f"{s['integrity_checks']} checks")
    check(launches == pinned, f"resume: launches {launches} != {pinned}")
    check(all(same_pac), "resume: per-K PAC differs from the pinned run at "
                         f"K={[k for k, e in zip(ks, same_pac) if not e]}")
    check(left == [f"k{k:04d}.npz" for k in ks] + ["stream",
                                                    "sweep_meta.json"],
          f"resume: checkpoint dir after the fit {left}")
    check(not any(sentinel["counts"].values()),
          f"resume: packed sentinel on generation 2: {sentinel['counts']}")
    check(sentinel["equal_cpu"], "resume: packed sentinel card != CPU")
    check(sentinel["spot_rows_max_abs_err"] == 0
          and sentinel["spot_rows_count_sum"] > 0,
          "resume: B3 at the sentinel's spot rows != plain popcount "
          f"(max err {sentinel['spot_rows_max_abs_err']}, count sum "
          f"{sentinel['spot_rows_count_sum']})")
    stream = results.get("stream_fit")
    if stream is None:
        emit({"phase": "resume", "hist_equal_to_stream_per_k":
              "not run: the stream phase did not run in this call"})
        return
    same = [bool(np.array_equal(cc.cdf_at_K_data[k]["hist"],
                                stream.cdf_at_K_data[k]["hist"]))
            for k in ks]
    emit({"phase": "resume", "hist_equal_to_stream_per_k": same})
    check(all(same), "resume: per-K hist differs from the stream phase")


def _packed_sentinel_on_frame(torch, header, arrays):
    """The packed sentinel on a ring generation's state on the card: its
    counts, its ms a check (CUDA events), whether B3's spot-row counts
    (what the sentinel judges) equal the plain popcount on the same words
    for Iij and every K, and whether the counts equal the sentinel's CPU
    run on the same state, clean and with one bit flipped."""
    from consensus_clustering_tpu_torch.ops.bitpack import (
        popcount_accumulate,
    )
    from consensus_clustering_tpu_torch.ops.popcount import (
        packed_coassoc_counts,
    )
    from consensus_clustering_tpu_torch.resilience import integrity

    host = {name: np.ascontiguousarray(arrays[f"state_{name}"]).view(
        np.int32) for name in ("planes", "coplanes")}
    state = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    fn = integrity.build_packed_sentinel(int(header["hb_pad"]),
                                         host["planes"].shape[1])
    h_seen, n = int(header["h_done"]), 5000
    idx = integrity.sentinel_sample_rows(n, header["block_index"])
    counts = fn(state, h_seen, idx)
    ms = cuda_ms(torch, lambda: fn(state, h_seen, idx), 5)
    cop = state["coplanes"]
    spot = torch.as_tensor(idx, dtype=torch.int64, device="cuda")
    spot_err, spot_sum = 0, 0
    for words in [cop] + [p.reshape(-1, cop.shape[1])
                          for p in state["planes"]]:
        got = packed_coassoc_counts(words[:, spot], words)
        ref = popcount_accumulate(words[:, spot], words)
        spot_err = max(spot_err, int((got.long() - ref.long()).abs().max()))
        spot_sum += int(ref.long().sum())
    equal_cpu = True
    for flips in (0, 1):
        if flips:
            integrity.flip_array_bits(state["planes"], 1, seed=3)
        cpu = {k: v.cpu() for k, v in state.items()}
        got = fn(state, h_seen, idx)
        equal_cpu &= got == fn(cpu, h_seen, idx)
        equal_cpu &= bool(any(got.values())) == bool(flips)
    return {"counts": counts, "ms": ms, "equal_cpu": equal_cpu,
            "spot_rows_max_abs_err": spot_err, "spot_rows_count_sum": spot_sum,
            "spot_rows_shapes": [[cop.shape[0], len(idx), cop.shape[1]],
                                 [cop.shape[0] * state["planes"].shape[1],
                                  len(idx), cop.shape[1]]]}


# -- phase 8 -------------------------------------------------------------

_SMALL_X = dict(n_samples=300, n_features=8, centers=4, cluster_std=2.0,
                random_state=5)
_KILLED_RUN = """
import sys
import numpy as np
from consensus_clustering_tpu_torch import make_blobs
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.models.kmeans import KMeans
from consensus_clustering_tpu_torch.parallel.streaming import StreamingSweep
from consensus_clustering_tpu_torch.resilience import StreamCheckpointer
x = make_blobs(**{x_kwargs})[0].astype(np.float32)
cfg = SweepConfig(**{cfg_kwargs})
StreamingSweep(KMeans(n_init=2), cfg, device="cuda").run(
    x, 7, 60, checkpointer=StreamCheckpointer(sys.argv[1]))
"""


def phase_resilience_small(torch):
    from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.parallel.streaming import (
        StreamingSweep,
    )
    from consensus_clustering_tpu_torch.resilience import (
        InjectedFault,
        IntegrityError,
        StreamCheckpointer,
        faults,
    )

    x = make_blobs(**_SMALL_X)[0].astype(np.float32)
    cfg_kwargs = dict(n_samples=300, n_features=8, k_values=(2, 3, 4, 5, 6),
                      n_iterations=60, store_matrices=False,
                      stream_h_block=16)
    keys = ("hist", "cdf", "pac_area")

    def same(a, b):
        return all(np.array_equal(a[k], b[k]) for k in keys) and (
            a["streaming"]["pac_trajectory"]
            == b["streaming"]["pac_trajectory"])

    def armed(plan, fn):
        """``fn()``'s exception (None if it returned) with ``plan`` armed,
        disarmed afterwards whatever happens."""
        faults.configure(plan)
        try:
            fn()
        except (InjectedFault, IntegrityError) as e:
            return e
        finally:
            faults.clear()
        return None

    report = {}
    engines, refs = {}, {}
    for repr_ in ("dense", "packed"):
        eng = StreamingSweep(KMeans(n_init=2), SweepConfig(
            **cfg_kwargs, accum_repr=repr_), device="cuda")
        engines[repr_], refs[repr_] = eng, eng.run(x, 7, 60)
        with tempfile.TemporaryDirectory() as tmp:
            ck = StreamCheckpointer(tmp)
            err = armed("accumulator=1:bitflip", lambda: eng.run(
                x, 7, 60, checkpointer=ck, integrity_check_every=1))
            got = eng.run(x, 7, 60, checkpointer=ck, integrity_check_every=1)
            ck.close()
        report[f"a_{repr_}"] = ok = (
            isinstance(err, IntegrityError) and err.point == "accumulator"
            and err.block == 1
            and got["streaming"]["resumed_from_block"] == 1
            and same(got, refs[repr_]))
        check(ok, f"resilience_small (a) {repr_}: {err!r}, resumed from "
                  f"{got['streaming']['resumed_from_block']}")
    eng, ref = engines["packed"], refs["packed"]
    with tempfile.TemporaryDirectory() as tmp:
        ck = StreamCheckpointer(tmp)
        err = armed("checkpoint_payload=2:bitflip,block_start=3",
                    lambda: eng.run(x, 7, 60, checkpointer=ck,
                                    integrity_check_every=1))
        got = eng.run(x, 7, 60, checkpointer=ck, integrity_check_every=1)
        ck.close()
    report["b"] = ok = (isinstance(err, InjectedFault)
                        and ck.verify_rejects == 1
                        and got["streaming"]["resumed_from_block"] == 2
                        and same(got, ref))
    check(ok, f"resilience_small (b): {err!r}, rejects {ck.verify_rejects},"
              f" resumed from {got['streaming']['resumed_from_block']}")
    with tempfile.TemporaryDirectory() as tmp:
        code = _KILLED_RUN.format(x_kwargs=repr(_SMALL_X), cfg_kwargs=repr(
            dict(cfg_kwargs, accum_repr="packed")))
        proc = subprocess.run(
            [sys.executable, "-c", code, tmp], cwd=REPO, timeout=600,
            env={**os.environ, "CCTPU_FAULTS": "block_start=2:kill"})
        ck = StreamCheckpointer(tmp)
        got = eng.run(x, 7, 60, checkpointer=ck)
        ck.close()
    report["c_exit_code"] = proc.returncode
    report["c_resumed_from_block"] = got["streaming"]["resumed_from_block"]
    report["c"] = ok = (proc.returncode == 137
                        and report["c_resumed_from_block"] in (1, 2)
                        and same(got, ref))
    check(ok, f"resilience_small (c): exit {proc.returncode}, resumed from "
              f"{report['c_resumed_from_block']}")
    kw = dict(n_iterations=40, random_state=7, store_matrices=True,
              cluster_batch=16)
    fresh = ConsensusClustering(K_range=range(2, 7), **kw,
                                plot_cdf=False).fit(x)
    seen = []
    with tempfile.TemporaryDirectory() as tmp:
        ConsensusClustering(K_range=range(2, 5), checkpoint_dir=tmp,
                            **kw, plot_cdf=False).fit(x)
        wider = ConsensusClustering(
            K_range=range(2, 7), checkpoint_dir=tmp,
            progress_callback=lambda k, p: seen.append((k, p)), **kw,
            plot_cdf=False).fit(x)
    report["d"] = ok = wider.metrics_.get("resumed_ks") == [2, 3, 4] and all(
        np.array_equal(wider.cdf_at_K_data[k][name],
                       fresh.cdf_at_K_data[k][name])
        for k in range(2, 7) for name in keys + ("mij", "iij", "cij"))
    check(ok, f"resilience_small (d): resumed {wider.metrics_.get('resumed_ks')}"
              ", or a K differs from a fresh fit")
    report["e"] = ok = seen == [
        (k, wider.cdf_at_K_data[k]["pac_area"]) for k in (5, 6)]
    check(ok, f"resilience_small (e): progress {seen}")
    report["f"] = _dense_sentinel_full_shape(torch)
    emit({"phase": "resilience_small", **report})


def _dense_sentinel_full_shape(torch):
    """(f): the dense sentinel on a valid state of the dense stream's full
    shape (Iij of the headline's plan, Mij = Iij for each of 19 K), on
    the card against its CPU run, clean and with one bit flipped."""
    from consensus_clustering_tpu_torch import rng
    from consensus_clustering_tpu_torch.ops.resample import (
        cosample_counts,
        resample_indices,
    )
    from consensus_clustering_tpu_torch.resilience import integrity

    n, h = 5000, 500
    key = rng.split(rng.prng_key(23, "cuda"))[0]
    iij = cosample_counts(resample_indices(key, n, h, 4000), n)
    state = {"iij": iij, "mij": iij[None].repeat(19, 1, 1)}
    fn = integrity.build_sentinel()
    idx = integrity.sentinel_sample_rows(n, 4)
    clean = fn(state, h, idx)
    ms = cuda_ms(torch, lambda: fn(state, h, idx), 3)
    integrity.flip_array_bits(state["mij"], 1, seed=4)
    flipped = fn(state, h, idx)
    cpu = fn({k: v.cpu() for k, v in state.items()}, h, idx)
    out = {"shape": list(state["mij"].shape), "clean": clean,
           "flipped": flipped, "flipped_cpu": cpu, "ms": ms}
    check(not any(clean.values()), f"resilience_small (f): clean {clean}")
    check(flipped == cpu and any(flipped.values()),
          f"resilience_small (f): card {flipped} != CPU {cpu}")
    return out


# -- phase 6 -------------------------------------------------------------


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
            plot_cdf=False,
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


# -- phase 7 -------------------------------------------------------------


def phase_stream_small(torch):
    from consensus_clustering_tpu_torch import make_blobs
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.parallel.streaming import (
        StreamingSweep,
        run_streaming_sweep,
    )
    from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

    x, _ = make_blobs(n_samples=300, n_features=8, centers=4,
                      cluster_std=2.0, random_state=5)
    x = x.astype(np.float32)
    base = SweepConfig(n_samples=300, n_features=8, k_values=(2, 3, 4, 5, 6),
                       n_iterations=60, store_matrices=True)
    km = KMeans(n_init=2)
    mono = run_sweep(km, base, x, 7, device="cuda")
    stream = {}
    for repr_ in ("dense", "packed"):
        cfg = dataclasses.replace(base, stream_h_block=16, accum_repr=repr_)
        stream[repr_] = run_streaming_sweep(km, cfg, x, 7, device="cuda")
    keys = ("mij", "iij", "cij", "hist", "cdf", "pac_area")
    dense_eq = {k: bool(np.array_equal(stream["dense"][k], mono[k]))
                for k in keys}
    packed_eq = {k: bool(np.array_equal(stream["packed"][k], mono[k]))
                 for k in keys}
    captured = {}
    for fuse in ("on", "off", "cpu"):
        cfg = dataclasses.replace(base, stream_h_block=16,
                                  accum_repr="packed", store_matrices=False,
                                  fuse_block="off" if fuse == "off" else "on")
        eng = StreamingSweep(km, cfg, device="cpu" if fuse == "cpu" else
                             "cuda")
        captured[fuse] = eng.run(x, 7, 60, capture_state=True)
    planes_eq = bool(np.array_equal(captured["on"]["final_state"]["planes"],
                                    captured["off"]["final_state"]["planes"]))
    cop_eq = bool(np.array_equal(captured["on"]["final_state"]["coplanes"],
                                 captured["cpu"]["final_state"]["coplanes"]))
    pac_gap = float(np.abs(captured["on"]["pac_area"]
                           - captured["cpu"]["pac_area"]).max())
    cpu_mono = run_sweep(km, base, x, 7, device="cpu")
    iij_eq = bool(np.array_equal(cpu_mono["iij"], mono["iij"]))
    emit({"phase": "stream_small", "streamed_dense_equals_monolithic":
          dense_eq, "packed_equals_dense": packed_eq,
          "fused_planes_equal_unfused": planes_eq,
          "card_cpu_iij_equal": iij_eq, "card_cpu_coplanes_equal": cop_eq,
          "card_cpu_max_pac_gap": pac_gap,
          "launches": stream["packed"]["timing"]["kernel_launches"]})
    check(all(dense_eq.values()),
          f"stream_small: streamed dense != monolithic: {dense_eq}")
    check(all(packed_eq.values()),
          f"stream_small: packed != dense: {packed_eq}")
    check(planes_eq, "stream_small: fused planes != unfused planes")
    check(iij_eq and cop_eq, "stream_small: Iij or coplanes differ between "
                             "the card and the CPU")
    check(pac_gap <= 0.02, f"stream_small: card/CPU PAC gap {pac_gap}")


# -- phase 9 -------------------------------------------------------------


def phase_corr(torch):
    from consensus_clustering_tpu_torch import ConsensusClustering, load_corr

    with open(os.path.join(REPO, "tests", "fixtures",
                           "reference_goldens.json")) as f:
        goldens = json.load(f)
    ks = list(range(2, 15))
    cc = ConsensusClustering(K_range=range(2, 15), random_state=23,
                             n_iterations=30, store_matrices=True,
                             plot_cdf=False)
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


# -- phase 10 ------------------------------------------------------------


def _fit_counted(torch, name, x, **kwargs):
    """``ConsensusClustering(**kwargs)`` fitted on the card (``fit_predict``
    when ``kwargs`` asks for it) with the launch counts set to 0 just
    before; emits the run; returns (fit, launches, wall, labels)."""
    from consensus_clustering_tpu_torch import ConsensusClustering
    from consensus_clustering_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )

    predict = kwargs.pop("predict", False)
    cc = ConsensusClustering(device="cuda", progress=False, **kwargs,
                             plot_cdf=False)
    reset_launch_counts()
    t0 = time.perf_counter()
    labels = cc.fit_predict(x) if predict else cc.fit(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    ks = list(cc.cdf_at_K_data)
    pac = np.array([cc.cdf_at_K_data[k]["pac_area"] for k in ks])
    emit({"phase": "clusterers", "fit": name, "nvidia_smi": smi_line(),
          "wall_seconds": wall, "run_seconds": cc.metrics_["run_seconds"],
          "resamples_per_second": cc.metrics_["resamples_per_second"],
          "launches": launches, "ks": ks, "pac": pac.tolist(),
          "best_k": cc.best_k_})
    swept = cc.metrics_["kernel_launches"]
    if predict or kwargs.get("compute_consensus_labels"):
        # The consensus labels run after the sweep (spectral: B2, the
        # assignment), so the sweep's own counts may be lower.
        check(all(swept[k] <= n for k, n in launches.items())
              and swept["hist"] == launches["hist"],
              f"clusterers/{name}: metrics_ launch counts {swept}")
    else:
        check(swept == launches,
              f"clusterers/{name}: metrics_ launch counts differ")
    check(bool(np.isfinite(pac).all() and (pac >= 0).all()
               and (pac <= 1).all()),
          f"clusterers/{name}: PAC not finite in [0, 1]: {pac}")
    return cc, launches, wall, (labels if predict else None)


def adjusted_rand(a, b):
    """The adjusted Rand index of two labellings (numpy only, so that the
    script needs no sklearn)."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1))
    np.add.at(table, (ai, bi), 1)

    def pairs(v):
        return float((v * (v - 1) / 2).sum())

    s_ab, s_a, s_b = pairs(table), pairs(table.sum(1)), pairs(table.sum(0))
    expected = s_a * s_b / pairs(np.array([len(ai)], float))
    top = (s_a + s_b) / 2
    return 1.0 if top == expected else (s_ab - expected) / (top - expected)


class HostLloyd:
    """A host clusterer (``fit_predict_host``) in numpy: Lloyd from k rows
    drawn by ``RandomState(seed)``.  It drives the host backend without
    sklearn; the sklearn adapter's path is tested on the CPU."""

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


def _cpu_fit(x, **kwargs):
    from consensus_clustering_tpu_torch import ConsensusClustering

    return ConsensusClustering(device="cpu", progress=False, **kwargs,
                               plot_cdf=False).fit(x)


def _against_cpu(name, card, x, ks, band, **kwargs):
    """Fits ``kwargs`` on the CPU and holds the card's fit ``card`` to it:
    Iij equal, PAC within ``band`` at every K, and Mij equal at K=8, the
    blob count, where the labels are determined (below it a spectral
    embedding takes columns of a degenerate eigenspace's basis, which
    rounding picks, so the band there is a statistical gate)."""
    ref = _cpu_fit(x, K_range=ks, store_matrices=True, **kwargs)
    iij_eq = bool(np.array_equal(card.cdf_at_K_data[ks[0]]["iij"],
                                 ref.cdf_at_K_data[ks[0]]["iij"]))
    gaps = [abs(card.cdf_at_K_data[k]["pac_area"]
                - ref.cdf_at_K_data[k]["pac_area"]) for k in ks]
    mij_eq = [bool(np.array_equal(card.cdf_at_K_data[k]["mij"],
                                  ref.cdf_at_K_data[k]["mij"])) for k in ks]
    emit({"phase": "clusterers", "fit": name, "card_cpu_iij_equal": iij_eq,
          "card_cpu_pac_gap_per_k": gaps, "pac_band": band,
          "card_cpu_mij_equal_per_k": mij_eq})
    check(iij_eq, f"clusterers/{name}: Iij differs between the card and "
                  "the CPU")
    check(max(gaps) <= band, f"clusterers/{name}: card/CPU PAC gaps {gaps}")
    check(mij_eq[list(ks).index(8)],
          f"clusterers/{name}: card/CPU Mij differ at K=8")


def _grouping(torch, name, x, cluster_batch, ks, **kwargs):
    """Fits ``kwargs`` on the card in one group of resamples and in groups
    of ``cluster_batch``, which must give the same Mij at every K (labels
    are a per-resample function).  Returns the one-group fit."""
    one = _fit_counted(torch, f"{name}/one group", x, K_range=ks,
                       store_matrices=True, **kwargs)[0]
    grouped = _fit_counted(torch, f"{name}/cluster_batch={cluster_batch}",
                           x, K_range=ks, store_matrices=True,
                           cluster_batch=cluster_batch, **kwargs)[0]
    same = [bool(np.array_equal(one.cdf_at_K_data[k]["mij"],
                                grouped.cdf_at_K_data[k]["mij"]))
            for k in ks]
    emit({"phase": "clusterers", "fit": name,
          f"cluster_batch_{cluster_batch}_mij_equal_per_k": same})
    check(all(same), f"clusterers/{name}: cluster_batch={cluster_batch} "
                     f"changes Mij: {same}")
    return one


def phase_clusterers(torch, results):
    from consensus_clustering_tpu_torch import (
        AgglomerativeClustering,
        GaussianMixture,
        SpectralClustering,
        load_corr,
        make_blobs,
    )
    from consensus_clustering_tpu_torch.models.agglomerative import (
        consensus_labels_from_cij,
    )
    from consensus_clustering_tpu_torch.models.kmeans import KMeans

    t_phase = time.perf_counter()
    ks = range(2, 11)
    n_ks = len(ks)
    corr = load_corr(transform=True)

    def record(name, launches):
        _record_launches(results, f"clusterers/{name}", launches)

    # gmm, through fit_predict: the exact agglomerative regime at N=2000.
    x, truth = make_blobs(n_samples=2000, n_features=16, centers=8,
                          cluster_std=3.0, random_state=0)
    x = x.astype(np.float32)
    cc, launches, wall, labels = _fit_counted(
        torch, "gmm", x, clusterer=GaussianMixture(n_init=2),
        clusterer_options={}, K_range=ks, n_iterations=100,
        random_state=23, store_matrices=True, predict=True)
    record("gmm", launches)
    pac = [cc.cdf_at_K_data[k]["pac_area"] for k in ks]
    t0 = time.perf_counter()
    again = consensus_labels_from_cij(cc.cdf_at_K_data[cc.best_k_]["cij"],
                                      cc.best_k_, device="cuda")
    torch.cuda.synchronize()
    exact_seconds = time.perf_counter() - t0
    ari = adjusted_rand(truth, labels)
    emit({"phase": "clusterers", "fit": "gmm",
          "pac_argmin_k": list(ks)[int(np.argmin(pac))],
          "labels_regime": "agglomerative", "labels_n": len(labels),
          "labels_k": cc.best_k_, "labels_seconds": exact_seconds,
          "labels_ari_vs_truth": ari})
    check(launches["lloyd"] > 0 and launches["assign"] > 0
          and launches["hist"] == n_ks,
          f"clusterers/gmm: launches {launches}")
    check(np.array_equal(again, labels) and len(labels) == 2000,
          "clusterers/gmm: fit_predict labels differ from a second "
          "agglomeration of the same Cij")
    check(ari >= 0.95, f"clusterers/gmm: labels ARI {ari} < 0.95")
    # A shorter fit (H=20) one resample a group against one group, and
    # the one-group fit against its CPU run.
    kw = dict(clusterer=GaussianMixture(n_init=2), clusterer_options={},
              n_iterations=20, random_state=23)
    one = _grouping(torch, "gmm", x, 1, ks, **kw)
    _against_cpu("gmm", one, x, ks, 0.02, **kw)

    # agglo: against the CPU run of the same fit.
    kw = dict(clusterer=AgglomerativeClustering(linkage="average"),
              K_range=ks, n_iterations=500, random_state=23,
              store_matrices=True)
    cc, launches, _, _ = _fit_counted(torch, "agglo", corr, **kw)
    record("agglo", launches)
    ref = _cpu_fit(corr, **kw)
    iij_eq = bool(np.array_equal(cc.cdf_at_K_data[2]["iij"],
                                 ref.cdf_at_K_data[2]["iij"]))
    gap = max(abs(cc.cdf_at_K_data[k]["pac_area"]
                  - ref.cdf_at_K_data[k]["pac_area"]) for k in ks)
    mij_eq = [bool(np.array_equal(cc.cdf_at_K_data[k]["mij"],
                                  ref.cdf_at_K_data[k]["mij"])) for k in ks]
    emit({"phase": "clusterers", "fit": "agglo", "card_cpu_iij_equal": iij_eq,
          "card_cpu_max_pac_gap": gap, "card_cpu_mij_equal_per_k": mij_eq})
    check(iij_eq, "clusterers/agglo: Iij differs between the card and the CPU")
    check(gap <= 0.02, f"clusterers/agglo: card/CPU PAC gap {gap}")
    check(launches["hist"] == n_ks and launches["lloyd"] == 0,
          f"clusterers/agglo: launches {launches}")

    # spectral: LOBPCG, then KMeans on the embedding (B2, the assignment);
    # then a shorter fit in groups of 4 resamples against one group, and
    # the one-group fit against its CPU run.
    x30, _ = make_blobs(n_samples=2000, n_features=30, centers=8,
                        cluster_std=3.0, random_state=0)
    x30 = x30.astype(np.float32)
    kw = dict(clusterer=SpectralClustering(gamma=0.02, solver="lobpcg"),
              random_state=23, store_matrices=False)
    cc, launches, _, _ = _fit_counted(torch, "spectral", x30, K_range=ks,
                                      n_iterations=50, **kw)
    record("spectral", launches)
    check(launches["lloyd"] > 0 and launches["assign"] > 0
          and launches["hist"] == n_ks,
          f"clusterers/spectral: launches {launches}")
    del kw["store_matrices"]
    kw.update(n_iterations=10)
    one = _grouping(torch, "spectral", x30, 4, (2, 5, 8), **kw)
    _against_cpu("spectral", one, x30, (2, 5, 8), 0.02, **kw)

    # host: labels on the host, counts on the card, against the CPU run.
    kw = dict(clusterer=HostLloyd(), K_range=ks, n_iterations=100,
              random_state=23, store_matrices=True)
    cc, launches, _, _ = _fit_counted(torch, "host", corr, **kw)
    record("host", launches)
    ref = _cpu_fit(corr, **kw)
    eq = {name: all(bool(np.array_equal(cc.cdf_at_K_data[k][name],
                                        ref.cdf_at_K_data[k][name]))
                    for k in ks) for name in ("mij", "iij")}
    emit({"phase": "clusterers", "fit": "host", "card_cpu_equal": eq,
          "label_seconds": sum(cc.metrics_["label_seconds_per_k"]),
          "accumulate_seconds": sum(cc.metrics_["accumulate_seconds_per_k"])})
    check(all(eq.values()), f"clusterers/host: card != CPU counts: {eq}")
    check(launches["hist"] == n_ks and launches["lloyd"] == 0,
          f"clusterers/host: launches {launches}")

    # labels: the headline at K=8, the spectral regime above 4096 items.
    x, truth = make_blobs(n_samples=5000, n_features=50, centers=8,
                          cluster_std=3.0, random_state=0)
    head = dict(HEADLINE, K_range=(8,), store_matrices=True)
    cc, launches, _, _ = _fit_counted(
        torch, "labels", x.astype(np.float32),
        compute_consensus_labels=True, **head)
    record("labels", launches)
    entry = cc.cdf_at_K_data[8]
    t0 = time.perf_counter()
    again = consensus_labels_from_cij(entry["cij"], 8, seed=23,
                                      device="cuda")
    torch.cuda.synchronize()
    spectral_seconds = time.perf_counter() - t0
    ari = adjusted_rand(truth, entry["consensus_labels"])
    emit({"phase": "clusterers", "fit": "labels",
          "labels_regime": "spectral", "labels_seconds": spectral_seconds,
          "labels_ari_vs_truth": ari,
          "cluster_consensus": entry["cluster_consensus"].tolist(),
          "pac_equal_pinned": entry["pac_area"] == PINNED_PAC[6]})
    check(entry["pac_area"] == PINNED_PAC[6],
          f"clusterers/labels: PAC(K=8) {entry['pac_area']} != pinned "
          f"{PINNED_PAC[6]}")
    check(ari >= 0.95, f"clusterers/labels: ARI {ari} < 0.95")
    check(np.array_equal(again, entry["consensus_labels"]),
          "clusterers/labels: labels differ from a second spectral run")

    # k_batch: the stream_small fit in batches of two Ks against one batch.
    xs = make_blobs(**_SMALL_X)[0].astype(np.float32)
    kw = dict(clusterer=KMeans(n_init=2), clusterer_options={},
              K_range=range(2, 7), n_iterations=60, random_state=7,
              store_matrices=True, stream_h_block=16, accum_repr="packed")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "events.jsonl")
        one, _, _, _ = _fit_counted(torch, "k_batch/one", xs, **kw)
        two, launches, _, _ = _fit_counted(torch, "k_batch/2", xs,
                                           k_batch_size=2, metrics_path=path,
                                           **kw)
        with open(path) as f:
            events = [json.loads(line)["event"] for line in f]
    same = all(np.array_equal(one.cdf_at_K_data[k][name],
                              two.cdf_at_K_data[k][name])
               for k in range(2, 7)
               for name in ("hist", "cdf", "pac_area", "mij", "iij", "cij"))
    emit({"phase": "clusterers", "fit": "k_batch", "equal_to_one_batch": same,
          "n_batches": two.metrics_["n_batches"], "events": events})
    check(same, "clusterers/k_batch: batched fit differs from one batch")
    check(two.metrics_["n_batches"] == 3
          and events.count("k_batch_complete") == 3
          and events[-1] == "sweep_complete",
          f"clusterers/k_batch: {two.metrics_['n_batches']} batches, "
          f"events {events}")
    emit({"phase": "clusterers", "seconds": time.perf_counter() - t_phase})


# -- the estimator and append (ROADMAP A9 + A11) --------------------------

ESTIMATE_N = 100_000
ESTIMATE_H = 100


def estimate_data():
    """The headline generator (``bench.py:41-49``) at N = 100,000."""
    from consensus_clustering_tpu_torch import make_blobs

    x, _ = make_blobs(n_samples=ESTIMATE_N, n_features=50, centers=8,
                      cluster_std=3.0, random_state=0)
    return x.astype(np.float32)


def kernels_estimate_shapes(torch, results):
    """The kernels at the shapes the estimator and its refinement give
    them at N = 100,000, each exact against its plain version on the card:
    B2 and the final assignment on 16 resamples x n_init 3 (48 lanes) of
    80,000 x 50 rows drawn with the port's plan from the N = 100,000 blobs,
    k = k_max = 20; B3 at 32 words (K = 8's cluster planes of 4 words) x
    2,048 rows x 100,000 columns; B1's count entry on a 2,048 x 100,000
    int32 tile whose row_offset (49,152) lies in the middle of the
    triangle.  Random words include bit 31; the count tile is bimodal,
    as at the blobs' K."""
    from consensus_clustering_tpu_torch import rng
    from consensus_clustering_tpu_torch.ops import fused_block, hist, lloyd
    from consensus_clustering_tpu_torch.ops import popcount
    from consensus_clustering_tpu_torch.ops.bitpack import (
        popcount_accumulate,
    )
    from consensus_clustering_tpu_torch.ops.resample import resample_indices

    n, n_sub, d, k_max = ESTIMATE_N, 80_000, 50, 20
    g = torch.Generator(device="cuda").manual_seed(7)
    x_all = torch.tensor(estimate_data(), device="cuda")
    idx = resample_indices(rng.prng_key(23, "cuda"), n, 16, n_sub)
    xs = x_all[idx]
    src = torch.arange(16, device="cuda",
                       dtype=torch.int32).repeat_interleave(3)
    lanes = src.shape[0]
    cents = xs[src.long()[:, None], torch.randint(
        0, n_sub, (lanes, k_max), generator=g, device="cuda")]
    got = lloyd.lloyd_step_kernel(xs, src, cents, k_max)
    ref = lloyd.lloyd_step_ordered_plain(xs, src, cents, k_max)
    lab, dmin = fused_block.assign_labels_kernel(xs, src, cents, k_max)
    lab_p, dmin_p = fused_block.assign_labels_plain(xs, src, cents, k_max)
    torch.cuda.synchronize()
    l_same = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
    a_same = bool(torch.equal(lab, lab_p) and torch.equal(dmin, dmin_p))
    l_err = max(float((a.double() - b.double()).abs().max())
                for a, b in zip(got, ref))
    check(all(l_same), f"lloyd != ordered plain at 80,000 rows: {l_same}")
    check(a_same, "assign kernel != plain at 80,000 rows")
    rows = n_sub
    lloyd_bound = bound_ms(
        4 * (16 * rows * d + lanes * k_max * d + lanes
             + lanes * k_max * (d + 2)),
        lanes * rows * (2 * d * k_max + 3 * k_max + 3 * d))
    assign_bound = bound_ms(
        4 * (16 * rows * d + lanes * k_max * d + lanes + 2 * lanes * rows),
        lanes * rows * (k_max * (2 * d + 3) + 2 * d))
    for name, fn, plain, bound, same, err in (
            ("lloyd", lloyd.lloyd_step_kernel, lloyd.lloyd_step_plain,
             lloyd_bound, all(l_same), l_err),
            ("assign", fused_block.assign_labels_kernel,
             fused_block.assign_labels_plain, assign_bound, a_same,
             float((dmin - dmin_p).abs().max()))):
        timing = {
            "shape": [lanes, rows, d, k_max],
            "ms": device_ms(torch, lambda: fn(xs, src, cents, k_max), 10),
            "plain_ms": cuda_ms(torch, lambda: plain(xs, src, cents, k_max),
                                2),
            "bound_ms": bound[0], "bound_by": bound[1],
            "equal_plain": same, "max_abs_err": err}
        results[name]["estimate_shape"] = timing
        emit({"phase": "kernels", "kernel": name,
              "case": "estimator lanes, 80,000 rows", **timing})
    del xs, x_all, cents, got, ref

    # B3 and B1's count entry at the refinement's tiles.
    n_words, tile = 32, 2048
    cols = torch.randint(-2**31, 2**31 - 1, (n_words, n), generator=g,
                         device="cuda", dtype=torch.int32)
    r0 = 49_152
    rows_w = cols[:, r0:r0 + tile]

    def pop_plain(a, b, chunk=12_500):
        return torch.cat([popcount_accumulate(a, b[:, c:c + chunk])
                          for c in range(0, b.shape[1], chunk)], dim=1)

    got = popcount.packed_coassoc_counts_kernel(rows_w, cols)
    ref = pop_plain(rows_w, cols)
    torch.cuda.synchronize()
    err = int((got.long() - ref.long()).abs().max())
    check(err == 0, "popcount kernel != plain at 2,048 x 100,000")
    del got, ref
    b_ms, b_by = bound_ms(4 * (n_words * (tile + n) + tile * n),
                          n_words * tile * n, POPC_PER_S)
    timing = {"shape": [n_words, tile, n],
              "ms": device_ms(torch, lambda: popcount.
                              packed_coassoc_counts_kernel(rows_w, cols), 5),
              "plain_ms": cuda_ms(torch, lambda: pop_plain(rows_w, cols), 1),
              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    results["popcount"]["refine_tile"] = timing
    emit({"phase": "kernels", "kernel": "popcount",
          "case": "refinement Mij tile, 100,000 columns", **timing})
    del cols, rows_w

    mij, iij = count_tiles(torch, tile, n, 8, "bimodal")
    bins = 20
    out_k = torch.zeros(bins, dtype=torch.int64, device="cuda")
    out_p = torch.zeros(bins, dtype=torch.int64, device="cuda")
    hist.consensus_hist_from_counts_kernel(mij, iij, n, r0, bins, out_k)
    hist.consensus_hist_from_counts_plain(mij, iij, n, r0, bins, out_p)
    torch.cuda.synchronize()
    err = int((out_k - out_p).abs().max())
    pairs = sum(n - 1 - (r0 + r) for r in range(tile))
    check(err == 0 and int(out_k.sum()) == pairs,
          f"hist count entry != plain at 2,048 x 100,000: "
          f"{out_k.tolist()} vs {out_p.tolist()} ({pairs} pairs)")
    b_ms, b_by = bound_ms(pairs * 8 + (bins + 1) * 4 + bins * 8,
                          pairs * (3 + math.ceil(math.log2(bins)) + 4))
    timing = {"shape": [tile, n], "row_offset": r0, "counted": pairs,
              "ms": device_ms(torch, lambda: hist.
                              consensus_hist_from_counts_kernel(
                                  mij, iij, n, r0, bins, out_k), 5),
              "plain_ms": cuda_ms(torch, lambda: hist.
                                  consensus_hist_from_counts_plain(
                                      mij, iij, n, r0, bins, out_p), 1),
              "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    results["hist"]["refine_tile"] = timing
    emit({"phase": "kernels", "kernel": "hist", "entry": "counts",
          "case": "refinement tile, 100,000 columns", **timing})
    del mij, iij
    torch.cuda.empty_cache()


def phase_estimate(torch, results):
    """The estimator at its own scale, through the API: ``mode="auto"``
    on the N = 100,000 blobs, H = 100, K = 2..20, KMeans(n_init=3),
    ``cluster_batch=16``, ``chunk_size=4``, ``stream_h_block=100``,
    ``accum_repr="packed"``, the default ``n_pairs`` (2^17) and
    ``exact_best_k=True``, with the launch counts set to 0 just before."""
    from consensus_clustering_tpu_torch import ConsensusClustering
    from consensus_clustering_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )

    x = estimate_data()
    ks = list(range(2, 21))
    cc = ConsensusClustering(
        K_range=ks, n_iterations=ESTIMATE_H, random_state=23, chunk_size=4,
        cluster_batch=16, mode="auto", stream_h_block=100,
        accum_repr="packed", exact_best_k=True, device="cuda", plot_cdf=False)
    reset_launch_counts()
    t0 = time.perf_counter()
    cc.fit(x)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    m = cc.metrics_
    refine = m.get("exact_best_k", {})
    est_launches = m["kernel_launches"]
    ref_launches = refine.get("timing", {}).get("kernel_launches", {})
    pac = np.array([cc.cdf_at_K_data[k]["pac_area"] for k in ks])
    bound = m["estimator"]["pac_error_bound"]
    budget = torch.cuda.get_device_properties(0).total_memory
    gap = abs(refine.get("pac_area_exact", np.nan)
              - refine.get("pac_area_estimate", np.nan))
    h_eff = m["streaming"]["h_effective"]
    emit({"phase": "estimate", "nvidia_smi": smi_line(),
          "config": f"make_blobs N={ESTIMATE_N} d=50 centers=8 std=3, "
                    f"H={ESTIMATE_H}, K=2..20, KMeans(n_init=3), "
                    "cluster_batch=16, chunk_size=4, stream_h_block=100, "
                    "accum_repr=packed, mode=auto, exact_best_k, seed 23",
          "mode": m.get("mode"), "auto": m.get("auto"),
          "card_total_memory": budget, "wall_seconds": wall,
          "run_seconds": m["run_seconds"],
          "resamples_per_second": h_eff * len(ks) / m["run_seconds"],
          "peak_device_bytes": m.get("device_memory", {}).get(
              "peak_bytes_in_use"),
          "refine_seconds": refine.get("timing", {}).get("seconds"),
          "refine_collect_seconds":
              refine.get("timing", {}).get("collect_seconds"),
          "refine_peak_device_bytes": refine.get("timing", {}).get(
              "device_memory", {}).get("peak_bytes_in_use"),
          "estimator": m["estimator"], "pac": pac.tolist(),
          "best_k": cc.best_k_, "exact_best_k": {
              k: v for k, v in refine.items() if k != "timing"},
          "refined_gap": gap, "launches": launches,
          "estimate_launches": est_launches,
          "refine_launches": ref_launches})
    check(m.get("mode") == "estimate", f"estimate: mode {m.get('mode')}")
    check(m.get("auto", {}).get("budget_bytes") == budget
          and m["auto"]["dense_total_bytes"] > budget,
          f"estimate: auto did not resolve against the card: {m.get('auto')}")
    check(bool(np.isfinite(pac).all() and (pac >= 0).all()
               and (pac <= 1).all()), f"estimate: PAC not in [0, 1]: {pac}")
    check(0 < bound < 1 and m["estimator"]["n_pairs"] == 2**17,
          f"estimate: disclosure {m['estimator']}")
    check(cc.best_k_ == 8, f"estimate: best K {cc.best_k_}, expected 8")
    check(refine.get("k") == 8 and gap <= bound,
          f"estimate: refined K=8 PAC {refine} off the estimate by {gap} > "
          f"{bound}")
    check(est_launches["lloyd"] > 0 and est_launches["assign"] > 0,
          f"estimate: B2/assign not launched: {est_launches}")
    check(ref_launches.get("popcount", 0) > 0
          and ref_launches.get("hist", 0) > 0,
          f"estimate: B3/B1' not launched in the refinement: {ref_launches}")
    check(launches == {name: est_launches[name] + ref_launches[name]
                       for name in launches},
          f"estimate: launches {launches} != estimate + refinement")
    _record_launches(results, "estimate", launches)


def _pairs_from_planes(torch, state, pi, pj):
    """Every K's mij and the iij at the pairs (pi, pj), popcounted from a
    packed stream's captured planes on the card."""
    from consensus_clustering_tpu_torch.ops.bitpack import popcount32

    cop = torch.from_numpy(state["coplanes"]).cuda()
    iij = popcount32(cop[:, pi] & cop[:, pj]).sum(0)
    mij = []
    for planes_k in state["planes"]:
        p = torch.from_numpy(planes_k).cuda()
        mij.append(popcount32(p[..., pi] & p[..., pj]).sum((0, 1)))
    return torch.stack(mij).cpu().numpy(), iij.cpu().numpy()


def phase_estimate_check(torch, results):
    """The estimator where exact still runs: the headline data (N = 5000),
    H = 100, K = 2..20, blocks of 50.  Every sampled pair's counts equal
    the packed stream's captured planes at that pair (both pair paths),
    the observed PAC error stays under the disclosed bound, and a run cut
    by ``block_start`` at block 1 resumes from the ring bit for bit."""
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.estimator.engine import (
        PairConsensusEngine,
    )
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.parallel.streaming import (
        StreamingSweep,
    )
    from consensus_clustering_tpu_torch.resilience import (
        InjectedFault,
        StreamCheckpointer,
        faults,
    )

    x = headline_data()
    h = 100
    config = SweepConfig(n_samples=5000, n_features=50,
                         k_values=tuple(range(2, 21)), n_iterations=h,
                         store_matrices=False, chunk_size=4,
                         cluster_batch=16, stream_h_block=50,
                         accum_repr="packed", fuse_block="auto")
    t0 = time.perf_counter()
    stream = StreamingSweep(KMeans(n_init=3), config, device="cuda")
    stream.warmup()
    exact = stream.run(x, 23, h, capture_state=True)
    stream_s = time.perf_counter() - t0
    runs, seconds = {}, {}
    for path in ("dense", "packed"):
        t0 = time.perf_counter()
        engine = PairConsensusEngine(
            KMeans(n_init=3), dataclasses.replace(config, accum_repr=path),
            device="cuda")
        runs[path] = engine.run(x, 23, h, return_state=True)
        seconds[path] = time.perf_counter() - t0
    ps = runs["packed"]["pair_state"]
    pi = torch.from_numpy(ps["pair_i"]).cuda()
    pj = torch.from_numpy(ps["pair_j"]).cuda()
    mij_ref, iij_ref = _pairs_from_planes(torch, exact["final_state"], pi, pj)
    same = {path: bool(np.array_equal(r["pair_state"]["mij"], mij_ref)
                       and np.array_equal(r["pair_state"]["iij"], iij_ref))
            for path, r in runs.items()}
    bound = runs["packed"]["estimator"]["pac_error_bound"]
    err = np.abs(runs["packed"]["pac_area"].astype(np.float64)
                 - exact["pac_area"].astype(np.float64))
    # Cut before block 1 (after block 0 reached the ring), then resumed.
    with tempfile.TemporaryDirectory() as tmp:
        ring = StreamCheckpointer(tmp)
        engine = PairConsensusEngine(KMeans(n_init=3), config, device="cuda")
        faults.configure("block_start=1")
        raised = False
        try:
            engine.run(x, 23, h, checkpointer=ring, return_state=True)
        except InjectedFault:
            raised = True
        finally:
            faults.clear()
        resumed = engine.run(x, 23, h, checkpointer=ring, return_state=True)
        ring.close()
    res_same = bool(
        raised and resumed["streaming"]["resumed_from_block"] == 1
        and all(np.array_equal(resumed["pair_state"][k], ps[k])
                for k in ("mij", "iij"))
        and all(np.array_equal(resumed[k], runs["packed"][k])
                for k in ("hist", "cdf", "pac_area")))
    emit({"phase": "estimate_check", "nvidia_smi": smi_line(),
          "config": "headline data N=5000, H=100, K=2..20, blocks of 50, "
                    "KMeans(n_init=3), n_pairs 2^17, seed 23",
          "pair_counts_equal_planes": same, "pac_abs_err": err.tolist(),
          "max_pac_abs_err": float(err.max()), "pac_error_bound": bound,
          "resume_bit_identical": res_same,
          "stream_seconds": stream_s, "estimate_seconds": seconds,
          "pairs_with_iij": int((iij_ref > 0).sum())})
    check(all(same.values()), f"estimate_check: pair counts != the stream's "
                              f"planes at the pairs: {same}")
    check(bool((err <= bound).all()),
          f"estimate_check: |PAC_est - PAC_exact| {err.max()} > {bound}")
    check(res_same, "estimate_check: the resumed run != the uninterrupted")


def phase_refine(torch, results):
    """``exact_curves_for_k`` at the headline configuration (N = 5000,
    H = 500, K = 8): PAC equal to ``PINNED_PAC`` at K = 8, the CDF equal
    to the dense headline's (when that phase ran), and the tiled kernel
    route equal to its plain route on the card."""
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.estimator.tiled import (
        collect_resample_labels,
        exact_curves_for_k,
        tiled_exact_curves,
    )
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.ops.bitpack import (
        popcount_accumulate,
    )
    from consensus_clustering_tpu_torch.ops.hist import (
        consensus_hist_from_counts_plain,
    )

    x = headline_data()
    ks = list(HEADLINE["K_range"])
    config = SweepConfig(n_samples=5000, n_features=50, k_values=tuple(ks),
                         n_iterations=500, store_matrices=False,
                         chunk_size=4, cluster_batch=16, stream_h_block=100)
    exact = exact_curves_for_k(KMeans(n_init=3), config, x, 23, 8,
                               device="cuda")
    pinned = PINNED_PAC[ks.index(8)]
    idx, lab = collect_resample_labels(KMeans(n_init=3), config, x, 23, 8,
                                       device="cuda")
    lo, hi = config.pac_idx
    t0 = time.perf_counter()
    plain = tiled_exact_curves(idx, lab, 5000, 20, lo, hi,
                               popcount_fn=popcount_accumulate,
                               hist_fn=consensus_hist_from_counts_plain)
    plain_s = time.perf_counter() - t0
    same_plain = all(np.array_equal(exact[k], plain[k])
                     for k in ("hist", "cdf", "pac_area"))
    dense = results.get("headline_fit")
    same_headline = ("not run: the headline phase did not run in this call"
                     if dense is None else bool(np.array_equal(
                         exact["cdf"].astype(np.float64),
                         dense.cdf_at_K_data[8]["cdf"])))
    emit({"phase": "refine", "nvidia_smi": smi_line(),
          "pac_area": float(exact["pac_area"]), "pinned_pac": pinned,
          "cdf_equal_headline": same_headline,
          "equal_plain_route": same_plain, "timing": exact["timing"],
          "plain_route_seconds": plain_s})
    check(float(exact["pac_area"]) == pinned,
          f"refine: PAC {exact['pac_area']} != pinned {pinned}")
    check(same_headline is not False, "refine: CDF != the headline's at K=8")
    check(same_plain, "refine: kernel route != plain route on the card")
    check(exact["timing"]["kernel_launches"]["popcount"] > 0
          and exact["timing"]["kernel_launches"]["hist"] > 0,
          f"refine: launches {exact['timing']['kernel_launches']}")
    _record_launches(results, "refine", exact["timing"]["kernel_launches"])


def phase_append(torch, results):
    """Incremental append at the headline's width: a parent of the
    headline blobs' first 4,000 rows (H_old = 400, blocks of 100, packed,
    fused) bootstrapped into a plane store, then all 5,000 rows appended
    with h_new = 100 (dN/N = 0.2), the launch counts set to 0 just
    before the append."""
    from consensus_clustering_tpu_torch.append import (
        PlaneStore,
        bootstrap_generation,
        run_append,
    )
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from consensus_clustering_tpu_torch.ops.bitpack import (
        popcount_accumulate,
    )
    from consensus_clustering_tpu_torch.ops.hist import (
        consensus_hist_from_counts_plain,
    )
    from consensus_clustering_tpu_torch.ops.tiles import (
        plane_words,
        planes_curves,
    )

    x = headline_data()
    ks = tuple(HEADLINE["K_range"])
    config = SweepConfig(n_samples=4000, n_features=50, k_values=ks,
                         n_iterations=400, store_matrices=False,
                         chunk_size=4, cluster_batch=16, stream_h_block=100,
                         accum_repr="packed", fuse_block="auto")
    meta = {"name": "KMeans", "options": {"n_init": 3}}
    with tempfile.TemporaryDirectory() as tmp:
        store = PlaneStore(tmp)
        t0 = time.perf_counter()
        bootstrap_generation(x[:4000], config=config,
                             clusterer=KMeans(n_init=3), seed=23,
                             store=store, clusterer_meta=meta, device="cuda")
        parent_s = time.perf_counter() - t0
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run_append(store, x, h_new=100, clusterer=KMeans(n_init=3),
                         stream_h_block=100, k_values=ks,
                         clusterer_name="KMeans",
                         clusterer_options={"n_init": 3}, device="cuda")
        append_s = time.perf_counter() - t0
        launches = launch_counts()
        manifest, arrays = store.load_latest()
    planes = plane_words(arrays["planes"], "cuda")
    cop = plane_words(arrays["coplanes"], "cuda")
    lo, hi = config.pac_idx
    card = planes_curves(planes, cop, 20, lo, hi)
    plain = planes_curves(planes, cop, 20, lo, hi,
                          popcount_fn=popcount_accumulate,
                          hist_fn=consensus_hist_from_counts_plain)
    same_plain = all(np.array_equal(card[k], plain[k])
                     for k in ("hist", "cdf", "pac_area"))
    same_out = bool(np.array_equal(np.asarray(out["cdf"]), card["cdf"]))
    ap = out["append"]
    stream_wall = results.get("stream_wall")
    emit({"phase": "append", "nvidia_smi": smi_line(),
          "config": "headline blobs, parent N=4000 H=400, append N=5000 "
                    "h_new=100, K=2..20, blocks of 100, packed, fused",
          "parent_seconds": parent_s, "append_seconds": append_s,
          "append_run_seconds": ap["run_seconds"],
          "from_scratch_stream_seconds": stream_wall
          if stream_wall else "not run: the stream phase did not run",
          "append": {k: v for k, v in ap.items() if k != "staleness"},
          "staleness": ap["staleness"], "pac": out["pac_area"],
          "merged_equal_plain_route": same_plain,
          "result_equal_reloaded_store": same_out,
          "store_generation": manifest["generation"],
          "store_backend": manifest.get("backend"),
          "launches": launches})
    check(ap["iij_bit_identical"] and ap["generation"] == 1
          and ap["h_total"] == 500, f"append: accounting {ap}")
    check(same_plain, "append: merged curves on the card != plain route")
    check(same_out, "append: result != the reloaded generation's curves")
    check(manifest["generation"] == 1 and manifest["h_done"] == 500,
          f"append: store reloaded generation {manifest['generation']}")
    check(not ap["staleness"]["refresh_recommended"],
          f"append: staleness {ap['staleness']}")
    check(all(launches[k] > 0 for k in ("lloyd", "assign", "fused_block",
                                        "popcount", "hist")),
          f"append: a kernel of the path never launched: {launches}")
    _record_launches(results, "append", launches)


# -- phase 15 ------------------------------------------------------------

#: The serve phase's requests: A at the headline (its PAC must equal
#: ``PINNED_PAC``), B and C fused, D progressive, E an append to A.
SERVE = dict(n_extra=1000, h_a=500, h_bc=200, h_d=100, h_e=100, block=100)


def _http(base, path, body=None):
    """(status, parsed json or text, seconds) of one HTTP round trip."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            raw, code = r.read(), r.status
    except urllib.error.HTTPError as e:
        raw, code = e.read(), e.code
    seconds = time.perf_counter() - t0
    text = raw.decode()
    try:
        return code, json.loads(text), seconds
    except ValueError:
        return code, text, seconds


def _await_job(base, job_id, budget=600.0):
    deadline = time.time() + budget
    while time.time() < deadline:
        code, rec, _ = _http(base, f"/jobs/{job_id}")
        if code != 200 or rec["status"] in ("done", "failed", "timeout",
                                            "cancelled"):
            return rec
        time.sleep(0.1)
    return {"status": "still running", "job_id": job_id}


def _split(post_seconds, rec):
    """A finished job's seconds: the POST round trip (the host's JSON
    parse, validation, fingerprint and admission), the queue wait, the
    engine run, and the rest of the attempt (engine lookup, result
    shaping and the store write)."""
    result = rec.get("result") or {}
    run = (result.get("timings") or {}).get("run_seconds")
    started, finished = rec.get("started_at"), rec.get("finished_at")
    out = {"post_seconds": post_seconds, "run_seconds": run}
    if started is not None:
        out["queue_wait_seconds"] = started - rec["submitted_at"]
    if started is not None and finished is not None and run is not None:
        out["result_write_seconds"] = finished - started - run
    return out


def phase_serve(torch, results):
    """The port's HTTP service on the card at the headline's width: a
    ``ConsensusService`` over the port's ``SweepExecutor`` (``cuda``,
    ``fusion_max=2``, the fair schedule, the budget from
    ``resolve_memory_budget``) answering, over HTTP on 127.0.0.1: A, the
    headline stream (H=500, K=2..20, packed, blocks of 100: PAC equal to
    ``PINNED_PAC``), A again (from the store), B and C (H=200, seeds 101
    and 102, queued behind A so the scheduler fuses them: each equal to
    a solo run of its spec), D (``progressive``, H=100: the estimate,
    then its refinement inside the bound), and E (an append of 1,000 rows
    of another seed's blobs to A's plane store, H=100: equal to
    ``run_append`` on a copy of the store), with the launch counts set to
    0 just before the first request and read after the last."""
    from consensus_clustering_tpu_torch import make_blobs
    from consensus_clustering_tpu_torch.append import PlaneStore, run_append
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.obs.prom import validate_exposition
    from consensus_clustering_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )
    from consensus_clustering_tpu_torch.serve import (
        ConsensusService,
        SweepExecutor,
        parse_job_spec,
        resolve_memory_budget,
    )

    cfg = SERVE
    x = headline_data()
    n = x.shape[0]
    extra, _ = make_blobs(n_samples=cfg["n_extra"], n_features=x.shape[1],
                          centers=8, cluster_std=3.0, random_state=1)
    x_grown = np.concatenate([x, extra.astype(np.float32)])
    ks = list(HEADLINE["K_range"])
    common = {"k": ks, "stream_h_block": cfg["block"],
              "accum_repr": "packed", "clusterer_options": {"n_init": 3}}
    body_a = {"data": x.tolist(), "config": {
        **common, "iterations": cfg["h_a"], "seed": 23}}
    body_bc = [{"data": x.tolist(), "config": {
        **common, "iterations": cfg["h_bc"], "seed": seed, "tenant": t}}
        for seed, t in ((101, "b"), (102, "c"))]
    body_d = {"data": x.tolist(), "config": {
        "k": ks, "iterations": cfg["h_d"], "seed": 23,
        "stream_h_block": cfg["block"], "mode": "progressive",
        "clusterer_options": {"n_init": 3}}}
    budget = resolve_memory_budget(device="cuda")
    executor = SweepExecutor(device="cuda")
    report = {"phase": "serve", "nvidia_smi": smi_line(),
              "memory_budget_bytes": budget, "requests": {}}
    with tempfile.TemporaryDirectory() as tmp:
        svc = ConsensusService(store_dir=os.path.join(tmp, "store"), port=0,
                               executor=executor, fusion_max=2,
                               schedule="fair", memory_budget_bytes=budget)
        svc.start()
        base = f"http://127.0.0.1:{svc.port}"
        try:
            reset_launch_counts()
            t_phase = time.perf_counter()
            code_a, rec_a, post_a = _http(base, "/jobs", body_a)
            posted = [_http(base, "/jobs", b) for b in body_bc]
            done_a = _await_job(base, rec_a["job_id"])
            runs_before_a2 = executor.run_count
            code_a2, rec_a2, post_a2 = _http(base, "/jobs", body_a)
            runs_after_a2 = executor.run_count
            done_bc = [_await_job(base, rec["job_id"])
                       for _, rec, _ in posted]
            plane_copy = os.path.join(tmp, "planes_copy")
            planes = svc.store.plane_dir(done_a["fingerprint"])
            check(os.path.isdir(planes), "serve A: no plane store written")
            if os.path.isdir(planes):
                shutil.copytree(planes, plane_copy)
            code_d, rec_d, post_d = _http(base, "/jobs", body_d)
            done_d = _await_job(base, rec_d["job_id"])
            cont_id = done_d.get("continuation_job_id")
            done_r = (_await_job(base, cont_id) if cont_id
                      else {"status": "no continuation"})
            body_e = {"data": x_grown.tolist(), "config": {
                **common, "iterations": cfg["h_e"], "seed": 23,
                "mode": "append", "append_parent": done_a["fingerprint"]}}
            code_e, rec_e, post_e = _http(base, "/jobs", body_e)
            done_e = _await_job(base, rec_e["job_id"])
            expected = {"run_count": 6, "fused_executions_total": 1,
                        "fused_jobs_total": 2, "estimator_runs_total": 1,
                        "append_runs_total": 1,
                        "plane_stores_written_total": 2}
            # The scheduler writes a job's status before its last
            # counters: wait for the side effects, not the status.
            deadline = time.time() + 30
            while time.time() < deadline:
                code_m, metrics, _ = _http(base, "/metrics")
                got = {k: metrics.get("sweeps_executed" if k == "run_count"
                                      else k) for k in expected}
                if got == expected:
                    break
                time.sleep(0.2)
            code_h, health, _ = _http(base, "/healthz")
            code_p, prom, _ = _http(base, "/metrics.prom")
            serve_seconds = time.perf_counter() - t_phase
            launches = launch_counts()
        finally:
            svc.stop()
        # Oracles, after the service's requests (their launches are not
        # the service's): B and C solo, E's append on the store's copy.
        t0 = time.perf_counter()
        solo = [executor.run(*parse_job_spec(b)) for b in body_bc]
        if not os.path.isdir(plane_copy):
            raise RuntimeError("serve: request A failed: "
                               f"{done_a.get('error')}; see the checks")
        direct = run_append(
            PlaneStore(plane_copy), x_grown, h_new=cfg["h_e"],
            clusterer=KMeans(n_init=3), stream_h_block=cfg["block"],
            k_values=tuple(ks), subsampling=0.8, bins=20,
            pac_interval=(0.1, 0.9), parity_zeros=True, dtype="float32",
            clusterer_name="kmeans", clusterer_options={"n_init": 3},
            device="cuda")
        oracle_seconds = time.perf_counter() - t0

    res_a = done_a.get("result") or {}
    pac_a = [res_a.get("pac_area", {}).get(str(k)) for k in ks]
    same_pinned = [p == q for p, q in zip(pac_a, PINNED_PAC)]
    mem_a = res_a.get("memory") or {}
    report["requests"]["A"] = {
        "http": [code_a], "status": done_a["status"],
        **_split(post_a, done_a), "pac": pac_a,
        "pac_equal_pinned_per_k": same_pinned,
        "memory": {k: mem_a.get(k) for k in (
            "estimated_bytes", "measured_bytes", "measurement_source",
            "preflight_accuracy", "peak_delta_bytes")},
        "peak_device_bytes": (mem_a.get("device_after") or {}).get(
            "peak_bytes_in_use"),
        "streaming": {k: (res_a.get("streaming") or {}).get(k) for k in (
            "h_block", "h_effective", "n_blocks_run", "checkpoint_writes")},
        "autotune": res_a.get("autotune"),
        "plane_store": res_a.get("plane_store")}
    check(done_a["status"] == "done", f"serve A: {done_a.get('error')}")
    check(all(same_pinned), "serve A: per-K PAC differs from the pinned run "
                            f"at K={[k for k, e in zip(ks, same_pinned) if not e]}")
    acc = mem_a.get("preflight_accuracy")
    check(mem_a.get("measurement_source") == "device"
          and (mem_a.get("measured_bytes") or 0) > 0
          and acc is not None and math.isfinite(acc),
          f"serve A: memory disclosure {mem_a}")

    report["requests"]["A_again"] = {
        "http": [code_a2], "post_seconds": post_a2,
        "from_cache": rec_a2.get("from_cache"),
        "run_count_before_after": [runs_before_a2, runs_after_a2]}
    # A second run of A would also show in the total run_count (6) below.
    check(code_a2 == 200 and rec_a2.get("from_cache") is True
          and runs_after_a2 == runs_before_a2
          and (rec_a2.get("result") or {}).get("result_fingerprint")
          == res_a.get("result_fingerprint"),
          f"serve A': not served from the store: {code_a2}")

    for name, (code, rec, post), done, oracle in zip(
            "BC", posted, done_bc, solo):
        res = done.get("result") or {}
        same = {k: res.get(k) == oracle[k] for k in (
            "result_fingerprint", "pac_area", "best_k")}
        report["requests"][name] = {
            "http": [code], "status": done["status"], **_split(post, done),
            "fused": res.get("fused"), "equal_solo": same,
            "best_k": res.get("best_k")}
        check(done["status"] == "done", f"serve {name}: {done.get('error')}")
        check(res.get("fused") == {"batch": 2}, f"serve {name}: not fused: "
                                                f"{res.get('fused')}")
        check(all(same.values()), f"serve {name}: fused != solo: {same}")

    res_d, res_r = done_d.get("result") or {}, done_r.get("result") or {}
    bound = (res_d.get("estimator") or {}).get("pac_error_bound")
    best_d = res_d.get("best_k")
    est_pac = (res_d.get("pac_area") or {}).get(str(best_d))
    ref_pac = (res_r.get("pac_area") or {}).get(str(best_d))
    ordered = (done_d.get("finished_at") or 0) <= (
        done_r.get("finished_at") or -1)
    report["requests"]["D"] = {
        "http": [code_d], "status": [done_d["status"], done_r["status"]],
        "estimate": _split(post_d, done_d),
        "refine": {"queue_wait_seconds": (done_r.get("started_at") or 0)
                   - (done_r.get("submitted_at") or 0),
                   "run_seconds": (res_r.get("timings") or {}).get(
                       "run_seconds")},
        "best_k": best_d, "estimate_pac": est_pac, "refined_pac": ref_pac,
        "pac_error_bound": bound, "estimate_first": ordered,
        "n_pairs": (res_d.get("estimator") or {}).get("n_pairs")}
    check(done_d["status"] == "done" and done_r["status"] == "done"
          and res_d.get("mode") == "estimate" and res_r.get("refined"),
          f"serve D: {done_d.get('error')} {done_r.get('error')}")
    check(ordered, "serve D: the refinement finished before the estimate")
    check(None not in (bound, est_pac, ref_pac)
          and abs(ref_pac - est_pac) <= bound,
          f"serve D: refined PAC {ref_pac} vs estimate {est_pac} outside "
          f"the bound {bound}")

    res_e = done_e.get("result") or {}
    ap = res_e.get("append") or {}
    direct_pac = {str(k): float(p) for k, p in zip(ks, direct["pac_area"])}
    same_direct = res_e.get("pac_area") == direct_pac and ap.get(
        "h_total") == direct["append"]["h_total"]
    report["requests"]["E"] = {
        "http": [code_e], "status": done_e["status"], **_split(post_e, done_e),
        "append": {k: v for k, v in ap.items() if k != "staleness"},
        "staleness": ap.get("staleness"), "equal_direct_run_append":
        same_direct}
    check(done_e["status"] == "done" and not ap.get("fallback")
          and ap.get("iij_bit_identical") is True,
          f"serve E: {done_e.get('error')} {ap}")
    check(same_direct, "serve E: merged curves != run_append on the copy")

    try:
        prom_problems = validate_exposition(prom)
    except Exception as e:  # noqa: BLE001 -- a parser failure is the finding
        prom_problems = [repr(e)]
    report.update({
        "healthz": health, "metrics_http": [code_m, code_h, code_p],
        "metrics_counters": got, "metrics_expected": expected,
        "prom_problems": prom_problems, "launches": launches,
        "serve_seconds": serve_seconds, "oracle_seconds": oracle_seconds,
        "peak_device_bytes_since_last_reset":
            torch.cuda.max_memory_allocated()})
    emit(report)
    check(code_h == 200 and health.get("backend") == "torch-cuda",
          f"serve: healthz {health}")
    check(code_m == 200 and got == expected,
          f"serve: /metrics counters {got} != {expected}")
    check(code_p == 200 and prom_problems == [],
          f"serve: /metrics.prom does not parse: {prom_problems[:3]}")
    check(all(launches[k] > 0 for k in KERNEL_NAMES),
          f"serve: a kernel of the path never launched: {launches}")
    _record_launches(results, "serve", launches)


# The cli phase's run: the headline's width (N, d, K) at H=100.
CLI = dict(n=5000, d=50, k_hi=20, h=100, block=100)


def _cli_run_argv():
    return ["run", "--dataset", "blobs", "--n-samples", str(CLI["n"]),
            "--n-features", str(CLI["d"]), "--k", f"2:{CLI['k_hi']}",
            "--iterations", str(CLI["h"]), "--stream", str(CLI["block"]),
            "--accum-repr", "packed", "--fuse-block", "on", "--seed", "23"]


def _cli_data():
    from consensus_clustering_tpu_torch import make_blobs

    x, _ = make_blobs(n_samples=CLI["n"], n_features=CLI["d"], centers=8,
                      cluster_std=3.0, random_state=23)
    return x.astype(np.float32)


def _cli_start(args):
    """Start ``python -m consensus_clustering_tpu_torch ARGS`` in a
    process of its own, its output in temporary files (no pipe to fill);
    :func:`_cli_finish` collects it."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "consensus_clustering_tpu_torch", *args],
        cwd=REPO, stdout=out, stderr=err, text=True)
    return proc, out, err, time.perf_counter()


def _cli_finish(started, timeout):
    """(exit code, stdout, stderr, wall seconds) of a :func:`_cli_start`
    process; killed past ``timeout`` seconds (exit code None)."""
    proc, out, err, t0 = started
    try:
        proc.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        return None, "", f"killed after {timeout} s", time.perf_counter() - t0
    wall = time.perf_counter() - t0
    texts = []
    for f in (out, err):
        f.seek(0)
        texts.append(f.read())
        f.close()
    return proc.returncode, texts[0], texts[1], wall


def _cli(args, timeout):
    """(exit code, stdout, stderr, wall seconds) of one subcommand."""
    return _cli_finish(_cli_start(args), timeout)


def _tail(text, n=800):
    return text[-n:] if text else ""


def _cli_run_steps(torch, results, tmp, report):
    """Step 1: the headline-width streamed ``run`` and the dense corr
    ``run``; returns the first run's result."""
    from consensus_clustering_tpu_torch import ConsensusClustering

    out = os.path.join(tmp, "run.json")
    code, _, err, wall = _cli(_cli_run_argv() + ["--out", out], 600)
    check(code == 0, f"cli run: exit {code}: {_tail(err)}")
    if code != 0:
        return None
    with open(out) as f:
        res = json.load(f)
    m = res["metrics"]
    ks = list(range(2, CLI["k_hi"] + 1))
    lib = ConsensusClustering(
        K_range=ks, n_iterations=CLI["h"], random_state=23,
        clusterer_options={"n_init": 3}, store_matrices=False,
        split_init=False, stream_h_block=CLI["block"], accum_repr="packed",
        fuse_block="on", plot_cdf=False).fit(_cli_data())
    same = [res["pac_area"][str(k)] == lib.cdf_at_K_data[k]["pac_area"]
            for k in ks]
    launches = m["kernel_launches"]
    report["steps"]["run"] = {
        "wall_seconds": wall, "run_seconds": m["run_seconds"],
        "start_and_load_seconds": wall - m["run_seconds"],
        "compile_seconds": m["compile_seconds"], "launches": launches,
        "strategy": m.get("timing"), "best_k": res["best_k"],
        "pac_equal_library_per_k": same}
    check(all(same), "cli run: per-K PAC differs from the library fit at "
                     f"K={[k for k, e in zip(ks, same) if not e]}")
    check(m.get("timing") == {"packed_kernel": "cuda", "fuse_block": "fused",
                              "fused_kernel": "cuda"},
          f"cli run: strategy {m.get('timing')}")
    check(all(launches[k] > 0 for k in KERNEL_NAMES),
          f"cli run: a kernel of the path never launched: {launches}")

    with open(os.path.join(REPO, "tests", "fixtures",
                           "reference_goldens.json")) as f:
        goldens = json.load(f)
    out = os.path.join(tmp, "corr.json")
    code, _, err, wall = _cli(["run", "--dataset", "corr", "--k", "2:14",
                               "--iterations", "100", "--out", out], 300)
    check(code == 0, f"cli corr: exit {code}: {_tail(err)}")
    if code == 0:
        with open(out) as f:
            corr = json.load(f)
        ours = np.array([corr["pac_area"][str(k)] for k in range(2, 15)])
        ref = np.array([goldens["kmeans_pac"][str(k)] for k in range(2, 15)])
        inside = bool((np.abs(ours - ref) <= np.maximum(0.02, 0.25 * ref))
                      .all())
        cl = corr["metrics"]["kernel_launches"]
        report["steps"]["corr"] = {
            "wall_seconds": wall, "run_seconds": corr["metrics"][
                "run_seconds"], "launches": cl, "pac": ours.tolist(),
            "inside_golden_bands": inside}
        check(inside, "cli corr: PAC outside the golden bands")
        check(cl["hist"] == 13 and cl["lloyd"] > 0 and cl["assign"] > 0,
              f"cli corr: launches {cl}")
        launches = {k: n + cl[k] for k, n in launches.items()}
    _record_launches(results, "cli", launches)
    return res


def _cli_autotune_steps(torch, tmp, report):
    """Step 2: the smoke probes on the card, ``show``, and the API's
    resolution against their records."""
    from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs
    from consensus_clustering_tpu_torch.autotune.store import CalibrationStore

    cal = os.path.join(tmp, "calibration")
    code, out, err, wall = _cli(["autotune", "run", "--shapes", "smoke",
                                 "--store", cal, "--budget", "120"], 600)
    try:
        summary = json.loads(out.strip().splitlines()[-1])
    except (IndexError, ValueError):
        summary = {}
    records = CalibrationStore(cal).records()
    name = torch.cuda.get_device_name(0)
    ours = [r for _, r in records if r.get("env", {}).get("device_kind")
            == name]
    step = report["steps"]["autotune_run"] = {
        "wall_seconds": wall, "exit": code,
        "gate_failed": summary.get("gate_failed"),
        "records": {r["knob"] + "@" + r["bucket"]: {
            "value": r["value"], "rate": r.get("rate"),
            "speedup": r.get("speedup")} for r in ours},
        "measurements": {p["probe"]: p["measurements"]
                         for p in summary.get("probes", [])}}
    check(code == 0 and summary.get("gate_failed") is False and ours,
          f"cli autotune run: exit {code}, {step}: {_tail(err)}")
    step["env"] = summary.get("env")
    check(all(isinstance(r["env"].get("driver_version"), int) for r in ours),
          f"cli autotune run: a record without the driver's version: "
          f"{summary.get('env')}")
    code, out, err, wall = _cli(["autotune", "show", "--store", cal,
                                 "--this-env-only"], 120)
    shown = json.loads(out) if code == 0 else {"records": []}
    report["steps"]["autotune_show"] = {
        "wall_seconds": wall, "records": len(shown["records"])}
    check(code == 0 and len(shown["records"]) == len(ours),
          f"cli autotune show: exit {code}, {len(shown['records'])} "
          f"records of {len(ours)}: {_tail(err)}")
    by_knob = {r["knob"]: r for r in ours}
    fits = {}
    for knob, (n, d, h, k_hi) in (("stream_h_block", (200, 8, 48, 4)),
                                  ("max_iter", (300, 10, 24, 6))):
        record = by_knob.get(knob)
        if record is None:
            check(False, f"cli autotune: no {knob} record")
            continue
        kwargs = dict(K_range=range(2, k_hi + 1), n_iterations=h,
                      random_state=23, store_matrices=False)
        # The probes' data (autotune.probes._blobs).
        x = make_blobs(n_samples=n, n_features=d, centers=8,
                       cluster_std=3.0, random_state=0)[0].astype(np.float32)
        tuned = ConsensusClustering(**kwargs, autotune=True,
                                    calibration_dir=cal, plot_cdf=False).fit(x)
        pin = ({"stream_h_block": record["value"]} if knob ==
               "stream_h_block" else {"clusterer_options": {
                   "n_init": 3, "max_iter": record["value"]}})
        pinned = ConsensusClustering(**kwargs, **pin, plot_cdf=False).fit(x)
        disclosed = tuned.metrics_["autotune"][knob]
        # A calibrated block is adopted only where its record measured
        # streaming faster than the monolithic sweep (the reference's
        # rule); a declined one leaves the monolithic sweep, whose full-H
        # PAC equals every block size's.
        adopted = knob != "stream_h_block" or (
            record.get("speedup") or 0) > 1.0
        same = [tuned.cdf_at_K_data[k]["pac_area"]
                == pinned.cdf_at_K_data[k]["pac_area"]
                for k in range(2, k_hi + 1)]
        fits[knob] = {"record_value": record["value"],
                      "record_speedup": record.get("speedup"),
                      "disclosed": disclosed, "pac_equal_pinned": same}
        check(disclosed["provenance"] == ("calibrated" if adopted
                                          else "default"),
              f"cli autotune: {knob} disclosed {disclosed}")
        check(all(same), f"cli autotune: {knob} PAC != the pinned fit")
    report["steps"]["autotune_api"] = fits
    return cal




def _cli_serve_steps(tmp, cal, run_result, report):
    """Step 3: ``serve`` in a process of its own answering step 1's job
    (and from the store the second time), ``serve-admin`` on its store
    and events, then SIGINT."""
    import signal

    store, events = os.path.join(tmp, "store"), os.path.join(tmp, "ev.jsonl")
    port_file = os.path.join(tmp, "port")
    log_path = os.path.join(tmp, "serve.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        # A file, not a pipe: the service logs every job, and a pipe
        # nobody reads would fill and stall it.
        proc = subprocess.Popen(
            [sys.executable, "-m", "consensus_clustering_tpu_torch", "serve",
             "--port", "0", "--port-file", port_file, "--store-dir", store,
             "--events-path", events, "--calibration-dir", cal],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    step = report["steps"]["serve"] = {}
    try:
        deadline = time.time() + 180
        while not os.path.exists(port_file) and proc.poll() is None \
                and time.time() < deadline:
            time.sleep(0.2)
        if not os.path.exists(port_file):
            check(False, f"cli serve: no port file (exit {proc.poll()})")
            return
        step["start_seconds"] = time.perf_counter() - t0
        with open(port_file) as f:
            base = f"http://127.0.0.1:{f.read().strip()}"
        config = {"k": list(range(2, CLI["k_hi"] + 1)),
                  "iterations": CLI["h"], "stream_h_block": CLI["block"],
                  "accum_repr": "packed", "clusterer_options": {"n_init": 3}}
        body = {"data": _cli_data().tolist(),
                "config": {**config, "seed": 23}}
        second = {"data": body["data"], "config": {
            **config, "seed": 24, "iterations": 20 * CLI["h"]}}
        code_a, rec_a, post_a = _http(base, "/jobs", body)
        code_b, rec_b, post_b = _http(base, "/jobs", second)
        # B (H=2000) runs behind A, its payload on disk until it is done:
        # show prices it (a finished job's payload is gone).  Its ~30 s on
        # an H100 outlast show's process start (7-13 s there); at H=500 B
        # was done before show read it.
        code, out, err, wall = _cli(["serve-admin", "--store-dir", store,
                                     "show", rec_b["job_id"]], 120)
        shown = json.loads(out) if code == 0 else {}
        step["admin_show"] = {"wall_seconds": wall,
                              "status_at_show": shown.get("status"),
                              "footprints": shown.get("footprints")}
        check(code == 0 and "footprints" in shown,
              f"cli serve-admin show: exit {code}, "
              f"status {shown.get('status')}: {_tail(err)}")
        done_a = _await_job(base, rec_a["job_id"])
        done_b = _await_job(base, rec_b["job_id"])
        code_a2, rec_a2, post_a2 = _http(base, "/jobs", body)
        _, metrics, _ = _http(base, "/metrics")
        res_a = done_a.get("result") or {}
        ks = [str(k) for k in range(2, CLI["k_hi"] + 1)]
        same = [res_a.get("pac_area", {}).get(k)
                == (run_result or {}).get("pac_area", {}).get(k) for k in ks]
        step.update({
            "http": [code_a, code_b, code_a2],
            "A": {"status": done_a["status"], **_split(post_a, done_a),
                  "pac_equal_cli_run_per_k": same,
                  "autotune": res_a.get("autotune")},
            "B": {"status": done_b["status"], **_split(post_b, done_b)},
            "A_again": {"post_seconds": post_a2,
                        "from_cache": rec_a2.get("from_cache")},
            "sweeps_executed": metrics.get("sweeps_executed")})
        check(done_a["status"] == "done" and done_b["status"] == "done",
              f"cli serve: {done_a.get('error')} {done_b.get('error')}")
        check(all(same), "cli serve: A's PAC differs from the CLI run at "
                         f"K={[k for k, e in zip(ks, same) if not e]}")
        check(code_a2 == 200 and rec_a2.get("from_cache") is True
              and metrics.get("sweeps_executed") == 2,
              f"cli serve: A again not from the store ({code_a2}, "
              f"{metrics.get('sweeps_executed')} runs)")
        bundle = os.path.join(tmp, "bundle.tar.gz")
        started = {name: _cli_start(["serve-admin", "--store-dir", store,
                                     *args]) for name, args in (
            ("list", ["list"]),
            ("trace", ["trace", rec_a["job_id"], "--events", events]),
            ("report", ["report", "--events", events]),
            ("bundle", ["bundle", rec_a["job_id"], "--events", events,
                        "--out", bundle]))}
        admin = {}
        for name, admin_proc in started.items():
            code, out, err, wall = _cli_finish(admin_proc, 120)
            admin[name] = {"exit": code, "wall_seconds": wall}
            check(code == 0, f"cli serve-admin {name}: exit {code}: "
                             f"{_tail(err)}")
        step["admin_in_parallel"] = admin
        import tarfile

        record = None
        if os.path.exists(bundle):
            with tarfile.open(bundle) as tar:
                member = f"{rec_a['job_id']}/record.json"
                if member in tar.getnames():
                    record = json.load(tar.extractfile(member))
        check(record is not None and record.get("job_id") == rec_a["job_id"]
              and record.get("status") == "done",
              "cli serve-admin bundle: no job record in the bundle")
    finally:
        t1 = time.perf_counter()
        if proc.poll() is None:
            proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        step["stop_seconds"] = time.perf_counter() - t1
        step["exit"] = proc.returncode
        with open(log_path) as f:
            step["log_tail"] = _tail(f.read(), 600)
        check(proc.returncode == 0 and step["stop_seconds"] <= 10,
              f"cli serve: SIGINT gave exit {proc.returncode} after "
              f"{step['stop_seconds']:.1f} s")


def phase_cli(torch, results):
    """The command line, each subcommand in a process of its own: the
    headline-width streamed ``run`` (PAC equal to the library's fit bit
    for bit, every kernel launched) and the dense corr ``run`` (golden
    bands, B1); ``autotune run --shapes smoke`` and ``show``, with the
    API resolving its records; ``serve`` answering the run's job (equal,
    then from the store) with ``serve-admin`` on its files and SIGINT to
    stop it; ``lint --pack all --json`` on the CI gate's paths (exit 0,
    no new finding) beside ``bench`` (refused)."""
    report = {"phase": "cli", "nvidia_smi": smi_line(), "steps": {}}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        run_result = _cli_run_steps(torch, results, tmp, report)
        cal = _cli_autotune_steps(torch, tmp, report)
        _cli_serve_steps(tmp, cal, run_result, report)
    lint = _cli_start(["lint", "--pack", "all", "--json", *LINT_PATHS])
    bench = _cli_start(["bench"])
    # bench ends first: each wall is its own process's.
    code, _, err, wall = _cli_finish(bench, 120)
    report["steps"]["bench"] = {"exit": code, "wall_seconds": wall}
    check(code != 0 and "item A18" in err,
          f"cli bench: exit {code}, not refused by A18: {_tail(err)}")
    _cli_lint_step(lint, report)
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit(report)


#: The paths the repository's CI gate lints (.github/workflows/ci.yml).
LINT_PATHS = ("consensus_clustering_tpu", "tests", "bench.py", "benchmarks",
              "examples", "scripts")


def _cli_lint_step(started, report):
    """``lint``'s report: exit 0, no new finding, no error, files read;
    its wall seconds include the process's torch import."""
    code, out, err, wall = _cli_finish(started, 300)
    try:
        summary = json.loads(out)["summary"]
    except (ValueError, KeyError):
        summary = None
    report["steps"]["lint"] = {"exit": code, "wall_seconds": wall,
                               "summary": summary}
    check(code == 0 and summary is not None and summary["new"] == 0
          and summary["errors"] == 0 and summary["files"] > 0,
          f"cli lint: exit {code}, summary {summary}: {_tail(err)}")


# -- phase 17 ------------------------------------------------------------

#: The plot phase's configuration: the cli phase's dense headline width.
PLOT = dict(n=5000, d=50, k_hi=20, h=100)

#: ``run --plot-dir`` in a subprocess, through the CLI's ``main`` with
#: argv, which then writes the process's kernel launches to stderr on a
#: ``kernel_launches=`` line (before a traceback, if any): the fit's own
#: are in the JSON, the rest are the heatmap labels'.
_PLOT_RUN = """
import json, sys
from consensus_clustering_tpu_torch.cli import main
from consensus_clustering_tpu_torch.ops import launch_counts
try:
    main(sys.argv[1:])
finally:
    print("kernel_launches=" + json.dumps(launch_counts()), file=sys.stderr,
          flush=True)
"""


def _plot_argv(plot_dir, out):
    return ["run", "--dataset", "blobs", "--n-samples", str(PLOT["n"]),
            "--n-features", str(PLOT["d"]), "--k", f"2:{PLOT['k_hi']}",
            "--iterations", str(PLOT["h"]), "--seed", "23",
            "--plot-dir", plot_dir, "--out", out]


def phase_plot(torch, results):
    """Plotting at the headline's width, dense (H cut to 100): (a) the
    library ``fit`` with ``plot_cdf=True`` and ``store_matrices=True``,
    counts set to 0 just before; (b) ``run --plot-dir`` with the same
    arguments in a subprocess.  PAC equal per K bit for bit; B1, B2 and
    the assignment launched in both.  The heatmap's labels, as ``run
    --plot-dir`` computes them, from (a)'s best-K Cij on the card
    (spectral above 4096 items: B2 and the assignment launch), ARI
    against the blobs' truth >= 0.95.  With matplotlib: (a)'s figure
    draws one curve per K, ``[0] + cdf``; (b)'s three files exist,
    ``cdf.png`` and ``delta_k.png`` equal to the same figures drawn in
    this process from (a), the labels' KMeans launched in (b); the
    heatmap's image array, drawn here from (a), equals Cij ordered by
    its labels.  Without matplotlib: (a) raises ``ImportError`` naming it
    after the sweep, its results set, and (b) prints its JSON, then exits
    non-zero before its labels, as the reference does."""
    from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs
    from consensus_clustering_tpu_torch.models.agglomerative import (
        consensus_labels_from_cij,
    )
    from consensus_clustering_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )

    try:
        import matplotlib  # noqa: F401

        has_mpl = True
    except ImportError:
        has_mpl = False
    report = {"phase": "plot", "nvidia_smi": smi_line(),
              "matplotlib": has_mpl,
              "config": f"make_blobs N={PLOT['n']} d={PLOT['d']} centers=8 "
                        f"std=3 seed 23, H={PLOT['h']} (cut from 500), "
                        f"K=2..{PLOT['k_hi']}, KMeans(n_init=3), dense, "
                        "store_matrices"}
    t_phase = time.perf_counter()
    ks = list(range(2, PLOT["k_hi"] + 1))
    cc = ConsensusClustering(
        K_range=ks, n_iterations=PLOT["h"], random_state=23,
        clusterer_options={"n_init": 3}, store_matrices=True,
        split_init=False, plot_cdf=True)
    x, truth = make_blobs(n_samples=PLOT["n"], n_features=PLOT["d"],
                          centers=8, cluster_std=3.0, random_state=23)
    reset_launch_counts()
    t0 = time.perf_counter()
    error = None
    try:
        cc.fit(x.astype(np.float32))
    except ImportError as e:
        error = e
    report["fit_wall_seconds"] = time.perf_counter() - t0
    launches = launch_counts()
    report["fit_launches"] = launches
    _record_launches(results, "plot", launches)
    check(all(launches[k] > 0 for k in ("hist", "lloyd", "assign")),
          f"plot fit: B1, B2 or the assignment never launched: {launches}")
    check(sorted(cc.cdf_at_K_data) == ks,
          f"plot fit: no results for every K: {sorted(cc.cdf_at_K_data)}")
    if has_mpl:
        check(error is None, f"plot fit: raised {error!r}")
        _plot_figure_checks(cc, report)
    else:
        check(error is not None and "matplotlib" in str(error),
              f"plot fit without matplotlib: raised {error!r}")
        report["fit_error"] = repr(error)
        report["figures"] = ("not drawn: matplotlib does not import on this "
                             "machine; the fit raised ImportError after "
                             "the sweep, with its results set, as the "
                             "reference does")
    reset_launch_counts()
    t0 = time.perf_counter()
    labels = consensus_labels_from_cij(
        cc.cdf_at_K_data[cc.best_k_]["cij"], cc.best_k_,
        linkage=cc.agg_clustering_linkage, method="auto", seed=23,
        device="cuda")
    report["labels_seconds"] = time.perf_counter() - t0
    label_launches = launch_counts()
    ari = adjusted_rand(labels, truth)
    report.update(best_k=cc.best_k_, labels_launches=label_launches,
                  labels_ari=ari, labels_sizes=np.bincount(labels).tolist())
    _record_launches(results, "plot_labels", label_launches)
    check(label_launches["lloyd"] > 0 and label_launches["assign"] > 0,
          f"plot labels: spectral KMeans never launched: {label_launches}")
    check(ari >= 0.95, f"plot labels: ARI {ari} against the blobs' truth")
    with tempfile.TemporaryDirectory() as tmp:
        plot_dir, out = os.path.join(tmp, "plots"), os.path.join(tmp, "r.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _PLOT_RUN, *_plot_argv(plot_dir, out)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        report["run_wall_seconds"] = time.perf_counter() - t0
        report["run_exit"] = proc.returncode
        res = None
        if os.path.exists(out):
            with open(out) as f:
                res = json.load(f)
        check(res is not None, f"plot run: no JSON: {_tail(proc.stderr)}")
        if res is None:
            emit(report)
            return
        same = [res["pac_area"][str(k)] == cc.cdf_at_K_data[k]["pac_area"]
                for k in ks]
        report["pac_equal_fit_per_k"] = same
        check(all(same), "plot run: per-K PAC differs from the fit at "
                         f"K={[k for k, e in zip(ks, same) if not e]}")
        fit_launches = res["metrics"]["kernel_launches"]
        (total,) = [json.loads(line.split("=", 1)[1])
                    for line in proc.stderr.splitlines()
                    if line.startswith("kernel_launches=")]
        run_labels = {k: total[k] - fit_launches[k] for k in total}
        report["run_launches"] = fit_launches
        report["run_labels_launches"] = run_labels
        report["run_seconds"] = res["metrics"]["run_seconds"]
        _record_launches(results, "plot_run", total)
        check(all(fit_launches[k] > 0 for k in ("hist", "lloyd", "assign")),
              f"plot run: B1, B2 or the assignment never launched: "
              f"{fit_launches}")
        if has_mpl:
            # Without matplotlib the run stops at the CDF figure, before
            # the heatmap's labels, as the reference's does.
            check(run_labels["lloyd"] > 0 and run_labels["assign"] > 0,
                  f"plot run: the labels' spectral KMeans never launched "
                  f"the kernels: {run_labels}")
            check(proc.returncode == 0,
                  f"plot run: exit {proc.returncode}: {_tail(proc.stderr)}")
            _plot_file_checks(cc, labels, plot_dir, tmp, res["best_k"],
                              report)
        else:
            check(proc.returncode != 0
                  and "matplotlib" in proc.stderr,
                  f"plot run without matplotlib: exit {proc.returncode}: "
                  f"{_tail(proc.stderr)}")
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit(report)


def _plot_figure_checks(cc, report):
    """(a)'s figure: one curve per K, ``[0] + cdf``; then closed."""
    import matplotlib.pyplot as plt

    nums = plt.get_fignums()
    check(len(nums) == 1, f"plot fit: {len(nums)} figures drawn, not 1")
    if len(nums) != 1:
        return
    lines = plt.figure(nums[0]).axes[0].get_lines()
    ks = sorted(cc.cdf_at_K_data)
    same = len(lines) == len(ks) and all(
        list(line.get_ydata()) == [0.0] + list(cc.cdf_at_K_data[k]["cdf"])
        for line, k in zip(lines, ks))
    report["fit_figure_curves_equal_cdf"] = same
    check(same, "plot fit: the figure's curves differ from [0] + cdf")
    plt.close("all")


def _plot_file_checks(cc, labels, plot_dir, tmp, best_k, report):
    """(b)'s files against the same figures drawn here from (a): the curve
    figures byte for byte; the heatmap from (a)'s best-K Cij and labels
    computed on the card, its image array equal to Cij in label order."""
    import matplotlib.pyplot as plt

    from consensus_clustering_tpu_torch import cli
    from consensus_clustering_tpu_torch.utils import plotting

    names = sorted(os.listdir(plot_dir))
    expect = sorted(["cdf.png", "delta_k.png",
                     f"consensus_matrix_K{best_k}.png"])
    sizes = {n: os.path.getsize(os.path.join(plot_dir, n)) for n in names}
    report["files"] = sizes
    check(names == expect and all(sizes.values()),
          f"plot run: files {sizes}, expected {expect}")
    check(best_k == cc.best_k_, f"plot run: best K {best_k} != {cc.best_k_}")
    here = os.path.join(tmp, "here")
    heatmap, drawn = plotting.plot_consensus_matrix, []

    def spy(*args, **kwargs):
        drawn.append(args)
        return heatmap(*args, **kwargs)

    t0 = time.perf_counter()
    plotting.plot_consensus_matrix = spy
    try:
        cli._write_figures(cc, here, "cuda")
    finally:
        plotting.plot_consensus_matrix = heatmap
    report["figures_in_process_seconds"] = time.perf_counter() - t0
    for name in expect:
        with open(os.path.join(plot_dir, name), "rb") as a, \
                open(os.path.join(here, name), "rb") as b:
            same = a.read() == b.read()
        report[f"{name}_equal_in_process"] = same
        # The heatmap's bytes also rest on the card's spectral labels
        # being the same in two processes: reported, not held.
        if not name.startswith("consensus_matrix"):
            check(same, f"plot run: {name} differs from the figure drawn "
                        "here")
    cij = cc.cdf_at_K_data[best_k]["cij"]
    check(len(drawn) == 1 and np.array_equal(drawn[0][1], labels),
          "plot: the heatmap's labels differ from consensus_labels_from_cij")
    order = np.argsort(labels, kind="stable")
    fig = plotting.plot_consensus_matrix(cij, labels, show=False)
    image = np.asarray(fig.axes[0].get_images()[0].get_array())
    same = np.array_equal(image, np.asarray(cij)[np.ix_(order, order)])
    report["heatmap_equal_cij_in_label_order"] = same
    check(same, "plot: the heatmap's image is not Cij in label order")
    plt.close("all")


# -- phase 18 ------------------------------------------------------------

#: The mesh phase's cuts: the estimator's H (and block) at N = 100,000, the
#: processes' sweep H and stream H, and the one-lane-group case's H, Ks and
#: group size.
MESH = dict(estimate_h=20, ranks_h=100, ranks_stream_h=200, lane_h=17,
            lane_ks=(2, 8, 14), lane_batch=8)

_RANK = r"""
import json, os, sys, time
import numpy as np
import torch
from chip_smoke import rank_arrays, rank_engine_run
from consensus_clustering_tpu_torch.ops import launch_counts, reset_launch_counts
from consensus_clustering_tpu_torch.parallel import distributed
from consensus_clustering_tpu_torch.parallel.mesh import resample_mesh
from consensus_clustering_tpu_torch.resilience.blocks import StreamCheckpointer

coord, pid, procs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cards = [torch.device("cuda", int(i)) for i in sys.argv[4].split(",")]
out_dir = sys.argv[6]
distributed.initialize(coord, num_processes=procs, process_id=pid,
                       local_devices=cards)
# Does gloo all-gather CUDA tensors itself?  (The port hands them to it as
# they are.)
probe = None
if distributed.backend() == "gloo":
    import torch.distributed as dist
    mine = torch.full((2,), pid, dtype=torch.int32, device=cards[0])
    got = [torch.empty_like(mine) for _ in range(procs)]
    try:
        dist.all_gather(got, mine)
        probe = "native: " + str([t.tolist() for t in got])
    except Exception as e:
        probe = f"refused: {type(e).__name__}: {str(e)[:160]}"
for item in sys.argv[5].split(","):
    engine, rows = item.split(":")
    mesh = resample_mesh(row_shards=int(rows))
    ring = (StreamCheckpointer(os.path.join(out_dir, f"ring_{engine}_{pid}"))
            if engine == "stream" else None)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = rank_engine_run(engine, dict(mesh=mesh), ring)
    wall = time.perf_counter() - t0
    if ring is not None:
        ring.close()
    np.savez(os.path.join(out_dir, f"{engine}_{rows}_{pid}.npz"),
             **rank_arrays(out))
    print("RESULT " + json.dumps({
        "engine": engine, "row_shards": int(rows), "pid": pid,
        "backend": distributed.backend(),
        "is_primary": distributed.is_primary(), "mesh": mesh.shape,
        "wall_seconds": wall,
        "run_seconds": out["timing"]["run_seconds"],
        "peak_device_bytes": out["timing"]["device_memory"].get(
            "peak_bytes_in_use"),
        "checkpoint_writes": out.get("streaming", {}).get(
            "checkpoint_writes"),
        "processes": out["timing"].get("processes"),
        "gloo_cuda_all_gather": probe,
        "launches": launch_counts()}), flush=True)
distributed.shutdown()
"""


def rank_engine_run(engine, where, ring=None, x=None):
    """One run of a ``mesh`` phase process engine on ``where`` (a mesh or
    a device), from a seed: ``sweep`` the dense sweep at the headline's
    width (H cut to ``MESH['ranks_h']``), ``stream`` the packed fused
    stream at the headline's width (H cut to ``MESH['ranks_stream_h']``,
    blocks of 100, the final state captured, ``ring`` its checkpointer),
    ``estimate`` the estimator at N = 100,000 (H = ``MESH['estimate_h']``
    in one block, packed pairs); ``x`` the data (default: made here).  The
    processes and their one-process references run the same function;
    the engine's build (kernels already built: none) is in the run."""
    from consensus_clustering_tpu_torch.config import SweepConfig
    from consensus_clustering_tpu_torch.estimator.engine import (
        PairConsensusEngine,
    )
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.parallel.streaming import (
        StreamingSweep,
    )
    from consensus_clustering_tpu_torch.parallel.sweep import run_sweep

    if x is None:
        x = estimate_data() if engine == "estimate" else headline_data()
    shape = dict(n_samples=x.shape[0], n_features=x.shape[1],
                 k_values=tuple(range(2, 21)), store_matrices=False,
                 chunk_size=4, cluster_batch=16)
    if engine == "sweep":
        config = SweepConfig(**shape, n_iterations=MESH["ranks_h"])
        return run_sweep(KMeans(n_init=3), config, x, 23, **where)
    if engine == "stream":
        h = MESH["ranks_stream_h"]
        config = SweepConfig(**shape, n_iterations=h,
                             stream_h_block=STREAM["stream_h_block"],
                             accum_repr="packed", fuse_block="auto")
        run = StreamingSweep(KMeans(n_init=3), config, **where)
        run.warmup()
        return run.run(x, 23, h, checkpointer=ring, capture_state=True)
    h = MESH["estimate_h"]
    config = SweepConfig(**shape, n_iterations=h, stream_h_block=h,
                         accum_repr="packed")
    run = PairConsensusEngine(KMeans(n_init=3), config, **where)
    run.warmup()
    return run.run(x, 23, h, return_state=True)


def rank_arrays(out):
    """The arrays a process run is held to its one-process run by: the
    curves, and the captured state or the pair counts."""
    arrays = {name: out[name] for name in ("hist", "cdf", "pac_area")}
    for group in ("final_state", "pair_state"):
        for name, value in out.get(group, {}).items():
            arrays[f"{group}/{name}"] = value
    return arrays


def phase_mesh(torch, results):
    """Multi-device sweeps on the card's virtual meshes (the card repeated):
    the dense headline on (k=2, h=2, n=2) with ``k_interleave`` and the
    packed fused stream on (h=2, n=2), each equal to ``PINNED_PAC`` with
    its launches pinned; the estimator at N = 100,000 on (h=2, n=2) equal
    to its one-device run; a shard whose last Lloyd group holds one lane;
    and gloo processes sharing the card, each engine equal to one process:
    two holding the card twice each (the monolithic sweep with 'h' across
    them), then two holding it once each (the sweep and the packed fused
    stream with 'n' across them, the estimator with 'h' across them).
    Copies between cards and NCCL are not exercised: the machine has one
    card."""
    from consensus_clustering_tpu_torch.parallel import resample_mesh

    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    phase_launches = {}
    for name, kwargs in (
            ("mesh_dense", dict(mesh=resample_mesh([card] * 8, row_shards=2,
                                                   k_shards=2),
                                k_interleave=True)),
            ("mesh_stream", dict(STREAM, mesh=resample_mesh(
                [card] * 4, row_shards=2)))):
        cc, launches = _drive(torch, name, results, **kwargs)
        per_device = cc.metrics_.get("device_memory", {})
        emit({"phase": "mesh", "run": name, "mesh": kwargs["mesh"].shape,
              "peak_device_bytes": per_device.get("peak_bytes_in_use"),
              "strategy": cc.metrics_.get("timing", {})})
        for kernel, n in launches.items():
            phase_launches[kernel] = phase_launches.get(kernel, 0) + n
        if name == "mesh_stream":
            check(cc.metrics_.get("timing", {}).get("fuse_block") == "fused",
                  f"mesh: the stream did not fuse: {cc.metrics_.get('timing')}")
    check(all(phase_launches.get(k, 0) > 0 for k in KERNEL_NAMES),
          f"mesh: a kernel was not launched on the mesh path: "
          f"{phase_launches}")
    refs = {"estimate": _mesh_estimator(torch, card, resample_mesh)}
    _mesh_one_lane_group(torch, card, resample_mesh)
    _mesh_processes(torch, "two_processes", ["0,0", "0,0"], "sweep:2",
                    "gloo", refs)
    _mesh_processes(torch, "two_processes_engines", ["0", "0"],
                    "sweep:2,stream:2,estimate:1", "gloo", refs)
    emit({"phase": "mesh", "seconds": time.perf_counter() - t_phase,
          "launches": phase_launches, "nvidia_smi": smi_line()})


def _mesh_estimator(torch, card, resample_mesh):
    """The estimator at N = 100,000 (cut to H = MESH['estimate_h'] in one
    block) on (h=2, n=2) against its one-device run: curves and every
    sampled pair's counts bit for bit.  Returns the one-device run's
    arrays and seconds (the processes' reference)."""
    from consensus_clustering_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
    )

    h = MESH["estimate_h"]
    x = estimate_data()
    runs = {}
    for name, where in (("one_device", dict(device=card)),
                        ("mesh", dict(mesh=resample_mesh([card] * 4,
                                                         row_shards=2)))):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = rank_engine_run("estimate", where, x=x)
        runs[name] = (out, time.perf_counter() - t0, launch_counts())
    (one, one_s, one_l), (got, got_s, got_l) = runs["one_device"], runs["mesh"]
    same = {name: bool(np.array_equal(got[name], one[name]))
            for name in ("hist", "cdf", "pac_area")}
    same.update({f"pair_{name}": bool(np.array_equal(
        got["pair_state"][name], one["pair_state"][name]))
        for name in ("pair_i", "pair_j", "mij", "iij")})
    emit({"phase": "mesh", "run": "estimate",
          "config": f"make_blobs N={ESTIMATE_N} d=50, H={h} (cut from "
                    f"{ESTIMATE_H} for time), K=2..20, KMeans(n_init=3), "
                    "cluster_batch=16, chunk_size=4, packed pairs, 2^17 "
                    "pairs, seed 23, mesh (h=2, n=2)",
          "one_device_seconds": one_s, "mesh_seconds": got_s,
          "one_device_peak_device_bytes": one["timing"]["device_memory"].get(
              "peak_bytes_in_use"),
          "mesh_peak_device_bytes": got["timing"]["device_memory"].get(
              "peak_bytes_in_use"),
          "one_device_launches": one_l, "mesh_launches": got_l,
          "equal_to_one_device": same})
    check(all(same.values()), f"mesh: estimator on (h=2, n=2) != one device "
                              f"{same}")
    check(got_l["lloyd"] > 0 and got_l["assign"] > 0,
          f"mesh: estimator launched {got_l}")
    return {"arrays": rank_arrays(one), "seconds": one_s}


def _mesh_one_lane_group(torch, card, resample_mesh):
    """H = 17 over 2 'h' shards with ``cluster_batch=8``: each shard has 9
    lane slots, so shard 0's last Lloyd group holds one lane (lane 8) and
    one device's last group another (lane 16); Mij must be the same."""
    from consensus_clustering_tpu_torch import ConsensusClustering

    x = headline_data()
    kw = dict(K_range=MESH["lane_ks"], n_iterations=MESH["lane_h"],
              random_state=23, cluster_batch=MESH["lane_batch"],
              chunk_size=4, store_matrices=True)
    t0 = time.perf_counter()
    one = ConsensusClustering(device=card, **kw, plot_cdf=False).fit(x)
    sharded = ConsensusClustering(mesh=resample_mesh([card] * 2), **kw,
                                  plot_cdf=False).fit(x)
    same = {k: bool(np.array_equal(one.cdf_at_K_data[k]["mij"],
                                   sharded.cdf_at_K_data[k]["mij"]))
            for k in MESH["lane_ks"]}
    emit({"phase": "mesh", "run": "one_lane_group",
          "config": f"headline data, H={MESH['lane_h']}, "
                    f"K={list(MESH['lane_ks'])}, cluster_batch="
                    f"{MESH['lane_batch']}, mesh (h=2)",
          "seconds": time.perf_counter() - t0, "mij_equal_per_k": same})
    check(all(same.values()), f"mesh: one-lane group Mij differs {same}")


def _mesh_processes(torch, name, cards, engines, backend, refs):
    """One process per entry of ``cards`` (each a comma list of the card
    indices it holds) in one group, running each of ``engines`` (a comma
    list of ``engine:row_shards``, :func:`rank_engine_run`) on the
    processes' mesh, each held bit for bit to this process's one-process
    run (``refs``: engine -> its arrays and seconds, filled as needed);
    the merges must go over ``backend``, rank 0 alone is primary, and only
    it writes the stream's frames."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO)
    out_dir = tempfile.mkdtemp(prefix="cctpu_ranks_")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, coord, str(pid), str(len(cards)),
         local, engines, out_dir], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid, local in enumerate(cards)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=900)
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith("RESULT ")]
            check(p.returncode == 0 and bool(lines),
                  f"mesh: a process exited {p.returncode}: {stderr[-2000:]}")
            outs.append([json.loads(ln[len("RESULT "):]) for ln in lines])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    try:
        for item in engines.split(","):
            engine, rows = item.split(":")
            if engine not in refs:
                t1 = time.perf_counter()
                one = rank_engine_run(engine, dict(device="cuda"))
                refs[engine] = {"arrays": rank_arrays(one),
                                "seconds": time.perf_counter() - t1}
            want = refs[engine]["arrays"]
            ranks = [next((r for r in o if r["engine"] == engine
                           and r["row_shards"] == int(rows)), None)
                     for o in outs]
            same = []
            for pid, rank in enumerate(ranks):
                path = os.path.join(out_dir, f"{engine}_{rows}_{pid}.npz")
                if rank is None or not os.path.exists(path):
                    same.append(False)
                    continue
                with np.load(path) as got:
                    same.append(sorted(got.files) == sorted(want) and all(
                        np.array_equal(got[k], want[k]) for k in want))
            live = [r for r in ranks if r is not None]
            emit({"phase": "mesh", "run": f"{name}:{engine}",
                  "config": _RANK_CONFIGS[engine] + f"; {len(cards)} "
                            f"processes holding cards {cards}, "
                            f"row_shards={rows}",
                  "group_wall_seconds": wall,
                  "one_process_seconds": refs[engine]["seconds"],
                  "processes": live, "equal_to_one_process": same})
            check(len(live) == len(cards) and all(same),
                  f"mesh: {name} {engine} != one process {same}")
            check([r["is_primary"] for r in live]
                  == [True] + [False] * (len(cards) - 1)
                  and all(r["backend"] == backend for r in live),
                  f"mesh: {name} roles "
                  f"{[(r['is_primary'], r['backend']) for r in live]}")
            if engine == "stream":
                writes = [r["checkpoint_writes"] for r in live]
                check(bool(writes) and writes[0] > 0
                      and not any(writes[1:]),
                      f"mesh: {name} stream frames written {writes}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


#: What each process engine runs (:func:`rank_engine_run`).
_RANK_CONFIGS = {
    "sweep": f"make_blobs N=5000 d=50, H={MESH['ranks_h']} (cut from 500), "
             "K=2..20, KMeans(n_init=3), cluster_batch=16, chunk_size=4, "
             "seed 23, the dense sweep",
    "stream": f"make_blobs N=5000 d=50, H={MESH['ranks_stream_h']} (cut "
              "from 500), K=2..20, KMeans(n_init=3), cluster_batch=16, "
              "chunk_size=4, seed 23, the packed fused stream, blocks of "
              "100, a ring each, the final state captured",
    "estimate": f"make_blobs N={ESTIMATE_N} d=50, H={MESH['estimate_h']} "
                "in one block, K=2..20, KMeans(n_init=3), cluster_batch=16, "
                "chunk_size=4, packed pairs, 2^17 pairs, seed 23",
}


def phase_mesh_cards(torch, results):
    """Distinct cards (four; a phase for a machine with several, not in
    the default run): the dense headline on the four cards twice as
    (k=2, h=2, n=2) with ``k_interleave`` and the packed fused stream on
    (h=2, n=2), each equal to ``PINNED_PAC`` with the virtual meshes'
    pinned launches (the same shards, so the same launches), the partial
    counts moving between cards; four processes with a card each over
    NCCL, the sweep at the headline's width (H cut to 100) with 'h'
    across them and the packed fused stream (H cut to 200) on (h=2, n=2),
    in subgroups of two, each equal to one process."""
    from consensus_clustering_tpu_torch.parallel import resample_mesh

    t_phase = time.perf_counter()
    check(torch.cuda.device_count() >= 4,
          f"mesh_cards: needs 4 cards, sees {torch.cuda.device_count()}")
    if torch.cuda.device_count() < 4:
        return
    cards = [torch.device("cuda", i) for i in range(4)]
    for name, pin, kwargs in (
            ("mesh_cards_dense", "mesh_dense",
             dict(mesh=resample_mesh(cards * 2, row_shards=2, k_shards=2),
                  k_interleave=True)),
            ("mesh_cards_stream", "mesh_stream",
             dict(STREAM, mesh=resample_mesh(cards, row_shards=2)))):
        _drive(torch, name, results, pin=pin, **kwargs)
        emit({"phase": "mesh_cards", "run": name, "peak_bytes_per_card": {
            str(c): torch.cuda.max_memory_allocated(c) for c in cards}})
    _mesh_processes(torch, "four_nccl_processes", ["0", "1", "2", "3"],
                    "sweep:1,stream:2", "nccl", {})
    emit({"phase": "mesh_cards", "seconds": time.perf_counter() - t_phase,
          "nvidia_smi": smi_line()})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES))
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - {"mesh_cards"}
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    # Figures render off screen, here and in every subprocess.
    os.environ["MPLBACKEND"] = "Agg"
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
    if "stream" in phases:
        phase_stream(torch, results)
    if "resume" in phases:
        phase_resume(torch, results)
    if "small" in phases:
        phase_small(torch)
    if "stream_small" in phases:
        phase_stream_small(torch)
    if "resilience_small" in phases:
        phase_resilience_small(torch)
    if "corr" in phases:
        phase_corr(torch)
    if "clusterers" in phases:
        phase_clusterers(torch, results)
    if "estimate" in phases:
        phase_estimate(torch, results)
    if "estimate_check" in phases:
        phase_estimate_check(torch, results)
    if "refine" in phases:
        phase_refine(torch, results)
    if "append" in phases:
        phase_append(torch, results)
    if "serve" in phases:
        phase_serve(torch, results)
    if "cli" in phases:
        phase_cli(torch, results)
    if "plot" in phases:
        phase_plot(torch, results)
    if "mesh" in phases:
        phase_mesh(torch, results)
    if "mesh_cards" in phases:
        phase_mesh_cards(torch, results)

    if FAILURES:
        print("chip_smoke FAILED: " + "; ".join(FAILURES), file=sys.stderr)
        return 1
    emit({"kernels": [results[k] for k in (*KERNEL_NAMES, "kmeanspp")
                      if k in results]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
