#!/usr/bin/env python3
"""Where the time of the Lloyd kernel (B2), the final-assignment kernel,
the histogram (B1) and the fused assign+pack kernel (B4) goes, phase by
phase, on the GPU.

    python3 kernel_phases.py [--rounds 3] [--kernels lloyd,assign,hist,fused_block]

Run from the repository root.  Builds copies of
``consensus_clustering_tpu_torch/csrc/`` with one phase cut out of a
kernel, or one design choice changed, each (the cuts are textual edits of
the sources; one that no longer applies raises) into the package's
``_build/phases/``, one ``nvcc`` per copy, all started together, and
times each copy's kernel at the timing shapes of ``chip_smoke.py``: B2
and the assignment at the headline's lane batch, 16 resamples x n_init 3
of 4000 x 50 rows, k = k_max = 20; B1 at the cases listed below; B4 at
the stream headline's block.  A phase's cost is the full kernel's time
less the time without it; phases overlap on the card, so the costs need
not add up.  The full kernels are first held bit for bit against their
plain versions, and also timed with one lane a block (B2, the
assignment: no lane shares a staged tile) or at each of
``FUSED_SPLITS`` splits of a word's lanes (B4).  Times are means over
CUDA-graph replays of 50 launches (``chip_smoke.device_ms``), in
``--rounds`` interleaved rounds.  Prints the card's name and power limit,
then one JSON line per (kernel, variant, case).  Needs a CUDA device and
``nvcc``.

    python3 kernel_phases.py --root DIR

instead times the full kernels of the package in another checkout DIR
(an unpacked earlier commit, say) the same way, and their back-to-back
calls, so that two versions compare by one method in one call: B2 and the
assignment at the shape above, B1 on a uniform and a bimodal 5000 x 5000
Cij and on the stream's first 256 x 5120 tile of each (and the tile's
whole evaluation from its int32 counts: the count entry where the
checkout has one, else Cij formed and then counted, timed back to back
only), and B4 at the stream headline's block (5120 x 50, 100 lanes,
k 20, 4 words).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys

import torch

from chip_smoke import count_tiles, cuda_ms, device_ms, smi_line

_NO_DIST = ("common.cuh",
            "    if (live) {\n      const int split",
            "    if (false) {\n      const int split")
# kernel -> variant -> cuts: (file, text, replacement) each.
VARIANTS = {
    "assign": {
        "full": [],
        "no distances": [_NO_DIST],
        "no row staging": [
            ("fused_block.cu",
             "      cc_stage_rows<4>(x + ((size_t)src * n + row0) * d, rows, "
             "d, xs, xt);", "")],
    },
    "lloyd": {
        "full": [],
        "no distances": [_NO_DIST],
        "no row staging": [
            ("lloyd.cu",
             "      cc_stage_rows<4>(x + ((size_t)src * n + row0) * d, rows, "
             "d, xs, xt);", "")],
        "no partial sums": [
            ("lloyd.cu", "  for (int j0 = 0; j0 < k_max; j0 += 32) {",
             "  for (int j0 = 0; j0 < 0; j0 += 32) {")],
        "no tile far points": [
            ("lloyd.cu", "b >= 0 && b < k_max;", "b >= 0 && b < 0;")],
        "no reduction kernel": [
            ("lloyd.cu", "  lloyd_reduce_kernel<<<",
             "  if (false) lloyd_reduce_kernel<<<")],
    },
}
VARIANTS["hist"] = {
    "full": [],
    "no atomics": [
        ("hist.cu", "    atomicAdd(&counts[b], 1);\n  };",
         "    if (b == 1000) counts[0] = b;\n  };")],
    "no bin arithmetic": [
        ("hist.cu", "    const float p = __fmul_rn(v, fbins);",
         "    const float p = 0.5f;")],
    "edges checked for every value": [
        ("hist.cu", "      if ((frac < CC_HIST_NEAR && b > 0) || "
         "frac > 1.0f - CC_HIST_NEAR) {", "      if (true) {")],
    "loads only": [
        ("hist.cu", "    if (!(v >= lo && v <= hi)) return;",
         "    if (!(v >= lo && v <= hi) || v != 12345.0f) return;")],
    "8 units a thread": [
        ("hist.cu", "#define CC_HIST_UNITS 4", "#define CC_HIST_UNITS 8")],
}
VARIANTS["fused_block"] = {
    "full": [],
    "no distances": [
        ("fused_block.cu", "        cc_nearest_slots<VEC>(xt + col * xs,",
         "        if (false) cc_nearest_slots<VEC>(xt + col * xs,")],
    "no merge kernel": [
        ("fused_block.cu", "  fused_merge_kernel<<<",
         "  if (false) fused_merge_kernel<<<")],
}
# kernel -> the library (csrc/<name>.cu) that holds it.
_SOURCE = {"assign": "fused_block", "lloyd": "lloyd", "hist": "hist",
           "fused_block": "fused_block"}
# B4's splits of a word's lanes, timed with the full kernel.
FUSED_SPLITS = (1, 2, 3, 4, 5, 6, 8)


def build_variants(kernels) -> dict:
    """(kernel, variant) -> path of its library, for each of ``kernels``,
    all compiled together."""
    from consensus_clustering_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for kernel in kernels:
        variants = VARIANTS[kernel]
        for name, cuts in variants.items():
            d = os.path.join(_build.BUILD_DIR, "phases", kernel,
                             name.replace(" ", "_"))
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(_build.CSRC_DIR, d)
            for fname, old, new in cuts:
                path = os.path.join(d, fname)
                with open(path) as f:
                    text = f.read()
                if old not in text:
                    raise RuntimeError(f"cut {name!r} of {kernel} no longer "
                                       f"applies to {fname}")
                with open(path, "w") as f:
                    f.write(text.replace(old, new))
            out = os.path.join(d, "lib.so")
            procs[kernel, name] = (out, subprocess.Popen(
                _build.nvcc_command(
                    nvcc, os.path.join(d, _SOURCE[kernel] + ".cu"), out),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    paths = {}
    for key, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {key} failed:\n{log}")
        paths[key] = out
    return paths


def b1_b4_cases() -> dict:
    """name -> (shape, wrapper call, whether a CUDA graph can hold it) for
    B1 and B4, from the package on sys.path (this checkout's or
    ``--root``'s)."""
    from consensus_clustering_tpu_torch import rng
    from consensus_clustering_tpu_torch.data import make_blobs
    from consensus_clustering_tpu_torch.ops import fused_block, hist
    from consensus_clustering_tpu_torch.ops.analysis import consensus_matrix
    from consensus_clustering_tpu_torch.ops.bitpack import pack_cosample_planes
    from consensus_clustering_tpu_torch.ops.resample import resample_indices

    cases = {}
    for kind in ("uniform", "bimodal"):
        cij = consensus_matrix(*count_tiles(torch, 5000, 5000, 0, kind))
        mij_t, iij_t = count_tiles(torch, 256, 5120, 1, kind)
        tile = consensus_matrix(mij_t, iij_t)
        cases[f"hist {kind}"] = ([5000, 5000], functools.partial(
            hist.consensus_hist_counts_kernel, cij, 5000, 0, 20), True)
        cases[f"hist tile {kind}"] = ([256, 5120], functools.partial(
            hist.consensus_hist_counts_kernel, tile, 5000, 0, 20), True)
        if hasattr(hist, "consensus_hist_from_counts"):
            out = torch.zeros(20, dtype=torch.int64, device="cuda")
            cases[f"hist count entry tile {kind}"] = (
                [256, 5120], functools.partial(
                    hist.consensus_hist_from_counts, mij_t, iij_t, 5000, 0,
                    20, out), True)
        else:  # its consensus_matrix copies eps from the host: no graph
            cases[f"hist count entry tile {kind}"] = (
                [256, 5120], lambda m=mij_t, i=iij_t: (
                    hist.consensus_hist_counts_kernel(
                        consensus_matrix(m, i, row_offset=0), 5000, 0, 20)),
                False)
    x_np, _ = make_blobs(n_samples=5000, n_features=50, centers=8,
                         cluster_std=3.0, random_state=0)
    x_cols = torch.zeros((5120, 50), device="cuda")
    x_cols[:5000] = torch.tensor(x_np, dtype=torch.float32, device="cuda")
    idx = resample_indices(rng.prng_key(100, "cuda"), 5000, 100, 4000)
    cop = pack_cosample_planes(idx, 5120, n_words=4, row0=0)
    g = torch.Generator(device="cuda").manual_seed(4)
    cents = x_cols[torch.randint(0, 5000, (100, 20), generator=g,
                                 device="cuda")]
    cases["fused_block"] = ([5120, 50, 100, 20, 4], functools.partial(
        fused_block.fused_assign_pack_kernel, x_cols, cents, 20, cop, 0, 4),
        True)
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--root", default=None)
    ap.add_argument("--kernels", default=",".join(VARIANTS),
                    help="kernels to time phase by phase (comma-separated)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device is visible", file=sys.stderr)
        return 2
    print(smi_line(), flush=True)
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    from consensus_clustering_tpu_torch import rng
    from consensus_clustering_tpu_torch.data import make_blobs
    from consensus_clustering_tpu_torch.ops import (
        _build,
        fused_block,
        hist,
        lloyd,
    )
    from consensus_clustering_tpu_torch.ops.resample import resample_indices

    x_np, _ = make_blobs(n_samples=5000, n_features=50, centers=8,
                         cluster_std=3.0, random_state=0)
    x_all = torch.tensor(x_np, dtype=torch.float32, device="cuda")
    idx = resample_indices(rng.prng_key(23, "cuda"), 5000, 16, 4000)
    xs = x_all[idx].contiguous()
    src = torch.arange(16, device="cuda",
                       dtype=torch.int32).repeat_interleave(3)
    g = torch.Generator(device="cuda").manual_seed(1)
    cen = xs[src.long()[:, None], torch.randint(
        0, 4000, (48, 20), generator=g, device="cuda")].contiguous()
    kernels = {"assign": fused_block.assign_labels_kernel,
               "lloyd": lloyd.lloyd_step_kernel}
    if args.root is not None:
        for _ in range(args.rounds):
            for kernel, fn in kernels.items():
                line = {"kernel": kernel, "root": args.root,
                        "package": os.path.dirname(lloyd.__file__),
                        "shape": [48, 4000, 50, 20],
                        "eager_ms": cuda_ms(
                            torch, lambda: fn(xs, src, cen, 20), 50)}
                try:
                    line["ms"] = device_ms(
                        torch, lambda: fn(xs, src, cen, 20), 50)
                except RuntimeError as err:  # a wrapper graphs cannot hold
                    line["ms"] = f"not measured: {err}"
                print(json.dumps(line), flush=True)
            for name, (shape, fn, graph) in b1_b4_cases().items():
                print(json.dumps({
                    "kernel": name, "root": args.root, "shape": shape,
                    "eager_ms": cuda_ms(torch, fn, 50),
                    "ms": device_ms(torch, fn, 50) if graph else
                    "not measured: host copies in the call"}), flush=True)
        return 0
    phased = [k for k in args.kernels.split(",") if k]
    unknown = set(phased) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
    b1_b4 = b1_b4_cases()
    # kernel -> (case -> call), and each kernel's check against its plain
    # version, run with the full build.
    calls = {kernel: {"headline": functools.partial(fn, xs, src, cen, 20)}
             for kernel, fn in kernels.items()}
    calls["hist"] = {name: fn for name, (_, fn, _) in b1_b4.items()
                     if name.startswith("hist")}
    calls["fused_block"] = {"headline": b1_b4["fused_block"][1]}
    plain = {
        "assign": fused_block.assign_labels_plain(xs, src, cen, 20),
        "lloyd": lloyd.lloyd_step_ordered_plain(xs, src, cen, 20),
    }

    def check_full(kernel):
        if kernel in plain:
            got = kernels[kernel](xs, src, cen, 20)
            same = all(torch.equal(a, b) for a, b in zip(got, plain[kernel]))
        elif kernel == "fused_block":
            fn = b1_b4["fused_block"][1]
            same = torch.equal(fn(), fused_block.fused_planes_plain(
                *fn.args))
        else:
            same = all(
                torch.equal(hist.consensus_hist_counts_kernel(*fn.args),
                            hist.consensus_hist_counts_plain(*fn.args))
                for name, fn in calls["hist"].items()
                if "count entry" not in name)
        if not same:
            raise RuntimeError(f"{kernel} != its plain version")

    paths = build_variants(phased)
    times = {(kernel, name, case): [] for kernel, name in paths
             for case in calls[kernel]}
    extra = {}
    for _ in range(args.rounds):
        for (kernel, name), path in paths.items():
            with _build.library_override(_SOURCE[kernel], path):
                if name == "full":
                    check_full(kernel)
                    if kernel in plain:
                        fn = kernels[kernel]
                        extra.setdefault((kernel, "one lane a block"),
                                         []).append(device_ms(torch, lambda: (
                                             fn(xs, src, cen, 20,
                                                per_block=1)), 50))
                    if kernel == "fused_block":
                        fn = b1_b4["fused_block"][1]
                        for n in FUSED_SPLITS:
                            extra.setdefault(
                                (kernel, f"{n} splits a word"), []).append(
                                device_ms(torch, functools.partial(
                                    fn, splits=n), 50))
                for case, fn in calls[kernel].items():
                    times[kernel, name, case].append(device_ms(torch, fn, 50))
    for (kernel, name, case), ts in times.items():
        print(json.dumps({"kernel": kernel, "variant": name, "case": case,
                          "ms": ts}), flush=True)
    for (kernel, name), ts in extra.items():
        print(json.dumps({"kernel": kernel, "variant": f"full, {name}",
                          "case": "headline", "ms": ts}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
