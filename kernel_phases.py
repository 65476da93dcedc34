#!/usr/bin/env python3
"""Where the time of the Lloyd kernel (B2) and the final-assignment kernel
goes, phase by phase, on the GPU.

    python3 kernel_phases.py [--rounds 3]

Run from the repository root.  Builds copies of
``consensus_clustering_tpu_torch/csrc/`` with one phase cut out of a
kernel each (the cuts are textual edits of the sources; one that no longer
applies raises) into the package's ``_build/phases/``, one ``nvcc`` per
copy, all started together, and times each copy's kernel at the timing
shape of ``chip_smoke.py``: the headline's lane batch, 16 resamples x
n_init 3 of 4000 x 50 rows, k = k_max = 20.  A phase's cost is the full
kernel's time less the time without it; phases overlap on the card, so
the costs need not add up.  The full kernels are also timed with one lane
per block (no lane shares a staged tile), and are first held bit for bit
against their plain versions.  Times are means over CUDA-graph replays of
50 launches (``chip_smoke.device_ms``), in ``--rounds`` interleaved
rounds.  Prints the card's name and power limit, then one JSON line per
(kernel, variant).  Needs a CUDA device and ``nvcc``.

    python3 kernel_phases.py --root DIR

instead times the full kernels of the package in another checkout DIR
(an unpacked earlier commit, say) the same way, and their back-to-back
calls, so that two versions compare by one method in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

import torch

from chip_smoke import cuda_ms, device_ms, smi_line

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
# kernel -> the library (csrc/<name>.cu) that holds it.
_SOURCE = {"assign": "fused_block", "lloyd": "lloyd"}


def build_variants() -> dict:
    """(kernel, variant) -> path of its library, all compiled together."""
    from consensus_clustering_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for kernel, variants in VARIANTS.items():
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device is visible", file=sys.stderr)
        return 2
    print(smi_line(), flush=True)
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    from consensus_clustering_tpu_torch import rng
    from consensus_clustering_tpu_torch.data import make_blobs
    from consensus_clustering_tpu_torch.ops import _build, fused_block, lloyd
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
        return 0
    plain = {
        "assign": fused_block.assign_labels_plain(xs, src, cen, 20),
        "lloyd": lloyd.lloyd_step_ordered_plain(xs, src, cen, 20),
    }
    paths = build_variants()
    times = {key: [] for key in paths}
    one_lane = {kernel: [] for kernel in VARIANTS}
    for _ in range(args.rounds):
        for (kernel, name), path in paths.items():
            fn = kernels[kernel]
            with _build.library_override(_SOURCE[kernel], path):
                if name == "full":
                    got = fn(xs, src, cen, 20)
                    if not all(torch.equal(a, b)
                               for a, b in zip(got, plain[kernel])):
                        raise RuntimeError(f"{kernel} != its plain version")
                    one_lane[kernel].append(device_ms(
                        torch, lambda: fn(xs, src, cen, 20, per_block=1), 50))
                times[kernel, name].append(
                    device_ms(torch, lambda: fn(xs, src, cen, 20), 50))
    for (kernel, name), ts in times.items():
        print(json.dumps({"kernel": kernel, "variant": name, "ms": ts,
                          "shape": [48, 4000, 50, 20]}), flush=True)
    for kernel, ts in one_lane.items():
        print(json.dumps({"kernel": kernel, "variant": "full, one lane a "
                          "block", "ms": ts, "shape": [48, 4000, 50, 20]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
