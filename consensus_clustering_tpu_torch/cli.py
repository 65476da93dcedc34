# Ported from consensus_clustering_tpu/cli.py.
"""Command-line entry point of the PyTorch/CUDA port.

    python -m consensus_clustering_tpu_torch run --dataset corr --k 2:15 \
        --iterations 100 --seed 23 --out results.json
    python -m consensus_clustering_tpu_torch serve --port 8000
    python -m consensus_clustering_tpu_torch serve-admin --store-dir DIR list
    python -m consensus_clustering_tpu_torch lint                # docs/LINT.md
    python -m consensus_clustering_tpu_torch autotune run --store DIR

The reference's subcommands with its flags, result JSON and exit codes.
``run``, ``serve`` and ``autotune run`` compute on ``cuda`` unless given
``--device cpu`` (without a GPU and without it they exit non-zero);
nothing falls back to the CPU or to a kernel's plain version.  ``run
--plot-dir DIR`` writes the CDF fan, the Δ(K) elbow and the best K's
consensus-matrix heatmap after the JSON.  ``lint`` is the reference's
static analyser, copied: it builds no kernel and touches no CUDA.
``bench`` exits non-zero naming ROADMAP item A18 (the repo's
``bench.py`` measures the reference package).  ``run --k-shards/
--row-shards`` shard the sweep over a mesh of every visible card, or,
with ``--device`` naming one device, over that device repeated (a
virtual mesh).  ``serve-admin`` stays off
the engine and never initialises CUDA: it exists for the moments the
card is wedged.

Results are written as JSON (PAC / CDF curves and stability statistics);
matrices stay out of the JSON by design.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_k(spec: str):
    if ":" in spec:
        lo, hi = spec.split(":")
        return tuple(range(int(lo), int(hi) + 1))
    return tuple(int(v) for v in spec.split(","))


def _refuse(feature: str, item: str):
    from consensus_clustering_tpu_torch.config import not_ported

    raise SystemExit(str(not_ported(feature, item)))


def _device(args):
    """``--device`` as a torch device: ``cuda`` when not given, which
    exits with :func:`..device.resolve_device`'s message without a GPU."""
    from consensus_clustering_tpu_torch.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{args.cmd}: {e}; here: --device cpu")


def _load_dataset(name: str, n: int, d: int, seed: int):
    import numpy as np

    if name == "corr":
        from consensus_clustering_tpu_torch.data import load_corr

        return load_corr(transform=True)
    if name == "blobs":
        from consensus_clustering_tpu_torch.data import make_blobs

        x, _ = make_blobs(
            n_samples=n, n_features=d, centers=8, cluster_std=3.0,
            random_state=seed,
        )
        return x.astype(np.float32)
    if name.endswith(".csv"):
        from consensus_clustering_tpu_torch.data import read_csv

        return read_csv(name).astype(np.float32)
    raise SystemExit(f"unknown dataset {name!r} (corr | blobs | path.csv)")


def _make_clusterer(name: str):
    from consensus_clustering_tpu_torch.models.agglomerative import (
        AgglomerativeClustering,
    )
    from consensus_clustering_tpu_torch.models.gmm import GaussianMixture
    from consensus_clustering_tpu_torch.models.kmeans import KMeans
    from consensus_clustering_tpu_torch.models.spectral import (
        SpectralClustering,
    )

    table = {
        "kmeans": KMeans(),
        "gmm": GaussianMixture(),
        "agglomerative": AgglomerativeClustering(),
        "spectral": SpectralClustering(),
    }
    if name not in table:
        raise SystemExit(
            f"unknown clusterer {name!r} (choose from {sorted(table)})"
        )
    return table[name]


def _mesh(args, device):
    """The ('k', 'h', 'n') mesh of ``--k-shards``/``--row-shards`` (None
    for one device): every visible card, or ``--device`` repeated once per
    shard when the flag names one device."""
    if args.k_shards <= 1 and args.row_shards <= 1:
        return None
    from consensus_clustering_tpu_torch.parallel.mesh import resample_mesh

    devices = None
    if args.device is not None:
        devices = [device] * (max(1, args.k_shards)
                              * max(1, args.row_shards))
    try:
        return resample_mesh(devices, row_shards=args.row_shards,
                             k_shards=args.k_shards)
    except ValueError as e:
        raise SystemExit(f"--k-shards/--row-shards: {e}")


def cmd_run(args):
    if args.use_pallas == "off" or args.packed_kernel == "off":
        raise SystemExit(
            "--use-pallas off / --packed-kernel off would run the kernels' "
            "plain versions on the card, a fallback the port does not take "
            "(use auto or on)"
        )
    device = _device(args)
    from consensus_clustering_tpu_torch.api import ConsensusClustering

    x = _load_dataset(args.dataset, args.n_samples, args.n_features, args.seed)
    if args.k_interleave and args.k_shards <= 1:
        # k_interleave only reorders work BETWEEN k-groups; without a
        # 'k'-axis mesh it is a silent no-op (SweepConfig docs) — tell
        # the user their load-balance knob did nothing.
        print(
            "warning: --k-interleave has no effect without --k-shards "
            ">= 2 (no 'k' mesh axis to spread K values over)",
            file=sys.stderr,
        )
    mesh = _mesh(args, device)
    # The heatmap needs Cij, so --plot-dir implies keeping matrices
    # unless they were explicitly switched off — in which case only the
    # curve figures are written.  Labels for ordering the heatmap are
    # extracted lazily for the best K alone (consensus_labels_from_cij),
    # not computed per swept K.
    store_matrices = {"on": True, "off": False}[args.store_matrices] \
        if args.store_matrices != "auto" else bool(args.plot_dir)
    progress_cb = None
    if args.progress:
        # With a checkpoint dir the fit may resume and sweep only the
        # non-checkpointed Ks, so a denominator from the full --k list
        # would never be reached; count without a total in that case.
        # Deduplicate: the callback fires once per distinct K, so a
        # repeated --k entry (e.g. 2,2,3) must not inflate the total.
        total = ("" if args.checkpoint_dir
                 else f"/{len(set(_parse_k(args.k)))}")
        done_count = [0]

        def progress_cb(k, pac):
            done_count[0] += 1
            print(f"K={k} done ({done_count[0]}{total}), pac={pac:.5f}",
                  file=sys.stderr, flush=True)

    if args.mode == "estimate" and store_matrices:
        raise SystemExit(
            "--mode estimate never materialises the consensus matrices "
            "(that is the point); drop --plot-dir / --store-matrices on"
        )
    if args.n_pairs is not None and args.mode == "exact":
        raise SystemExit(
            "--n-pairs only applies with --mode estimate or auto"
        )
    if args.adaptive is not None and not args.stream:
        raise SystemExit(
            "--adaptive needs --stream: early stopping is a property of "
            "the streaming driver loop (per-block PAC deltas)"
        )
    if args.adaptive is not None and store_matrices:
        raise SystemExit(
            "--adaptive is curves-only (an early-stopped run's matrices "
            "would disagree with its h_effective); drop --plot-dir / "
            "--store-matrices on, or run without --adaptive"
        )

    try:
        cc = ConsensusClustering(
            clusterer=_make_clusterer(args.clusterer),
            clusterer_options=(
                {} if args.clusterer != "kmeans" else {"n_init": 3}),
            K_range=_parse_k(args.k),
            n_iterations=args.iterations,
            subsampling=args.subsampling,
            random_state=args.seed,
            plot_cdf=False,
            device=device if mesh is None else None,
            mesh=mesh,
            k_interleave=args.k_interleave,
            store_matrices=store_matrices,
            checkpoint_dir=args.checkpoint_dir,
            compute_consensus_labels=False,
            profile_dir=args.profile_dir,
            use_pallas={"auto": None, "on": True}[args.use_pallas],
            cluster_batch=args.cluster_batch or None,
            split_init=args.split_init,
            metrics_path=args.metrics_path,
            k_batch_size=args.k_batch_size,
            compute_dtype=args.compute_dtype,
            progress_callback=progress_cb,
            stream_h_block=args.stream or None,
            accum_repr=args.accum_repr,
            use_packed_kernel={"auto": None, "on": True}[args.packed_kernel],
            fuse_block=args.fuse_block,
            adaptive_tol=args.adaptive,
            adaptive_patience=args.adaptive_patience,
            adaptive_min_h=args.adaptive_min_h,
            mode=args.mode,
            n_pairs=args.n_pairs,
            exact_best_k=args.exact_best_k,
        )
    except ValueError as e:
        raise SystemExit(f"run: {e}")
    t0 = time.perf_counter()
    cc.fit(x)
    wall = time.perf_counter() - t0

    result = {
        "dataset": args.dataset,
        "shape": list(x.shape),
        "clusterer": args.clusterer,
        # Constructor order (not sorted): "areas"/"delta_k" are parallel
        # arrays and a comma --k list may be unsorted.
        "K": [int(k) for k in cc.K_range],
        "pac_area": {k: v["pac_area"] for k, v in cc.cdf_at_K_data.items()},
        "areas": cc.areas_.tolist(),
        "delta_k": cc.delta_k_.tolist(),
        "best_k": cc.best_k_,
        "metrics": cc.metrics_,
        "wall_seconds": wall,
    }
    payload = json.dumps(result, indent=1, default=float)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        print(f"best_k={cc.best_k_}  -> {args.out}")
    else:
        print(payload)

    # After the JSON: a plotting failure (missing matplotlib extra,
    # unwritable dir) must not discard a completed sweep's results.
    if args.plot_dir:
        _write_figures(cc, args.plot_dir, device)


def _write_figures(cc, plot_dir: str, device) -> None:
    """Save the CDF fan, the Δ(K) elbow and — when Cij was kept — the
    best-K consensus-matrix heatmap into ``plot_dir``; the heatmap's
    labels are computed on ``device``."""
    import os

    from consensus_clustering_tpu_torch.utils.plotting import (
        plot_cdf,
        plot_consensus_matrix,
        plot_delta_k,
    )

    os.makedirs(plot_dir, exist_ok=True)
    plot_cdf(
        cc.cdf_at_K_data, pac_interval=cc.PAC_interval, show=False,
        save_path=os.path.join(plot_dir, "cdf.png"),
    )
    # areas_/delta_k_ follow the constructor's K_range order, which a
    # comma --k list may leave unsorted: keep x and y aligned.
    plot_delta_k(
        list(cc.K_range), cc.areas_, cc.delta_k_, show=False,
        save_path=os.path.join(plot_dir, "delta_k.png"),
    )
    best = cc.cdf_at_K_data[cc.best_k_]
    if best.get("cij") is not None:
        from consensus_clustering_tpu_torch.models.agglomerative import (
            consensus_labels_from_cij,
        )

        # Best-K labels only (one extraction), not per swept K; the
        # seed matters on the large-N spectral path (method="auto"),
        # where labels must follow the run's --seed like fit_predict.
        labels = best["consensus_labels"]
        if not len(labels):
            labels = consensus_labels_from_cij(
                best["cij"], cc.best_k_,
                linkage=cc.agg_clustering_linkage,
                method="auto",
                seed=int(cc.random_state),
                device=device,
            )
        plot_consensus_matrix(
            best["cij"],
            labels,
            show=False,
            save_path=os.path.join(
                plot_dir, f"consensus_matrix_K{cc.best_k_}.png"
            ),
        )


def _build_executor(args, device):
    """The service's executor on ``device``, its kernels probed (a build
    that fails stops the service here, before its first job)."""
    from consensus_clustering_tpu_torch.obs.drift import DriftWatchdog
    from consensus_clustering_tpu_torch.obs.memory import MemoryAccountant
    from consensus_clustering_tpu_torch.ops.probe import probe_kernels
    from consensus_clustering_tpu_torch.serve import SweepExecutor

    calibration = None
    if args.calibration_dir:
        from consensus_clustering_tpu_torch.autotune.store import (
            CalibrationStore,
            environment,
        )

        calibration = CalibrationStore(args.calibration_dir,
                                       env=environment(device))
    try:
        lo_s, _, hi_s = args.drift_band.partition(":")
        drift = DriftWatchdog(
            band=(float(lo_s), float(hi_s)),
            anchor_blocks=args.drift_anchor_blocks,
            enabled=not args.no_drift_watchdog,
        )
    except ValueError as e:
        raise SystemExit(
            f"serve: --drift-band {args.drift_band!r} / "
            f"--drift-anchor-blocks {args.drift_anchor_blocks}: {e}"
        )
    try:
        lo_s, _, hi_s = args.preflight_band.partition(":")
        memory_accountant = MemoryAccountant(
            band=(float(lo_s), float(hi_s)),
            enabled=not args.no_memory_accounting,
        )
    except ValueError as e:
        raise SystemExit(
            f"serve: --preflight-band {args.preflight_band!r}: {e}"
        )
    executor = SweepExecutor(
        device=device,
        # 0 = resolve per job through the autotune policy: a calibrated
        # block size for this (environment, shape bucket) when the
        # store has one, else the H/8-clamped-[16,128] heuristic as the
        # default tier.  A positive value pins one block size for every
        # job that doesn't set stream_h_block itself (user-pinned tier).
        default_h_block=args.stream_block or None,
        calibration_store=calibration,
        integrity_check_every=args.integrity_every,
        drift_watchdog=drift,
        memory_accountant=memory_accountant,
    )
    probe_kernels(executor.device)
    return executor


def cmd_serve(args):
    import logging
    import os
    import signal

    from consensus_clustering_tpu_torch.obs.slo import SLOMonitor
    from consensus_clustering_tpu_torch.serve import (
        BackendInitTimeout,
        ConsensusService,
        JobSpec,
        ShedPolicy,
        await_backend_init,
    )

    logging.basicConfig(level=logging.INFO)
    if args.lease_ttl <= 0:
        raise SystemExit(
            f"serve: --lease-ttl must be > 0, got {args.lease_ttl}"
        )
    if args.checkpoint_every != 1:
        raise SystemExit(
            "serve: --checkpoint-every must be 1: the port's executor "
            "writes its checkpoint ring after every evaluated block"
        )
    try:
        short_s, _, long_s = args.slo_windows.partition(":")
        slo_monitor = SLOMonitor(
            objectives=args.slo_objective or None,
            windows=(float(short_s), float(long_s)),
            burn_threshold=args.slo_burn,
            min_count=args.slo_min_count,
            enabled=not args.no_slo,
        )
    except ValueError as e:
        raise SystemExit(
            f"serve: --slo-objective/--slo-windows/--slo-burn/"
            f"--slo-min-count: {e}"
        )
    device = _device(args)
    # Bounded device initialisation, kernel builds and probe BEFORE
    # binding the port or reconciling jobs: a wedged card must fail the
    # process fast and named, not hang it in a state no liveness probe
    # can tell from a slow start.
    try:
        executor = await_backend_init(
            lambda: _build_executor(args, device), args.backend_init_timeout
        )
    except BackendInitTimeout as e:
        raise SystemExit(f"serve: {e}")
    from consensus_clustering_tpu_torch.serve.sched.fairshare import (
        parse_priority_weights,
        parse_tenant_weights,
    )

    try:
        priority_weights = parse_priority_weights(args.priority_weights)
        tenant_weights = parse_tenant_weights(args.tenant_weight)
    except ValueError as e:
        raise SystemExit(f"serve: {e}")
    memory_budget = None
    if args.memory_budget != "off":
        from consensus_clustering_tpu_torch.serve.preflight import (
            resolve_memory_budget,
        )

        if args.memory_budget == "auto":
            explicit = None
        else:
            try:
                explicit = int(args.memory_budget)
            except ValueError:
                raise SystemExit(
                    f"serve: --memory-budget {args.memory_budget!r} is "
                    "not valid; expected 'auto', 'off', or an integer "
                    "byte count"
                )
        memory_budget = resolve_memory_budget(explicit,
                                              device=executor.device)
        if memory_budget is None:
            print(
                "warning: no memory budget could be determined; the "
                "preflight gate is open (set --memory-budget BYTES or "
                "CCTPU_MEMORY_BUDGET)",
                file=sys.stderr,
            )
    service = ConsensusService(
        store_dir=args.store_dir,
        host=args.host,
        port=args.port,
        max_queue=args.queue_size,
        job_timeout=args.job_timeout or None,
        max_retries=args.max_retries,
        events_path=args.events_path,
        executor=executor,
        job_checkpoints=not args.no_job_checkpoints,
        quarantine_after=args.quarantine_after,
        watchdog=not args.no_watchdog,
        wedge_floor=args.wedge_floor,
        wedge_scale=args.wedge_scale,
        wedge_compile_grace=args.wedge_compile_grace,
        shed_policy=None if args.no_shed else ShedPolicy(
            low_frac=args.shed_low_frac,
            normal_frac=args.shed_normal_frac,
            retry_after=args.shed_retry_after,
        ),
        memory_budget_bytes=memory_budget,
        slo_monitor=slo_monitor,
        worker_id=args.worker_id,
        leases=not args.no_leases,
        lease_ttl=args.lease_ttl,
        fleet=not args.no_fleet,
        fleet_target_drain_seconds=args.fleet_target_drain,
        emulate_device_seconds=args.emulate_device_seconds,
        schedule=args.schedule,
        fusion_max=args.fusion_max,
        priority_weights=priority_weights,
        tenant_weights=tenant_weights,
        starvation_seconds=args.starvation_seconds,
        tenant_header=args.tenant_header or None,
        sse_keepalive_seconds=args.sse_keepalive,
    )
    if args.port_file:
        # The orchestration handshake for --port 0 (ephemeral): whoever
        # launched this process reads the bound port from the file —
        # written atomically so a reader never sees a partial line.
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(service.port))
        os.replace(tmp, args.port_file)
    for spec_str in args.warmup or ():
        # n,d,kspec,h — build this shape bucket's engine (and the
        # kernels behind it) so the first real request at it skips
        # straight to execution.
        try:
            n_s, d_s, k_s, h_s = spec_str.split(",", 3)
            spec = JobSpec(
                k_values=_parse_k(k_s.replace(";", ",")),
                n_iterations=int(h_s),
            )
            n, d = int(n_s), int(d_s)
        except ValueError:
            raise SystemExit(
                f"--warmup {spec_str!r}: expected n,d,klo:khi,h "
                "(e.g. 500,16,2:6,50)"
            )
        secs = executor.warmup(spec, n, d)
        block = executor._resolve_h_block(spec, n, d).value
        print(
            f"warmed bucket n={n} d={d} k={spec.k_values} "
            f"h_block={block} in {secs:.1f}s",
            file=sys.stderr,
        )
    print(
        f"consensus service on http://{args.host}:{service.port} "
        f"(store: {os.path.abspath(args.store_dir)}, "
        f"queue: {args.queue_size}, backend: {executor.backend()})",
        file=sys.stderr, flush=True,
    )
    # SIGINT stops the service however it was started (a shell without
    # job control starts background commands with SIGINT ignored).
    signal.signal(signal.SIGINT, signal.default_int_handler)
    try:
        service.serve_forever()
    except KeyboardInterrupt:
        service.stop()


def cmd_lint(args):
    from consensus_clustering_tpu_torch.lint.runner import run as lint_run

    raise SystemExit(lint_run(args))


def cmd_autotune(args):
    from consensus_clustering_tpu_torch.autotune.cli import (
        cmd_autotune as run,
    )

    raise SystemExit(run(args))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="consensus_clustering_tpu_torch",
        description="consensus clustering on one GPU (PyTorch + CUDA)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run a consensus k-sweep")
    run.add_argument("--dataset", default="corr",
                     help="corr | blobs | path.csv")
    run.add_argument("--clusterer", default="kmeans")
    run.add_argument("--k", default="2:10", help="lo:hi or comma list")
    run.add_argument("--iterations", type=int, default=100)
    run.add_argument("--subsampling", type=float, default=0.8)
    run.add_argument("--seed", type=int, default=23)
    run.add_argument("--n-samples", type=int, default=5000)
    run.add_argument("--n-features", type=int, default=50)
    run.add_argument("--device", default=None,
                     help="torch device (default: cuda, which needs a "
                     "GPU; cpu runs the kernels' plain versions)")
    run.add_argument("--checkpoint-dir", default=None)
    run.add_argument("--profile-dir", default=None,
                     help="write a torch.profiler trace here")
    run.add_argument("--cluster-batch", type=int, default=0,
                     help="resamples per clustering sub-batch (0 = one "
                     "batch); lets each group's Lloyd loop stop at its "
                     "own slowest lane")
    run.add_argument("--split-init", action="store_true",
                     help="with --cluster-batch: seed all lanes in one "
                     "full-width pass, group only the Lloyd loop "
                     "(bit-identical)")
    run.add_argument("--k-interleave", action="store_true",
                     help="on a 'k'-sharded mesh: assign K values to "
                     "k-groups round-robin so slow large-K problems "
                     "spread across groups (identical results)")
    run.add_argument("--k-shards", type=int, default=1,
                     help="shard the K sweep over this many k-groups "
                     "of devices (device count must be divisible by "
                     "k-shards * row-shards; with --device, that device "
                     "repeated)")
    run.add_argument("--row-shards", type=int, default=1,
                     help="shard the N x N consensus matrices over "
                     "this many row blocks of devices")
    run.add_argument("--use-pallas", choices=["auto", "on", "off"],
                     default="auto",
                     help="the histogram kernel: auto and on run it on "
                     "the card; off is refused (no plain version on a "
                     "CUDA tensor)")
    run.add_argument("--metrics-path", default=None,
                     help="append JSON-lines run metrics to this file")
    run.add_argument("--progress", action="store_true",
                     help="print a line per completed K")
    run.add_argument("--compute-dtype", choices=["float32", "float64"],
                     default="float32",
                     help="float64 is the parity path for ill-conditioned "
                     "data, on --device cpu (see SweepConfig.dtype).  A "
                     "seed >= 2^32 keys the port's generator with both "
                     "of its words, as the reference does only with x64 "
                     "on: for such seeds this command equals the "
                     "reference's only on its float64 path")
    run.add_argument("--k-batch-size", type=int, default=None,
                     help="run the sweep in batches of this many K "
                          "values, checkpointing after each")
    run.add_argument("--accum-repr", choices=["dense", "packed"],
                     default="dense",
                     help="exact-mode accumulator representation: "
                          "'packed' holds co-membership as bit-plane "
                          "words counted by the popcount kernel (results "
                          "bit-identical; config.ACCUM_REPRS)")
    run.add_argument("--packed-kernel", choices=["auto", "on", "off"],
                     default="auto",
                     help="with --accum-repr packed: the popcount kernel; "
                          "auto and on run it on the card, off is "
                          "refused (disclosed in metrics.timing as "
                          "packed_kernel)")
    run.add_argument("--fuse-block", choices=["auto", "on", "off"],
                     default="auto",
                     help="with --accum-repr packed: fuse the final "
                          "assignment and bit-plane packing into one "
                          "kernel so per-lane labels never materialise "
                          "(auto fuses where the clusterer supports it; "
                          "disclosed in metrics.timing as fuse_block)")
    run.add_argument("--stream", type=int, default=0, metavar="H_BLOCK",
                     help="stream the sweep in blocks of this many "
                     "resamples with device-resident accumulators "
                     "(0 = the monolithic sweep); bit-identical at "
                     "full H")
    run.add_argument("--adaptive", nargs="?", const=0.01, default=None,
                     type=float, metavar="TOL",
                     help="with --stream: stop early once every K's PAC "
                     "moves < TOL (bare flag: 0.01) for "
                     "--adaptive-patience consecutive blocks; the "
                     "result metrics carry h_effective and the "
                     "per-block PAC trajectory")
    run.add_argument("--adaptive-patience", type=int, default=2,
                     help="consecutive quiet blocks before an adaptive "
                     "stop (default 2)")
    run.add_argument("--adaptive-min-h", type=int, default=0,
                     help="resample floor before an adaptive stop may "
                     "trigger")
    run.add_argument("--mode", choices=["exact", "estimate", "auto"],
                     default="exact",
                     help="consensus execution mode: 'exact' (dense "
                     "O(N^2) accumulators, the reference statistic), "
                     "'estimate' (the sampled-pair estimator — O(M) "
                     "state, PAC with a disclosed error bound in "
                     "metrics.estimator), or 'auto' (exact when the "
                     "dense footprint fits the memory budget, estimate "
                     "otherwise); 'progressive' is serving-only")
    run.add_argument("--n-pairs", type=int, default=None,
                     help="pair-sample size for --mode estimate "
                     "(default: 2^17 capped at the N(N-1)/2 pair "
                     "population; more pairs = tighter bound)")
    run.add_argument("--exact-best-k", action="store_true",
                     help="with --mode estimate: recompute the chosen "
                     "K's curves exactly via the row-tiled pass so "
                     "best-K reporting carries no estimation band")
    run.add_argument("--store-matrices", choices=["auto", "on", "off"],
                     default="auto",
                     help="keep Iij/Mij/Cij in results (auto: on "
                     "only with --plot-dir, for the heatmap)")
    run.add_argument("--plot-dir", default=None,
                     help="write cdf.png, delta_k.png and the best K's "
                     "consensus-matrix heatmap here, after the JSON")
    run.add_argument("--out", default=None)
    run.set_defaults(fn=cmd_run)

    bench_p = sub.add_parser(
        "bench", help="not ported (ROADMAP A18): bench.py measures the "
        "reference package")
    bench_p.set_defaults(fn=lambda a: _refuse(
        "the bench subcommand (the port's benchmark script)", "A18"))

    serve_p = sub.add_parser(
        "serve", help="run the consensus-clustering HTTP service",
    )
    serve_p.add_argument("--host", default="127.0.0.1")
    serve_p.add_argument("--port", type=int, default=8000,
                         help="0 binds an ephemeral port")
    serve_p.add_argument("--device", default=None,
                         help="torch device of the executor (default: "
                         "cuda, which needs a GPU)")
    serve_p.add_argument("--store-dir", default="serve_store",
                         help="jobstore directory (results survive "
                         "restarts; identical submissions dedup)")
    serve_p.add_argument("--queue-size", type=int, default=16,
                         help="admission bound; a full queue returns 429")
    serve_p.add_argument("--job-timeout", type=float, default=0,
                         help="per-job wall-clock budget in seconds "
                         "(0 = unlimited)")
    serve_p.add_argument("--max-retries", type=int, default=2,
                         help="retries on transient failures "
                         "(exponential backoff)")
    serve_p.add_argument("--events-path", default=None,
                         help="append JSONL lifecycle events here")
    serve_p.add_argument("--stream-block", type=int, default=0,
                         help="default resamples per streamed H-block "
                         "for jobs that don't set stream_h_block; 0 "
                         "(default) resolves per job: calibrated block "
                         "size when --calibration-dir has a matching "
                         "record, else H/8 clamped to [16, 128]")
    serve_p.add_argument("--calibration-dir", default=None,
                         help="autotune calibration store consulted "
                         "for jobs that don't pin stream_h_block; "
                         "resolution provenance is disclosed per result "
                         "and in /metrics")
    serve_p.add_argument("--checkpoint-every", type=int, default=1,
                         help="checkpoint the streamed block state every "
                         "N evaluated blocks; the port writes every "
                         "block, so only 1 is accepted")
    serve_p.add_argument("--integrity-every", type=int, default=4,
                         help="run the accumulator integrity sentinel "
                         "(0 <= Mij <= Iij <= h_seen, diagonal, "
                         "sampled symmetry) every N evaluated blocks "
                         "and at the final block; a breach is retried "
                         "from the last VERIFIED checkpoint generation "
                         "(corrupt:accumulator).  0 disables")
    serve_p.add_argument("--no-job-checkpoints", action="store_true",
                         help="disable per-job block checkpointing "
                         "(payload persistence and restart re-queue "
                         "stay on; re-queued jobs restart from zero)")
    serve_p.add_argument("--port-file", default=None,
                         help="write the bound port here after binding "
                         "(the handshake for --port 0)")
    serve_p.add_argument("--warmup", action="append", default=None,
                         metavar="N,D,KSPEC,H",
                         help="build a shape bucket's engine at startup, "
                         "e.g. 500,16,2:6,50 (repeatable)")
    serve_p.add_argument("--backend-init-timeout", type=float, default=120,
                         help="fail startup if the device's "
                         "initialisation, the kernels' build or their "
                         "probe hangs past this many seconds; 0 "
                         "disables the bound")
    serve_p.add_argument("--no-watchdog", action="store_true",
                         help="disable the hang watchdog (a job whose "
                         "block heartbeat goes silent is then only "
                         "bounded by --job-timeout, if set)")
    serve_p.add_argument("--wedge-floor", type=float, default=30.0,
                         help="minimum heartbeat-silence deadline in "
                         "seconds (no block is ever declared wedged "
                         "faster than this)")
    serve_p.add_argument("--wedge-scale", type=float, default=8.0,
                         help="wedge deadline = max(floor, scale x the "
                         "bucket's observed/calibrated block seconds)")
    serve_p.add_argument("--wedge-compile-grace", type=float, default=600.0,
                         help="heartbeat-silence allowance before the "
                         "first block (engine and kernel build)")
    serve_p.add_argument("--quarantine-after", type=int, default=3,
                         help="restart-requeues allowed before a "
                         "crash-looping job is quarantined (payload + "
                         "checkpoint ring retained; release with "
                         "serve-admin)")
    serve_p.add_argument("--memory-budget", default="auto",
                         metavar="auto|off|BYTES",
                         help="memory preflight budget: 'auto' resolves "
                         "from CCTPU_MEMORY_BUDGET, else the card's "
                         "memory (host RAM with --device cpu); 'off' "
                         "disables the 413 gate; an integer pins bytes")
    serve_p.add_argument("--no-drift-watchdog", action="store_true",
                         help="disable the perf-drift watchdog (live "
                         "per-bucket throughput vs its calibrated/"
                         "observed anchor; perf_drift events + "
                         "/metrics ratios)")
    serve_p.add_argument("--drift-band", default="0.6:1.8",
                         metavar="LOW:HIGH",
                         help="acceptable live/anchor throughput ratio "
                         "band; outside it the bucket flags perf_drift "
                         "(default 0.6:1.8)")
    serve_p.add_argument("--drift-anchor-blocks", type=int, default=12,
                         help="evaluated blocks before a bucket with "
                         "no calibration record self-anchors on its "
                         "own block-time EWMA (default 12)")
    serve_p.add_argument("--no-memory-accounting", action="store_true",
                         help="disable per-bucket memory accounting "
                         "(preflight estimate vs the allocator's "
                         "measured peak; preflight_inaccurate events; "
                         "the admission gate then trusts the model "
                         "uncorrected)")
    serve_p.add_argument("--preflight-band", default="0.2:10",
                         metavar="LOW:HIGH",
                         help="acceptable preflight accuracy band "
                         "(estimated / measured bytes); outside it the "
                         "bucket flags preflight_inaccurate (default "
                         "0.2:10)")
    serve_p.add_argument("--no-slo", action="store_true",
                         help="disable the SLO monitor (no slo_breach "
                         "events; /metrics slo section reports "
                         "enabled=false)")
    serve_p.add_argument("--slo-objective", action="append",
                         default=None,
                         metavar="SIGNAL:THRESHOLD[:TARGET]",
                         help="SLO objective, repeatable: signal "
                         "(job_seconds | queue_wait_seconds | "
                         "error_rate), latency threshold in seconds "
                         "(empty for error_rate), target good "
                         "fraction (default 0.95). Default: "
                         "job_seconds:600:0.95 "
                         "queue_wait_seconds:120:0.95 error_rate::0.9")
    serve_p.add_argument("--slo-windows", default="300:3600",
                         metavar="SHORT:LONG",
                         help="rolling burn-rate windows in seconds "
                         "(default 300:3600); a breach needs the burn "
                         "over BOTH")
    serve_p.add_argument("--slo-burn", type=float, default=2.0,
                         help="error-budget burn multiple that "
                         "breaches (default 2.0)")
    serve_p.add_argument("--slo-min-count", type=int, default=3,
                         help="long-window samples required before an "
                         "(objective, bucket) may breach (default 3)")
    serve_p.add_argument("--no-shed", action="store_true",
                         help="disable priority-aware overload shedding "
                         "(admission then only bounds at --queue-size)")
    serve_p.add_argument("--shed-low-frac", type=float, default=0.5,
                         help="queue fraction at which low-priority "
                         "admissions shed (429 + Retry-After)")
    serve_p.add_argument("--shed-normal-frac", type=float, default=0.85,
                         help="queue fraction at which normal-priority "
                         "admissions shed")
    serve_p.add_argument("--shed-retry-after", type=float, default=15.0,
                         help="FLOOR for the Retry-After on shed "
                         "responses; the actual hint derives from the "
                         "live queue drain rate")
    serve_p.add_argument("--schedule", choices=["fair", "fifo"],
                         default="fair",
                         help="admission queue discipline: weighted-fair "
                         "DRR lanes over tenant x priority (default), or "
                         "the bounded FIFO as the control arm")
    serve_p.add_argument("--fusion-max", type=int, default=1,
                         help=">= 2 enables same-bucket job fusion: up "
                         "to this many runnable jobs sharing one shape "
                         "bucket run as one fused execution "
                         "(bit-identical to solo).  1 = off (the "
                         "default; requires --schedule fair)")
    serve_p.add_argument("--priority-weights", default=None,
                         metavar="HIGH:NORMAL:LOW",
                         help="DRR weights per priority lane "
                         "(default 4:2:1)")
    serve_p.add_argument("--tenant-weight", action="append",
                         default=None, metavar="TENANT=W",
                         help="per-tenant DRR weight multiplier "
                         "(repeatable; unlisted tenants weigh 1)")
    serve_p.add_argument("--starvation-seconds", type=float,
                         default=30.0,
                         help="fair-share starvation clock: a lane "
                         "whose head job has waited longer than this "
                         "is served next regardless of weights")
    serve_p.add_argument("--tenant-header", default="X-Tenant",
                         help="HTTP header carrying the tenant "
                         "identity (overrides config.tenant when "
                         "present; empty string disables)")
    serve_p.add_argument("--sse-keepalive", type=float, default=5.0,
                         help="seconds between SSE keepalive comment "
                         "frames on GET /jobs/<id>/events")
    serve_p.add_argument("--worker-id", default=None,
                         help="restart-stable identity of this worker "
                         "over a SHARED jobstore; default: the hostname "
                         "— co-hosted workers must set their own")
    serve_p.add_argument("--lease-ttl", type=float, default=60.0,
                         help="job-lease expiry in seconds; a worker "
                         "silent past this is presumed dead and its "
                         "jobs are taken over by a peer")
    serve_p.add_argument("--no-leases", action="store_true",
                         help="disable fenced job leases (single-worker "
                         "stores only)")
    serve_p.add_argument("--no-fleet", action="store_true",
                         help="disable the fleet layer — heartbeat "
                         "advertisement, work-stealing pickup, and the "
                         "autoscale signal; implied by --no-leases")
    serve_p.add_argument("--fleet-target-drain", type=float,
                         default=60.0,
                         help="seconds the fleet should be able to "
                         "drain its whole backlog in at the measured "
                         "rate; a worse estimate flips the autoscale "
                         "signal to scale_out")
    serve_p.add_argument("--emulate-device-seconds", type=float,
                         default=0.0,
                         help="benchmark-only: sleep this long after "
                         "every executor program that ran, emulating a "
                         "fixed-latency remote accelerator; 0 disables")
    serve_p.set_defaults(fn=cmd_serve)

    admin_p = sub.add_parser(
        "serve-admin",
        help="operate on a serve jobstore: quarantine list/show/release, "
        "profile-next, trace/report/bundle (never initialises CUDA)",
    )
    from consensus_clustering_tpu_torch.serve.admin import (
        add_arguments as admin_add_arguments,
        cmd_serve_admin,
    )

    admin_add_arguments(admin_p)
    admin_p.set_defaults(fn=lambda a: sys.exit(cmd_serve_admin(a)))

    lint_p = sub.add_parser(
        "lint",
        help="run jaxlint, the JAX-aware static analyzer (docs/LINT.md)",
    )
    from consensus_clustering_tpu_torch.lint.runner import add_arguments

    add_arguments(lint_p)
    lint_p.set_defaults(fn=cmd_lint)

    autotune_p = sub.add_parser(
        "autotune",
        help="parity-gated perf probes + calibration store",
    )
    from consensus_clustering_tpu_torch.autotune.cli import (
        add_arguments as autotune_add_arguments,
    )

    autotune_add_arguments(autotune_p)
    autotune_p.set_defaults(fn=cmd_autotune)

    args, extra = parser.parse_known_args(argv)
    if extra and args.cmd != "bench":
        # The refused subcommand takes whatever the reference's takes;
        # every other subcommand parses strictly.
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd in ("run", "serve", "autotune"):
        # After parsing: --help and argument errors build nothing.
        from consensus_clustering_tpu_torch.utils.platform import (
            enable_compilation_cache,
        )

        enable_compilation_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
