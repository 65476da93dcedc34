"""What the port may import, where it runs, and what it refuses.

- The package imports neither ``jax`` nor ``consensus_clustering_tpu``
  (checked with ``ast`` and in a subprocess where both are poisoned).
- ``fit`` without ``device`` raises when no GPU is visible.
- The subprocess also drives every clusterer (GMM, agglomerative,
  spectral, an sklearn estimator on the host backend), ``k_batch_size``,
  consensus labels and ``fit_predict``, the estimator (``mode="estimate"``
  and ``"auto"``, ``exact_best_k``), an append on a plane store, a
  ``ConsensusService`` answering one job over HTTP, the command line
  (``run``, ``autotune run``, ``serve-admin``, ``lint``),
  ``autotune=True`` and a plotting ``fit`` under Agg; the ``ast`` scan
  covers every subpackage (``estimator/``, ``append/``, ``serve/``,
  ``serve/sched/``, ``serve/fleet/``, ``obs/``, ``autotune/``,
  ``utils/`` and ``lint/`` included) and the command line's modules.
- Every ``ConsensusClustering(`` call in the port's tests and root
  scripts passes ``plot_cdf``, since the default draws a figure (the
  plotting tests are exempt).
- The kernel modules import on the CPU, their wrappers take the plain
  versions there, and the build raises a clear error without ``nvcc``.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import consensus_clustering_tpu_torch as port
from consensus_clustering_tpu_torch import ConsensusClustering
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.convert import (
    config_from_jax,
    key_from_jax,
    kmeans_from_jax,
)
from consensus_clustering_tpu_torch.ops import (
    _build,
    fused_block,
    hist,
    launch_counts,
    lloyd,
    popcount,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(port.__file__))


def _port_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "batch_invariance.py")


def _forbidden(name):
    return name == "jax" or name.startswith("jax.") or (
        name == "consensus_clustering_tpu"
        or name.startswith("consensus_clustering_tpu.")
    )


def test_no_module_imports_jax_or_the_reference_package():
    offenders = []
    scanned = {os.path.relpath(os.path.dirname(p), PKG)
               for p in _port_sources()}
    assert {"estimator", "append", "serve", "ops", "parallel", "obs",
            "serve/sched", "serve/fleet", "autotune", "utils",
            "lint"} <= scanned
    files = {os.path.relpath(p, PKG) for p in _port_sources()}
    assert {"cli.py", "__main__.py", "serve/admin.py", "obs/query.py",
            "autotune/probes.py", "autotune/cli.py", "ops/probe.py",
            "utils/platform.py", "utils/plotting.py", "parallel/mesh.py",
            "parallel/distributed.py", "lint/__init__.py",
            "lint/__main__.py", "lint/contracts.py", "lint/findings.py",
            "lint/packs.py", "lint/registry.py", "lint/reporters.py",
            "lint/rules.py", "lint/runner.py"} <= files
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [(path, n) for n in names if _forbidden(n)]
    assert not offenders, offenders


def _calls_omitting_plot_cdf(source):
    """Lines of ``ConsensusClustering(`` calls (under any name it is
    imported as, or as an attribute) without a ``plot_cdf`` keyword, also
    inside string literals that parse as Python (subprocess scripts)."""
    tree = ast.parse(source)
    names = {"ConsensusClustering"}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname for a in node.names
                      if a.name == "ConsensusClustering" and a.asname}
    lines = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and "ConsensusClustering(" in node.value):
            try:
                inner = _calls_omitting_plot_cdf(node.value)
            except SyntaxError:  # prose, not a script
                inner = []
            lines += [node.lineno + n - 1 for n in inner]
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if ((isinstance(f, ast.Name) and f.id in names)
                or (isinstance(f, ast.Attribute)
                    and f.attr == "ConsensusClustering")):
            if not any(k.arg == "plot_cdf" for k in node.keywords):
                lines.append(node.lineno)
    return sorted(lines)


def test_every_fit_outside_the_plotting_tests_names_plot_cdf():
    """``plot_cdf`` defaults to True, as in the reference: a call that
    omits it draws a figure at the end of ``fit`` (one per fit in every
    test worker).  The tests and root scripts pass it, as the reference's
    tests pass ``plot_cdf=False``; only the plotting tests draw."""
    tests = os.path.join(REPO, "tests")
    paths = [os.path.join(tests, f) for f in sorted(os.listdir(tests))
             if f.startswith("test_torch_") and f.endswith(".py")
             and f != "test_torch_plotting.py"]
    paths += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "batch_invariance.py")]
    missing = {}
    for path in paths:
        with open(path) as f:
            lines = _calls_omitting_plot_cdf(f.read())
        if lines:
            missing[os.path.relpath(path, REPO)] = lines
    assert not missing, missing
    # The probe names the class through {cc} so that this file's own
    # scan does not read it as a call.
    probe = ("from m import {cc} as CC\nCC(K_range=(2, 3))\nm.{cc}()\n"
             "S = '''\\n{cc}(plot_cdf=False)\\n{cc}()\\n'''\n")
    assert _calls_omitting_plot_cdf(
        probe.format(cc="ConsensusClustering")) == [2, 3, 6]


_POISONED = """
import sys
sys.modules["jax"] = None
sys.modules["consensus_clustering_tpu"] = None
import numpy as np
from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs
x, _ = make_blobs(n_samples=60, n_features=3, centers=2, random_state=0)
cc = ConsensusClustering(K_range=(2, 3), n_iterations=8, random_state=0,
                         device="cpu", plot_cdf=False).fit(x)
st = ConsensusClustering(K_range=(2, 3), n_iterations=8, random_state=0,
                         device="cpu", stream_h_block=3, accum_repr="packed",
                         fuse_block="auto", plot_cdf=False).fit(x)
assert st.metrics_["timing"] == {"packed_kernel": "plain",
                                 "fuse_block": "fused", "fused_kernel": "plain"}
assert all(np.array_equal(cc.cdf_at_K_data[k]["mij"], st.cdf_at_K_data[k]["mij"])
           for k in (2, 3))
from consensus_clustering_tpu_torch.parallel import distributed, resample_mesh
sharded = ConsensusClustering(K_range=(2, 3), n_iterations=8, random_state=0,
                              mesh=resample_mesh(["cpu"] * 8, row_shards=2,
                                                 k_shards=2),
                              k_interleave=True, plot_cdf=False).fit(x)
assert all(np.array_equal(cc.cdf_at_K_data[k]["mij"],
                          sharded.cdf_at_K_data[k]["mij"]) for k in (2, 3))
assert distributed.is_primary()
from sklearn.cluster import KMeans as SkKMeans
from consensus_clustering_tpu_torch import (
    AgglomerativeClustering, GaussianMixture, SpectralClustering)
for clusterer in (GaussianMixture(), AgglomerativeClustering(),
                  SpectralClustering(solver="lobpcg"), SkKMeans(n_init=1)):
    other = ConsensusClustering(clusterer=clusterer, K_range=(2, 3),
                                n_iterations=4, random_state=0, device="cpu",
                                progress=False, k_batch_size=1,
                                store_matrices=True,
                                compute_consensus_labels=True,
                                plot_cdf=False)
    assert len(other.fit_predict(x)) == 60
import os, tempfile
os.environ["CCTPU_MEMORY_BUDGET"] = "1000"
est = ConsensusClustering(K_range=(2, 3), n_iterations=8, random_state=0,
                          device="cpu", mode="auto", stream_h_block=4,
                          exact_best_k=True, plot_cdf=False).fit(x)
assert est.metrics_["mode"] == "estimate" and "exact_best_k" in est.metrics_
from consensus_clustering_tpu_torch.append import (
    PlaneStore, bootstrap_generation, run_append)
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.models.kmeans import KMeans
with tempfile.TemporaryDirectory() as tmp:
    store = PlaneStore(tmp)
    bootstrap_generation(x[:50], config=SweepConfig(
        n_samples=50, n_features=3, k_values=(2, 3), n_iterations=8,
        store_matrices=False, stream_h_block=4, accum_repr="packed"),
        clusterer=KMeans(), seed=0, store=store, device="cpu")
    out = run_append(store, x, h_new=4, clusterer=KMeans(), device="cpu")
    assert out["append"]["generation"] == 1
    import json, time, urllib.request
    from consensus_clustering_tpu_torch.serve import (
        ConsensusService, SweepExecutor)
    svc = ConsensusService(store_dir=tmp, port=0,
                           executor=SweepExecutor(device="cpu")).start()
    try:
        base = f"http://127.0.0.1:{svc.port}"
        body = {"data": x.tolist(), "config": {"k": [2, 3], "iterations": 8}}
        req = urllib.request.Request(base + "/jobs", json.dumps(body).encode(),
                                     {"Content-Type": "application/json"})
        job = json.loads(urllib.request.urlopen(req, timeout=30).read())
        for _ in range(600):
            rec = json.loads(urllib.request.urlopen(
                f"{base}/jobs/{job['job_id']}", timeout=30).read())
            if rec["status"] != "queued" and rec["status"] != "running":
                break
            time.sleep(0.05)
        assert rec["status"] == "done", rec
        assert rec["result"]["backend"] == "torch-cpu"
    finally:
        svc.stop()
    import contextlib, io
    from consensus_clustering_tpu_torch.cli import main
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        # blobs: scipy's Yeo-Johnson (corr.csv) trips on the poisoned jax.
        main(["run", "--dataset", "blobs", "--n-samples", "60",
              "--n-features", "3", "--k", "2:3", "--iterations", "4",
              "--device", "cpu"])
        main(["run", "--dataset", "blobs", "--n-samples", "60",
              "--n-features", "3", "--k", "2:3", "--iterations", "4",
              "--row-shards", "2", "--device", "cpu"])
        try:
            # --budget 0: every probe budget-skipped, the modules loaded.
            main(["autotune", "run", "--shapes", "smoke", "--budget", "0",
                  "--device", "cpu", "--store", os.path.join(tmp, "cal")])
        except SystemExit as e:
            assert e.code == 0, e.code
        try:
            main(["serve-admin", "--store-dir", tmp, "list"])
        except SystemExit as e:
            assert e.code == 0, e.code
        try:
            main(["lint", "--list-rules"])
        except SystemExit as e:
            assert e.code == 0, e.code
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        try:
            main(["lint", "--pack", "all", "--json",
                  "consensus_clustering_tpu_torch/utils/plotting.py"])
        except SystemExit as e:
            assert e.code == 0, e.code
    assert json.loads(report.getvalue())["summary"]["files"] == 1
    assert "JL019 " in out.getvalue()
    auto = ConsensusClustering(K_range=(2, 3), n_iterations=8, random_state=0,
                               device="cpu", autotune=True,
                               calibration_dir=os.path.join(tmp, "cal"),
                               plot_cdf=False).fit(x)
    assert set(auto.metrics_["autotune"]) == {
        "cluster_batch", "split_init", "stream_h_block", "max_iter"}
import matplotlib.pyplot as plt
drawn = ConsensusClustering(K_range=(2, 3), n_iterations=8, random_state=0,
                            device="cpu", plot_cdf=True).fit(x)
(fig,) = [plt.figure(n) for n in plt.get_fignums()]
assert [list(line.get_ydata()) for line in fig.axes[0].get_lines()] == [
    [0.0] + list(drawn.cdf_at_K_data[k]["cdf"]) for k in (2, 3)]
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print(cc.best_k_, sorted(cc.cdf_at_K_data))
"""


def test_port_runs_with_jax_poisoned():
    env = dict(os.environ, MPLBACKEND="Agg")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _POISONED], capture_output=True, text=True,
        timeout=300, cwd=REPO, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("[2, 3]")


def test_import_pins_full_f32_matmul():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_fit_without_device_raises_without_cuda(monkeypatch):  # jaxlint: disable=JL018 -- raises before any sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(0).normal(size=(20, 3))
    cc = ConsensusClustering(K_range=(2, 3), n_iterations=4, random_state=0,
                             plot_cdf=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cc.fit(x)


def test_sklearn_clusterer_raises():  # jaxlint: disable=JL018 -- raises before any sweep
    """An sklearn estimator runs on the host backend; one without a
    cluster count (``n_clusters``/``n_components``) raises, as in the
    reference."""
    from sklearn.cluster import DBSCAN

    cc = ConsensusClustering(clusterer=DBSCAN(), K_range=(2, 3),
                             random_state=0, device="cpu", plot_cdf=False)
    with pytest.raises(AttributeError, match="n_clusters nor n_components"):
        cc.fit(np.random.default_rng(0).normal(size=(20, 3)))


def test_fit_rejects_bad_input():  # jaxlint: disable=JL018 -- raises before any sweep
    x = np.ones((10, 2))
    x[3, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        ConsensusClustering(random_state=0, device="cpu",
                            plot_cdf=False).fit(x)
    with pytest.raises(ValueError, match="zero variance"):
        ConsensusClustering(random_state=0, device="cpu",
                            plot_cdf=False).fit(np.ones((10, 2)))
    with pytest.raises(ValueError, match="random_state"):
        ConsensusClustering(device="cpu", plot_cdf=False).fit(np.eye(10))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load("hist")
    assert not (tmp_path / "build").exists()


def test_kernel_sources_ship_with_the_package():
    for name in ("hist", "lloyd", "popcount", "fused_block"):
        path = _build.library_path(name)
        assert path.startswith(_build.BUILD_DIR)
        assert os.path.isfile(os.path.join(_build.CSRC_DIR, f"{name}.cu"))
    assert set(launch_counts()) == {"hist", "lloyd", "popcount",
                                    "fused_block", "assign"}
    assert all(n >= 0 for n in launch_counts().values())


def test_cpu_wrappers_take_the_plain_versions():
    before = launch_counts()
    hist.consensus_hist_counts(torch.rand(9, 9), 9, 0, 20)
    lloyd.lloyd_step(torch.rand(1, 9, 2), torch.zeros(1, dtype=torch.int64),
                     torch.rand(1, 3, 2), 3)
    words = torch.randint(-2**31, 2**31 - 1, (3, 9), dtype=torch.int32)
    popcount.packed_coassoc_counts(words, words)
    fused_block.assign_labels(torch.rand(1, 9, 2),
                              torch.zeros(1, dtype=torch.int64),
                              torch.rand(1, 3, 2), 3)
    fused_block.fused_assign_pack(torch.rand(9, 2), torch.rand(4, 3, 2), 3,
                                  words[:1], 0, n_words=1)
    assert launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        hist.consensus_hist_counts_kernel(torch.rand(9, 9), 9, 0, 20)
    with pytest.raises(ValueError, match="CUDA"):
        popcount.packed_coassoc_counts_kernel(words, words)
    with pytest.raises(ValueError, match="CUDA"):
        fused_block.fused_assign_pack_kernel(
            torch.rand(9, 2), torch.rand(4, 3, 2), 3, words[:1], 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fused_block.assign_labels_kernel(
            torch.rand(1, 9, 2), torch.zeros(1, dtype=torch.int64),
            torch.rand(1, 3, 2), 3)


def test_lloyd_kernel_layout_limits():
    assert lloyd.smem_bytes(50, 20) <= lloyd.MAX_SMEM_BYTES
    assert lloyd.smem_bytes(500, 20) > lloyd.MAX_SMEM_BYTES


def test_convert_from_reference_state():
    import jax

    from consensus_clustering_tpu.config import SweepConfig as JaxConfig
    from consensus_clustering_tpu.models.kmeans import KMeans as JaxKMeans

    ref = JaxConfig(n_samples=50, n_features=3, k_values=(2, 4),
                    n_iterations=9, cluster_batch=4, split_init=True)
    cfg = config_from_jax(dataclasses.asdict(ref))
    assert isinstance(cfg, SweepConfig)
    assert (cfg.n_sub, cfg.k_max, cfg.pac_idx) == (ref.n_sub, ref.k_max,
                                                  ref.pac_idx)
    assert cfg.cluster_batch == 4 and cfg.split_init
    assert config_from_jax(dataclasses.asdict(
        JaxConfig(n_samples=50, n_features=3, k_interleave=True))).k_interleave
    packed = config_from_jax(dataclasses.asdict(JaxConfig(
        n_samples=50, n_features=3, n_iterations=9, store_matrices=False,
        stream_h_block=4, accum_repr="packed", fuse_block="off",
        adaptive_tol=0.01, adaptive_patience=3, adaptive_min_h=4)))
    assert (packed.stream_h_block, packed.accum_repr, packed.fuse_block,
            packed.adaptive_tol, packed.adaptive_patience,
            packed.adaptive_min_h) == (4, "packed", "off", 0.01, 3, 4)
    km = kmeans_from_jax(dataclasses.asdict(JaxKMeans(n_init=3, tol=1e-3)))
    assert (km.n_init, km.max_iter, km.tol) == (3, 100, 1e-3)
    key = key_from_jax(np.asarray(jax.random.key_data(
        jax.random.PRNGKey(42))))
    np.testing.assert_array_equal(key.numpy(), [0, 42])


def test_peak_memory_window_resets_only_when_alone(monkeypatch):
    """The allocator's high-water is reset at a window's start only when
    no other window on the device is open (a nested engine run, or an
    abandoned attempt's thread), and only ``peak_memory_window`` resets
    it anywhere in the port."""
    from consensus_clustering_tpu_torch.utils import metrics

    resets = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda device=None: resets.append(str(device)))
    card = torch.device("cuda", 0)
    opened, release = threading.Event(), threading.Event()

    def abandoned_attempt():
        with metrics.peak_memory_window(card):
            opened.set()
            release.wait(10)

    with metrics.peak_memory_window(card):
        with metrics.peak_memory_window(card):
            pass
        worker = threading.Thread(target=abandoned_attempt)
        worker.start()
        opened.wait(10)
    # The attempt outlives the run that started beside it.
    with metrics.peak_memory_window(card):
        pass
    with metrics.peak_memory_window("cpu"):
        pass
    assert resets == ["cuda:0"]
    release.set()
    worker.join(10)
    with metrics.peak_memory_window(card):
        pass
    assert resets == ["cuda:0", "cuda:0"]

    sites = []
    for root, _, names in os.walk(PKG):
        for name in names:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    if "reset_peak_memory_stats(" in f.read():
                        sites.append(os.path.relpath(
                            os.path.join(root, name), PKG))
    assert sites == [os.path.join("utils", "metrics.py")]
