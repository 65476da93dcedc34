"""The harness's lookups by name and its cells across processes, on the
CPU: the current cells' constructor arguments and data held to literals,
a configuration with another clusterer run by adding files alone, and
two gloo ranks equal to one process, with a killed rank ending the run."""

import copy
import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import pytest

from portbench import harness, ranks

ROOT = harness.ROOT
TESTS = os.path.dirname(os.path.abspath(__file__))
SEED = 2**31 + 77

_KMEANS = {"max_iter": 100, "n_init": 3, "tol": 0.0001}
_COMMON = {"PAC_interval": [0.1, 0.9], "bins": 20, "chunk_size": 4,
           "cluster_batch": 16, "clusterer_options": _KMEANS,
           "n_iterations": 100, "plot_cdf": False, "progress": False,
           "store_matrices": False, "subsampling": 0.8}
_STREAM = {**_COMMON, "K_range": list(range(2, 11)), "accum_repr": "packed",
           "fuse_block": "auto", "stream_h_block": 100}
FIT_KWARGS = {
    "est100k": {**_COMMON, "K_range": list(range(2, 21)),
                "accum_repr": "packed", "exact_best_k": True,
                "mode": "auto", "n_pairs": 131072, "stream_h_block": 100},
    "blobs20k_stream": _STREAM,
    # The dense cell groups each K's lanes as its source does (all in
    # one): a knob of pace, every lane bit for bit the same.
    "blobs20k_dense": {**_COMMON, "K_range": list(range(2, 11)),
                       "accum_repr": "dense", "cluster_batch": None},
    "blobs20k_stream_4chip": _STREAM,
}
#: sha256 of make_data's bytes at 600 rows (every current configuration
#: draws 8 blobs of std 3 in 50 features).
DATA = {
    SEED: "8b0854a515fa73947f2bb4c3a3fc41021f69af4fd8bc4ca84f44c99bd2b4431c",
    5: "07312467676219ad3fefa031d959ef365a99d994fcb518bf6de6f2d069cce094"}


@pytest.mark.parametrize("name", sorted(FIT_KWARGS))
def test_current_cells_keep_their_arguments_and_data(name):
    cell = harness.load_cell(name)
    assert harness.fit_kwargs(cell) == FIT_KWARGS[name]
    assert "clusterer" not in harness.fit_kwargs(cell)
    config = copy.deepcopy(cell["config"])
    config["data"]["n_samples"] = 600
    for seed, digest in DATA.items():
        x = harness.make_data(config, seed)
        assert x.shape == (600, 50) and x.dtype.name == "float32"
        assert hashlib.sha256(x.tobytes()).hexdigest() == digest


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def _add_cell(root, name, config, traffic, limits, chips=1):
    """Files and entries of a new cell; nothing already there changes."""
    bench = root / "portbench"
    (bench / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    (bench / "traffic" / f"{traffic['name']}.json").write_text(
        json.dumps(traffic))
    (bench / "workloads" / f"{name}.json").write_text(json.dumps({
        "config": config["name"], "traffic": traffic["name"],
        "chips": chips, "check": {"mode": "exact", "within": 2},
        "limits": limits}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config["name"], "source": "a test",
                            "file": f"portbench/configs/{config['name']}"
                                    ".json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": name, "config": config["name"],
                              "traffic": traffic["name"], "chips": chips,
                              "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.load_cell(name, root=str(root))


def _small_config(name, n, d, h, k_hi):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "blobs20k.json")) as f:
        config = json.load(f)
    config["name"] = name
    config["data"].update(n_samples=n, n_features=d, centers=4)
    config["fit"].update(n_iterations=h, K_range=[2, k_hi], cluster_batch=4)
    return config


#: A data generator of ``reference/data/``: four clumps, 3 apart.
_CLUMPS = """import numpy as np


def make(data, seed):
    rng = np.random.default_rng(seed)
    n, d = int(data["n_samples"]), int(data["n_features"])
    centre = rng.integers(0, int(data["centers"]), n)
    return rng.normal(size=(n, d)) + 3.0 * centre[:, None]
"""


@pytest.mark.parametrize("linkage,correct", [("average", True),
                                             ("single", False)])
def test_another_clusterer_runs_by_adding_files(tmp_path, linkage, correct):
    root = _checkout(tmp_path)
    clusterers = root / "portbench" / "reference" / "clusterers"
    clusterers.mkdir()
    source = open(os.path.join(TESTS, "agglomerative_reference.py")).read()
    (clusterers / "AgglomerativeClustering.py").write_text(
        source.replace('LINKAGE = "average"', f'LINKAGE = "{linkage}"'))
    data = root / "portbench" / "reference" / "data"
    data.mkdir()
    (data / "clumps.py").write_text(_CLUMPS)
    config = _small_config("agglo_small", 120, 8, 6, 4)
    config["data"]["generator"] = "clumps"
    config["clusterer"] = {
        "name": "AgglomerativeClustering", "options": {"linkage": "average"},
        "capture": ["consensus_clustering_tpu_torch.models.agglomerative",
                    "AgglomerativeClustering", "fit_predict"]}
    cell = _add_cell(root, "agglo_small", config,
                     {"name": "sweeps_agglo", "fit": {}},
                     {"cdf_gap": 5e-05, "best_k_gap": 0, "label_gap": 0})
    assert type(harness.fit_kwargs(cell)["clusterer"]).__name__ == \
        "AgglomerativeClustering"
    x = harness.make_data(cell["config"], 23, cell["bench_dir"])
    assert x.shape == (120, 8) and x.dtype.name == "float32"
    result = harness.run_cell(cell, 23, 0.0, False, device="cpu")
    assert result["correct"] is correct
    numbers = {k: v["value"] for k, v in result["check"].items()}
    assert set(numbers) == {"cdf_gap", "best_k_gap", "label_gap"}
    if correct:
        assert numbers == {"cdf_gap": 0.0, "best_k_gap": 0.0,
                           "label_gap": 0.0}
    else:
        assert numbers["label_gap"] > 0 and numbers["cdf_gap"] > 5e-05


def _two_ranks(root, limits):
    config = _small_config("tiny", 300, 8, 8, 4)
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "sweeps_stream_packed_4proc.json")) as f:
        traffic = json.load(f)
    traffic.update(name="tiny_ranks", processes=2, backend="gloo",
                   mesh={"k_shards": 1, "row_shards": 2})
    traffic["fit"]["stream_h_block"] = 8
    # The traffic pins the lane grouping: groups of 4 there.
    traffic["fit"]["cluster_batch"] = config["fit"].pop("cluster_batch")
    return _add_cell(root, "tiny_ranks", config, traffic, limits)


def test_two_ranks_equal_one_process_and_a_fault_is_refused(tmp_path):
    # The four-card cell's own numbers and limits.
    with open(os.path.join(ROOT, "portbench", "workloads",
                           "blobs20k_stream_4chip.json")) as f:
        limits = json.load(f)["limits"]
    cell = _two_ranks(_checkout(tmp_path), limits)
    code, result = ranks.launch(cell, SEED, 0.0, False, device="cpu")
    assert code == 0 and result["correct"] is True
    assert result["device"]["memory_peak_bytes_by_card"] == [0, 0]
    alone = harness.run_cell(dict(cell, processes=1), SEED, 0.0, False,
                             device="cpu")
    assert result["check"] == {**alone["check"],
                               "rank_gap": {"value": 0.0, "limit": 0}}
    assert result["attempted"] == alone["attempted"] == 1
    # The sums between the ranks left out: the curves part from the
    # reference's and the ranks from each other.
    code, faulty = ranks.launch(cell, SEED, 0.0, False, device="cpu",
                                fault="exchange_left_out")
    assert code == 0 and faulty["correct"] is False
    assert faulty["check"]["cdf_gap"]["value"] > 5e-05
    assert faulty["check"]["rank_gap"]["value"] > 0


def test_a_taken_coordinator_port_starts_the_ranks_again(tmp_path,
                                                          monkeypatch,
                                                          capfd):
    cell = _two_ranks(_checkout(tmp_path),
                      {"cdf_gap": 5e-05, "best_k_gap": 0, "rank_gap": 0})
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        ports = [taken.getsockname()[1]]
        free = ranks._free_port
        monkeypatch.setattr(ranks, "_free_port",
                            lambda: ports.pop() if ports else free())
        code, result = ranks.launch(cell, SEED, 0.0, False, device="cpu")
    assert code == 0 and result["correct"] is True
    assert "starting the ranks again" in capfd.readouterr().err
    assert any("started 2 times" in note for note in result["notes"])


def test_a_killed_rank_ends_the_run(tmp_path):
    root = _checkout(tmp_path)
    _two_ranks(root, {"cdf_gap": 5e-05, "best_k_gap": 0, "rank_gap": 0})
    launcher = subprocess.Popen(
        [sys.executable, "-c",
         "import sys\n"
         "from portbench import harness, ranks\n"
         "harness.set_environment()\n"
         f"cell = harness.load_cell('tiny_ranks', root={str(root)!r})\n"
         "code, _ = ranks.launch(cell, 7, 120.0, False, device='cpu')\n"
         "sys.exit(code)\n"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT},
        stderr=subprocess.PIPE, text=True)
    pids = None
    try:
        for line in launcher.stderr:
            if line.startswith("portbench: 2 ranks, pids"):
                pids = json.loads(line.split("pids", 1)[1])
            if "the window opened" in line:
                break
        assert pids, "the launcher named no ranks"
        os.kill(pids[1], signal.SIGKILL)
        t0 = time.monotonic()
        launcher.stderr.close()
        code = launcher.wait(timeout=30)
        assert time.monotonic() - t0 < 10
        # The killed rank (137), or a rank whose peer vanished (1).
        assert code != 0
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()
    for pid in pids:  # the launcher ended and reaped both ranks
        assert not os.path.exists(f"/proc/{pid}")


@pytest.fixture
def four_cards():
    """Skips the test without four CUDA devices."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (the four-card cell)")


def test_a_killed_rank_ends_the_four_card_cell(four_cards):
    run = subprocess.Popen(
        [sys.executable, "portbench/run.py", "--workload",
         "blobs20k_stream_4chip", "--seed", "31", "--seconds", "51"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pids = None
    try:
        for line in run.stderr:
            if line.startswith("portbench: 4 ranks, pids"):
                pids = json.loads(line.split("pids", 1)[1])
            if "the window opened" in line:
                break
        assert pids, "the launcher named no ranks"
        time.sleep(5.0)
        os.kill(pids[2], signal.SIGKILL)
        t0 = time.monotonic()
        out, err = run.communicate(timeout=120)
        ended = time.monotonic() - t0
        print(f"rank 2 killed 5 s into the window; the run ended "
              f"{ended:.3f} s later with exit {run.returncode}; "
              f"{err.strip().splitlines()[-1]}")
        assert run.returncode != 0 and not out.strip()
        assert ended < 30
    finally:
        if run.poll() is None:
            run.kill()
            run.wait()
    for pid in pids:
        assert not os.path.exists(f"/proc/{pid}")
