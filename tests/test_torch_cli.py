"""The port's command line on the CPU, held against the JAX package's.

``python -m consensus_clustering_tpu_torch run`` on corr.csv against the
JAX package's ``run`` (the same JSON keys, K, shape and best K, per-K PAC
within the sweep parity band max(0.02, 0.25·ref)); a streamed packed
``run`` against the port's own library fit, bit for bit; the CSV reader
against pandas; each refused flag naming why, and ``bench`` naming its
ROADMAP item; and the no-GPU exit of every subcommand that computes.
``run --plot-dir`` is held in tests/test_torch_plotting.py and ``lint``
in tests/test_torch_lint.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from consensus_clustering_tpu.cli import main as jax_main
from consensus_clustering_tpu_torch import ConsensusClustering, make_blobs
from consensus_clustering_tpu_torch.cli import main
from consensus_clustering_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORR_CSV = os.path.join(REPO, "consensus_clustering_tpu_torch", "data",
                        "corr.csv")


@pytest.fixture(autouse=True)
def _own_build_dir(monkeypatch):
    """Each CLI call chooses the kernels' build directory; restore it."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setenv("CCTPU_COMPILATION_CACHE", "off")


def _run(entry, argv, capsys):
    entry(argv)
    return json.loads(capsys.readouterr().out)


def test_run_on_corr_matches_the_jax_cli(capsys):
    argv = ["run", "--dataset", "corr", "--k", "2:8", "--iterations", "20",
            "--seed", "23"]
    ref = _run(jax_main, argv, capsys)
    port = _run(main, argv + ["--device", "cpu"], capsys)
    assert set(port) == set(ref)
    assert (port["K"], port["shape"], port["best_k"]) == (
        ref["K"], ref["shape"], ref["best_k"])
    assert set(port["pac_area"]) == set(ref["pac_area"])
    for k, pac in ref["pac_area"].items():
        assert abs(port["pac_area"][k] - pac) <= max(0.02, 0.25 * pac), k
    assert port["metrics"]["device"] == "cpu"
    assert set(port["metrics"]["kernel_launches"]) == {
        "hist", "lloyd", "popcount", "fused_block", "assign"}


def test_streamed_packed_run_equals_the_library_fit(tmp_path, capsys):  # jaxlint: disable=JL018 -- the port's own fit at n=120, H=16 is the oracle; no JAX compile
    out = tmp_path / "run.json"
    main(["run", "--dataset", "blobs", "--n-samples", "120", "--n-features",
          "6", "--k", "2:4", "--iterations", "16", "--stream", "8",
          "--accum-repr", "packed", "--seed", "23", "--device", "cpu",
          "--out", str(out)])
    assert capsys.readouterr().out.startswith("best_k=")
    result = json.loads(out.read_text())
    x, _ = make_blobs(n_samples=120, n_features=6, centers=8,
                      cluster_std=3.0, random_state=23)
    cc = ConsensusClustering(
        K_range=(2, 3, 4), n_iterations=16, random_state=23, device="cpu",
        clusterer_options={"n_init": 3}, store_matrices=False,
        split_init=False, stream_h_block=8, accum_repr="packed",
        plot_cdf=False,
    ).fit(x.astype(np.float32))
    assert result["pac_area"] == {
        str(k): cc.cdf_at_K_data[k]["pac_area"] for k in (2, 3, 4)}
    assert result["best_k"] == cc.best_k_
    assert result["metrics"]["timing"] == {
        "packed_kernel": "plain", "fuse_block": "fused",
        "fused_kernel": "plain"}
    assert result["metrics"]["streaming"]["h_effective"] == 16


def test_csv_reader_equals_pandas(tmp_path, capsys):
    import pandas as pd

    from consensus_clustering_tpu_torch.data import read_csv

    ours = read_csv(CORR_CSV).astype(np.float32)
    theirs = pd.read_csv(CORR_CSV, index_col=0).values.astype(np.float32)
    np.testing.assert_array_equal(ours, theirs)
    copy = tmp_path / "data.csv"
    copy.write_bytes(open(CORR_CSV, "rb").read())
    result = _run(main, ["run", "--dataset", str(copy), "--k", "2:3",
                         "--iterations", "4", "--device", "cpu"], capsys)
    assert result["shape"] == [29, 29] and result["K"] == [2, 3]


@pytest.mark.parametrize("argv,named", [
    (["run", "--use-pallas", "off"], "plain versions"),
    (["run", "--packed-kernel", "off"], "plain versions"),
    (["bench"], "A18"),
])
def test_refused_flags_name_their_item(argv, named):
    with pytest.raises(SystemExit) as exc:
        main(argv + (["--device", "cpu"] if argv[0] == "run" else []))
    assert exc.value.code not in (0, None)
    assert named in str(exc.value.code)


@pytest.mark.parametrize("argv", [
    ["run", "--k", "2:3", "--iterations", "4"],
    ["serve", "--port", "0"],
    ["autotune", "run", "--shapes", "smoke", "--store", "STORE"],
])
def test_compute_subcommands_need_a_gpu_without_device(argv, monkeypatch,
                                                       tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [str(tmp_path / "cal") if a == "STORE" else a for a in argv]
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code not in (0, None)
    said = str(exc.value.code) + capsys.readouterr().err
    assert "no CUDA device is visible" in said
    assert not (tmp_path / "cal").exists()


@pytest.mark.parametrize("knob", ["", "off", "DIR"])
def test_compilation_cache_knob_chooses_the_build_dir(knob, monkeypatch,
                                                      tmp_path):
    from consensus_clustering_tpu_torch.utils.platform import (
        enable_compilation_cache,
    )

    value = str(tmp_path / "kernels") if knob == "DIR" else knob
    monkeypatch.setenv("CCTPU_COMPILATION_CACHE", value)
    chosen = enable_compilation_cache()
    assert _build.BUILD_DIR == chosen
    assert _build.library_path("hist").startswith(chosen)
    if knob == "":
        assert chosen == _build.DEFAULT_BUILD_DIR
    elif knob == "off":
        assert os.path.isdir(chosen) and chosen != _build.DEFAULT_BUILD_DIR
    else:
        assert chosen == value


def test_kernel_probe_is_plain_on_the_cpu():
    from consensus_clustering_tpu_torch.ops import launch_counts, probe

    before = launch_counts()
    assert probe.probe_kernels("cpu") == "plain"
    # The probe's calls are well formed: on CPU tensors each wrapper takes
    # its plain version and answers in the plain version's shapes.
    for name, got, ref in probe._cases(torch.device("cpu")):
        a, b = got(), ref()
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        assert [t.shape for t in a] == [t.shape for t in b], name
    assert launch_counts() == before
