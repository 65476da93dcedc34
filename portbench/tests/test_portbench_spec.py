"""BENCHMARK.json against the contract's shapes, the data-driven layout,
and the frozen bound arithmetic."""

import json
import os
import re
import shutil

import pytest

from portbench import harness, peaks

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_command():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["portbench"]
    assert 1 <= len(s["command"]) <= 32
    assert all(line_ok(w) for w in s["command"])
    for word in s["command"]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert word.split("/")[0] in s["paths"]
            assert os.path.isfile(os.path.join(ROOT, word))
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    s = spec()
    names = []
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = [w["name"] for w in s["workloads"]]
    assert len(set(cells)) == len(cells)
    pairs = {(w["config"], w["traffic"]) for w in s["workloads"]}
    assert len(pairs) == len(cells)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line_ok(w["why"])
    metrics = s["end_to_end"] + s["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line_ok(m["layer"])
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_every_cell_resolves_to_its_files_and_readers(cell):
    c = harness.load_cell(cell)
    assert c["config"]["name"] == [w for w in spec()["workloads"]
                                   if w["name"] == cell][0]["config"]
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert callable(harness.reader(c["metrics_dir"], m["name"]))
    kwargs = harness.fit_kwargs(c)
    assert kwargs["plot_cdf"] is False and kwargs["K_range"]
    limits = c["workload"]["limits"]
    assert set(limits) <= {"centroid_gap", "cdf_gap", "est_cdf_gap",
                           "best_k_gap", "rank_gap", "parted_lanes",
                           "fixed_point_gap"}
    assert ("parted_lanes" in limits) == ("fixed_point_gap" in limits)
    assert ("rank_gap" in limits) == (c["processes"] > 1)
    assert c["workload"]["check"]["mode"] in ("exact", "estimate")
    assert int(c["workload"]["check"]["within"]) >= 1


def test_a_new_cell_is_found_by_adding_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    s = spec()
    before = {p: (root / "portbench" / p).read_bytes()
              for p in ("configs/blobs20k.json", "traffic/sweeps.json")}
    (root / "portbench" / "traffic" / "sweeps_stream_dense.json").write_text(
        json.dumps({"name": "sweeps_stream_dense",
                    "fit": {"stream_h_block": 50}}))
    (root / "portbench" / "workloads" / "blobs20k_stream_dense.json"
     ).write_text(json.dumps({"config": "blobs20k",
                              "traffic": "sweeps_stream_dense", "chips": 1,
                              "check": {"mode": "exact", "within": 4},
                              "limits": {"cdf_gap": 0}}))
    (root / "portbench" / "metrics" / "sweeps_in_window.py").write_text(
        "def read(record):\n    return len(record['sweeps'])\n")
    s["workloads"].append({"name": "blobs20k_stream_dense",
                           "config": "blobs20k",
                           "traffic": "sweeps_stream_dense", "chips": 1,
                           "why": "a test"})
    s["per_layer"].append({"name": "sweeps_in_window", "unit": "sweeps",
                           "better": "higher", "source": "host_clock",
                           "layer": "api", "moves": "resamples_per_s",
                           "workloads": ["blobs20k_stream_dense"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    cell = harness.load_cell("blobs20k_stream_dense", root=str(root))
    assert harness.fit_kwargs(cell)["stream_h_block"] == 50
    names = [m["name"] for m in cell["per_layer"]]
    assert "sweeps_in_window" in names
    read = harness.reader(cell["metrics_dir"], "sweeps_in_window")
    assert read({"sweeps": [{}, {}]}) == 2
    for p, data in before.items():
        assert (root / "portbench" / p).read_bytes() == data


def test_a_cell_whose_files_disagree_is_refused(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    s = spec()
    s["workloads"][0]["chips"] = 4
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    with pytest.raises(harness.CellError):
        harness.load_cell(s["workloads"][0]["name"], root=str(root))


def test_frozen_bounds_reproduce_the_kernel_table():
    # PERF.md's kernel table: B2 at 48 x 4,000 x 50 (16 subsamples, 20
    # slots) and B3 at 400 x 256 x 5120.
    assert peaks.lloyd_step_bound_ms(16, 4000, 50, 48, 20) == pytest.approx(
        0.00633, abs=5e-6)
    assert peaks.bound_ms(*peaks.lloyd_step_work(16, 4000, 50, 48, 20))[1] \
        == "operations"
    assert peaks.popcount_bound_ms(400, 256, 5120) == pytest.approx(
        0.1254, abs=5e-5)
    assert peaks.lloyd_resamples_read(48, 16, 3) == 16
    assert peaks.lloyd_resamples_read(4, 16, 3) == 2
