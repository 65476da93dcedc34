"""The trace's reduction with the program's ranges recorded, and the
per-layer metrics that read them: user annotations are no device work,
program ranges and benchmark spans own apart, and a metric on a new
program range, a new ``metrics_`` counter or a new launcher's bound is one
new file."""

import hashlib
import json
import os
import shutil
import types

import pytest

from portbench import harness, spans
from portbench import trace as bench_trace
from portbench.tests.conftest import small_cell
from portbench.trace import Event, raw_events, summarize, summarize_program

ROOT = harness.ROOT
SEED = 2**31 + 77


def _kineto(*rows, flag=True):
    """A stand-in for a finished kineto profile: (name, on the card, user
    annotation, start ns, duration ns, correlation id) rows; without
    ``flag`` the events do not say whether they are annotations."""
    def event(name, cuda, annotation, start, duration, corr):
        e = types.SimpleNamespace(
            name=lambda: name,
            device_type=lambda: "DeviceType.CUDA" if cuda
            else "DeviceType.CPU",
            start_ns=lambda: start, duration_ns=lambda: duration,
            correlation_id=lambda: corr)
        if flag:
            e.is_user_annotation = lambda: annotation
        return e
    return types.SimpleNamespace(events=lambda: [event(*r) for r in rows])


#: A window with a benchmark span inside a program range, launches in
#: each, and every host range's GPU-side copy.
_BENCH_ROWS = [
    ("portbench.window", False, True, 0, 1000, 1),
    ("portbench.window", True, True, 100, 800, 1),
    ("portbench.b2", False, True, 300, 200, 2),
    ("portbench.b2", True, True, 320, 300, 2),
    ("cudaLaunchKernel", False, False, 110, 5, 10),
    ("cudaLaunchKernel", False, False, 310, 5, 11),
    ("cudaLaunchKernel", False, False, 610, 5, 12),
    ("cudaMemcpyAsync", False, False, 700, 5, 13),
    ("k_before", True, False, 120, 80, 10),
    ("lloyd_step_kernel", True, False, 320, 300, 11),
    ("k_after", True, False, 640, 60, 12),
    ("Memcpy DtoH (Device -> Pinned)", True, False, 720, 10, 13),
]
_PROGRAM_ROWS = [
    ("cc.fit", False, True, 50, 640, 3),
    ("cc.fit", True, True, 120, 580, 3),
    ("cc.kmeans.lloyd", False, True, 250, 400, 4),
    ("cc.kmeans.lloyd", True, True, 320, 360, 4),
    ("cc.kmeans.lloyd.wait", False, True, 600, 40, 5),
    ("nccl:all_reduce", False, True, 605, 10, 6),
    ("nccl:all_reduce", True, True, 640, 60, 6),
]


@pytest.mark.parametrize("flag", [True, False])
def test_gpu_side_annotations_are_no_operations(flag):
    bare = raw_events(_kineto(*_BENCH_ROWS, flag=flag))
    recorded = raw_events(_kineto(*_BENCH_ROWS, *_PROGRAM_ROWS, flag=flag))
    kinds = {(e.name, e.kind) for e in recorded}
    assert ("cc.fit", "range") in kinds and ("cc.fit", "other") in kinds
    assert ("portbench.b2", "other") in kinds
    assert not any(e.kind == "device" and e.name.startswith(
        ("cc.", "portbench.")) for e in recorded)
    if flag:
        # Any user annotation, whatever its name: NCCL's ranges too.
        assert ("nccl:all_reduce", "other") in kinds
    else:
        recorded = [e for e in recorded if not e.name.startswith("nccl")]
    without, with_ranges = summarize(bare), summarize(recorded)
    assert with_ranges == without
    assert without["kernels"] == 3
    assert without["busy_s"] == pytest.approx(450e-9)
    assert without["device_s_by_range"] == pytest.approx(
        {"window": 150e-9, "b2": 300e-9})


def test_summarize_program_gives_nested_ranges_their_own_seconds():
    events = raw_events(_kineto(*_BENCH_ROWS, *_PROGRAM_ROWS))
    ranges = summarize_program(events)
    ns = pytest.approx
    assert ranges["cc.fit"] == {
        "calls": 1, "host_s": ns(640e-9), "self_host_s": ns(240e-9),
        "device_s": ns(80e-9), "kernels": 1, "idle_s": ns(120e-9)}
    # B2's launch inside the benchmark's span is the Lloyd range's: a
    # benchmark span takes nothing from a program range.
    assert ranges["cc.kmeans.lloyd"] == {
        "calls": 1, "host_s": ns(400e-9), "self_host_s": ns(360e-9),
        "device_s": ns(300e-9), "kernels": 1, "idle_s": 0}
    assert ranges["cc.kmeans.lloyd.wait"] == {
        "calls": 1, "host_s": ns(40e-9), "self_host_s": ns(40e-9),
        "device_s": ns(60e-9), "kernels": 1, "idle_s": ns(20e-9)}
    # What no program range launched or began: the copy, the gaps before
    # the sweep's first range and after its last.
    assert ranges[bench_trace.WINDOW] == {
        "calls": 0, "host_s": 0, "self_host_s": 0, "device_s": ns(10e-9),
        "kernels": 0, "idle_s": ns(410e-9)}
    assert sum(e["idle_s"] for e in ranges.values()) == ns(
        1000e-9 - summarize(events)["busy_s"])
    # And the program's range takes nothing from B2's span.
    assert summarize(events)["device_s_by_range"]["b2"] == ns(300e-9)
    assert summarize_program([Event("k", "device", 0, 5, 1)]) is None


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def _digests(root):
    out = {}
    for base, dirs, files in os.walk(root / "portbench"):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def _new_metric(root, name, source, cell="blobs20k_stream"):
    """``metrics/<name>.py`` and its entry in BENCHMARK.json."""
    (root / "portbench" / "metrics" / f"{name}.py").write_text(source)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": name, "unit": "n", "better": "lower",
        "source": "program_span", "layer": "a test",
        "moves": "resamples_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def _small_from(root, name="blobs20k_stream"):
    """``small_cell``'s CPU-sized cut of ``name``, read from ``root``."""
    cell = small_cell(name, n=300, h=6)
    found = harness.load_cell(name, root=str(root))
    for key in ("per_layer", "bench_dir", "root", "metrics_dir",
                "bounds_dir"):
        cell[key] = found[key]
    return cell


_NOVEL_READER = '''def read(record):
    ranges = record["program"]["ranges"]
    counter = record["program"]["metrics"].get("novel_counter")
    if "cc.novel.assign" not in ranges or counter is None:
        return None
    return 100 * ranges["cc.novel.assign"]["calls"] + counter["seen"]
'''


def test_a_metric_on_a_new_range_and_counter_is_one_file(tmp_path,
                                                         monkeypatch):
    from consensus_clustering_tpu_torch import api
    from consensus_clustering_tpu_torch.models import kmeans
    from consensus_clustering_tpu_torch.obs.tracing import region

    # The program as a later change might leave it: a range and a
    # counter that no file of the benchmark names.
    assign = kmeans.assign_labels
    build = api.ConsensusClustering._build_results

    def ranged_assign(*args, **kwargs):
        with region("novel.assign"):
            return assign(*args, **kwargs)

    def counted_build(self, *args, **kwargs):
        build(self, *args, **kwargs)
        self.metrics_["novel_counter"] = {"seen": 7}

    monkeypatch.setattr(kmeans, "assign_labels", ranged_assign)
    monkeypatch.setattr(api.ConsensusClustering, "_build_results",
                        counted_build)
    root = _checkout(tmp_path)
    before = _digests(root)
    _new_metric(root, "novel_assigns", _NOVEL_READER)
    cell = _small_from(root)
    assert "novel_assigns" in [m["name"] for m in cell["per_layer"]]
    result = harness.run_cell(cell, SEED, 0.0, True, device="cpu")
    assert result["correct"] is True
    value = result["metrics"]["novel_assigns"]["value"]
    assert value >= 107 and value % 100 == 7
    # The committed readers of ranges and counters read on the CPU too.
    for name in ("kmeanspp_share", "lloyd_share", "lloyd_wait_share",
                 "evaluate_share", "lloyd_steps_per_fit",
                 "lloyd_lane_occupancy"):
        assert result["metrics"][name]["value"] > 0
    after = _digests(root)
    added = set(after) - set(before)
    assert added == {"portbench/metrics/novel_assigns.py"}
    assert {p: after[p] for p in before} == before


_ASSIGN_BOUND = '''MODULE = "consensus_clustering_tpu_torch.models.kmeans"
ATTRIBUTE = "assign_labels"


def bound_ms(config, x, centroids, *args, **kwargs):
    return 0.25 * config["clusterer"]["n_init"]
'''


def test_a_new_launchers_bound_is_one_file(tmp_path):
    root = _checkout(tmp_path)
    assert [(name, module.rsplit(".", 1)[-1]) for name, module, _, _
            in spans.span_table(str(root / "portbench" / "bounds"))] == [
        ("b2", "lloyd"), ("b3", "popcount")]
    before = _digests(root)
    (root / "portbench" / "bounds" / "assign.py").write_text(_ASSIGN_BOUND)
    _new_metric(root, "assign_bound_per_call",
                'def read(record):\n'
                '    span = record["spans"].get("assign")\n'
                '    if not span or not span["calls"]:\n'
                '        return None\n'
                '    return span["bound_ms"] / span["calls"]\n')
    result = harness.run_cell(_small_from(root), SEED, 0.0, True,
                              device="cpu")
    assert result["correct"] is True
    # Each call's bound recorded and summed: 0.25 ms x n_init 3 a call.
    assert result["metrics"]["assign_bound_per_call"]["value"] == \
        pytest.approx(0.75)
    after = _digests(root)
    assert set(after) - set(before) == {
        "portbench/bounds/assign.py",
        "portbench/metrics/assign_bound_per_call.py"}
    assert {p: after[p] for p in before} == before
