"""The port's named host ranges on the sweep path and its Lloyd counters.

- Under ``torch.profiler`` (CPU) with ranges recorded
  (``recording_ranges``), an exact, a streamed, an estimated (with
  ``exact_best_k``) and a meshed fit open the ``cc.*`` ranges, each nested
  in the range listed as its parent.
- With no profiler recording, or ranges not asked for, a range is one
  shared do-nothing context: it enters no ``record_function`` and reads no
  clock, and a profiled fit's trace holds no ``cc.*`` event.
- A range given a span times itself and emits the span into its tracer.
- Centres, curves and ``best_k_`` are identical with a profiler on and off.
- ``lloyd_counts`` equals a count taken by stepping the Lloyd loop by hand,
  and ``metrics_["lloyd"]["steps"]`` equals the run's ``lloyd_step`` calls.
- The streaming engine and the estimator emit the JAX package's
  spans (``resume_restore``, ``h_block``, ``host_evaluate``,
  ``integrity_check``) into a tracer.
"""

import collections
import time

import numpy as np
import pytest
import torch

from consensus_clustering_tpu_torch import ConsensusClustering
from consensus_clustering_tpu_torch.config import SweepConfig
from consensus_clustering_tpu_torch.data import make_blobs
from consensus_clustering_tpu_torch.estimator.engine import (
    PairConsensusEngine,
)
from consensus_clustering_tpu_torch.models import kmeans
from consensus_clustering_tpu_torch.models.kmeans import (
    KMeans,
    lloyd_counts,
    lloyd_since,
)
from consensus_clustering_tpu_torch.obs.tracing import (
    Tracer,
    recording_ranges,
    region,
)
from consensus_clustering_tpu_torch.parallel import resample_mesh
from consensus_clustering_tpu_torch.parallel.streaming import StreamingSweep
from consensus_clustering_tpu_torch.resilience.blocks import (
    StreamCheckpointer,
)

#: Each range and the ranges it may open directly under (None: top level).
PARENTS = {
    "cc.fit": {None},
    "cc.fit.resolve": {"cc.fit"},
    "cc.fit.refine": {"cc.fit"},
    "cc.fit.assemble": {"cc.fit"},
    "cc.engine": {"cc.fit"},
    "cc.engine.block": {"cc.engine"},
    "cc.engine.cluster": {"cc.engine", "cc.engine.block"},
    "cc.engine.accumulate": {"cc.engine", "cc.engine.block"},
    "cc.engine.evaluate": {"cc.engine", "cc.engine.block"},
    "cc.engine.integrity": {"cc.engine.block"},
    "cc.engine.checkpoint": {"cc.engine.block"},
    "cc.mesh.merge": {"cc.engine", "cc.engine.block",
                      "cc.engine.accumulate", "cc.engine.evaluate"},
    "cc.refine.labels": {"cc.fit.refine"},
    "cc.refine.tiles": {"cc.fit.refine"},
    "cc.kmeans.seed": {"cc.engine.cluster", "cc.refine.labels"},
    "cc.kmeans.lloyd": {"cc.engine.cluster", "cc.refine.labels"},
    "cc.kmeans.lloyd.wait": {"cc.kmeans.lloyd"},
    "cc.kmeans.assign": {"cc.engine.cluster", "cc.refine.labels"},
}
_COMMON = {"cc.fit", "cc.fit.resolve", "cc.fit.assemble", "cc.engine",
           "cc.engine.cluster", "cc.engine.accumulate", "cc.engine.evaluate",
           "cc.kmeans.seed", "cc.kmeans.lloyd", "cc.kmeans.lloyd.wait",
           "cc.kmeans.assign"}
_BLOCKS = {"cc.engine.block", "cc.engine.integrity", "cc.engine.checkpoint"}
#: The fits, their keyword arguments and the ranges each must open.
FITS = {
    "exact": ({}, _COMMON),
    "stream": (dict(stream_h_block=4, accum_repr="packed",
                    fuse_block="auto", integrity_check_every=1,
                    checkpoint="ring"), _COMMON | _BLOCKS),
    "estimate": (dict(mode="estimate", n_pairs=1500, exact_best_k=True,
                      stream_h_block=4, integrity_check_every=1,
                      checkpoint="ring"),
                 _COMMON | _BLOCKS | {"cc.fit.refine", "cc.refine.labels",
                                      "cc.refine.tiles"}),
    "mesh": (dict(mesh="rows"), _COMMON | {"cc.mesh.merge"}),
}


@pytest.fixture(scope="module")
def data():
    x, _ = make_blobs(n_samples=90, n_features=4, centers=3,
                      cluster_std=1.0, random_state=4)
    return x.astype(np.float32)


def _fit(x, tmp_path, **kwargs):
    if kwargs.pop("checkpoint", None):
        kwargs["checkpoint_dir"] = str(tmp_path / "ckpt")
    if kwargs.get("mesh") == "rows":
        kwargs["mesh"] = resample_mesh(["cpu"] * 2, row_shards=2)
    return ConsensusClustering(
        K_range=(2, 3, 4), n_iterations=8, random_state=11, device="cpu",
        store_matrices=False, clusterer_options={"n_init": 2},
        progress=False, plot_cdf=False, **kwargs).fit(x)


def _ranges(prof):
    """(name, name of the innermost enclosing ``cc.*`` range) of every
    ``cc.*`` range the profile holds."""
    out = []
    for e in prof.events():
        if not e.name.startswith("cc."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("cc."):
            parent = parent.cpu_parent
        out.append((e.name, None if parent is None else parent.name))
    return out


@pytest.mark.parametrize("kind", sorted(FITS))
def test_fit_opens_the_ranges_nested_as_listed(data, tmp_path, kind):  # jaxlint: disable=JL018 -- N=90, H=8, K 2..4 on the CPU port
    kwargs, expected = FITS[kind]
    with recording_ranges(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _fit(data, tmp_path, **kwargs)
    ranges = _ranges(prof)
    assert {name for name, _ in ranges} == expected
    for name, parent in ranges:
        assert parent in PARENTS[name], (name, parent)
    assert sum(1 for name, _ in ranges if name == "cc.fit") == 1


def test_without_a_profiler_a_range_records_and_reads_nothing(monkeypatch):
    calls = collections.Counter()

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for owner in (torch.profiler, torch.autograd.profiler):
        monkeypatch.setattr(owner, "record_function", counted(
            "record_function", owner.record_function))
    for clock in ("perf_counter", "perf_counter_ns", "monotonic",
                  "monotonic_ns", "time", "time_ns", "process_time"):
        monkeypatch.setattr(time, clock, counted(clock,
                                                 getattr(time, clock)))

    @region("test.decorated")
    def decorated(v):
        return v + 1

    assert not torch.autograd._profiler_enabled()
    for _ in range(3):
        with region("kmeans.seed") as r:
            assert decorated(1) == 2
    assert region("kmeans.seed") is r
    # A profiler alone (the benchmark's trace) does not record them.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with region("kmeans.seed") as r:
            decorated(1)
    assert r is region("kmeans.seed")
    assert calls == {}
    with recording_ranges(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with region("kmeans.seed"):
            decorated(1)
    assert calls["record_function"] == 2
    with recording_ranges():
        with region("kmeans.seed") as r:
            decorated(1)
    assert r is region("kmeans.seed")
    assert calls["record_function"] == 2


def test_a_profiled_fit_holds_no_range_unless_asked(data, tmp_path):  # jaxlint: disable=JL018 -- N=90, H=8, K 2..4 on the CPU port, twice
    kwargs = FITS["estimate"][0]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _fit(data, tmp_path / "off", **kwargs)
    assert _ranges(prof) == []
    with recording_ranges(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _fit(data, tmp_path / "on", **kwargs)
    assert ("cc.fit", None) in _ranges(prof)


def test_a_range_with_a_span_times_itself_and_emits_it():
    sink = _Sink()
    tracer = Tracer(sink, trace_id="job", parent_span_id="execute")
    with region("engine.integrity", "integrity_check", tracer,
                block=3) as check:
        check.add(violations=0)
    assert check.seconds >= 0
    assert [(p["name"], p["block"], p["violations"], p["parent_span_id"])
            for p in sink] == [("integrity_check", 3, 0, "execute")]
    assert sink[0]["seconds"] == round(check.seconds, 6)
    with pytest.raises(RuntimeError):
        with region("engine.block", "h_block", tracer, block=4):
            raise RuntimeError("block failed")
    assert len(sink) == 1
    with region("engine.block", "h_block", None, block=5) as untraced:
        pass
    assert untraced.seconds >= 0 and len(sink) == 1


def test_fit_enters_no_record_function_without_a_profiler(  # jaxlint: disable=JL018 -- N=90, H=8, K 2..4 on the CPU port
        data, tmp_path, monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _fit(data, tmp_path, **FITS["estimate"][0])
    assert entered == []


def _capture_centres(monkeypatch):
    """Every ``KMeans.fit``'s returned centres, in call order."""
    got = []
    real = KMeans.fit

    def fit(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        got.append(out[1].clone())
        return out

    monkeypatch.setattr(KMeans, "fit", fit)
    return got


@pytest.mark.parametrize("kind", ["exact", "stream", "estimate"])
def test_results_identical_with_a_profiler_on_and_off(  # jaxlint: disable=JL018 -- N=90, H=8, K 2..4 on the CPU port, twice
        data, tmp_path, monkeypatch, kind):
    kwargs = dict(FITS[kind][0])
    kwargs.pop("checkpoint", None)
    centres = _capture_centres(monkeypatch)
    off = _fit(data, tmp_path, **kwargs)
    n_off = len(centres)
    with recording_ranges(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = _fit(data, tmp_path, **kwargs)
    assert len(centres) == 2 * n_off > 0
    for a, b in zip(centres[:n_off], centres[n_off:]):
        assert torch.equal(a, b)
    assert on.best_k_ == off.best_k_
    assert on.metrics_["lloyd"] == off.metrics_["lloyd"]
    for k in off.cdf_at_K_data:
        for key in ("hist", "cdf"):
            np.testing.assert_array_equal(on.cdf_at_K_data[k][key],
                                          off.cdf_at_K_data[k][key])
        assert on.cdf_at_K_data[k]["pac_area"] == \
            off.cdf_at_K_data[k]["pac_area"]


def test_lloyd_counts_equal_the_loop_stepped_by_hand():
    km = KMeans(n_init=3, max_iter=50, tol=1e-4)
    # Structureless data: the lanes stop after different numbers of steps.
    x = torch.randn((3, 40, 4), generator=torch.Generator().manual_seed(0))
    keys = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int64)
    k, k_max = 3, 4
    before = lloyd_counts()
    km.fit(keys, x, k, k_max)
    counted = lloyd_since(before)

    # The same loop, stepped here: a lane runs until its shift falls to
    # the tolerance or it reaches max_iter.
    init = km.init_centroids(keys, x, k, k_max)
    lanes = 3 * km.n_init
    cen = init.reshape(lanes, k_max, 4).clone()
    src = torch.arange(3, dtype=torch.int32).repeat_interleave(km.n_init)
    tol = (km.tol * x.var(dim=1, correction=0).mean(dim=-1))[src]
    shift = torch.full((lanes,), float("inf"))
    iters = torch.zeros(lanes, dtype=torch.int64)
    valid = torch.arange(k_max) < k
    steps = lane_steps = 0
    while True:
        idx = torch.nonzero((shift > tol) & (iters < km.max_iter)).squeeze(1)
        if idx.numel() == 0:
            break
        steps += 1
        lane_steps += idx.numel()
        sums, counts, far = kmeans.lloyd_step(x, src[idx], cen[idx], k)
        new, step_shift = kmeans._apply_update(
            x, src[idx], cen[idx], sums, counts, far, valid)
        cen[idx], shift[idx] = new, step_shift
        iters[idx] += 1
    assert counted == {"fits": 1, "steps": steps, "lane_steps": lane_steps,
                       "lane_slots": steps * lanes}
    assert 0 < lane_steps < steps * lanes


@pytest.mark.parametrize("kind", ["exact", "stream", "estimate"])
def test_metrics_lloyd_steps_equal_the_runs_lloyd_step_calls(  # jaxlint: disable=JL018 -- N=90, H=8, K 2..4 on the CPU port
        data, tmp_path, monkeypatch, kind):
    calls = []
    real = kmeans.lloyd_step

    def step(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(kmeans, "lloyd_step", step)
    cc = _fit(data, tmp_path, **FITS[kind][0])
    lloyd = dict(cc.metrics_["lloyd"])
    refined = cc.metrics_.get("exact_best_k")
    if refined is not None:
        for name, n in refined["timing"]["lloyd"].items():
            lloyd[name] += n
    assert lloyd["steps"] == len(calls) > 0
    assert lloyd["lane_steps"] == sum(calls)
    assert lloyd["fits"] > 0 and lloyd["lane_slots"] >= lloyd["lane_steps"]


def _run_with_ring(engine, x, directory, tracer):
    ring = StreamCheckpointer(str(directory))
    try:
        engine.run(x, 5, 8, checkpointer=ring, integrity_check_every=1,
                   tracer=tracer)
    finally:
        ring.close()


class _Sink(list):
    def __call__(self, payload):
        self.append(payload)


@pytest.mark.parametrize("engine", ["stream", "estimate"])
def test_engines_emit_their_block_spans(data, tmp_path, engine):
    config = SweepConfig(n_samples=90, n_features=4, k_values=(2, 3),
                         n_iterations=8, store_matrices=False,
                         stream_h_block=4, accum_repr="packed")
    if engine == "stream":
        eng = StreamingSweep(KMeans(n_init=2), config, device="cpu")
    else:
        eng = PairConsensusEngine(KMeans(n_init=2), config, n_pairs=1500,
                                  device="cpu")
    sink = _Sink()
    tracer = Tracer(sink, trace_id="job", parent_span_id="execute")
    _run_with_ring(eng, data, tmp_path / engine, tracer)
    spans = [(p["name"], p.get("block")) for p in sink]
    assert spans == [("integrity_check", 0), ("host_evaluate", 0),
                     ("h_block", 0), ("integrity_check", 1),
                     ("host_evaluate", 1), ("h_block", 1)]
    assert all(p["trace_id"] == "job" and p["parent_span_id"] == "execute"
               and p["seconds"] >= 0 and p["status"] == "ok" for p in sink)
    assert [p["h_done"] for p in sink if p["name"] == "h_block"] == [4, 8]
    assert all(p["violations"] == 0 for p in sink
               if p["name"] == "integrity_check")
    sink.clear()
    _run_with_ring(eng, data, tmp_path / engine, tracer)
    assert [p["name"] for p in sink] == ["resume_restore"]
    assert {k: sink[0][k] for k in ("resumed_from_block", "h_done",
                                    "terminal")} == {
        "resumed_from_block": 2, "h_done": 8, "terminal": True}
