"""The sweep profiler's grouping of device kernels by name, and its
breakdown of a trace by the program's ``cc.*`` ranges."""

import types

import pytest

from portbench import trace as bench_trace
from consensus_clustering_tpu_torch.profile_sweep import (
    NO_RANGE,
    Event,
    _innermost,
    _kernel_class,
    range_breakdown,
    trace_events,
)


@pytest.mark.parametrize("name,group", [
    ("void lloyd_step_kernel<true>(float const*, int const*, float const*)",
     "lloyd_step_kernel"),
    ("lloyd_reduce_kernel(float const*, float const*, int const*, int)",
     "lloyd_reduce_kernel"),
    ("void assign_kernel<false>(float const*, int const*)", "assign_kernel"),
    ("void fused_planes_kernel<true>(float const*, float const*, int)",
     "fused_planes_kernel"),
    ("hist_kernel(float const*, int, int)", "hist_kernel"),
    ("void hist_kernel<CountLoad, 4, long long>(CountLoad, long long)",
     "hist_kernel"),
    ("fused_merge_kernel(int const*, long long, int, int, int*)",
     "fused_merge_kernel"),
    ("kmeanspp_draw_kernel(long long const*, unsigned int, float const*, "
     "int, int, int, unsigned long long*)", "kmeanspp_draw_kernel"),
    ("kmeanspp_pick_kernel(unsigned long long const*, unsigned long, int, "
     "int, long long*)", "kmeanspp_pick_kernel"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8", "cublas gemm"),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::"
     "CUDAFunctor_add<long>>(int, long)",
     "other (elementwise, reductions, copies)"),
])
def test_kernel_class_groups_each_kernel_under_its_own_name(name, group):
    # Both instantiations of a template kernel fall under one name.
    assert _kernel_class(name) == group


def _kineto(*rows):
    """A stand-in for ``kineto_results``: (name, on the card, user
    annotation, start ns, duration ns, correlation id) rows."""
    def event(name, cuda, annotation, start, duration, corr):
        return types.SimpleNamespace(
            name=lambda: name, is_user_annotation=lambda: annotation,
            device_type=lambda: "DeviceType.CUDA" if cuda
            else "DeviceType.CPU",
            start_ns=lambda: start, duration_ns=lambda: duration,
            correlation_id=lambda: corr)
    return types.SimpleNamespace(events=lambda: [event(*r) for r in rows])


def test_trace_events_keep_the_ranges_device_annotations_off_the_device():
    events = trace_events(_kineto(
        ("cc.fit", False, True, 0, 100, 9),
        ("aten::add", False, False, 5, 3, 10),
        ("cudaLaunchKernel", False, False, 6, 1, 1),
        ("cc.fit", True, True, 30, 15, 9),
        ("k1", True, False, 30, 15, 1),
        ("user.range", False, True, 0, 100, 8),
    ))
    assert [e.kind for e in events] == [
        "range", "other", "launch", "other", "device", "other"]
    assert events[4] == Event("k1", "device", 30, 45, 1)


def test_range_breakdown_names_operations_and_gaps_by_their_range():
    ranges = range_breakdown([
        Event("cc.fit", "range", 0, 100, 0),
        Event("cc.engine", "range", 10, 90, 0),
        Event("cc.kmeans.seed", "range", 20, 40, 0),
        Event("cudaLaunchKernel", "launch", 25, 26, 1),
        Event("cudaLaunchKernel", "launch", 50, 51, 2),
        Event("cudaMemcpyAsync", "launch", 95, 96, 3),
        Event("k1", "device", 30, 45, 1),
        Event("k2", "device", 55, 60, 2),
        Event("Memcpy DtoH (Device -> Pinned)", "device", 96, 98, 3),
        Event("k3", "device", 99, 99, 4),  # its launch is not traced
        Event("cc.engine", "other", 55, 60, 7),
    ])
    ns = pytest.approx
    assert ranges["cc.fit"] == {
        "calls": 1, "host_s": ns(100e-9), "self_host_s": ns(20e-9),
        "device_s": ns(2e-9), "kernels": 0, "idle_s": ns(2e-9)}
    assert ranges["cc.engine"] == {
        "calls": 1, "host_s": ns(80e-9), "self_host_s": ns(60e-9),
        "device_s": ns(5e-9), "kernels": 1, "idle_s": ns(46e-9)}
    assert ranges["cc.kmeans.seed"] == {
        "calls": 1, "host_s": ns(20e-9), "self_host_s": ns(20e-9),
        "device_s": ns(15e-9), "kernels": 1, "idle_s": 0}
    # The gap from the window's start began as cc.fit opened: a query
    # at an instant precedes the opening.
    assert ranges[NO_RANGE]["kernels"] == 1
    assert ranges[NO_RANGE]["idle_s"] == ns(30e-9)
    assert range_breakdown([Event("k1", "device", 0, 5, 1)]) == {}


def test_trace_events_tell_annotations_by_name_where_the_event_cannot():
    kineto = _kineto(("cc.fit", False, True, 0, 100, 9),
                     ("cc.fit", True, True, 30, 15, 9),
                     ("portbench.window", True, True, 30, 15, 8),
                     ("k1", True, False, 30, 15, 1))
    rows = kineto.events()
    for e in rows:
        del e.is_user_annotation
    bare = types.SimpleNamespace(events=lambda: rows)
    assert [e.kind for e in trace_events(bare)] == [
        "range", "other", "other", "device"]


@pytest.mark.parametrize("times", [
    [0, 10, 20, 40, 50, 90, 100],  # every range's edges: ties
    [5, 15, 25, 45, 95, 120],
])
def test_innermost_reads_ties_as_the_benchmarks_reduction_does(times):
    ranges = sorted([Event("cc.fit", "range", 0, 100, 0),
                     Event("cc.engine", "range", 10, 90, 0),
                     Event("cc.kmeans.seed", "range", 20, 40, 0),
                     Event("cc.kmeans.lloyd", "range", 40, 50, 0),
                     Event("cc.kmeans.assign", "range", 50, 50, 0)],
                    key=lambda e: (e.start, -e.end))
    theirs = bench_trace._innermost(
        [bench_trace.Event(*r) for r in ranges], times)
    ours = _innermost(ranges, times)
    assert ours == [None if name == bench_trace.WINDOW else name
                    for name in theirs]
    if 40 in times:
        # At 40 the seed closes and Lloyd opens: the query between them.
        assert ours[times.index(40)] == "cc.engine"
