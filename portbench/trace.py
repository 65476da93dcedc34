"""Reduction of a ``torch.profiler`` trace of one steady sub-window to the
numbers the per-layer readers take.

- The window is the ``portbench.window`` range; device operations are the
  trace's kernels, copies and sets on a CUDA device (their GPU-side
  annotations are not operations).
- Busy time is the union of the operations' intervals inside the window;
  idle gaps are what lies between them, each named by the innermost
  benchmark range the host was in when the gap began.
- A device operation belongs to the benchmark range in which the host
  launched it: the launch call's correlation id ties the two.
- Kernel classes follow the names of the port's kernels; cuBLAS products
  form one class and every other PyTorch kernel another.

The profile is the lightest that still ties launches to ranges
(:func:`profiling`): the benchmark's ranges, and on the card the launch
calls and device operations, but none of PyTorch's operators, whose
recording about doubles a host-paced sweep.  Its raw kineto events are
read, which avoids building the profiler's Python event tree over
hundreds of thousands of launches.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

WINDOW = "portbench.window"
PREFIX = "portbench."
_KERNEL_PREFIXES = ("lloyd_", "hist_kernel", "popcount_kernel",
                    "fused_planes_kernel", "fused_merge_kernel",
                    "assign_kernel", "kmeanspp_")


def kernel_class(name: str) -> str:
    """The port's kernel a device operation is, else its class."""
    bare = name[len("void "):] if name.startswith("void ") else name
    for prefix in _KERNEL_PREFIXES:
        if bare.startswith(prefix):
            return bare.split("(")[0].split("<")[0]
    lowered = name.lower()
    if "nccl" in lowered:
        return "nccl collective"
    if "gemm" in lowered or "cutlass" in lowered or "xmma" in lowered:
        return "cublas gemm"
    if "memcpy" in lowered:
        return "memcpy"
    if "memset" in lowered:
        return "memset"
    return "other (elementwise, reductions, copies)"


class Event(NamedTuple):
    name: str
    kind: str  # "device", "range", "launch" or "other"
    start: int  # ns
    end: int  # ns
    corr: int


#: Host calls that put work on the device: their correlation ids tie the
#: device operations to the host range that launched them.
_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                 "cuMemcpy", "cuMemset", "cudaGraphLaunch")


def _kind(name: str, on_device: bool) -> str:
    if on_device:
        # The GPU side of a host range is an annotation, not an operation.
        return "other" if name.startswith(PREFIX) else "device"
    if name.startswith(PREFIX):
        return "range"
    if name.startswith(_LAUNCH_CALLS):
        return "launch"
    return "other"


def raw_events(results) -> List[Event]:
    """Every event of a finished kineto profile, as :class:`Event`."""
    out = []
    for e in results.events():
        name = e.name()
        start = int(e.start_ns())
        corr = getattr(e, "correlation_id", None)
        out.append(Event(
            name, _kind(name, str(e.device_type()).endswith("CUDA")),
            start, start + int(e.duration_ns()),
            int(corr()) if corr is not None else 0))
    return out


class Profile:
    """A finished profile; :meth:`events` reads it once."""

    def __init__(self):
        self.results = None
        self._events: Optional[List[Event]] = None

    def events(self) -> List[Event]:
        if self._events is None:
            self._events = raw_events(self.results)
            self.results = None
        return self._events


@contextlib.contextmanager
def profiling(cuda: bool):
    """Profile the block: user ranges (``record_function``) on the host,
    and with ``cuda`` the CUDA runtime's launch calls and the device's
    operations; PyTorch's operators are not recorded."""
    from torch._C._profiler import RecordScope, _ExperimentalConfig
    from torch.autograd.profiler import (
        ProfilerConfig, ProfilerState, _disable_profiler, _enable_profiler,
        _prepare_profiler)
    from torch.profiler import ProfilerActivity

    activities = {ProfilerActivity.CPU}
    if cuda:
        activities.add(ProfilerActivity.CUDA)
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                            False, _ExperimentalConfig())
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    prof = Profile()
    try:
        yield prof
    finally:
        prof.results = _disable_profiler()


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(ranges: List[Event], times: List[int]) -> List[str]:
    """The innermost range open at each time (ranges of one host thread
    nest); ``portbench.window`` where none is."""
    marks = []
    for i, r in enumerate(ranges):
        marks.append((r.start, 1, i))
        marks.append((r.end, -1, i))
    for j, t in enumerate(times):
        marks.append((t, 0, j))
    # At one instant: close before query before open.
    marks.sort(key=lambda m: (m[0], {-1: 0, 0: 1, 1: 2}[m[1]]))
    stack: List[int] = []
    out = [WINDOW] * len(times)
    for _, what, i in marks:
        if what == 1:
            stack.append(i)
        elif what == -1:
            if i in stack:
                stack.remove(i)
        else:
            out[i] = ranges[stack[-1]].name if stack else WINDOW
    return out


def summarize(events: List[Event], top: int = 10
              ) -> Optional[Dict[str, Any]]:
    """The trace's window, busy time, operations, per-class and per-range
    device seconds, and the longest idle time by host range; None when the
    trace holds no window."""
    windows = [e for e in events if e.kind == "range" and e.name == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0].start, windows[0].end
    ranges = sorted((e for e in events if e.kind == "range"
                     and e.name != WINDOW and e.start >= w0 and e.end <= w1),
                    key=lambda e: e.start)
    device = [e for e in events if e.kind == "device"
              and e.end > w0 and e.start < w1]
    launches = [e for e in events if e.kind == "launch"
                and w0 <= e.start <= w1]
    busy = _union((max(e.start, w0), min(e.end, w1)) for e in device)
    by_class: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        by_class[kernel_class(e.name)] += (e.end - e.start) * 1e-9
    # Device time by the range its launch was made in.
    launch_range = dict(zip(
        (e.corr for e in launches),
        _innermost(ranges, [e.start for e in launches])))
    by_range: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        owner = launch_range.get(e.corr) if e.corr else None
        if owner is not None:
            by_range[owner[len(PREFIX):]] += (e.end - e.start) * 1e-9
    # Idle gaps, named by the host's range at each gap's start.
    gaps = []
    cursor = w0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < w1:
        gaps.append((cursor, w1))
    idle_by: Dict[str, float] = collections.defaultdict(float)
    for (a, b), name in zip(gaps, _innermost(ranges, [a for a, _ in gaps])):
        idle_by[name] += (b - a) * 1e-9
    busy_s = sum(b - a for a, b in busy) * 1e-9
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": busy_s,
        "kernels": sum(1 for e in device if kernel_class(e.name) not in
                       ("memcpy", "memset")),
        "device_s_by_class": dict(by_class),
        "device_s_by_range": dict(by_range),
        "collective_s": by_class.get("nccl collective", 0.0),
        "device_ops": sorted(([k, v] for k, v in by_class.items()),
                             key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in idle_by.items()),
                            key=lambda kv: -kv[1])[:top],
    }
