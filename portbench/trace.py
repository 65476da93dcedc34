"""Reduction of a ``torch.profiler`` trace of one steady sub-window to the
numbers the per-layer readers take.

- The window is the ``portbench.window`` range; device operations are the
  trace's kernels, copies and sets on a CUDA device.  A user annotation
  (a host range, the benchmark's ``portbench.*`` or the program's
  ``cc.*``, and the GPU-side copy the profiler makes of it) is told by the
  profiler's own flag, and by its name only where an event lacks the flag:
  a host range is a ``"range"``, its GPU-side copy no operation.
- Busy time is the union of the operations' intervals inside the window;
  idle gaps are what lies between them.
- A device operation belongs to the range in which the host launched it
  (the launch call's correlation id ties the two): the innermost benchmark
  range (:func:`summarize`) and, apart, the innermost program range
  (:func:`summarize_program`), so that neither kind takes time from the
  other.  An idle gap belongs to the program range the host was in when
  the gap began.
- Kernel classes follow the names of the port's kernels; cuBLAS products
  form one class and every other PyTorch kernel another.

The profile is the lightest that still ties launches to ranges
(:func:`profiling`): user ranges, and on the card the launch calls and
device operations, but none of PyTorch's operators, whose recording about
doubles a host-paced sweep.  Its raw kineto events are read, which avoids
building the profiler's Python event tree over hundreds of thousands of
launches.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

WINDOW = "portbench.window"
PREFIX = "portbench."
#: Every range of the program (``obs/tracing.region``) starts with this.
PROGRAM_PREFIX = "cc."
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


def _is_annotation(event, name: str) -> bool:
    """Whether a kineto event is a user annotation: by the event's own
    flag, else by the name of a range of the benchmark or the program."""
    says = getattr(event, "is_user_annotation", None)
    if says is not None:
        return bool(says())
    return name.startswith((PREFIX, PROGRAM_PREFIX))


def _kind(name: str, on_device: bool, annotation: bool) -> str:
    if annotation:
        # The GPU side of a host range spans what it launched; it is not
        # an operation.
        return "other" if on_device else "range"
    if on_device:
        return "device"
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
            name, _kind(name, str(e.device_type()).endswith("CUDA"),
                        _is_annotation(e, name)),
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


def _window(events: List[Event]) -> Optional[Tuple[int, int]]:
    windows = [e for e in events if e.kind == "range" and e.name == WINDOW]
    return (windows[0].start, windows[0].end) if windows else None


def _ranges(events: List[Event], prefix: str, w0: int, w1: int
            ) -> List[Event]:
    """The ranges named ``prefix``* inside the window (the window itself
    none of them), the outer first where two open together."""
    return sorted((e for e in events if e.kind == "range"
                   and e.name != WINDOW and e.name.startswith(prefix)
                   and e.start >= w0 and e.end <= w1),
                  key=lambda e: (e.start, -e.end))


def _attribute(events: List[Event], ranges: List[Event], w0: int, w1: int):
    """The rule both reductions share: the window's device operations,
    each with the innermost of ``ranges`` at its launch (None where its
    launch is not in the trace); the busy intervals; and the idle gaps,
    each with the innermost of ``ranges`` at the gap's start."""
    device = [e for e in events if e.kind == "device"
              and e.end > w0 and e.start < w1]
    launches = [e for e in events if e.kind == "launch"
                and w0 <= e.start <= w1]
    launch_range = dict(zip(
        (e.corr for e in launches),
        _innermost(ranges, [e.start for e in launches])))
    owners = [launch_range.get(e.corr) if e.corr else None for e in device]
    busy = _union((max(e.start, w0), min(e.end, w1)) for e in device)
    gaps = []
    cursor = w0
    for a, b in busy:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    if cursor < w1:
        gaps.append((cursor, w1))
    idle = list(zip(gaps, _innermost(ranges, [a for a, _ in gaps])))
    return device, owners, busy, idle


def _is_kernel(name: str) -> bool:
    return kernel_class(name) not in ("memcpy", "memset")


def summarize(events: List[Event], top: int = 10
              ) -> Optional[Dict[str, Any]]:
    """The trace's window, busy time, operations, per-class device
    seconds and the device seconds by the benchmark range that launched
    them; None when the trace holds no window."""
    window = _window(events)
    if window is None:
        return None
    w0, w1 = window
    device, owners, busy, _ = _attribute(
        events, _ranges(events, PREFIX, w0, w1), w0, w1)
    by_class: Dict[str, float] = collections.defaultdict(float)
    by_range: Dict[str, float] = collections.defaultdict(float)
    for e, owner in zip(device, owners):
        by_class[kernel_class(e.name)] += (e.end - e.start) * 1e-9
        if owner is not None:
            by_range[owner[len(PREFIX):]] += (e.end - e.start) * 1e-9
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "kernels": sum(1 for e in device if _is_kernel(e.name)),
        "device_s_by_class": dict(by_class),
        "device_s_by_range": dict(by_range),
        "collective_s": by_class.get("nccl collective", 0.0),
        "device_ops": longest(by_class, top),
    }


def summarize_program(events: List[Event]
                      ) -> Optional[Dict[str, Dict[str, float]]]:
    """Each program range's ``calls``; ``host_s``, summed over its calls;
    ``self_host_s``, less the program ranges directly inside it;
    ``device_s`` and ``kernels`` of the device operations launched with it
    the innermost program range; and ``idle_s`` of the idle gaps that
    began in it.  The entry ``portbench.window`` holds what no program
    range launched or began.  Only program ranges own here: a benchmark
    range inside one takes nothing from it.  None when the trace holds no
    window."""
    window = _window(events)
    if window is None:
        return None
    w0, w1 = window
    ranges = _ranges(events, PROGRAM_PREFIX, w0, w1)
    out: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: dict.fromkeys(("calls", "host_s", "self_host_s", "device_s",
                               "kernels", "idle_s"), 0))
    stack: List[Event] = []
    for r in ranges:
        while stack and stack[-1].end <= r.start:
            stack.pop()
        seconds = (r.end - r.start) * 1e-9
        entry = out[r.name]
        entry["calls"] += 1
        entry["host_s"] += seconds
        entry["self_host_s"] += seconds
        if stack:
            out[stack[-1].name]["self_host_s"] -= seconds
        stack.append(r)
    device, owners, _, idle = _attribute(events, ranges, w0, w1)
    for e, owner in zip(device, owners):
        if owner is not None:
            out[owner]["device_s"] += (e.end - e.start) * 1e-9
            out[owner]["kernels"] += _is_kernel(e.name)
    for (a, b), name in idle:
        out[name]["idle_s"] += (b - a) * 1e-9
    return dict(out)


def longest(seconds: Dict[str, float], top: int = 10) -> List[List[Any]]:
    """The ``top`` largest [name, seconds] entries, largest first."""
    return sorted(([k, v] for k, v in seconds.items()),
                  key=lambda kv: -kv[1])[:top]
