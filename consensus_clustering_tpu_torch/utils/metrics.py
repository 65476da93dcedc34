"""Run metrics: JSON-lines events and device memory statistics."""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import threading
import time
from typing import Any, Dict, Iterator, Optional

import torch

logger = logging.getLogger(__name__)


def device_memory_stats(device=None) -> Dict[str, int]:
    """Allocator statistics of a CUDA device, {} for the CPU.

    ``peak_bytes_in_use`` is ``torch.cuda.max_memory_allocated`` since the
    last ``torch.cuda.reset_peak_memory_stats``; the names follow the
    reference package's ``device_memory_stats``.
    """
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(device)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
        "bytes_limit": int(total),
        "bytes_free": int(free),
    }


_window_lock = threading.Lock()
_open_windows: Dict[str, int] = {}


@contextlib.contextmanager
def peak_memory_window(device) -> Iterator[None]:
    """One run's window on a CUDA device's allocator high-water.

    The high-water belongs to the whole process, so it is reset at a
    window's start only when no other window on the device is open: a
    run never wipes the peak of another that is still executing (a
    timed-out attempt's abandoned thread), and an engine run inside a
    service run's window keeps the service's reading whole.  This is
    the port's one place that resets the high-water.  Nothing happens
    on the CPU.
    """
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    if on_cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    name = str(device)
    with _window_lock:
        _open_windows[name] = _open_windows.get(name, 0) + 1
        if on_cuda and _open_windows[name] == 1:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
    try:
        yield
    finally:
        with _window_lock:
            _open_windows[name] -= 1


def in_peak_memory_window(method):
    """Run an engine's method inside :func:`peak_memory_window` on each
    distinct device of the engine's ``mesh`` that this process holds."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with contextlib.ExitStack() as windows:
            for dev in self.mesh.local_devices:
                windows.enter_context(peak_memory_window(dev))
            return method(self, *args, **kwargs)

    return wrapped


class MetricsLogger:
    """Append structured events to a JSON-lines file and to the log.

    Each event is one line ``{"ts": <unix>, "event": <name>, ...fields}``;
    ``path=None`` logs only.  With a file the log mirror is at DEBUG,
    without one at INFO.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.log_level = logging.DEBUG if path else logging.INFO

    def emit(self, event: str, **fields: Any) -> Dict[str, Any]:
        record = {"ts": round(time.time(), 3), "event": event, **fields}
        line = json.dumps(record, default=float, sort_keys=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        logger.log(self.log_level, "metrics: %s", line)
        return record
