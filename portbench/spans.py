"""Spans the benchmark puts around the program's kernel launchers in a
traced run, for the bounds of the roofline metrics.

Each file ``bounds/<span>.py`` names one launcher of the port by its
module and attribute (``MODULE``, ``ATTRIBUTE``) and holds
``bound_ms(config, *args, **kwargs)``: the least milliseconds a call's
work could take on the card, from the configuration of the cell
(``configs/<config>.json``) and the call's arguments' shapes, without
reading the device.  While installed, each launcher so named is wrapped:
inside it the host time is summed, its bound recorded and a
``torch.profiler`` range ``portbench.<span>`` is open, so the trace can
tell which device operations the calls launched.  Adding a kernel's bound
is adding its file; a name the program no longer has is reported
missing, never wrapped silently.

The layers above the launchers are the program's own ranges (``cc.*``,
``obs/tracing.region``) and counters (``metrics_``), which the harness
records beside these spans: a program range, a counter or a kernel's
bound is read by adding files.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

PREFIX = "portbench."


def span_table(bounds_dir: str) -> List[Tuple[str, str, str, Callable]]:
    """(span, module, attribute, bound of a call) of each
    ``bounds/<span>.py``, in the order of their names."""
    table = []
    for entry in sorted(os.listdir(bounds_dir)):
        name, ext = os.path.splitext(entry)
        if ext != ".py" or name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"portbench_bounds_{name}", os.path.join(bounds_dir, entry))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        table.append((name, module.MODULE, module.ATTRIBUTE,
                      module.bound_ms))
    return table


class Spans:
    """Host seconds, calls and call bounds of each span while installed."""

    def __init__(self, config: Dict[str, Any], bounds_dir: str):
        self.config = config
        self.table = span_table(bounds_dir)
        self.host_s: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.bounds_ms: Dict[str, List[float]] = {}
        self.missing: Dict[str, str] = {}

    def _wrap(self, name: str, fn: Callable, bound: Callable) -> Callable:
        label = PREFIX + name

        def wrapper(*args, **kwargs):
            self.bounds_ms[name].append(bound(self.config, *args, **kwargs))
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
            self.host_s[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out

        wrapper.__wrapped__ = fn
        return wrapper

    @contextlib.contextmanager
    def installed(self) -> Iterator["Spans"]:
        """Wrap every launcher of the table that exists; restore on exit."""
        saved: List[Tuple[Any, str, Any]] = []
        for name, module_name, attr, bound in self.table:
            self.host_s[name] = 0.0
            self.calls[name] = 0
            self.bounds_ms[name] = []
            try:
                owner = importlib.import_module(module_name)
                *path, leaf = attr.split(".")
                for part in path:
                    owner = getattr(owner, part)
                fn = getattr(owner, leaf)
            except (ImportError, AttributeError):
                self.missing[name] = f"{module_name}.{attr}"
                continue
            saved.append((owner, leaf, fn))
            setattr(owner, leaf, self._wrap(name, fn, bound))
        try:
            yield self
        finally:
            for owner, leaf, fn in reversed(saved):
                setattr(owner, leaf, fn)

    def record(self) -> Dict[str, Any]:
        return {
            name: {"host_s": self.host_s[name], "calls": self.calls[name],
                   "bound_ms": sum(self.bounds_ms[name])}
            for name in self.host_s if name not in self.missing
        }
