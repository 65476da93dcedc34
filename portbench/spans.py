"""Spans the benchmark puts around the program's layers in a traced run.

Each span wraps one function of the port by its module and attribute
name: inside it the host time is summed and a ``torch.profiler``
range ``portbench.<span>`` is open, so the trace can tell which layer the
host was in and which device kernels a layer launched.  A span may record
the work of each call from its arguments' shapes (the roofline metrics'
bounds), without reading the device.  A name the program no longer has is
reported missing, never wrapped silently.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from portbench import peaks

PREFIX = "portbench."


def _lloyd_step_bound(n_init: int) -> Callable[..., float]:
    def bound(x, lane_src, centroids, k, *args, **kwargs) -> float:
        resamples, rows, d = x.shape
        lanes = centroids.shape[0]
        return peaks.lloyd_step_bound_ms(
            peaks.lloyd_resamples_read(lanes, resamples, n_init), rows, d,
            lanes, int(k))
    return bound


def _popcount_bound(row_words, col_words, *args, **kwargs) -> float:
    words, rows = row_words.shape
    return peaks.popcount_bound_ms(words, rows, col_words.shape[1])


def span_table(n_init: int) -> List[Tuple[str, str, str, Optional[Callable]]]:
    """(span, module, attribute, bound of a call or None), outermost
    layers first."""
    kmeans = "consensus_clustering_tpu_torch.models.kmeans"
    return [
        ("kmeanspp", kmeans, "_kmeanspp_init", None),
        ("lloyd", kmeans, "KMeans._lloyd", None),
        ("assign", kmeans, "assign_labels", None),
        ("b2", "consensus_clustering_tpu_torch.ops.lloyd",
         "lloyd_step_kernel", _lloyd_step_bound(n_init)),
        ("b3", "consensus_clustering_tpu_torch.ops.popcount",
         "packed_coassoc_counts_kernel", _popcount_bound),
    ]


class Spans:
    """Host seconds, calls and call bounds of each span while installed."""

    def __init__(self, n_init: int):
        self.table = span_table(n_init)
        self.host_s: Dict[str, float] = {}
        self.calls: Dict[str, int] = {}
        self.bounds_ms: Dict[str, List[float]] = {}
        self.missing: Dict[str, str] = {}

    def _wrap(self, name: str, fn: Callable, bound) -> Callable:
        label = PREFIX + name

        def wrapper(*args, **kwargs):
            if bound is not None:
                self.bounds_ms[name].append(bound(*args, **kwargs))
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
        """Wrap every function of the table that exists; restore on exit."""
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
