"""Host-side progress bars: tqdm with a per-K description, or the plain
iterator when progress is off or tqdm is missing."""

from __future__ import annotations

from typing import Iterable


def progress_iter(it: Iterable, desc: str, enabled: bool = True) -> Iterable:
    if not enabled:
        return it
    try:
        from tqdm import tqdm
    except ImportError:
        return it
    return tqdm(it, desc=desc)
