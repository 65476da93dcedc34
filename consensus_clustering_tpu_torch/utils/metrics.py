"""Device memory statistics for run metrics."""

from __future__ import annotations

from typing import Dict

import torch


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
