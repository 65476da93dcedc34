"""Run metrics: JSON-lines events and device memory statistics."""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, Optional

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
