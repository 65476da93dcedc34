"""Where the port runs: the card, unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda``.

    Without a visible GPU and without an explicit device this raises: the
    CPU runs only the kernels' plain versions, and only when asked to.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: the port runs on the GPU by "
            "default; pass device='cpu' to run its plain PyTorch versions "
            "on the CPU"
        )
    return torch.device("cuda")
