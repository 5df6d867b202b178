"""Device selection: the port runs on the GPU unless asked for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; raises when there is none.

    The CPU is used only when the caller names it (``device="cpu"``), so a
    missing GPU is a clear error rather than a silent slow fallback.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: the port runs on the GPU by "
                "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
