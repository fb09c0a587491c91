"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. There is no
silent fallback: asking for CUDA on a machine without it raises.
"""
from __future__ import annotations

import torch


def resolve_device(name: str | torch.device | None = None) -> torch.device:
    """``None``/"cuda"/"cuda:N" → a CUDA device (raises without CUDA);
    "cpu" → the CPU."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device cpu (device='cpu') to run "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
