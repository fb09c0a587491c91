"""Supervised loss (``rmm_tpu/utils/loss.py::cross_entropy``)."""
from __future__ import annotations

from typing import Optional

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-class-weighted cross-entropy, mean-reduced over the rows that
    ``mask`` keeps: ``Σ w_y·ce / Σ w_y`` (``torch.nn.CrossEntropyLoss``
    with ``weight=``). Out-of-range labels are clipped; their rows must be
    masked out."""
    logp = torch.log_softmax(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    ce = -logp.gather(-1, safe[:, None])[:, 0]
    w = torch.ones_like(ce) if weights is None else weights.to(ce)[safe]
    if mask is not None:
        w = w * mask.to(w.dtype)
    return (ce * w).sum() / w.sum().clamp(min=1e-12)
