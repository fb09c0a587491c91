"""LoRA adapter (``rmm_tpu/nn/text/lora.py``)."""
from __future__ import annotations

import torch
from torch import nn

ALPHA = 16.0


class LoRADense(nn.Module):
    """A dense layer with a trainable low-rank update:
    ``y = x·W + b + (α/r)·(x·A)·B``, α = ``ALPHA`` (the reference's
    default), ``A [in, r]``, ``B [r, out]`` (no update at rank 0).
    ``weight`` is ``[out, in]`` (the JAX ``kernel`` transposed, as every
    Dense of the port). With ``freeze_base`` no
    gradient reaches ``W`` and ``b`` (the adapters train alone)."""

    def __init__(self, in_features: int, features: int, rank: int = 8,
                 freeze_base: bool = False):
        super().__init__()
        self.rank = rank
        self.freeze_base = freeze_base
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        if rank > 0:
            self.lora_a = nn.Parameter(torch.empty(in_features, rank))
            self.lora_b = nn.Parameter(torch.empty(rank, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if self.freeze_base:
            w, b = w.detach(), b.detach()
        y = nn.functional.linear(x, w, b)
        if self.rank > 0:
            y = y + (ALPHA / self.rank) * ((x @ self.lora_a)
                                                @ self.lora_b)
        return y
