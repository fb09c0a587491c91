"""Masked BatchNorm over padded node sets (``rmm_tpu/nn/norms.py``).

Batch statistics ignore padded rows. Running stats follow the JAX module:
``running = momentum·running + (1 − momentum)·batch`` with momentum 0.9
(torch's 0.1), the running variance unbiased, everything in float32.
Eval mode normalizes with the running stats.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.float()
        if self.training:
            if mask is not None:
                m = mask.to(x.dtype)[:, None]
                n = torch.clamp(m.sum(), min=1.0)
                mean = (x * m).sum(0) / n
                var = ((x - mean) ** 2 * m).sum(0) / n
            else:
                n = torch.tensor(float(x.shape[0]), device=x.device)
                mean = x.mean(0)
                var = x.var(0, unbiased=False)
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.running_mean.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(in_dtype)
