"""Dropout from an explicit ``torch.Generator`` (flax semantics).

Every random draw of a training step comes from one generator that the
trainer seeds from ``cfg.seed`` and hands to the model with
:func:`set_generator`, so the same seed on the same card gives the same
training run. flax's ``nn.Dropout``: keep each element with probability
``1 − p`` and scale what is kept by ``1 / (1 − p)``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def keep_mask(shape, rate: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Bool mask, True with probability ``1 − rate``."""
    if generator is None:
        raise RuntimeError("dropout in train mode needs a torch.Generator: "
                           "call rmm_tpu_torch.nn.dropout.set_generator")
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if not training or rate <= 0.0:
        return x
    keep = keep_mask(x.shape, rate, generator, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class GeneratorDropout(nn.Module):
    """Module form of :func:`dropout`; its generator is set from outside."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x, self.rate, self.training, self.generator)


def set_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Give every dropout of ``model`` (modules with a ``generator``
    attribute) the same generator."""
    for mod in model.modules():
        if hasattr(mod, "generator"):
            mod.generator = generator
