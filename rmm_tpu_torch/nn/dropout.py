"""Dropout from an explicit ``torch.Generator`` (flax semantics).

Every random draw of a training step comes from one generator that the
trainer seeds from ``cfg.seed`` and hands to the model with
:func:`set_generator`, so the same seed on the same card gives the same
training run. flax's ``nn.Dropout``: keep each element with probability
``1 − p`` and scale what is kept by ``1 / (1 − p)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


#: elements of the largest float32 draw behind one keep-mask; a larger mask
#: is drawn in slices along its first axis (the Elliptic node tokens'
#: [lanes, 8, 167, 167] mask would otherwise draw 0.9 GB of floats per
#: 1,024 lanes at once)
MAX_DRAW = 1 << 26


def keep_mask(shape, rate: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Bool mask, True with probability ``1 − rate``, drawn by
    ``torch.rand`` in slices of rows of ``shape[0]``, each at most
    ``MAX_DRAW`` elements (or one row), in order: a mask of at most
    ``MAX_DRAW`` elements is one draw."""
    if generator is None:
        raise RuntimeError("dropout in train mode needs a torch.Generator: "
                           "call rmm_tpu_torch.nn.dropout.set_generator")
    shape = tuple(shape)
    step = max(1, MAX_DRAW // math.prod(shape[1:]))
    out = torch.empty(shape, dtype=torch.bool, device=device)
    for i in range(0, shape[0], step):
        part = torch.rand((min(step, shape[0] - i), *shape[1:]),
                          generator=generator, device=device)
        torch.lt(part, 1.0 - rate, out=out[i:i + step])
    return out


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


def set_rate(model: nn.Module, rate: float) -> None:
    """Set every dropout rate of ``model`` (the ``rate`` of each
    :class:`GeneratorDropout`, the ``dropout`` of each attention layer's
    keep-mask) to ``rate``; parity runs take 0, which reaches the rates
    no flag sets (``CPNATAB``'s row attention keeps the reference's fixed
    0.1)."""
    for mod in model.modules():
        if isinstance(mod, GeneratorDropout):
            mod.rate = rate
        elif hasattr(mod, "generator") and hasattr(mod, "dropout"):
            mod.dropout = rate
