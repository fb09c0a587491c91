"""Dense and LayerNorm with flax's dtype promotion.

Under ``--precision bf16`` the parameters arrive in bf16 while some
activations stay float32 (the timestamp encoder's features are float32, so
the edge tokens that hold them are too, as in the reference). flax computes
a layer in the promoted dtype of its input and parameters; PyTorch's
``F.linear`` and ``F.layer_norm`` want one dtype, so these layers promote
first. In float32 they are ``nn.Linear`` and ``nn.LayerNorm`` as they were;
in bf16, Dense adds its bias to the product rounded to bf16, as flax does
(one rounding more than ``F.linear`` takes; the model's bf16 logits then
agree with the reference's to float32 accuracy).
LayerNorm uses flax's epsilon (1e-6); on bf16 its statistics are float32
inside ``F.layer_norm``, as flax takes them.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.precision import promote

LN_EPS = 1e-6   # flax.linen.LayerNorm default


class Dense(nn.Linear):
    def forward(self, x):
        x, w, b = promote(x, self.weight, self.bias)
        if x.dtype == torch.float32:
            return nn.functional.linear(x, w, b)
        # flax rounds the product to bf16 before it adds the bias
        return nn.functional.linear(x, w) + b


class LayerNorm(nn.LayerNorm):
    def __init__(self, channels: int, eps: float = LN_EPS):
        super().__init__(channels, eps=eps)

    def forward(self, x):
        x, w, b = promote(x, self.weight, self.bias)
        return nn.functional.layer_norm(x, self.normalized_shape, w, b,
                                        self.eps)
