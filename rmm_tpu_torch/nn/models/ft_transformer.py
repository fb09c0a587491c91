"""FTTransformer (``rmm_tpu/nn/models/ft_transformer.py``): the column
transformer backbone over encoded column tokens, as ``backbone``."""
from __future__ import annotations

import torch
from torch import nn

from ..transformer import FTTransformerConvs


class FTTransformer(nn.Module):
    def __init__(self, channels: int, num_layers: int, nhead: int = 8,
                 dropout: float = 0.2):
        super().__init__()
        self.backbone = FTTransformerConvs(channels, num_layers, nhead,
                                           dropout)

    def forward(self, x: torch.Tensor):
        """x: [B, num_cols, C] → (x [B, num_cols, C], x_cls [B, C])."""
        return self.backbone(x)
