"""Column-attention transformer blocks for tabular token sequences
(counterparts of ``rmm_tpu/nn/transformer.py``).

:class:`MultiHeadSelfAttention` always goes through
:func:`~rmm_tpu_torch.ops.column_attention.fused_column_attention`, at every
head_dim: the CUDA kernel for CUDA tensors, its plain twin on the CPU. The
JAX package's gate (kernel off below head_dim 16 and off the TPU) was a TPU
workaround and does not carry over. LayerNorms use flax's epsilon (1e-6).
Dropout (the attention keep-mask and the elementwise dropouts) draws from
the generator that :func:`~rmm_tpu_torch.nn.dropout.set_generator` gives.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.column_attention import fused_column_attention
from .dropout import GeneratorDropout, keep_mask
from .layers import Dense, LayerNorm


class MultiHeadSelfAttention(nn.Module):
    """Self-attention over the column-token axis. Weights keep the kernel's
    (and the JAX module's) layout: ``qkv_kernel [C, 3C]``, ``out_kernel
    [C, C]``."""

    def __init__(self, channels: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        if channels % nhead:
            raise ValueError("channels must be divisible by nhead")
        self.nhead = nhead
        self.dropout = dropout
        self.qkv_kernel = nn.Parameter(torch.empty(channels, 3 * channels))
        self.qkv_bias = nn.Parameter(torch.empty(3 * channels))
        self.out_kernel = nn.Parameter(torch.empty(channels, channels))
        self.out_bias = nn.Parameter(torch.empty(channels))
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        mask = None
        if self.training and self.dropout > 0.0:
            mask = keep_mask((b, self.nhead, s, s), self.dropout,
                             self.generator, x.device)
        return fused_column_attention(
            x, self.qkv_kernel, self.qkv_bias, self.out_kernel,
            self.out_bias, self.nhead, drop_mask=mask,
            dropout_rate=self.dropout if mask is not None else 0.0)


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer (``torch.nn.TransformerEncoderLayer`` with
    ``norm_first=False``):
        x = norm1(x + dropout(attn(x)))
        x = norm2(x + dropout(linear2(dropout(act(linear1(x))))))"""

    def __init__(self, channels: int, nhead: int,
                 feedforward_channels: Optional[int] = None,
                 dropout: float = 0.5, activation: str = "relu"):
        super().__init__()
        ff = feedforward_channels or channels
        self.self_attn = MultiHeadSelfAttention(channels, nhead, dropout)
        self.norm1 = LayerNorm(channels)
        self.linear1 = Dense(channels, ff)
        self.linear2 = Dense(ff, channels)
        self.norm2 = LayerNorm(channels)
        self.drop = GeneratorDropout(dropout)
        self.act = {"relu": torch.relu,
                    "gelu": nn.functional.gelu}[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.drop(self.self_attn(x)))
        h = self.linear2(self.drop(self.act(self.linear1(x))))
        return self.norm2(x + self.drop(h))


class FTTransformerLayer(nn.Module):
    """Half-residual column-attention layer: ``(x + LN(encoder(x))) / 2``."""

    def __init__(self, channels: int, nhead: int = 8,
                 feedforward_channels: Optional[int] = None,
                 dropout: float = 0.5, activation: str = "relu"):
        super().__init__()
        self.tab_conv = TransformerEncoderLayer(
            channels, nhead, feedforward_channels, dropout, activation)
        self.tab_norm = LayerNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x + self.tab_norm(self.tab_conv(x))) / 2.0


class CLSToken(nn.Module):
    """Learned CLS embedding prepended to the column-token axis."""

    def __init__(self, channels: int):
        super().__init__()
        self.cls = nn.Parameter(torch.empty(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, S, C]
        tok = self.cls.expand(x.shape[0], 1, -1)
        return torch.cat([tok, x], dim=1)


class FTTransformerConvs(nn.Module):
    """Column-transformer backbone: prepend ``cls_token``, run the
    ``layer_i`` encoder layers, then ``final_norm``; returns the feature
    tokens and the CLS state: ``[B, S, C]`` → ``([B, S, C], [B, C])``."""

    def __init__(self, channels: int, num_layers: int, nhead: int = 8,
                 dropout: float = 0.2,
                 feedforward_channels: Optional[int] = None):
        super().__init__()
        self.num_layers = num_layers
        self.cls_token = CLSToken(channels)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                channels, nhead, feedforward_channels, dropout))
        self.final_norm = LayerNorm(channels)

    def forward(self, x: torch.Tensor):
        x = self.cls_token(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x)
        x = self.final_norm(x)
        return x[:, 1:], x[:, 0]
