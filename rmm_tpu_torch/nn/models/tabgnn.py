"""TABGNN: column transformer over node and edge tokens → PNA message
passing (``rmm_tpu/nn/models/tabgnn.py``).

  tabular layer:   x ← (x + LN(encoder(x))) / 2   (one layer, shared by the
                   node and the edge tokens)
  stack residual:  x ← (x_in + x_stack) / 2
  PNA layer:       x ← (x + relu(BN(conv))) / 2,  ea ← ea + EMLP(...) / 2
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..gnn.conv import EdgeUpdateMLP, PNAConv, PNAConvHetero
from ..layers import Dense
from ..norms import MaskedBatchNorm
from ..transformer import CLSToken, FTTransformerLayer


class PNALayer(nn.Module):
    def __init__(self, nhidden: int = 128, avg_log_deg: float = 1.0,
                 reverse_mp: bool = False):
        super().__init__()
        conv = PNAConvHetero if reverse_mp else PNAConv
        self.gnn_conv = conv(nhidden, avg_log_deg)
        self.gnn_norm = MaskedBatchNorm(nhidden)
        self.gnn_edge_update = EdgeUpdateMLP(nhidden)

    def forward(self, x, edge_index, edge_attr, edge_mask=None,
                node_mask=None):
        h = self.gnn_conv(x, edge_index, edge_attr, edge_mask)
        h = self.gnn_norm(h, node_mask)
        x = (x + torch.relu(h)) / 2.0
        edge_attr = edge_attr + self.gnn_edge_update(
            x, edge_index, edge_attr) / 2.0
        return x, edge_attr


class TABGNN(nn.Module):
    """``node_cols``/``edge_cols``: feature columns per table (the CLS token
    makes ``S = cols + 1``); they size the flatten+project layers."""

    def __init__(self, channels: int, num_layers: int, node_cols: int,
                 edge_cols: int, nhidden: int = 128,
                 avg_log_deg: float = 1.0, reverse_mp: bool = False,
                 nhead: int = 8, dropout: float = 0.5,
                 feedforward_channels: Optional[int] = None):
        super().__init__()
        self.num_layers = num_layers
        self.cls_embedding = CLSToken(channels)
        for i in range(num_layers):
            self.add_module(f"tab_layer_{i}", FTTransformerLayer(
                channels, nhead, feedforward_channels, dropout))
        self.node_emb = Dense((node_cols + 1) * channels, nhidden)
        self.edge_emb = Dense((edge_cols + 1) * channels, nhidden)
        for i in range(num_layers):
            self.add_module(f"gnn_layer_{i}", PNALayer(
                nhidden, avg_log_deg, reverse_mp))

    def forward(self, x, edge_index, edge_attr, edge_mask=None,
                node_mask=None):
        """x: [V, n_node_cols, C]; edge_attr: [E, n_edge_cols, C] →
        (x [V, nhidden], edge_attr [E, nhidden])."""
        x = self.cls_embedding(x)
        edge_attr = self.cls_embedding(edge_attr)
        t_x, t_e = x, edge_attr
        for i in range(self.num_layers):
            layer = getattr(self, f"tab_layer_{i}")
            t_x = layer(t_x)
            t_e = layer(t_e)
        x = (x + t_x) / 2.0
        edge_attr = (edge_attr + t_e) / 2.0
        x = self.node_emb(x.reshape(x.shape[0], -1))
        edge_attr = self.edge_emb(edge_attr.reshape(edge_attr.shape[0], -1))
        for i in range(self.num_layers):
            x, edge_attr = getattr(self, f"gnn_layer_{i}")(
                x, edge_index, edge_attr, edge_mask, node_mask)
        return x, edge_attr
