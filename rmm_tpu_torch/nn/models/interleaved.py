"""TABGNNInterleaved (``rmm_tpu/nn/models/interleaved.py``): column
attention and PNA interleaved layer by layer through the edge CLS token.

Each layer runs column attention over the edge tokens, takes the CLS state
as the edge feature of a PNA conv and an edge update, and writes the
updated CLS back into the sequence. The reference's three updates differ
and are kept as they are:

  stem:        ea ← (ea + LN(conv(ea))) / 2
  in a layer:  ea ← ea + LN(conv(ea)) / 2
  CLS update:  cls ← (cls + EMLP(...)) / 2
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..gnn.conv import EdgeUpdateMLP, PNAConv, PNAConvHetero
from ..layers import Dense, LayerNorm
from ..norms import MaskedBatchNorm
from ..transformer import CLSToken, TransformerEncoderLayer


class FTTransformerPNAInterleavedLayer(nn.Module):
    def __init__(self, channels: int, nhidden: int = 128,
                 avg_log_deg: float = 1.0, reverse_mp: bool = False,
                 nhead: int = 8, dropout: float = 0.5,
                 feedforward_channels: Optional[int] = None):
        super().__init__()
        self.tab_conv = TransformerEncoderLayer(
            channels, nhead, feedforward_channels, dropout)
        self.tab_norm = LayerNorm(channels)
        conv = PNAConvHetero if reverse_mp else PNAConv
        self.gnn_conv = conv(nhidden, avg_log_deg)
        self.gnn_norm = MaskedBatchNorm(nhidden)
        self.gnn_edge_update = EdgeUpdateMLP(nhidden)

    def forward(self, x_gnn, edge_index, edge_attr, edge_mask=None,
                node_mask=None):
        edge_attr = edge_attr + self.tab_norm(self.tab_conv(edge_attr)) / 2.0
        ea_cls, ea_feat = edge_attr[:, 0, :], edge_attr[:, 1:, :]
        h = self.gnn_conv(x_gnn, edge_index, ea_cls, edge_mask)
        h = self.gnn_norm(h, node_mask)
        x_gnn = (x_gnn + torch.relu(h)) / 2.0
        upd = self.gnn_edge_update(x_gnn, edge_index, ea_cls)
        ea_cls = (ea_cls + upd) / 2.0
        return x_gnn, torch.cat([ea_cls[:, None, :], ea_feat], dim=1)


class TABGNNInterleaved(nn.Module):
    """``node_dim``: the flattened node features' width. Only
    ``channels == nhidden`` is supported, the one configuration the
    reference builds."""

    def __init__(self, channels: int, num_layers: int, node_dim: int = 1,
                 nhidden: int = 128, avg_log_deg: float = 1.0,
                 reverse_mp: bool = False, nhead: int = 8,
                 dropout: float = 0.5,
                 feedforward_channels: Optional[int] = None):
        super().__init__()
        assert channels == nhidden, \
            "interleaved model requires channels == nhidden"
        self.num_layers = num_layers
        self.node_emb = Dense(node_dim, nhidden)
        self.cls_embedding = CLSToken(channels)
        self.tab_conv = TransformerEncoderLayer(
            channels, nhead, feedforward_channels, dropout)
        self.tab_norm = LayerNorm(channels)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", FTTransformerPNAInterleavedLayer(
                channels, nhidden, avg_log_deg, reverse_mp, nhead, dropout,
                feedforward_channels))

    def forward(self, x, edge_index, edge_attr, edge_mask=None,
                node_mask=None):
        """x: [V, ...] node features (flattened to ``node_dim``);
        edge_attr: [E, n_cols, C] edge tokens → (x_gnn [V, nhidden],
        the final CLS state of each edge [E, C])."""
        x_gnn = self.node_emb(x.reshape(x.shape[0], -1))
        edge_attr = self.cls_embedding(edge_attr)
        edge_attr = (edge_attr + self.tab_norm(self.tab_conv(edge_attr))) / 2.0
        e_attr = edge_attr
        for i in range(self.num_layers):
            x_gnn, e_attr = getattr(self, f"layer_{i}")(
                x_gnn, edge_index, e_attr, edge_mask, node_mask)
        edge_attr = (e_attr + edge_attr) / 2.0
        return x_gnn, edge_attr[:, 0, :]
