"""TABGNNFused: per layer, column attention over the target edges' tokens
fused with PNA message passing, and a scatter-mean pooling of the fused
embeddings back into the node states (``rmm_tpu/nn/models/fused.py``).

The reference's parenthesization is kept, asymmetric where it is (in the
fused layer's tabular update the LayerNorm term alone is halved):

  top-level target path:  t ← LN(conv(CLS∥t))
  top-level edge path:    e ← (e + LN(conv(CLS∥e))) / 2
  layer tabular:          x_tab ← x_tab + LN(conv(x_tab)) / 2
  layer node:             x ← (x + relu(BN(conv))) / 2
  layer edge:             ea ← (ea + EMLP([xs, xd, ea])) / 2
  fuse (not LP):          z = [cls, x_s, x_d]; z ← (z + LN(fuse(z))) / 2;
                          cls ← (cls + z[:, :C]) / 2;
                          x_gnn[touched] ← (x_gnn + mean-pool) / 2

Every ``TransformerEncoderLayer`` attends through
:func:`~rmm_tpu_torch.ops.column_attention.fused_column_attention`, the CUDA
kernels on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops.segment import scatter_mean_update
from ..dropout import GeneratorDropout
from ..gnn.conv import EdgeUpdateMLP, PNAConv, PNAConvHetero, gather
from ..layers import Dense, LayerNorm
from ..norms import MaskedBatchNorm
from ..transformer import CLSToken, TransformerEncoderLayer


class FuseMLP(nn.Module):
    """LN → Linear(d→4d) LeakyReLU Dropout → Linear(4d→4d) LeakyReLU
    Dropout → Linear(4d→d)."""

    def __init__(self, dim: int, dropout: float = 0.5):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fc1 = Dense(dim, 4 * dim)
        self.fc2 = Dense(4 * dim, 4 * dim)
        self.fc3 = Dense(4 * dim, dim)
        self.drop = GeneratorDropout(dropout)

    def forward(self, z):
        h = self.drop(nn.functional.leaky_relu(self.fc1(self.norm(z))))
        h = self.drop(nn.functional.leaky_relu(self.fc2(h)))
        return self.fc3(h)


class FTTransformerPNAFusedLayer(nn.Module):
    def __init__(self, channels: int, nhidden: int = 128,
                 avg_log_deg: float = 1.0, reverse_mp: bool = False,
                 nhead: int = 8, dropout: float = 0.5,
                 feedforward_channels: Optional[int] = None):
        super().__init__()
        self.channels, self.nhidden = channels, nhidden
        self.tab_conv = TransformerEncoderLayer(channels, nhead,
                                                feedforward_channels, dropout)
        self.tab_norm = LayerNorm(channels)
        conv = PNAConvHetero if reverse_mp else PNAConv
        self.gnn_conv = conv(nhidden, avg_log_deg)
        self.gnn_norm = MaskedBatchNorm(nhidden)
        self.gnn_edge_update = EdgeUpdateMLP(nhidden)
        fused_dim = channels + 2 * nhidden
        self.fuse = FuseMLP(fused_dim, dropout)
        self.fuse_norm = LayerNorm(fused_dim)

    def forward(self, x_tab, x_gnn, edge_index, edge_attr, target_edge_index,
                lp: bool = False, edge_mask=None, node_mask=None):
        c, nh = self.channels, self.nhidden
        x_tab = x_tab + self.tab_norm(self.tab_conv(x_tab)) / 2.0
        x_cls, x_feat = x_tab[:, 0, :], x_tab[:, 1:, :]

        h = self.gnn_conv(x_gnn, edge_index, edge_attr, edge_mask)
        h = self.gnn_norm(h, node_mask)
        x_gnn = (x_gnn + torch.relu(h)) / 2.0
        upd = self.gnn_edge_update(x_gnn, edge_index, edge_attr)
        edge_attr = (edge_attr + upd) / 2.0

        if not lp:
            src, dst = target_edge_index[0], target_edge_index[1]
            z = torch.cat([x_cls, gather(x_gnn, src), gather(x_gnn, dst)],
                          dim=-1)
            z = (z + self.fuse_norm(self.fuse(z))) / 2.0
            x_cls = (x_cls + z[:, :c]) / 2.0
            x_tab = torch.cat([x_cls[:, None, :], x_feat], dim=1)
            x_gnn = scatter_mean_update(
                x_gnn, torch.cat([src, dst]),
                torch.cat([z[:, c:c + nh], z[:, c + nh:]], dim=0))
        return x_tab, x_gnn, edge_attr


class TABGNNFused(nn.Module):
    """``edge_cols``: feature columns of the edge table (the CLS token makes
    ``S = edge_cols + 1``); it sizes ``edge_emb``."""

    def __init__(self, channels: int, num_layers: int, edge_cols: int,
                 node_dim: int = 1, nhidden: int = 128,
                 avg_log_deg: float = 1.0, reverse_mp: bool = False,
                 nhead: int = 8, dropout: float = 0.5,
                 feedforward_channels: Optional[int] = None):
        super().__init__()
        self.num_layers = num_layers
        self.node_emb = Dense(node_dim, nhidden)
        self.cls_embedding = CLSToken(channels)
        self.tab_conv = TransformerEncoderLayer(channels, nhead,
                                                feedforward_channels, dropout)
        self.tab_norm = LayerNorm(channels)
        self.edge_emb = Dense((edge_cols + 1) * channels, nhidden)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", FTTransformerPNAFusedLayer(
                channels, nhidden, avg_log_deg, reverse_mp, nhead, dropout,
                feedforward_channels))

    def forward(self, x, edge_index, edge_attr, target_edge_index,
                target_edge_attr, lp: bool = False, edge_mask=None,
                node_mask=None):
        """x: [V, node_dim] node features; edge_attr: [E, n_cols, C]
        neighbour-edge tokens; target_edge_attr: [T, n_cols, C] → (x_gnn
        [V, nhidden], edge_attr [E, nhidden], target_edge_attr
        [T, nhidden])."""
        x_gnn = self.node_emb(x.reshape(x.shape[0], -1))
        target = self.cls_embedding(target_edge_attr)
        target = self.tab_norm(self.tab_conv(target))
        edge_attr = self.cls_embedding(edge_attr)
        edge_attr = (edge_attr + self.tab_norm(self.tab_conv(edge_attr))) / 2.0
        edge_attr = self.edge_emb(edge_attr.reshape(edge_attr.shape[0], -1))

        x_tab = target
        for i in range(self.num_layers):
            x_tab, x_gnn, edge_attr = getattr(self, f"layer_{i}")(
                x_tab, x_gnn, edge_index, edge_attr, target_edge_index, lp,
                edge_mask, node_mask)
        target = (x_tab + target) / 2.0
        target = self.edge_emb(target.reshape(target.shape[0], -1))
        return x_gnn, edge_attr, target
