"""Pure-GNN backbones (``rmm_tpu/nn/gnn/models.py``): ``GINe``, ``PNAS``,
``PNA``, ``CPNA`` and ``CPNATAB``.

  node update   x  ← (x + relu(BN(conv(x, e)))) / 2
  edge update   ea ← ea + EMLP([x_src, x_dst, ea]) / 2   (``emlps``)

``CPNA`` runs one conv chain per edge-table column over that column's
[E, F] block, the node states carried on from one column's chain to the
next; ``CPNATAB`` follows it with row attention over the columns.
"""
from __future__ import annotations

import torch
from torch import nn

from ..layers import Dense, LayerNorm
from ..norms import MaskedBatchNorm
from ..transformer import TransformerEncoderLayer
from .conv import (
    EdgeUpdateMLP,
    GINEConv,
    GINEConvHetero,
    PNAConv,
    PNAConvHetero,
)


def _make_conv(model: str, channels: int, avg_log_deg: float,
               reverse_mp: bool) -> nn.Module:
    if model == "pna":
        cls = PNAConvHetero if reverse_mp else PNAConv
        return cls(channels, avg_log_deg)
    if model == "gine":
        return (GINEConvHetero if reverse_mp else GINEConv)(channels)
    raise ValueError(model)


class _Stack(nn.Module):
    """``num_gnn_layers`` of (conv ``conv_{s}``, BatchNorm ``bn_{s}``,
    edge update ``emlp_{s}`` when ``edge_updates``), ``s`` the layer's
    suffix."""

    def _add_layers(self, conv: str, n_hidden: int, suffixes,
                    avg_log_deg: float, edge_updates: bool,
                    reverse_mp: bool):
        self.edge_updates = edge_updates
        for s in suffixes:
            self.add_module(f"conv_{s}", _make_conv(
                conv, n_hidden, avg_log_deg, reverse_mp))
            self.add_module(f"bn_{s}", MaskedBatchNorm(n_hidden))
            if edge_updates:
                self.add_module(f"emlp_{s}", EdgeUpdateMLP(n_hidden))

    def _layer(self, s, x, edge_index, edge_attr, edge_mask, node_mask):
        h = getattr(self, f"conv_{s}")(x, edge_index, edge_attr, edge_mask)
        h = getattr(self, f"bn_{s}")(h, node_mask)
        x = (x + torch.relu(h)) / 2.0
        if self.edge_updates:
            upd = getattr(self, f"emlp_{s}")(x, edge_index, edge_attr)
            edge_attr = edge_attr + upd / 2.0
        return x, edge_attr


class _FlatStack(_Stack):
    """A stack of ``conv`` layers over the flattened node and edge column
    embeddings: ``node_cols``/``edge_cols`` columns of ``channels``
    features each."""

    def __init__(self, conv: str, node_cols: int, edge_cols: int,
                 channels: int, n_hidden: int, num_gnn_layers: int,
                 avg_log_deg: float, edge_updates: bool, reverse_mp: bool):
        super().__init__()
        self.num_gnn_layers = num_gnn_layers
        self.node_emb = Dense(node_cols * channels, n_hidden)
        self.edge_emb = Dense(edge_cols * channels, n_hidden)
        self._add_layers(conv, n_hidden, range(num_gnn_layers), avg_log_deg,
                         edge_updates, reverse_mp)

    def forward(self, x, edge_index, edge_attr, edge_mask=None,
                node_mask=None):
        """x: [V, node_cols, C]; edge_attr: [E, edge_cols, C] →
        (x [V, n_hidden], edge_attr [E, n_hidden])."""
        x = self.node_emb(x.reshape(x.shape[0], -1))
        edge_attr = self.edge_emb(edge_attr.reshape(edge_attr.shape[0], -1))
        for i in range(self.num_gnn_layers):
            x, edge_attr = self._layer(i, x, edge_index, edge_attr,
                                       edge_mask, node_mask)
        return x, edge_attr


class GINe(_FlatStack):
    """GINE stack."""

    def __init__(self, node_cols: int, edge_cols: int, channels: int,
                 n_hidden: int = 100, num_gnn_layers: int = 2,
                 edge_updates: bool = False, reverse_mp: bool = False):
        super().__init__("gine", node_cols, edge_cols, channels, n_hidden,
                         num_gnn_layers, 0.0, edge_updates, reverse_mp)


class PNAS(_FlatStack):
    """PNA stack."""

    def __init__(self, node_cols: int, edge_cols: int, channels: int,
                 n_hidden: int = 128, num_gnn_layers: int = 2,
                 avg_log_deg: float = 1.0, edge_updates: bool = True,
                 reverse_mp: bool = False):
        super().__init__("pna", node_cols, edge_cols, channels, n_hidden,
                         num_gnn_layers, avg_log_deg, edge_updates,
                         reverse_mp)


class PNA(_Stack):
    """PNA stack that also projects a separate target-edge table with the
    edge embedding: x [V, node_in], edge_attr [E, edge_in] and
    target_edge_attr [T, edge_in] → (x, edge_attr, target_edge_attr)."""

    def __init__(self, node_in: int, edge_in: int, n_hidden: int = 128,
                 num_gnn_layers: int = 2, avg_log_deg: float = 1.0,
                 edge_updates: bool = True, reverse_mp: bool = False):
        super().__init__()
        self.num_gnn_layers = num_gnn_layers
        self.node_emb = Dense(node_in, n_hidden)
        self.edge_emb = Dense(edge_in, n_hidden)
        self._add_layers("pna", n_hidden, range(num_gnn_layers),
                         avg_log_deg, edge_updates, reverse_mp)

    def forward(self, x, edge_index, edge_attr, target_edge_attr,
                edge_mask=None, node_mask=None):
        x = self.node_emb(x)
        edge_attr = self.edge_emb(edge_attr)
        target_edge_attr = self.edge_emb(target_edge_attr)
        for i in range(self.num_gnn_layers):
            x, edge_attr = self._layer(i, x, edge_index, edge_attr,
                                       edge_mask, node_mask)
        return x, edge_attr, target_edge_attr


class CPNA(_Stack):
    """Column-wise PNA: for each edge-table column ``c`` in turn a chain of
    ``num_gnn_layers`` layers (``conv_{c}_{i}``, ``bn_{c}_{i}``,
    ``emlp_{c}_{i}``) over that column's [E, F] block. The node states run
    on through every column's chain (they are not reset for a column);
    each column's block comes out of its own chain."""

    def __init__(self, node_cols: int, channels: int, n_hidden: int = 128,
                 num_gnn_layers: int = 2, num_cols: int = 1,
                 avg_log_deg: float = 1.0, edge_updates: bool = True,
                 reverse_mp: bool = False):
        super().__init__()
        self.num_gnn_layers = num_gnn_layers
        self.num_cols = num_cols
        self.node_emb = Dense(node_cols * channels, n_hidden)
        self._add_layers("pna", n_hidden,
                         [f"{c}_{i}" for c in range(num_cols)
                          for i in range(num_gnn_layers)],
                         avg_log_deg, edge_updates, reverse_mp)

    def forward(self, x, edge_index, edge_attr, edge_mask=None,
                node_mask=None):
        """x: [V, node_cols, C]; edge_attr: [E, num_cols, F] → (x [V,
        n_hidden], edge_attr [E, num_cols, n_hidden])."""
        x = self.node_emb(x.reshape(x.shape[0], -1))
        cols = []
        for c in range(self.num_cols):
            col = edge_attr[:, c, :]
            for i in range(self.num_gnn_layers):
                x, col = self._layer(f"{c}_{i}", x, edge_index, col,
                                     edge_mask, node_mask)
            cols.append(col)
        return x, torch.stack(cols, dim=1)


class CPNATAB(nn.Module):
    """:class:`CPNA` (as ``cpna``), then ``num_gnn_layers`` row-attention
    layers over the column axis: ``ea ← (ea + row_norm_i(row_att_i(ea)))
    / 2``, 8 heads."""

    def __init__(self, node_cols: int, channels: int, n_hidden: int = 128,
                 num_gnn_layers: int = 2, num_cols: int = 1,
                 avg_log_deg: float = 1.0, edge_updates: bool = True,
                 reverse_mp: bool = False, dropout: float = 0.1):
        super().__init__()
        self.num_gnn_layers = num_gnn_layers
        self.cpna = CPNA(node_cols, channels, n_hidden, num_gnn_layers,
                         num_cols, avg_log_deg, edge_updates, reverse_mp)
        for i in range(num_gnn_layers):
            self.add_module(f"row_att_{i}", TransformerEncoderLayer(
                n_hidden, nhead=8, dropout=dropout))
            self.add_module(f"row_norm_{i}", LayerNorm(n_hidden))

    def forward(self, x, edge_index, edge_attr, edge_mask=None,
                node_mask=None):
        x, edge_attr = self.cpna(x, edge_index, edge_attr, edge_mask,
                                 node_mask)
        for i in range(self.num_gnn_layers):
            att = getattr(self, f"row_att_{i}")(edge_attr)
            edge_attr = (edge_attr
                         + getattr(self, f"row_norm_{i}")(att)) / 2.0
        return x, edge_attr
