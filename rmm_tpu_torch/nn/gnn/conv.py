"""Message passing over padded subgraphs (``rmm_tpu/nn/gnn/conv.py``):
``PNAConv``, the bidirectional ``PNAConvHetero`` and ``EdgeUpdateMLP``.
Padded edge lanes never contribute (``edge_mask``).

Node rows are gathered per edge with :func:`gather`: every node has many
edges and every padded lane points at node 0, so the gather's backward has
to sum long runs of repeated indices, which ``F.embedding``'s backward
does by sorting (``x[idx]``'s backward walks each run in one thread).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.segment import pna_aggregate
from ..layers import Dense


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for a 2-D ``x`` and 1-D ``idx``."""
    return nn.functional.embedding(idx, x)


class PNAConv(nn.Module):
    """message  m_e = pre_nn([x_dst, x_src, edge_encoder(e)])
    aggregate    = [mean|min|max|std] × [id|amp|atten] → [N, 12F]
    update   out = lin(post_nn([x, agg]))"""

    def __init__(self, channels: int, avg_log_deg: float):
        super().__init__()
        f = channels
        self.avg_log_deg = float(avg_log_deg)
        self.edge_encoder = Dense(f, f)
        self.pre_nn = Dense(3 * f, f)
        self.post_nn = Dense(13 * f, f)
        self.lin = Dense(f, f)

    def forward(self, x, edge_index, edge_attr, edge_mask=None):
        src, dst = edge_index[0], edge_index[1]
        e = self.edge_encoder(edge_attr)
        h = torch.cat([gather(x, dst), gather(x, src), e], dim=-1)   # [E, 3F]
        m = self.pre_nn(h)
        agg = pna_aggregate(m, dst, x.shape[0], self.avg_log_deg, edge_mask)
        return self.lin(self.post_nn(torch.cat([x, agg], dim=-1)))


class PNAConvHetero(nn.Module):
    """Reverse message passing: a forward conv on (src→dst), a backward conv
    on flipped edges, merged by ``lin([x, a_in, a_out])``."""

    def __init__(self, channels: int, avg_log_deg: float):
        super().__init__()
        self.conv_forw = PNAConv(channels, avg_log_deg)
        self.conv_back = PNAConv(channels, avg_log_deg)
        self.lin = Dense(3 * channels, channels)

    def forward(self, x, edge_index, edge_attr, edge_mask=None):
        a_in = self.conv_forw(x, edge_index, edge_attr, edge_mask)
        a_out = self.conv_back(x, edge_index.flip(0), edge_attr, edge_mask)
        return self.lin(torch.cat([x, a_in, a_out], dim=-1))


class EdgeUpdateMLP(nn.Module):
    """Linear(3F→F) → ReLU → Linear(F→F) over [x_src, x_dst, edge_attr]."""

    def __init__(self, channels: int):
        super().__init__()
        self.lin1 = Dense(3 * channels, channels)
        self.lin2 = Dense(channels, channels)

    def forward(self, x, edge_index, edge_attr):
        src, dst = edge_index[0], edge_index[1]
        h = torch.cat([gather(x, src), gather(x, dst), edge_attr], dim=-1)
        return self.lin2(torch.relu(self.lin1(h)))
