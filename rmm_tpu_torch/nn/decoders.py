"""Task heads (``rmm_tpu/nn/decoders.py``): the edge classifier."""
from __future__ import annotations

import torch
from torch import nn

from .dropout import GeneratorDropout
from .gnn.conv import gather


class _MLP50(nn.Module):
    """Linear(in→50) ReLU Dropout Linear(50→25) ReLU Dropout Linear(25→C)."""

    def __init__(self, in_features: int, n_classes: int,
                 dropout: float = 0.5):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 50)
        self.fc2 = nn.Linear(50, 25)
        self.fc3 = nn.Linear(25, n_classes)
        self.drop = GeneratorDropout(dropout)

    def forward(self, x):
        x = self.drop(torch.relu(self.fc1(x)))
        x = self.drop(torch.relu(self.fc2(x)))
        return self.fc3(x)


class ClassifierHead(nn.Module):
    """Edge classification: ``relu([x_src, x_dst]) ∥ edge_attr`` → MLP (the
    ReLU applies to the node pair only)."""

    def __init__(self, n_classes: int, n_hidden: int, edge_width: int,
                 dropout: float = 0.5):
        super().__init__()
        self.mlp = _MLP50(2 * n_hidden + edge_width, n_classes, dropout)

    def forward(self, x, edge_index, edge_attr):
        pair = torch.cat([gather(x, edge_index[0]), gather(x, edge_index[1])],
                         dim=-1)
        h = torch.cat([torch.relu(pair),
                       edge_attr.reshape(edge_attr.shape[0], -1)], dim=-1)
        return self.mlp(h)
