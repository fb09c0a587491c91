"""Task heads (``rmm_tpu/nn/decoders.py``): the supervised head off a CLS
state, the edge and node classifiers and the self-supervised heads (link
prediction, masked-cell modeling and the mask vector)."""
from __future__ import annotations

import torch
from torch import nn

from .dropout import GeneratorDropout
from .gnn.conv import gather
from .layers import Dense, LayerNorm


class SupervisedHead(nn.Module):
    """LayerNorm → ReLU → Linear off the CLS state (``norm``, ``lin``)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.norm = LayerNorm(channels)
        self.lin = Dense(channels, out_channels)

    def forward(self, x_cls: torch.Tensor) -> torch.Tensor:
        return self.lin(torch.relu(self.norm(x_cls)))


class _MLP50(nn.Module):
    """Linear(in→50) ReLU Dropout Linear(50→25) ReLU Dropout Linear(25→C)."""

    def __init__(self, in_features: int, n_classes: int,
                 dropout: float = 0.5):
        super().__init__()
        self.fc1 = Dense(in_features, 50)
        self.fc2 = Dense(50, 25)
        self.fc3 = Dense(25, n_classes)
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


class NodeClassificationHead(nn.Module):
    """Node classification: the seed nodes' states → MLP."""

    def __init__(self, n_classes: int, n_hidden: int, dropout: float = 0.5):
        super().__init__()
        self.mlp = _MLP50(n_hidden, n_classes, dropout)

    def forward(self, x):
        return self.mlp(x)


class _LPTrunk(nn.Module):
    """Linear(in→F) ReLU Dropout Linear(F→25) ReLU Dropout Linear(25→C),
    sigmoid."""

    def __init__(self, in_features: int, n_classes: int, n_hidden: int,
                 dropout: float):
        super().__init__()
        self.fc1 = Dense(in_features, n_hidden)
        self.fc2 = Dense(n_hidden, 25)
        self.fc3 = Dense(25, n_classes)
        self.drop = GeneratorDropout(dropout)

    def forward(self, h):
        h = self.drop(torch.relu(self.fc1(h)))
        h = self.drop(torch.relu(self.fc2(h)))
        return torch.sigmoid(self.fc3(h))


class LinkPredHead(nn.Module):
    """Link prediction on (pos, neg) edge sets: ``relu([x_src, x_dst]) ∥
    edge_attr`` → one shared trunk → probabilities ``[N, n_classes]``."""

    def __init__(self, n_classes: int = 1, n_hidden: int = 128,
                 edge_width: int = 128, dropout: float = 0.5):
        super().__init__()
        self.mlp = _LPTrunk(2 * n_hidden + edge_width, n_classes, n_hidden,
                            dropout)

    def forward(self, x, pos_edge_index, pos_edge_attr, neg_edge_index,
                neg_edge_attr):
        def feats(ei, ea):
            pair = torch.relu(torch.cat([gather(x, ei[0]), gather(x, ei[1])],
                                        dim=-1))
            return torch.cat([pair, ea.reshape(ea.shape[0], -1)], dim=-1)

        return (self.mlp(feats(pos_edge_index, pos_edge_attr)),
                self.mlp(feats(neg_edge_index, neg_edge_attr)))


class MCMHead(nn.Module):
    """Masked-cell modeling: one regressor for the numerical columns and
    one classifier a categorical column, each LayerNorm → ReLU → Linear
    over ``w · channels`` inputs. → (num_out [B, n_num], cat_out: list of
    [B, K_i])."""

    def __init__(self, channels: int, num_numerical: int,
                 num_categorical, w: int = 1):
        super().__init__()
        width = w * channels
        self.num_numerical = num_numerical
        self.num_categorical = list(num_categorical)
        self.num_norm = LayerNorm(width)
        self.num_lin = Dense(width, max(num_numerical, 1))
        for i, k in enumerate(self.num_categorical):
            self.add_module(f"cat_norm_{i}", LayerNorm(width))
            self.add_module(f"cat_lin_{i}", Dense(width, k))

    def forward(self, x):
        num_out = self.num_lin(torch.relu(self.num_norm(x)))
        cat_out = [getattr(self, f"cat_lin_{i}")(torch.relu(
            getattr(self, f"cat_norm_{i}")(x)))
            for i in range(len(self.num_categorical))]
        return num_out[:, :self.num_numerical], cat_out


class SelfSupervisedHead(nn.Module):
    """Masked-cell modeling off the CLS state: one :class:`MCMHead` of
    width ``channels`` (``mcm``). → (num_out, cat_out)."""

    def __init__(self, channels: int, num_numerical: int, num_categorical):
        super().__init__()
        self.mcm = MCMHead(channels, num_numerical, num_categorical, w=1)

    def forward(self, x_cls):
        return self.mcm(x_cls)


class MVHead(nn.Module):
    """Mask-vector head: LayerNorm → ReLU → Linear to one logit per
    maskable column (the numerical ones, then the categorical ones)."""

    def __init__(self, channels: int, num_numerical: int, num_categorical):
        super().__init__()
        self.norm = LayerNorm(channels)
        self.lin = Dense(channels, num_numerical + len(num_categorical))

    def forward(self, x_cls):
        return self.lin(torch.relu(self.norm(x_cls)))


class SelfSupervisedMVHead(nn.Module):
    """Masked-cell modeling and the mask vector off the CLS state
    (``mcm_decoder``, ``mask_vector_decoder``). → (num_out, cat_out,
    mv_out)."""

    def __init__(self, channels: int, num_numerical: int, num_categorical):
        super().__init__()
        self.mcm_decoder = SelfSupervisedHead(channels, num_numerical,
                                              num_categorical)
        self.mask_vector_decoder = MVHead(channels, num_numerical,
                                          num_categorical)

    def forward(self, x_cls):
        num_out, cat_out = self.mcm_decoder(x_cls)
        return num_out, cat_out, self.mask_vector_decoder(x_cls)
