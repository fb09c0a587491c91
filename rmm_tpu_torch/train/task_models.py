"""Task wrappers: encoders + backbone + classifier head as one module
(``rmm_tpu/train/task_models.py``: ``gather_rows``, ``apply_ego``, ``TT``,
``GNNWrap``, ``TABGNNS``, ``TABGNNFusedS``).

A wrapper takes the device-resident edge and node tables and a
:class:`~rmm_tpu_torch.utils.batch.GraphBatch` of ids and masks on the same
device, gathers the batch's rows there and runs encode → backbone → head.
Seed edges occupy lanes ``[0, B)``; the head reads that block. Under
``node_classification`` every wrapper's head reads the seed nodes, node
lanes ``[0, B)``, through a ``NodeClassificationHead`` as wide as the node
states. The fused wrapper message-passes over the edge lanes ``[B:)`` only
and fuses the block ``[0, B)`` as its targets, on a node-seeded batch too
(whatever edges the sampler put there), as the reference does.

Under ``mcm_edge_table`` (masked-cell modeling of the seed edges' masked
cells) a wrapper's head is an ``MCMHead`` over each seed edge's
``[x_src, x_dst, edge state]``: ``w = 3`` states wide, or ``num_edge_cols
+ 2`` for the column-wise ``cpna`` and ``cpnatab``, whose edge state is one
a column. → (num_out [B, n_num], cat_out: list of [B, K_i]).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..frame.stype import Stype
from ..frame.tensor_frame import TensorFrame
from ..nn.decoders import ClassifierHead, MCMHead, NodeClassificationHead
from ..nn.encoders import (
    EmbeddingEncoder,
    LinearEmbeddingEncoder,
    LinearEncoder,
    LinearModelEncoder,
    ProjectionEncoder,
    StypeWiseFeatureEncoder,
    TimestampEncoder,
)
from ..nn.gnn.conv import gather
from ..nn.gnn.models import CPNA, CPNATAB, PNAS, GINe
from ..nn.models.fused import TABGNNFused
from ..nn.models.ft_transformer import FTTransformer
from ..nn.models.interleaved import TABGNNInterleaved
from ..nn.models.tabgnn import TABGNN
from ..nn.norms import MaskedBatchNorm
from ..nn.text import Embed, LoRADense, TextToEmbeddingFinetune
from ..nn.transformer import CLSToken, MultiHeadSelfAttention
from ..utils.batch import GraphBatch


def gather_rows(tf: TensorFrame, ids: torch.Tensor) -> TensorFrame:
    """Row gather on a device-resident TensorFrame."""
    return TensorFrame(
        feats={st: v.index_select(0, ids) for st, v in tf.feats.items()},
        col_names=tf.col_names)


def apply_ego(tf: TensorFrame, seed_edge_index: torch.Tensor, num_nodes: int,
              col_name: str = "ego", seed_mask=None) -> TensorFrame:
    """Overwrite the ``ego`` relation column with a seed-incidence flag: a
    scatter-max of ``seed_mask`` over the seed edges' endpoints, so padded
    seed lanes (copies of the last real row) never mark a node."""
    names = list(tf.col_names.get(Stype.relation, []))
    if col_name not in names:
        return tf
    rel = tf.feats[Stype.relation]
    ends = seed_edge_index.reshape(-1)
    if seed_mask is None:
        vals = torch.ones(ends.shape[0], dtype=rel.dtype, device=rel.device)
    else:
        vals = seed_mask.to(rel.dtype)[None, :].expand(
            seed_edge_index.shape).reshape(-1)
    flags = torch.zeros(num_nodes, dtype=rel.dtype, device=rel.device)
    flags = flags.scatter_reduce(0, ends, vals, "amax")
    rel = rel.clone()
    rel[:, names.index(col_name)] = flags
    return TensorFrame(feats={**tf.feats, Stype.relation: rel},
                       col_names=tf.col_names, y=tf.y)


def _deghist_to_avg_log(deg_histogram) -> float:
    hist = np.asarray(deg_histogram, dtype=np.float64)
    d = np.arange(len(hist))
    return float((hist * np.log(d + 1)).sum() / max(hist.sum(), 1.0))


def _refuse_task(model: str, task: str, tasks: tuple):
    if task not in tasks:
        raise NotImplementedError(
            f"task {task!r} is not ported yet for model {model!r}")


def _mcm_target(x: torch.Tensor, target_ei: torch.Tensor,
                target_attr: torch.Tensor) -> torch.Tensor:
    """The MCM head's input for each seed edge: ``[x_src, x_dst, edge
    state]``, a wide edge state flattened."""
    return torch.cat([gather(x, target_ei[0]), gather(x, target_ei[1]),
                      target_attr.reshape(target_attr.shape[0], -1)],
                     dim=-1)


def _encode(wrapper: nn.Module, edge_table: TensorFrame,
            node_table: TensorFrame, batch: GraphBatch):
    """The batch's node and edge tokens (the ``ego`` column marked where
    the wrapper asks for it)."""
    node_tf = gather_rows(node_table, batch.node_gather)
    if wrapper.ego:
        b = batch.num_seeds
        node_tf = apply_ego(node_tf, batch.edge_index[:, :b],
                            batch.node_gather.shape[0],
                            seed_mask=batch.seed_mask)
    return (wrapper.node_encoder(node_tf),
            wrapper.edge_encoder(gather_rows(edge_table, batch.edge_gather)))


class TT(nn.Module):
    """Tabular-only classifier (model ``fttransformer``): one shared
    ``FTTransformer``. Edge classification runs it over the node tokens and
    over the edge tokens, and the classifier reads the nodes' and the seed
    edges' CLS states; node classification runs it over the node tokens
    alone (the reference builds no edge encoder then) and reads the seed
    nodes' CLS states. Like the reference it never marks the ``ego``
    column and has no ``mcm_edge_table`` branch."""

    TASKS = ("edge_classification", "node_classification")

    def __init__(self, node_encoder: StypeWiseFeatureEncoder,
                 edge_encoder: StypeWiseFeatureEncoder, channels: int,
                 num_layers: int, n_classes: int = 2, dropout: float = 0.1,
                 task: str = "edge_classification", ego: bool = False):
        super().__init__()
        _refuse_task("fttransformer", task, self.TASKS)
        self.task = task
        self.node_encoder = node_encoder
        self.model = FTTransformer(channels, num_layers, dropout=dropout)
        if task == "node_classification":
            self.decoder = NodeClassificationHead(n_classes, channels,
                                                  dropout)
        else:
            self.edge_encoder = edge_encoder
            self.decoder = ClassifierHead(n_classes, channels, channels,
                                          dropout)

    def forward(self, edge_table: TensorFrame, node_table: TensorFrame,
                batch: GraphBatch) -> torch.Tensor:
        b = batch.num_seeds
        x_tok = self.node_encoder(gather_rows(node_table, batch.node_gather))
        _, x_cls = self.model(x_tok)
        if self.task == "node_classification":
            return self.decoder(x_cls[:b])
        e_tok = self.edge_encoder(gather_rows(edge_table, batch.edge_gather))
        _, e_cls = self.model(e_tok)
        return self.decoder(x_cls, batch.edge_index[:, :b], e_cls[:b])


class GNNWrap(nn.Module):
    """Pure-GNN edge or node classifier or masked-cell model (models
    ``gin``, ``pna``, ``cpna``, ``cpnatab``). ``cpna`` and ``cpnatab`` keep
    one edge state per column, so the edge classifier reads
    ``num_edge_cols · n_hidden`` edge features. Their node states are
    ``n_hidden`` wide, and so is the node classifier's input: the
    reference declares ``num_edge_cols · n_hidden`` for it, but its dense
    layers take their width from the input. Their edge updates are
    ``emlps``'s, as the reference passes them."""

    MODELS = ("gin", "pna", "cpna", "cpnatab")
    TASKS = ("edge_classification", "node_classification",
             "mcm_edge_table")

    def __init__(self, node_encoder: StypeWiseFeatureEncoder,
                 edge_encoder: StypeWiseFeatureEncoder, model_name: str,
                 n_hidden: int, n_gnn_layers: int, num_edge_cols: int,
                 n_classes: int = 2, dropout: float = 0.1,
                 avg_log_deg: float = 1.0, reverse_mp: bool = False,
                 emlps: bool = False, ego: bool = False,
                 task: str = "edge_classification",
                 mcm_num_numerical: int = 0, mcm_categorical=()):
        super().__init__()
        if model_name not in self.MODELS:
            raise ValueError(model_name)
        _refuse_task(model_name, task, self.TASKS)
        self.ego = ego
        self.task = task
        self.node_encoder = node_encoder
        self.edge_encoder = edge_encoder
        # the encoders' tokens are n_hidden wide
        cols = (node_encoder.num_cols, edge_encoder.num_cols, n_hidden)
        edge_width = n_hidden
        if model_name == "gin":
            self.model = GINe(*cols, n_hidden, n_gnn_layers, emlps,
                              reverse_mp)
        elif model_name == "pna":
            self.model = PNAS(*cols, n_hidden, n_gnn_layers, avg_log_deg,
                              emlps, reverse_mp)
        else:
            cls = CPNA if model_name == "cpna" else CPNATAB
            self.model = cls(node_encoder.num_cols, n_hidden, n_hidden,
                             n_gnn_layers, num_edge_cols, avg_log_deg, emlps,
                             reverse_mp)
            edge_width = num_edge_cols * n_hidden
        if task == "mcm_edge_table":
            self.decoder = MCMHead(n_hidden, mcm_num_numerical,
                                   mcm_categorical,
                                   w=2 + edge_width // n_hidden)
        elif task == "node_classification":
            self.decoder = NodeClassificationHead(n_classes, n_hidden,
                                                  dropout)
        else:
            self.decoder = ClassifierHead(n_classes, n_hidden, edge_width,
                                          dropout)

    def forward(self, edge_table: TensorFrame, node_table: TensorFrame,
                batch: GraphBatch):
        b = batch.num_seeds
        x_tok, e_tok = _encode(self, edge_table, node_table, batch)
        x, edge_attr = self.model(x_tok, batch.edge_index, e_tok,
                                  batch.edge_mask, batch.node_mask)
        if self.task == "node_classification":
            return self.decoder(x[:b])
        if self.task == "mcm_edge_table":
            return self.decoder(_mcm_target(x, batch.edge_index[:, :b],
                                            edge_attr[:b]))
        return self.decoder(x, batch.edge_index[:, :b], edge_attr[:b])


class TABGNNS(nn.Module):
    """Hybrid tabular + GNN classifier (models ``tabgnn`` and
    ``tabgnninterleaved``) of the seed edges (``edge_classification``) or
    of the seed nodes (``node_classification``), or the masked-cell model
    of the seed edges (``mcm_edge_table``)."""

    TASKS = ("edge_classification", "node_classification",
             "mcm_edge_table")
    MODELS = ("tabgnn", "tabgnninterleaved")

    def __init__(self, node_encoder: StypeWiseFeatureEncoder,
                 edge_encoder: StypeWiseFeatureEncoder, channels: int,
                 n_gnn_layers: int, n_classes: int = 2, dropout: float = 0.1,
                 avg_log_deg: float = 1.0, reverse_mp: bool = False,
                 ego: bool = False, task: str = "edge_classification",
                 model_name: str = "tabgnn", mcm_num_numerical: int = 0,
                 mcm_categorical=()):
        super().__init__()
        if model_name not in self.MODELS:
            raise ValueError(model_name)
        _refuse_task(model_name, task, self.TASKS)
        self.ego = ego
        self.task = task
        self.node_encoder = node_encoder
        self.edge_encoder = edge_encoder
        if model_name == "tabgnn":
            self.model = TABGNN(channels, n_gnn_layers,
                                node_encoder.num_cols, edge_encoder.num_cols,
                                nhidden=channels, avg_log_deg=avg_log_deg,
                                reverse_mp=reverse_mp, dropout=dropout)
        else:
            self.model = TABGNNInterleaved(
                channels, n_gnn_layers,
                node_dim=node_encoder.num_cols * channels, nhidden=channels,
                avg_log_deg=avg_log_deg, reverse_mp=reverse_mp,
                dropout=dropout)
        if task == "node_classification":
            self.decoder = NodeClassificationHead(n_classes, channels,
                                                  dropout)
        elif task == "mcm_edge_table":
            self.decoder = MCMHead(channels, mcm_num_numerical,
                                   mcm_categorical, w=3)
        else:
            self.decoder = ClassifierHead(n_classes, channels, channels,
                                          dropout)

    def forward(self, edge_table: TensorFrame, node_table: TensorFrame,
                batch: GraphBatch):
        """→ logits [B, n_classes] for the seed edges (or nodes), or the
        MCM outputs."""
        b = batch.num_seeds
        x_tok, e_tok = _encode(self, edge_table, node_table, batch)
        x, edge_attr = self.model(x_tok, batch.edge_index, e_tok,
                                  batch.edge_mask, batch.node_mask)
        if self.task == "node_classification":
            return self.decoder(x[:b])
        if self.task == "mcm_edge_table":
            return self.decoder(_mcm_target(x, batch.edge_index[:, :b],
                                            edge_attr[:b]))
        return self.decoder(x, batch.edge_index[:, :b], edge_attr[:b])


class TABGNNFusedS(nn.Module):
    """The fused model as an edge or node classifier or masked-cell model
    (model ``tabgnnfused``): the node tokens flattened to ``node_dim =
    S_n·C`` into ``TABGNNFused``, whose targets are the edges of lanes
    ``[0, B)``; the edge head reads the nodes and the targets' embeddings,
    the node head the node lanes ``[0, B)``."""

    TASKS = ("edge_classification", "node_classification",
             "mcm_edge_table")

    def __init__(self, node_encoder: StypeWiseFeatureEncoder,
                 edge_encoder: StypeWiseFeatureEncoder, channels: int,
                 n_gnn_layers: int, n_classes: int = 2, dropout: float = 0.1,
                 avg_log_deg: float = 1.0, reverse_mp: bool = False,
                 ego: bool = False, task: str = "edge_classification",
                 mcm_num_numerical: int = 0, mcm_categorical=()):
        super().__init__()
        _refuse_task("tabgnnfused", task, self.TASKS)
        self.ego = ego
        self.task = task
        self.node_encoder = node_encoder
        self.edge_encoder = edge_encoder
        self.model = TABGNNFused(
            channels, n_gnn_layers, edge_encoder.num_cols,
            node_dim=node_encoder.num_cols * channels, nhidden=channels,
            avg_log_deg=avg_log_deg, reverse_mp=reverse_mp, dropout=dropout)
        if task == "mcm_edge_table":
            self.decoder = MCMHead(channels, mcm_num_numerical,
                                   mcm_categorical, w=3)
        elif task == "node_classification":
            self.decoder = NodeClassificationHead(n_classes, channels,
                                                  dropout)
        else:
            self.decoder = ClassifierHead(n_classes, channels, channels,
                                          dropout)

    def forward(self, edge_table: TensorFrame, node_table: TensorFrame,
                batch: GraphBatch):
        """→ logits [B, n_classes] for the seed edges (or nodes), or the
        MCM outputs."""
        b = batch.num_seeds
        x_tok, e_tok = _encode(self, edge_table, node_table, batch)
        target_ei = batch.edge_index[:, :b]
        x, _, target = self.model(
            x_tok.reshape(x_tok.shape[0], -1), batch.edge_index[:, b:],
            e_tok[b:], target_ei, e_tok[:b], False, batch.edge_mask[b:],
            batch.node_mask)
        if self.task == "node_classification":
            return self.decoder(x[:b])
        if self.task == "mcm_edge_table":
            return self.decoder(_mcm_target(x, target_ei, target))
        return self.decoder(x, target_ei, target)


#: flax's ``lecun_normal``: a standard normal truncated at ±2 has standard
#: deviation 0.87962566, which the draw divides out
TRUNC_NORMAL_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` (``variance_scaling(1, "fan_in",
    "truncated_normal")``) in place: a normal truncated at ±2, times
    ``1 / (0.87962566 · √fan_in)``, so the variance is ``1 / fan_in``."""
    draw = torch.empty(t.shape)
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        return t.copy_(draw / (TRUNC_NORMAL_STD * math.sqrt(fan_in)))


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Seeded initialization after the JAX modules' initializers: dense and
    attention kernels lecun-normal, biases zero, norms one/zero, encoder
    weights normal(0.1), the CLS token normal(0.01); of the text modules
    the text encoders' weights ``[n, in, C]`` lecun-normal at fan-in
    ``n · in`` (flax's for a 3-D kernel), token embeddings normal with
    std ``1/√features`` (flax's ``Embed``), positional embeddings and LoRA
    ``A`` normal(0.02), LoRA ``B`` zero."""
    g = torch.Generator().manual_seed(int(seed))

    def normal(t, std):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=g) * std)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, mod.in_features, g)
                mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, MaskedBatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, MultiHeadSelfAttention):
                c = mod.out_kernel.shape[0]
                lecun_normal_(mod.qkv_kernel, c, g)
                lecun_normal_(mod.out_kernel, c, g)
                mod.qkv_bias.zero_()
                mod.out_bias.zero_()
            elif isinstance(mod, EmbeddingEncoder):
                for p in mod.parameters():
                    normal(p, 0.1)
            elif isinstance(mod, (LinearEncoder, TimestampEncoder,
                                  ProjectionEncoder)):
                normal(mod.weight, 0.1)
                mod.bias.zero_()
            elif isinstance(mod, CLSToken):
                normal(mod.cls, 0.01)
            elif isinstance(mod, (LinearEmbeddingEncoder,
                                  LinearModelEncoder)):
                n, fan_in, _ = mod.weight.shape
                lecun_normal_(mod.weight, n * fan_in, g)
                mod.bias.zero_()
            elif isinstance(mod, Embed):
                normal(mod.embedding, mod.embedding.shape[1] ** -0.5)
            elif isinstance(mod, TextToEmbeddingFinetune):
                normal(mod.pos_emb, 0.02)
            elif isinstance(mod, LoRADense):
                lecun_normal_(mod.weight, mod.weight.shape[1], g)
                mod.bias.zero_()
                if mod.rank > 0:
                    normal(mod.lora_a, 0.02)
                    mod.lora_b.zero_()
    return model
