"""Node-classification families (counterpart of
``rmm_tpu/datasets/node_family.py``): a feature-rich nodes table whose
every column but the id and the label is a numerical token, beside an edges
table with one dummy attribute (or the two port columns); batches are
node-seeded k-hop samples.

Supervised only: the pretraining targets (``pretrain``) of these families
are refused. No entry point reaches them (the JAX ``build_dataset`` passes
no ``pretrain`` to a node family); only a direct caller of
``FeatureNodeTable`` does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..frame.dataset import Dataset
from ..frame.stype import Stype
from ..graph.store import GraphStore
from .base import apply_split
from .graph_dataset import GraphTableDataset, NodeTable


class FeatureNodeTable(NodeTable):
    """The nodes table: every column but ``label_col``, ``id_col`` and
    ``exclude`` numerical, the packed target ``[label, id]`` (float32), a
    ``split`` column (``split_type`` over ``timestamp_col``, or random
    where there is none) and, under ``ego``, an ``EgoID`` relation column
    of zeros (the wrappers mark a column named ``ego`` alone, so it stays
    zero, as in the reference)."""

    def __init__(self, columns: dict[str, np.ndarray], label_col: str,
                 id_col: str, exclude: Sequence[str] = (),
                 split_type: str = "temporal",
                 splits: Sequence[float] = (0.6, 0.2, 0.2),
                 timestamp_col: Optional[str] = None,
                 pretrain: Optional[set] = None, ego: bool = False):
        if pretrain:
            raise NotImplementedError(
                "pretraining targets of the node-classification families "
                "are not ported: no entry point reaches them")
        columns = dict(columns)
        feat_cols = [c for c in columns
                     if c not in set(exclude) | {label_col, id_col}]
        col_to_stype = {c: Stype.numerical for c in feat_cols}
        if timestamp_col is not None and split_type != "none":
            columns = apply_split(columns, split_type, list(splits),
                                  timestamp_col)
        elif "split" not in columns:
            columns = apply_split(columns, "random", list(splits), None)
        columns["target"] = np.stack(
            [np.asarray(columns[label_col], np.float64),
             np.asarray(columns[id_col], np.float64)], axis=1)
        col_to_stype["target"] = Stype.relation
        if ego:
            columns["EgoID"] = np.zeros(len(columns["target"]))
            col_to_stype["EgoID"] = Stype.relation
        super().__init__(columns, col_to_stype, split_col="split",
                         target_col="target")


class SimpleEdgeTable(Dataset):
    """The edges table: one ``edge_attr`` of 1.0 a row or, under ``ports``,
    the ``in_port`` and ``out_port`` columns (``GraphStore.ports`` with
    every edge at time 0), all of ``attr_stype`` (numerical, or relation
    for ogbn-arxiv); and the one graph of all edges that every sampling
    mode shares (node classification has no edge split)."""

    def __init__(self, columns: dict[str, np.ndarray], src_col: str,
                 dst_col: str, attr_stype: Stype = Stype.numerical,
                 ports: bool = False,
                 khop_neighbors: Sequence[int] = (100, 100),
                 num_nodes: Optional[int] = None):
        self.masked_numerical_columns: list[str] = []
        self.masked_categorical_columns: list[str] = []
        src = np.asarray(columns[src_col], np.int64)
        dst = np.asarray(columns[dst_col], np.int64)
        self.graph = GraphStore(src, dst, split=None, fanouts=khop_neighbors,
                                num_nodes=num_nodes)
        columns = dict(columns)
        if ports:
            columns["in_port"], columns["out_port"] = self.graph.ports()
            col_to_stype = {"in_port": attr_stype, "out_port": attr_stype}
        else:
            columns["edge_attr"] = np.ones(len(src))
            col_to_stype = {"edge_attr": attr_stype}
        super().__init__(columns, col_to_stype)


class NodeClassificationDataset(GraphTableDataset):
    """``ignore_label`` marks a class left out of the loss and the metrics
    (Elliptic's "unknown"); ``n_classes`` sizes the head."""

    def __init__(self, edges: SimpleEdgeTable, nodes: FeatureNodeTable,
                 edge_capacity: int = 0, node_capacity: int = 0,
                 ignore_label: Optional[int] = None, n_classes: int = 2):
        super().__init__(edges, nodes, edge_capacity, node_capacity)
        self.ignore_label = ignore_label
        self.n_classes = n_classes
