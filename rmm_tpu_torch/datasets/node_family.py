"""Node-classification families (counterpart of
``rmm_tpu/datasets/node_family.py``): a feature-rich nodes table whose
every column but the id and the label is a numerical token, beside an edges
table with one dummy attribute; batches are node-seeded k-hop samples.

Supervised only: the pretraining targets (``pretrain``), port numbering
(``--ports``) and ego ids (``--ego``) of these families are not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..frame.dataset import Dataset
from ..frame.stype import Stype
from ..graph.store import GraphStore
from .base import apply_split
from .graph_dataset import GraphTableDataset, NodeTable


def _refuse(pretrain=None, ports: bool = False, ego: bool = False):
    if pretrain:
        raise NotImplementedError(
            "pretraining targets of the node-classification families are "
            "not ported yet")
    for flag, value in (("--ports", ports), ("--ego", ego)):
        if value:
            raise NotImplementedError(
                f"{flag} is not ported for the node-classification "
                "families yet")


class FeatureNodeTable(NodeTable):
    """The nodes table: every column but ``label_col``, ``id_col`` and
    ``exclude`` numerical, the packed target ``[label, id]`` (float32) and
    a ``split`` column (``split_type`` over ``timestamp_col``, or random
    where there is none)."""

    def __init__(self, columns: dict[str, np.ndarray], label_col: str,
                 id_col: str, exclude: Sequence[str] = (),
                 split_type: str = "temporal",
                 splits: Sequence[float] = (0.6, 0.2, 0.2),
                 timestamp_col: Optional[str] = None,
                 pretrain: Optional[set] = None, ego: bool = False):
        _refuse(pretrain, ego=ego)
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
        super().__init__(columns, col_to_stype, split_col="split",
                         target_col="target")


class SimpleEdgeTable(Dataset):
    """The edges table: one numerical ``edge_attr`` of 1.0 a row, and the
    one graph of all edges that every sampling mode shares (node
    classification has no edge split)."""

    def __init__(self, columns: dict[str, np.ndarray], src_col: str,
                 dst_col: str, khop_neighbors: Sequence[int] = (100, 100),
                 num_nodes: Optional[int] = None, ports: bool = False):
        _refuse(ports=ports)
        self.masked_numerical_columns: list[str] = []
        self.masked_categorical_columns: list[str] = []
        src = np.asarray(columns[src_col], np.int64)
        dst = np.asarray(columns[dst_col], np.int64)
        self.graph = GraphStore(src, dst, split=None, fanouts=khop_neighbors,
                                num_nodes=num_nodes)
        columns = dict(columns)
        columns["edge_attr"] = np.ones(len(src))
        super().__init__(columns, {"edge_attr": Stype.numerical})


class NodeClassificationDataset(GraphTableDataset):
    """``ignore_label`` marks a class left out of the loss and the metrics
    (Elliptic's "unknown"); ``n_classes`` sizes the head."""

    def __init__(self, edges: SimpleEdgeTable, nodes: FeatureNodeTable,
                 edge_capacity: int = 0, node_capacity: int = 0,
                 ignore_label: Optional[int] = None, n_classes: int = 2):
        super().__init__(edges, nodes, edge_capacity, node_capacity)
        self.ignore_label = ignore_label
        self.n_classes = n_classes
