"""ogbn-arxiv (counterpart of ``rmm_tpu/datasets/ogbn_arxiv.py``): a node
per paper with its feature columns and ``year`` (a feature too, and the
key of the temporal split), the packed target ``[label, id]``; an edge
per citation with a relation-typed dummy attribute; 40 classes.

``nodes.csv``: the feature columns, ``id``, ``label``, ``year``;
``edges.csv``: ``src``, ``dst``.
"""
from __future__ import annotations

import os
from typing import Sequence

from ..frame.stype import Stype
from .base import read_csv_columns
from .node_family import (
    FeatureNodeTable,
    NodeClassificationDataset,
    SimpleEdgeTable,
)


class OgbnArxiv(NodeClassificationDataset):
    def __init__(self, root: str, split_type: str = "temporal",
                 splits: Sequence[float] = (0.6, 0.2, 0.2),
                 khop_neighbors: Sequence[int] = (100, 100),
                 ports: bool = False, ego: bool = False, pretrain=None,
                 edge_capacity: int = 0, node_capacity: int = 0):
        nodes = read_csv_columns(os.path.join(root, "nodes.csv"),
                                 text_columns=("id", "label", "year"))
        edges = read_csv_columns(os.path.join(root, "edges.csv"))
        node_table = FeatureNodeTable(
            nodes, label_col="label", id_col="id", exclude=("index",),
            split_type=split_type, splits=splits, timestamp_col="year",
            pretrain=pretrain, ego=ego)
        edge_table = SimpleEdgeTable(
            edges, "src", "dst", attr_stype=Stype.relation, ports=ports,
            khop_neighbors=khop_neighbors, num_nodes=len(nodes["id"]))
        super().__init__(edge_table, node_table, edge_capacity,
                         node_capacity, n_classes=40)
