"""MUSAE GitHub (counterpart of ``rmm_tpu/datasets/musae_github.py``): a
node per developer with its feature columns and the binary ``ml_target``,
an edge per mutual follow; a random split.

``nodes.csv``: the feature columns, ``id``, ``name`` (not a feature),
``ml_target``; ``edges.csv``: ``id_1``, ``id_2``.
"""
from __future__ import annotations

import os
from typing import Sequence

from .base import read_csv_columns
from .node_family import (
    FeatureNodeTable,
    NodeClassificationDataset,
    SimpleEdgeTable,
)


class MusaeGitHub(NodeClassificationDataset):
    def __init__(self, root: str, split_type: str = "random",
                 splits: Sequence[float] = (0.6, 0.2, 0.2),
                 khop_neighbors: Sequence[int] = (100, 100),
                 ports: bool = False, ego: bool = False, pretrain=None,
                 edge_capacity: int = 0, node_capacity: int = 0):
        nodes = read_csv_columns(os.path.join(root, "nodes.csv"),
                                 text_columns=("id", "name", "ml_target"))
        edges = read_csv_columns(os.path.join(root, "edges.csv"))
        node_table = FeatureNodeTable(
            nodes, label_col="ml_target", id_col="id",
            exclude=("index", "name"), split_type=split_type, splits=splits,
            timestamp_col=None, pretrain=pretrain, ego=ego)
        edge_table = SimpleEdgeTable(
            edges, "id_1", "id_2", ports=ports,
            khop_neighbors=khop_neighbors, num_nodes=len(nodes["id"]))
        super().__init__(edge_table, node_table, edge_capacity,
                         node_capacity, n_classes=2)
