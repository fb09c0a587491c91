"""LastFM Asia (counterpart of ``rmm_tpu/datasets/lastfm_asia.py``): a
node per user with its feature columns and its country (``target``, 18
classes), an edge per friendship; a random split.

``nodes.csv``: the feature columns, ``id``, ``target``; ``edges.csv``:
``node_1``, ``node_2``.
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


class LastFMAsia(NodeClassificationDataset):
    def __init__(self, root: str, split_type: str = "random",
                 splits: Sequence[float] = (0.6, 0.2, 0.2),
                 khop_neighbors: Sequence[int] = (100, 100),
                 ports: bool = False, ego: bool = False, pretrain=None,
                 edge_capacity: int = 0, node_capacity: int = 0,
                 n_classes: int = 18):
        nodes = read_csv_columns(os.path.join(root, "nodes.csv"),
                                 text_columns=("id", "target"))
        edges = read_csv_columns(os.path.join(root, "edges.csv"))
        node_table = FeatureNodeTable(
            nodes, label_col="target", id_col="id", exclude=("index",),
            split_type=split_type, splits=splits, timestamp_col=None,
            pretrain=pretrain, ego=ego)
        edge_table = SimpleEdgeTable(
            edges, "node_1", "node_2", ports=ports,
            khop_neighbors=khop_neighbors, num_nodes=len(nodes["id"]))
        super().__init__(edge_table, node_table, edge_capacity,
                         node_capacity, n_classes=n_classes)
