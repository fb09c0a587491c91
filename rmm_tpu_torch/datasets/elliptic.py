"""Elliptic Bitcoin transactions (counterpart of
``rmm_tpu/datasets/elliptic.py``): a node per transaction with its feature
columns (the first, "1", the time step), an edge per payment flow.

Classes are remapped as the reference's loader does ("2", licit, → 0;
"1", illicit, stays 1; "unknown" → 2, left out of the loss and the
metrics), transaction ids to contiguous node ids (an edge naming an id
that is not a node is dropped), and the nodes split in time order on the
time step.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .base import read_csv_columns
from .node_family import (
    FeatureNodeTable,
    NodeClassificationDataset,
    SimpleEdgeTable,
)


class EllipticBitcoin(NodeClassificationDataset):
    def __init__(self, root: str, split_type: str = "temporal",
                 splits: Sequence[float] = (0.6, 0.2, 0.2),
                 khop_neighbors: Sequence[int] = (100, 100),
                 ports: bool = False, ego: bool = False,
                 pretrain=None, edge_capacity: int = 0,
                 node_capacity: int = 0):
        nodes = read_csv_columns(os.path.join(root, "nodes.csv"),
                                 text_columns=("txId", "class"))
        edges = read_csv_columns(os.path.join(root, "edges.csv"))

        cls = np.asarray(nodes["class"]).astype(str)
        nodes["class"] = np.where(
            cls == "2", "0", np.where(cls == "unknown", "2", cls)).astype(
                np.int64)

        ids = np.asarray(nodes["txId"]).tolist()
        remap = {v: i for i, v in enumerate(ids)}
        nodes["txId"] = np.arange(len(ids), dtype=np.int64)
        ends = [np.array([remap.get(v, -1) for v in
                          np.asarray(edges[c]).tolist()], dtype=np.int64)
                for c in ("txId1", "txId2")]
        known = (ends[0] >= 0) & (ends[1] >= 0)
        edges = {"txId1": ends[0][known], "txId2": ends[1][known]}

        # the time step: the column named "1" (the reference's loader's)
        names = list(nodes)
        ts_col = "1" if "1" in nodes else (names[2] if len(names) > 2
                                           else None)
        node_table = FeatureNodeTable(
            nodes, label_col="class", id_col="txId", exclude=("index",),
            split_type=split_type, splits=splits, timestamp_col=ts_col,
            pretrain=pretrain, ego=ego)
        edge_table = SimpleEdgeTable(
            edges, "txId1", "txId2", khop_neighbors=khop_neighbors,
            num_nodes=len(ids), ports=ports)
        super().__init__(edge_table, node_table, edge_capacity,
                         node_capacity, ignore_label=2, n_classes=2)
