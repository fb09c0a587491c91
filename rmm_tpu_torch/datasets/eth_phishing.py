"""Ethereum phishing transactions (counterpart of
``rmm_tpu/datasets/eth_phishing.py``): a node per account, an edge per
transaction.

``nodes.csv`` (``node``, ``label``, ``first_transaction``): the packed
target ``[label, node]``, one constant token (``node_attr`` = 1.0, or an
``EgoID`` column of zeros under ``ego``) and a split at the cut-offs, the
``first_transaction`` quantiles of the split ratios. ``edges.csv``
(``from_address``, ``to_address``, ``nonce``, ``value``, ``gas``,
``gas_price``, ``block_timestamp``): four numerical columns, all maskable
for MCM, and the timestamp; no label column; split by ``split_type``, or,
with ``use_cutoffs``, at the accounts' cut-offs (``cutoff_split``: an edge
before the first is train, after the second test, val between them).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..frame.stype import Stype
from .base import cutoff_split, read_csv_columns
from .graph_dataset import EdgeTable, NodeTable
from .node_family import NodeClassificationDataset

ETH_EDGE_SCHEMA = {
    "nonce": Stype.numerical,
    "value": Stype.numerical,
    "gas": Stype.numerical,
    "gas_price": Stype.numerical,
    "block_timestamp": Stype.timestamp,
}
ETH_MASKED = ["nonce", "value", "gas", "gas_price"]


class EthereumPhishingNodes(NodeTable):
    """The accounts. ``cutoffs`` are the sorted ``first_transaction``
    values at ranks ``max(int(n · splits[0]) − 1, 0)`` and ``max(int(n ·
    (splits[0] + splits[1])) − 1, 0)``; an account before the first is
    train, after the second test, and val otherwise (an account at either
    cut-off is val)."""

    def __init__(self, columns: dict[str, np.ndarray],
                 splits: Sequence[float] = (0.65, 0.15, 0.2),
                 ego: bool = False):
        columns = dict(columns)
        n = len(columns["node"])
        columns["target"] = np.stack(
            [np.asarray(columns["label"], np.float64),
             np.asarray(columns["node"], np.float64)], axis=1)
        ts = np.sort(np.asarray(columns["first_transaction"]))
        self.cutoffs = [ts[max(int(n * splits[0]) - 1, 0)],
                        ts[max(int(n * (splits[0] + splits[1])) - 1, 0)]]
        columns = cutoff_split(columns, self.cutoffs, "first_transaction")
        schema = {"target": Stype.relation}
        token = "EgoID" if ego else "node_attr"
        columns[token] = np.full(n, 0.0 if ego else 1.0)
        schema[token] = Stype.relation
        super().__init__(columns, schema, split_col="split",
                         target_col="target")


class EthereumPhishing(NodeClassificationDataset):
    def __init__(self, root: str, pretrain: Optional[set] = None,
                 split_type: str = "temporal_daily",
                 splits: Sequence[float] = (0.65, 0.15, 0.2),
                 khop_neighbors: Sequence[int] = (100, 100),
                 ports: bool = False, ego: bool = False,
                 use_cutoffs: bool = False,
                 edge_capacity: int = 0, node_capacity: int = 0):
        node_cols = read_csv_columns(os.path.join(root, "nodes.csv"))
        edge_cols = read_csv_columns(
            os.path.join(root, "edges.csv"),
            text_columns=("from_address", "to_address", "block_timestamp"))
        nodes = EthereumPhishingNodes(node_cols, splits=splits, ego=ego)
        edges = EdgeTable(
            edge_cols, ETH_EDGE_SCHEMA, src_col="from_address",
            dst_col="to_address", timestamp_col="block_timestamp",
            supervised_col=None, masked_numerical_columns=ETH_MASKED,
            masked_categorical_columns=[], pretrain=pretrain,
            split_type="cutoff" if use_cutoffs else split_type,
            splits=list(nodes.cutoffs) if use_cutoffs else list(splits),
            khop_neighbors=khop_neighbors, ports=ports,
            cache_root=os.path.join(root, "edges"))
        super().__init__(edges, nodes, edge_capacity, node_capacity,
                         n_classes=2)
