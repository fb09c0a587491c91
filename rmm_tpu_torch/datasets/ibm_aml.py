"""IBM Transactions for AML: the transaction CSV becomes the edges table
(3 categorical columns, 1 numerical, the timestamp) beside an id-only nodes
table (counterpart of ``rmm_tpu/datasets/ibm_aml.py``). Maskable columns
for pretraining: Amount Paid, then the three categoricals. ``ports`` adds
the ``in_port`` and ``out_port`` numerical columns."""
from __future__ import annotations

from typing import Optional, Sequence

from ..frame.stype import Stype
from .base import read_csv_columns
from .graph_dataset import EdgeTable, GraphTableDataset, NodeTable

AML_COLUMNS = [
    "Timestamp", "From Bank", "From ID", "To Bank", "To ID",
    "Amount Received", "Receiving Currency", "Amount Paid",
    "Payment Currency", "Payment Format", "Is Laundering",
]

AML_SCHEMA = {
    "Payment Currency": Stype.categorical,
    "Receiving Currency": Stype.categorical,
    "Payment Format": Stype.categorical,
    "Timestamp": Stype.timestamp,
    "Amount Paid": Stype.numerical,
}


class IBMTransactionsAML(GraphTableDataset):
    def __init__(self, root: str, split_type: str = "temporal_daily",
                 splits: Sequence[float] = (0.6, 0.2, 0.2),
                 khop_neighbors: Sequence[int] = (100, 100),
                 ego: bool = False, edge_capacity: int = 0,
                 node_capacity: int = 0, pretrain: Optional[set] = None,
                 ports: bool = False):
        columns = read_csv_columns(root)
        if list(columns)[:3] != AML_COLUMNS[:3]:
            # headerless-style exports: rename positionally
            columns = dict(zip(AML_COLUMNS, columns.values()))
        edges = EdgeTable(
            columns, AML_SCHEMA, src_col="From ID", dst_col="To ID",
            timestamp_col="Timestamp",
            supervised_col=None if pretrain else "Is Laundering",
            masked_numerical_columns=["Amount Paid"],
            masked_categorical_columns=[
                "Receiving Currency", "Payment Currency", "Payment Format"],
            pretrain=pretrain, split_type=split_type, splits=splits,
            khop_neighbors=khop_neighbors, ports=ports, cache_root=root)
        nodes = NodeTable.synthetic(edges.graph.num_nodes - 1, ego=ego)
        super().__init__(edges, nodes, edge_capacity, node_capacity)
