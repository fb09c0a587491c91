"""Rel-H&M (counterpart of ``rmm_tpu/datasets/rel_hm.py``): H&M
transactions joined with their articles' columns, a customer → article
edge per transaction over one node id space; 12 categorical columns, the
``price`` and the ``t_dat`` timestamp (seconds), split ``temporal_daily``.
It has no supervised column: it pretrains on its masked cells (``price``,
``product_type_name``, ``department_name``,
``perceived_colour_value_name``) and its links, through ``cli/main.py
--task mcm_edge_table`` or the pretrainer.

Ids that are not numbers (the published customer ids are hex strings)
become codes over the sorted union of ``str(customer_id)`` and ``"a_" +
str(article_id)``, which is what the reference's pandas categories give.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..frame.stype import Stype
from .base import read_csv_columns, shared_node_ids
from .graph_dataset import EdgeTable, GraphTableDataset, NodeTable

HM_SCHEMA = {
    "t_dat": Stype.timestamp,
    "price": Stype.numerical,
    "postal_code": Stype.categorical,
    "product_type_name": Stype.categorical,
    "product_group_name": Stype.categorical,
    "graphical_appearance_name": Stype.categorical,
    "colour_group_name": Stype.categorical,
    "perceived_colour_value_name": Stype.categorical,
    "perceived_colour_master_name": Stype.categorical,
    "department_name": Stype.categorical,
    "index_name": Stype.categorical,
    "index_group_name": Stype.categorical,
    "section_name": Stype.categorical,
    "garment_group_name": Stype.categorical,
}
HM_MASKED_NUMERICAL = ["price"]
HM_MASKED_CATEGORICAL = ["product_type_name", "department_name",
                         "perceived_colour_value_name"]


class RelHM(GraphTableDataset):
    def __init__(self, root: str, pretrain: Optional[set] = None,
                 split_type: str = "temporal_daily",
                 splits: Sequence[float] = (0.6, 0.2, 0.2),
                 khop_neighbors: Sequence[int] = (100, 100),
                 ports: bool = False, ego: bool = False,
                 edge_capacity: int = 0, node_capacity: int = 0):
        if not pretrain:
            raise ValueError(
                "Rel-H&M has no supervised column: train it with --task "
                "mcm_edge_table or pretrain it (cli/fused.py's objectives)")
        columns = read_csv_columns(root)
        if columns["customer_id"].dtype.kind not in "iuf":
            columns["customer_id"], columns["article_id"] = shared_node_ids(
                columns["customer_id"], columns["article_id"])
        schema = {c: st for c, st in HM_SCHEMA.items() if c in columns}
        edges = EdgeTable(
            columns, schema, src_col="customer_id", dst_col="article_id",
            timestamp_col="t_dat", supervised_col=None,
            masked_numerical_columns=HM_MASKED_NUMERICAL,
            masked_categorical_columns=HM_MASKED_CATEGORICAL,
            pretrain=pretrain, split_type=split_type, splits=splits,
            khop_neighbors=khop_neighbors, ports=ports, cache_root=root)
        nodes = NodeTable.synthetic(edges.graph.num_nodes - 1, ego=ego)
        super().__init__(edges, nodes, edge_capacity, node_capacity)
