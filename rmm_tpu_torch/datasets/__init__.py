"""Datasets of the serving slice: IBM AML (CSV) and its synthetic twin."""
from .graph_dataset import EdgeTable, GraphTableDataset, NodeTable  # noqa: F401
from .ibm_aml import IBMTransactionsAML  # noqa: F401
from .synthetic import synthetic_aml_frame, write_synthetic_aml_csv  # noqa: F401


def build_dataset(cfg) -> GraphTableDataset:
    """Dataset dispatch by path; this slice serves supervised IBM AML."""
    for family in ("ethereum-phishing", "elliptic", "ogbn", "musae",
                   "lastfm"):
        if family in cfg.data:
            raise NotImplementedError(
                f"dataset family {family!r} is not ported yet")
    if cfg.pretrain or "mcm" in cfg.task:
        raise NotImplementedError("pretraining targets are not ported yet")
    if cfg.ports:
        raise NotImplementedError("--ports is not ported yet")
    return IBMTransactionsAML(
        root=cfg.data, split_type=cfg.split_type, splits=tuple(cfg.splits),
        khop_neighbors=tuple(cfg.num_neighs), ego=cfg.ego,
        edge_capacity=cfg.edge_capacity, node_capacity=cfg.node_capacity)
