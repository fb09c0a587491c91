"""Datasets of the port: IBM AML (CSV) and its synthetic twin."""
from .base import PretrainType, parse_pretrain_args  # noqa: F401
from .graph_dataset import EdgeTable, GraphTableDataset, NodeTable  # noqa: F401
from .ibm_aml import IBMTransactionsAML  # noqa: F401
from .synthetic import synthetic_aml_frame, write_synthetic_aml_csv  # noqa: F401


def build_dataset(cfg) -> GraphTableDataset:
    """Dataset dispatch by path: IBM AML, supervised or with the
    pretraining targets of ``cfg.pretrain`` (the SSL CLI's)."""
    for family in ("ethereum-phishing", "elliptic", "ogbn", "musae",
                   "lastfm"):
        if family in cfg.data:
            raise NotImplementedError(
                f"dataset family {family!r} is not ported yet")
    if "mcm" in cfg.task:
        raise NotImplementedError(f"task {cfg.task!r} is not ported yet")
    if cfg.ports:
        raise NotImplementedError("--ports is not ported yet")
    return IBMTransactionsAML(
        root=cfg.data, split_type=cfg.split_type, splits=tuple(cfg.splits),
        khop_neighbors=tuple(cfg.num_neighs), ego=cfg.ego,
        edge_capacity=cfg.edge_capacity, node_capacity=cfg.node_capacity,
        pretrain=parse_pretrain_args(cfg.pretrain))
