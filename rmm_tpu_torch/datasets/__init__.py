"""Datasets of the port: IBM AML (CSV), Elliptic (a nodes and an edges
CSV in a directory) and their synthetic twins."""
from .base import PretrainType, parse_pretrain_args  # noqa: F401
from .elliptic import EllipticBitcoin  # noqa: F401
from .graph_dataset import EdgeTable, GraphTableDataset, NodeTable  # noqa: F401
from .ibm_aml import IBMTransactionsAML  # noqa: F401
from .synthetic import (synthetic_aml_frame, write_synthetic_aml_csv,  # noqa: F401
                        write_synthetic_node_dataset)


def build_dataset(cfg) -> GraphTableDataset:
    """Dataset dispatch by path (``rmm_tpu/datasets/__init__.py``): a path
    naming ``elliptic`` is the Elliptic directory (supervised node
    classification), any other IBM AML, supervised or with the pretraining
    targets of ``cfg.pretrain`` (the SSL CLI's); an ``mcm`` task without
    them takes the masked-cell and link targets."""
    for family in ("ethereum-phishing", "ogbn", "musae", "lastfm"):
        if family in cfg.data:
            raise NotImplementedError(
                f"dataset family {family!r} is not ported yet")
    pretrain = parse_pretrain_args(cfg.pretrain)
    if "mcm" in cfg.task and not pretrain:
        pretrain = {PretrainType.MASK, PretrainType.LINK_PRED}
    if cfg.ports:
        raise NotImplementedError("--ports is not ported yet")
    if "elliptic" in cfg.data:
        return EllipticBitcoin(
            root=cfg.data, khop_neighbors=tuple(cfg.num_neighs),
            ego=cfg.ego, pretrain=pretrain, edge_capacity=cfg.edge_capacity,
            node_capacity=cfg.node_capacity)
    return IBMTransactionsAML(
        root=cfg.data, split_type=cfg.split_type, splits=tuple(cfg.splits),
        khop_neighbors=tuple(cfg.num_neighs), ego=cfg.ego,
        edge_capacity=cfg.edge_capacity, node_capacity=cfg.node_capacity,
        pretrain=pretrain)
