"""Datasets of the port: IBM AML and Rel-H&M (a CSV each), Ethereum
phishing, Elliptic, ogbn-arxiv, MUSAE GitHub and LastFM Asia (a nodes and
an edges CSV in a directory each) and their synthetic twins; the raw-data
tools ``prepare_aml`` and ``export_eth``."""
from .base import PretrainType, parse_pretrain_args  # noqa: F401
from .elliptic import EllipticBitcoin  # noqa: F401
from .eth_phishing import EthereumPhishing  # noqa: F401
from .graph_dataset import EdgeTable, GraphTableDataset, NodeTable  # noqa: F401
from .ibm_aml import IBMTransactionsAML  # noqa: F401
from .lastfm_asia import LastFMAsia  # noqa: F401
from .musae_github import MusaeGitHub  # noqa: F401
from .ogbn_arxiv import OgbnArxiv  # noqa: F401
from .rel_hm import RelHM  # noqa: F401
from .synthetic import (synthetic_aml_frame, write_synthetic_aml_csv,  # noqa: F401
                        write_synthetic_hm_csv, write_synthetic_node_dataset)


def build_dataset(cfg) -> GraphTableDataset:
    """Dataset dispatch by path substring (``rmm_tpu/datasets/
    __init__.py``), in its order: ``ethereum-phishing`` (the
    ``temporal_daily`` edge split), ``elliptic``, ``ogbn`` (the
    ``temporal`` split), ``musae``, ``lastfm``, Rel-H&M (``hm`` with ``rel``
    or ``h-and-m``); any other path is IBM AML. AML, Ethereum phishing and
    Rel-H&M take the pretraining targets of ``cfg.pretrain`` (the SSL
    CLI's); an ``mcm`` task without them takes the masked-cell and link
    targets. ``--ports`` and ``--ego`` reach every dataset."""
    pretrain = parse_pretrain_args(cfg.pretrain)
    if "mcm" in cfg.task and not pretrain:
        pretrain = {PretrainType.MASK, PretrainType.LINK_PRED}
    common = dict(khop_neighbors=tuple(cfg.num_neighs), ports=cfg.ports,
                  ego=cfg.ego, edge_capacity=cfg.edge_capacity,
                  node_capacity=cfg.node_capacity, pretrain=pretrain)
    data = cfg.data
    if "ethereum-phishing" in data:
        return EthereumPhishing(root=data, split_type="temporal_daily",
                                **common)
    if "elliptic" in data:
        return EllipticBitcoin(root=data, **common)
    if "ogbn" in data:
        return OgbnArxiv(root=data, split_type="temporal", **common)
    if "musae" in data:
        return MusaeGitHub(root=data, **common)
    if "lastfm" in data:
        return LastFMAsia(root=data, **common)
    if "hm" in data and ("rel" in data or "h-and-m" in data):
        return RelHM(root=data, **common)
    return IBMTransactionsAML(root=data, split_type=cfg.split_type,
                              splits=tuple(cfg.splits), **common)
