"""Synthetic datasets (numpy only): IBM-AML-shaped transactions and the
node-classification families (Elliptic, ogbn-arxiv, MUSAE GitHub, LastFM
Asia, Ethereum phishing).

Same generators as ``rmm_tpu/datasets/synthetic.py``
(``synthetic_aml_frame``, ``write_synthetic_node_dataset``): the same
``RandomState`` stream, draw for draw, so a seed gives the same tables in
both packages. A table is an ordered ``dict`` of numpy columns in the
CSV's column order.
"""
from __future__ import annotations

import os

import numpy as np

from .base import write_csv_columns


def synthetic_aml_frame(num_rows: int = 2000, num_accounts: int = 300,
                        num_days: int = 10, fraud_rate: float = 0.1,
                        seed: int = 0) -> dict[str, np.ndarray]:
    """AML-shaped transactions with a planted fraud signal (large amounts,
    a currency pair and a small ring of accounts)."""
    rng = np.random.RandomState(seed)
    n = num_rows
    is_fraud = rng.rand(n) < fraud_rate
    ring = rng.choice(num_accounts, size=max(num_accounts // 20, 2),
                      replace=False)

    from_id = rng.randint(0, num_accounts, n)
    to_id = rng.randint(0, num_accounts, n)
    from_id[is_fraud] = rng.choice(ring, is_fraud.sum())
    to_id[is_fraud] = rng.choice(ring, is_fraud.sum())
    amount = np.where(is_fraud, rng.lognormal(6, 1, n), rng.lognormal(3, 1, n))
    currencies = np.array(["USD", "EUR", "GBP", "BTC"])
    pay_cur = currencies[rng.randint(0, 4, n)]
    pay_cur[is_fraud & (rng.rand(n) < 0.7)] = "BTC"
    formats = np.array(["Wire", "ACH", "Cheque", "Card", "Bitcoin"])
    fmt = formats[rng.randint(0, 5, n)]
    fmt[is_fraud & (rng.rand(n) < 0.6)] = "Bitcoin"

    # draw order matters: Timestamp, From Bank, To Bank, then Receiving
    # Currency (the JAX generator's dict literal)
    timestamp = rng.randint(0, num_days * 86400, n).astype(np.int64)
    from_bank = rng.randint(0, 10, n)
    to_bank = rng.randint(0, 10, n)
    recv_cur = currencies[rng.randint(0, 4, n)]
    return {
        "Timestamp": timestamp,
        "From Bank": from_bank,
        "From ID": from_id.astype(np.float64),
        "To Bank": to_bank,
        "To ID": to_id.astype(np.float64),
        "Amount Received": amount,
        "Receiving Currency": recv_cur.astype(object),
        "Amount Paid": amount,
        "Payment Currency": pay_cur.astype(object),
        "Payment Format": fmt.astype(object),
        "Is Laundering": is_fraud.astype(int).astype(str).astype(object),
    }


def write_synthetic_aml_csv(path: str, **kw) -> str:
    write_csv_columns(path, synthetic_aml_frame(**kw))
    return path


def _planted_edges(rng, n_nodes: int, n_edges: int, labels: np.ndarray):
    """Edges with homophily, so node labels are learnable from structure:
    70% of the edges draw their destination among the nodes of the
    source's label. The draws of the JAX generator, in its order; the
    candidates of each label are listed once (the JAX generator lists them
    anew for each edge, which takes minutes at Elliptic's size)."""
    src = rng.randint(0, n_nodes, n_edges)
    dst = rng.randint(0, n_nodes, n_edges)
    same = rng.rand(n_edges) < 0.7
    by_label = {int(v): np.nonzero(labels == v)[0] for v in np.unique(labels)}
    for i in np.nonzero(same)[0]:
        cands = by_label[int(labels[src[i]])]
        dst[i] = cands[rng.randint(len(cands))]
    return src, dst


def write_synthetic_node_dataset(root: str, family: str = "elliptic",
                                 num_nodes: int = 300, num_edges: int = 900,
                                 num_feats: int = 8, n_classes: int = 4,
                                 seed: int = 0) -> str:
    """``<root>/nodes.csv`` and ``<root>/edges.csv`` in a family's schema,
    the labels drawn in ``[0, n_classes)``, the features a normal draw
    shifted by 0.8 · label and 70% of the edges within a label:

    * ``elliptic``: ``txId`` (not contiguous), ``class`` ("1", "2" by label
      parity, 20% "unknown"), the feature columns "1".."F" with "1" the
      time step (an integer in [1, 50), independent of the label); edges
      ``txId1``, ``txId2``;
    * ``musae``: ``f0``..``f{F-1}``, ``id``, ``name``, ``ml_target`` (the
      label's parity); edges ``id_1``, ``id_2``;
    * ``lastfm``: the features, ``id``, ``target``; edges ``node_1``,
      ``node_2``;
    * ``eth``: ``node``, ``label`` (the label's parity),
      ``first_transaction`` (seconds in 30 days); edges ``from_address``,
      ``to_address``, ``nonce``, ``value``, ``gas``, ``gas_price``,
      ``block_timestamp`` (no feature column is written);
    * any other name (``ogbn``): the features, ``id``, ``label``, ``year``
      (2010-2019); edges ``src``, ``dst``."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, num_nodes)
    feats = rng.randn(num_nodes, num_feats) + labels[:, None] * 0.8
    src, dst = _planted_edges(rng, num_nodes, num_edges, labels)
    ids = np.arange(num_nodes)

    def features() -> dict:
        return {f"f{i}": feats[:, i] for i in range(num_feats)}

    if family == "elliptic":
        feats[:, 0] = rng.randint(1, 50, num_nodes).astype(np.float32)
        tx = ids * 7 + 3
        cls = np.where(labels % 2 == 0, "1", "2").astype(object)
        cls[rng.rand(num_nodes) < 0.2] = "unknown"
        nodes = {"txId": tx, "class": cls}
        nodes.update((str(i + 1), feats[:, i]) for i in range(num_feats))
        edges = {"txId1": tx[src], "txId2": tx[dst]}
    elif family == "musae":
        nodes = {**features(), "id": ids,
                 "name": np.array([f"dev{i}" for i in ids], dtype=object),
                 "ml_target": labels % 2}
        edges = {"id_1": src, "id_2": dst}
    elif family == "lastfm":
        nodes = {**features(), "id": ids, "target": labels}
        edges = {"node_1": src, "node_2": dst}
    elif family == "eth":
        nodes = {"node": ids, "label": labels % 2,
                 "first_transaction": rng.randint(0, 30 * 86400, num_nodes)}
        # draw order: the edge columns left to right
        edges = {"from_address": src, "to_address": dst}
        edges["nonce"] = rng.randint(0, 100, num_edges).astype(float)
        edges["value"] = rng.lognormal(0, 1, num_edges)
        edges["gas"] = rng.lognormal(1, 0.3, num_edges)
        edges["gas_price"] = rng.lognormal(2, 0.5, num_edges)
        edges["block_timestamp"] = rng.randint(0, 30 * 86400, num_edges)
    else:
        nodes = {**features(), "id": ids, "label": labels,
                 "year": rng.randint(2010, 2020, num_nodes)}
        edges = {"src": src, "dst": dst}
    write_csv_columns(os.path.join(root, "nodes.csv"), nodes)
    write_csv_columns(os.path.join(root, "edges.csv"), edges)
    return root


#: the categorical columns of the synthetic Rel-H&M, in the CSV's order
HM_CATEGORIES = {
    "postal_code": [f"pc{i}" for i in range(10)],
    "product_type_name": ["Trousers", "Dress", "Sweater", "T-shirt"],
    "product_group_name": ["Garment Lower body", "Garment Upper body"],
    "graphical_appearance_name": ["Solid", "Stripe", "Print"],
    "colour_group_name": ["Black", "White", "Blue", "Red"],
    "perceived_colour_value_name": ["Dark", "Light", "Medium"],
    "perceived_colour_master_name": ["Black", "White", "Blue"],
    "department_name": ["Jersey", "Knitwear", "Trouser"],
    "index_name": ["Ladieswear", "Menswear", "Divided"],
    "index_group_name": ["Ladieswear", "Menswear"],
    "section_name": ["Womens Everyday", "Mens Basics"],
    "garment_group_name": ["Jersey Fancy", "Knitwear"],
}


def write_synthetic_hm_csv(path: str, num_rows: int = 800,
                           num_customers: int = 80, num_articles: int = 40,
                           seed: int = 0) -> str:
    """H&M-shaped transactions joined with article columns
    (``rmm_tpu/datasets/synthetic.py::write_synthetic_hm_csv``): ``t_dat``
    seconds over 20 days, customer ids ``[0, num_customers)``, article ids
    after them, a ``price`` in [0, 1) and the 12 categorical columns."""
    rng = np.random.RandomState(seed)
    n = num_rows
    columns = {
        "t_dat": rng.randint(0, 20 * 86400, n).astype(np.int64),
        "customer_id": rng.randint(0, num_customers, n),
        "article_id": num_customers + rng.randint(0, num_articles, n),
        "price": rng.rand(n)}
    columns.update((k, rng.choice(v, n)) for k, v in HM_CATEGORIES.items())
    write_csv_columns(path, columns)
    return path
