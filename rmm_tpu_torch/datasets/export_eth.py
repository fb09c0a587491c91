"""An Ethereum phishing transaction graph pickled by networkx (a
``MultiDiGraph``) → the ``nodes.csv`` and ``edges.csv`` that
``EthereumPhishing`` reads (``rmm_tpu/datasets/export_eth.py``), without
networkx:

    python -m rmm_tpu_torch.datasets.export_eth <graph.pkl> <out_dir>

The pickle is read by an unpickler that maps networkx's directed graph
classes to :class:`GraphState`, which keeps the graph's dicts, and its
cached view objects to an inert stand-in; any other class raises, by name
(unpickling can run code). Nodes are numbered in ``graph.nodes()`` order
and edges walked in ``edges(data=True)`` order: by source, then target,
then key, each in insertion order. An edge's time is its ``timestamp``
(else ``block_timestamp``, else 0), an account's first transaction its
earliest edge time (0 without one), its label ``isp`` (else ``label``,
else 0).
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np

from .base import write_csv_columns

#: networkx's directed graph classes, by their pickled name
GRAPH_CLASSES = {("networkx.classes.multidigraph", "MultiDiGraph"): True,
                 ("networkx.classes.digraph", "DiGraph"): False}
#: modules of networkx's view objects (cached in a graph's __dict__)
VIEW_MODULES = ("networkx.classes.reportviews", "networkx.classes.coreviews")
#: what else a pickle of such a graph refers to: old protocols' object
#: reconstruction, and numpy scalars (ids or attributes drawn by numpy)
SAFE = {("copyreg", "_reconstructor"), ("builtins", "object"),
        ("numpy", "dtype"), ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar")}


class GraphState:
    """A directed networkx graph's state: ``_node`` (node → attributes)
    and ``_succ`` (or ``_adj``): source → target → (key →) attributes."""

    multi = False

    # networkx caches its view objects in the graph's __dict__ under
    # ``nodes``, ``edges``, ...: these methods take other names

    def node_order(self) -> list:
        return list(self._node)

    def node_attrs(self, node) -> dict:
        return self._node[node]

    def edge_walk(self):
        """(source, target, attributes) in networkx's ``edges(data=True)``
        order."""
        succ = self.__dict__.get("_succ", self.__dict__.get("_adj"))
        for u, nbrs in succ.items():
            for v, data in nbrs.items():
                if self.multi:
                    for attrs in data.values():
                        yield u, v, attrs
                else:
                    yield u, v, data


class MultiGraphState(GraphState):
    multi = True


class _View:
    """An ignored networkx view object."""

    def __setstate__(self, state):
        pass


class GraphUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in GRAPH_CLASSES:
            return (MultiGraphState if GRAPH_CLASSES[module, name]
                    else GraphState)
        if module in VIEW_MODULES:
            return _View
        if (module, name) in SAFE:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"{module}.{name} is not a networkx directed graph part; "
            "refusing to unpickle it")


def load_graph(path: str) -> GraphState:
    with open(path, "rb") as f:
        graph = GraphUnpickler(f).load()
    if not isinstance(graph, GraphState):
        raise ValueError(f"{path} does not hold a networkx directed graph")
    return graph


def export_eth_graph(graph: GraphState, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    node_ids = {addr: i for i, addr in enumerate(graph.node_order())}
    first_tx: dict[int, float] = {}
    cols = {k: [] for k in ("from_address", "to_address", "nonce", "value",
                            "gas", "gas_price", "block_timestamp")}
    for u, v, data in graph.edge_walk():
        ui, vi = node_ids[u], node_ids[v]
        ts = float(data.get("timestamp", data.get("block_timestamp", 0)))
        for key, val in (
                ("from_address", ui), ("to_address", vi),
                ("nonce", float(data.get("nonce", 0))),
                ("value", float(data.get("amount", data.get("value", 0)))),
                ("gas", float(data.get("gas", 0))),
                ("gas_price", float(data.get("gas_price", 0))),
                ("block_timestamp", ts)):
            cols[key].append(val)
        for n in (ui, vi):
            if n not in first_tx or ts < first_tx[n]:
                first_tx[n] = ts
    write_csv_columns(os.path.join(out_dir, "edges.csv"), {
        k: np.asarray(v, np.int64 if k.endswith("address") else np.float64)
        for k, v in cols.items()})
    labels = []
    for addr in node_ids:
        attrs = graph.node_attrs(addr)
        labels.append(int(attrs.get("isp", attrs.get("label", 0))))
    write_csv_columns(os.path.join(out_dir, "nodes.csv"), {
        "node": np.arange(len(node_ids), dtype=np.int64),
        "label": np.asarray(labels, np.int64),
        "first_transaction": np.asarray(
            [first_tx.get(i, 0.0) for i in range(len(node_ids))],
            np.float64)})


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    export_eth_graph(load_graph(argv[0]), argv[1])
    print(f"exported {argv[1]}")


if __name__ == "__main__":
    main()
