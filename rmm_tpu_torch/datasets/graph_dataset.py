"""Edges table + nodes table + sampler wiring
(``rmm_tpu/datasets/graph_dataset.py``): the supervised target and the
pretraining targets (masked cells, link prediction)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..frame.dataset import Dataset
from ..frame.stats import StatType
from ..frame.stype import Stype
from ..graph.sampler import group_by
from ..graph.store import GraphStore
from ..utils.batch import GraphBatch, graph_inputs, lp_inputs, node_inputs
from .base import (PretrainType, apply_split, blank_masked_cells,
                   build_mask_target, category_codes, create_mask,
                   pack_link_column, pack_target)


class EdgeTable(Dataset):
    """Transactions as edges: the split (``apply_split``'s types over
    ``timestamp_col``; under ``cutoff`` ``splits`` holds the cut-off
    times), per-split graphs and the packed target (``base.py``'s layouts;
    none for a table without a label that pretrains on nothing).
    ``pretrain`` ⊆ {MASK, LINK_PRED}; empty is supervised. Under MASK each
    row has one masked column (``create_mask``, cached next to
    ``cache_root``), whose cell is blanked before the column statistics
    are computed. ``ports`` adds the numerical columns ``in_port`` and
    ``out_port`` (``GraphStore.ports`` over the full graph in time
    order)."""

    def __init__(self, columns: dict[str, np.ndarray], col_to_stype: dict,
                 src_col: str, dst_col: str, timestamp_col: Optional[str],
                 supervised_col: Optional[str],
                 masked_numerical_columns: Sequence[str] = (),
                 masked_categorical_columns: Sequence[str] = (),
                 pretrain: Optional[set] = None,
                 split_type: str = "temporal_daily",
                 splits: Sequence[float] = (0.6, 0.2, 0.2),
                 khop_neighbors: Sequence[int] = (100, 100),
                 ports: bool = False, cache_root: Optional[str] = None):
        self.pretrain = set(pretrain or ())
        self.masked_numerical_columns = list(masked_numerical_columns)
        self.masked_categorical_columns = list(masked_categorical_columns)
        col_to_stype = dict(col_to_stype)
        columns = apply_split(dict(columns), split_type, list(splits),
                              timestamp_col)
        src = np.asarray(columns[src_col]).astype(np.int64)
        dst = np.asarray(columns[dst_col]).astype(np.int64)
        ts = (np.asarray(columns[timestamp_col]).astype(np.int64)
              if timestamp_col else None)
        self.graph = GraphStore(src, dst, split=columns["split"],
                                timestamps=ts, fanouts=khop_neighbors)
        if ports:
            columns["in_port"], columns["out_port"] = self.graph.ports()
            col_to_stype["in_port"] = Stype.numerical
            col_to_stype["out_port"] = Stype.numerical
        mask_target = None
        if PretrainType.MASK in self.pretrain:
            maskable = (self.masked_numerical_columns
                        + self.masked_categorical_columns)
            mask_col = create_mask(cache_root, len(src), maskable)
            cat_codes = {c: category_codes(columns[c])
                         for c in self.masked_categorical_columns}
            mask_target = build_mask_target(
                columns, mask_col, self.masked_numerical_columns,
                self.masked_categorical_columns, cat_codes)
            blank_masked_cells(columns, mask_col)
        supervised = (np.asarray(columns[supervised_col], np.float64)
                      if supervised_col else None)
        y = pack_target(self.pretrain, pack_link_column(src, dst),
                        mask_target, supervised)
        target_col = None
        if y is not None:
            columns["target"] = y
            target_col = "target"
            col_to_stype["target"] = Stype.relation
        super().__init__(columns, col_to_stype, split_col="split",
                         target_col=target_col)

    def masked_categorical_cardinalities(self) -> list[int]:
        """MCM head sizes: the category count of each masked categorical
        column, from the statistics of the blanked table."""
        out = []
        for c in self.masked_categorical_columns:
            if c in self.col_stats and StatType.COUNT in self.col_stats[c]:
                out.append(len(self.col_stats[c][StatType.COUNT][0]))
            else:
                out.append(0)
        return out


class NodeTable(Dataset):
    @staticmethod
    def synthetic(num_nodes: int, ego: bool = False) -> "NodeTable":
        """Id-only nodes table: a constant ``node_attr`` relation column (and
        an ``ego`` column the model overwrites per batch)."""
        n = num_nodes + 1
        columns = {"node_attr": np.ones(n)}
        schema = {"node_attr": Stype.relation}
        if ego:
            columns["ego"] = np.ones(n)
            schema["ego"] = Stype.relation
        return NodeTable(columns, schema)


class GraphTableDataset:
    """``.edges`` + ``.nodes`` + batch builders; capacities <= 0 are
    calibrated on first use."""

    def __init__(self, edges: EdgeTable, nodes: NodeTable,
                 edge_capacity: int = 0, node_capacity: int = 0,
                 frontier_capacity: int = 0):
        self.edges = edges
        self.nodes = nodes
        self.edge_capacity = edge_capacity
        self.node_capacity = node_capacity
        self.frontier_capacity = frontier_capacity
        edges.materialize()
        nodes.materialize()

    @property
    def graph(self) -> GraphStore:
        return self.edges.graph

    def calibrate_capacities(self, batch_size: int, n_probe: int = 4,
                             safety: float = 1.5) -> tuple[int, int]:
        """Size the static subgraph buffers from probe samples: ``n_probe``
        random seed batches per split (train and test, ``RandomState(0)``),
        the true sampled size (kept + dropped), times ``safety``, rounded up
        to a multiple of 256 below 1k and to a power of two above. The
        probes are seed edges for node tasks too, as the reference's are:
        a batch of B edges has up to 2·B end nodes, so the buffers hold a
        batch of B seed nodes. The device sampler's frontier buffer is
        sized the same way from :meth:`_frontier_need` (at least 256, at
        most the node capacity) and set as ``frontier_capacity``."""
        g = self.graph
        rng = np.random.RandomState(0)
        b = max(int(batch_size), 1)
        cap_e = cap_n = 1 << 16
        need_e = need_n = need_f = 1
        for mode in ("train", "test"):
            for p in range(n_probe):
                take = min(b, g.num_edges)
                if take == 0:
                    continue
                idx = rng.choice(g.num_edges, size=take, replace=False)
                seeds = np.stack([g.src[idx], g.dst[idx], idx], axis=1)
                while True:
                    try:
                        sub = g.sample_edges(seeds, mode, cap_e, cap_n,
                                             rng_seed=p + 1)
                    except RuntimeError:   # node capacity exceeded
                        cap_n *= 2
                        continue
                    if sub.num_dropped > 0:
                        cap_e = 2 * (sub.num_edges + sub.num_dropped)
                        continue
                    break
                need_e = max(need_e, sub.num_edges)
                need_n = max(need_n, sub.num_nodes)
                need_f = max(need_f, self._frontier_need(
                    mode, np.unique(seeds[:, :2])))

        def rnd(x):
            need = max(int(x * safety), 256)
            if need <= 1024:
                return -(-need // 256) * 256
            return 1 << (need - 1).bit_length()

        self.edge_capacity = max(rnd(need_e), b)
        self.node_capacity = max(rnd(need_n), b)
        self.frontier_capacity = min(rnd(need_f), self.node_capacity)
        return self.edge_capacity, self.node_capacity

    def _frontier_need(self, mode: str, seed_nodes: np.ndarray) -> int:
        """A bound on the device sampler's distinct inter-hop frontier for
        one probe batch: at each hop but the last, the union of the
        frontier's whole neighbour lists (a draw is a subset of them) minus
        the nodes already seen, bounded by the number of draws (the sum of
        ``min(deg, fanout)``); the reference's ``_frontier_need`` over
        incoming edges (the port's samplers are directed). The split's host
        in-CSR is built once a mode."""
        s = self.graph.sampler(mode)
        cache = self.__dict__.setdefault("_frontier_csr", {})
        if mode not in cache:
            indptr, order = group_by(s.dst, self.graph.num_nodes)
            cache[mode] = indptr, np.asarray(s.src)[order]
        indptr, nbr = cache[mode]
        seen = frontier = np.unique(seed_nodes)
        need = 1
        for fanout in [int(f) for f in s.fanouts][:-1]:
            p0 = indptr[frontier]
            deg = indptr[frontier + 1] - p0
            draws = int(np.minimum(deg, fanout).sum())
            # every neighbour-list position of the frontier, in order
            at = np.repeat(p0 - np.cumsum(deg) + deg, deg)
            nxt = np.setdiff1d(np.unique(nbr[at + np.arange(len(at))]), seen,
                               assume_unique=True)
            need = max(need, min(len(nxt), draws))
            seen = np.union1d(seen, nxt)
            frontier = nxt
        return need

    def get_graph_inputs(self, batch_y, valid, mode="train",
                         rng_seed: int = 0) -> GraphBatch:
        if self.edge_capacity <= 0 or self.node_capacity <= 0:
            self.calibrate_capacities(len(batch_y))
        return graph_inputs(batch_y, valid, self.graph, mode,
                            self.edge_capacity, self.node_capacity, rng_seed)

    def get_node_inputs(self, node_ids, y, valid, mode="train",
                        rng_seed: int = 0) -> GraphBatch:
        """Node-seeded batch (node classification): the seeds fill node
        lanes [0, B) in input order."""
        if self.edge_capacity <= 0 or self.node_capacity <= 0:
            self.calibrate_capacities(len(node_ids))
        return node_inputs(node_ids, y, valid, self.graph, mode,
                           self.edge_capacity, self.node_capacity, rng_seed)

    def get_lp_inputs(self, batch_y, valid, mode="train",
                      num_neg_samples: int = 64, rng_seed: int = 0,
                      neg_seed: int = 0) -> GraphBatch:
        if self.edge_capacity <= 0 or self.node_capacity <= 0:
            self.calibrate_capacities(len(batch_y))
        return lp_inputs(batch_y, valid, self.graph, mode,
                         self.edge_capacity, self.node_capacity,
                         num_neg_samples, rng_seed, neg_seed)

    def in_degree_histogram(self) -> np.ndarray:
        return self.graph.in_degree_histogram()
