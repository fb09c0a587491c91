"""Static-shape k-hop neighbor sampling over a CSR (C++ engine; numpy
reference on request with ``use_native=False``).

Same contract as ``rmm_tpu/graph/sampler.py``: padded fixed-capacity
subgraphs, incoming edges sampled per hop; edge-seeded: seed edges first in
input order, node ids sorted-unique; node-seeded: seed nodes first in input
order, then the other sampled nodes sorted.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np

from .build import load_library


@dataclasses.dataclass
class SampledSubgraph:
    """edge_ids [E_cap] global edge ids (−1 pad); edge_index [2, E_cap]
    local src/dst; node_ids [N_cap] global node ids (−1 pad)."""

    edge_ids: np.ndarray
    edge_index: np.ndarray
    edge_mask: np.ndarray
    node_ids: np.ndarray
    node_mask: np.ndarray
    num_seeds: int
    num_edges: int
    num_nodes: int
    num_dropped: int


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def group_by(key: np.ndarray, num_nodes: int) -> tuple:
    """The CSR layout of edges grouped by ``key`` (one node id an edge):
    int64 offsets [num_nodes + 1] and the stable order that lists each
    node's edges in their input order. The host sampler, the device
    sampler's upload and the frontier calibration share it."""
    key = np.asarray(key, np.int64)
    offsets = np.zeros(int(num_nodes) + 1, dtype=np.int64)
    np.cumsum(np.bincount(key, minlength=int(num_nodes)), out=offsets[1:])
    return offsets, np.argsort(key, kind="stable")


class NeighborSampler:
    def __init__(self, edge_index: np.ndarray, edge_ids: Optional[np.ndarray],
                 num_nodes: int, fanouts: Sequence[int] = (100, 100),
                 use_native: bool = True):
        edge_index = np.ascontiguousarray(edge_index, dtype=np.int64)
        self.src = edge_index[0].copy()
        self.dst = edge_index[1].copy()
        self.edge_ids = (np.arange(edge_index.shape[1], dtype=np.int64)
                         if edge_ids is None
                         else np.ascontiguousarray(edge_ids, np.int64))
        self.num_nodes = int(num_nodes)
        self.fanouts = np.asarray(list(fanouts), dtype=np.int64)
        self._lib = load_library() if use_native else None
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.rmm_graph_create(
                _i64p(self.src), _i64p(self.dst), _i64p(self.edge_ids),
                len(self.src), self.num_nodes)
        else:
            self._in_csr = self._csr(self.dst, self.src)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.rmm_graph_destroy(self._handle)

    def _csr(self, key, other):
        offsets, order = group_by(key, self.num_nodes)
        return offsets, other[order], self.edge_ids[order]

    def in_degrees(self) -> np.ndarray:
        if self._handle is not None:
            out = np.zeros(self.num_nodes, dtype=np.int64)
            self._lib.rmm_in_degrees(self._handle, _i64p(out))
            return out
        offsets = self._in_csr[0]
        return offsets[1:] - offsets[:-1]

    def in_degree_histogram(self) -> np.ndarray:
        deg = self.in_degrees()
        return np.bincount(deg, minlength=int(deg.max(initial=0)) + 1)

    def sample_edges(self, seed_src, seed_dst, seed_ids, max_edges: int,
                     max_nodes: int, rng_seed: int) -> SampledSubgraph:
        seed_src = np.ascontiguousarray(seed_src, np.int64)
        seed_dst = np.ascontiguousarray(seed_dst, np.int64)
        seed_ids = np.ascontiguousarray(seed_ids, np.int64)
        if self._handle is None:
            return self._numpy_sample_edges(seed_src, seed_dst, seed_ids,
                                            int(rng_seed), max_edges,
                                            max_nodes)
        return self._native_sample(
            self._lib.rmm_sample_from_edges, (seed_src, seed_dst, seed_ids),
            rng_seed, max_edges, max_nodes)

    def sample_nodes(self, seed_nodes, max_edges: int, max_nodes: int,
                     rng_seed: int) -> SampledSubgraph:
        """The k-hop subgraph of the seed nodes: node lanes ``[0, n)`` hold
        the ``n`` distinct seeds in input order."""
        seed_nodes = np.ascontiguousarray(seed_nodes, np.int64)
        if self._handle is None:
            return self._numpy_sample_nodes(seed_nodes, int(rng_seed),
                                            max_edges, max_nodes)
        return self._native_sample(self._lib.rmm_sample_from_nodes,
                                   (seed_nodes,), rng_seed, max_edges,
                                   max_nodes)

    def _native_sample(self, fn, seeds, rng_seed, max_edges: int,
                       max_nodes: int) -> SampledSubgraph:
        edge_ids = np.empty(max_edges, dtype=np.int64)
        src_l = np.empty(max_edges, dtype=np.int64)
        dst_l = np.empty(max_edges, dtype=np.int64)
        node_ids = np.empty(max_nodes, dtype=np.int64)
        counts = np.zeros(3, dtype=np.int64)
        rc = fn(self._handle, *map(_i64p, seeds), len(seeds[-1]),
                _i64p(self.fanouts), len(self.fanouts),
                ctypes.c_uint64(int(rng_seed)), 0,   # 0: incoming edges only
                max_edges, max_nodes, _i64p(edge_ids), _i64p(src_l),
                _i64p(dst_l), _i64p(node_ids), _i64p(counts))
        if rc != 0:
            raise RuntimeError(
                f"sampler node capacity exceeded (max_nodes={max_nodes}); "
                "raise max_nodes or lower fanouts")
        return SampledSubgraph(
            edge_ids=edge_ids, edge_index=np.stack([src_l, dst_l]),
            edge_mask=edge_ids >= 0, node_ids=node_ids,
            node_mask=node_ids >= 0, num_seeds=len(seeds[-1]),
            num_edges=int(counts[0]), num_nodes=int(counts[1]),
            num_dropped=int(counts[2]))

    # -- numpy reference (same contract, its own random stream) -------------
    def _expand(self, frontier, seen_edges, rng):
        out_e, out_s, out_d = [], [], []
        fseen = set(frontier)
        offsets, nbrs, eids = self._in_csr
        for fanout in self.fanouts:
            nxt = []
            for v in frontier:
                beg, end = offsets[v], offsets[v + 1]
                deg = end - beg
                if deg <= 0:
                    continue
                if fanout < 0 or deg <= fanout:
                    sel = np.arange(beg, end)
                else:
                    sel = beg + rng.choice(deg, size=int(fanout),
                                           replace=False)
                for p in sel:
                    e, u = int(eids[p]), int(nbrs[p])
                    if e not in seen_edges:
                        seen_edges.add(e)
                        out_e.append(e)
                        out_s.append(u)
                        out_d.append(v)
                    if u not in fseen:
                        fseen.add(u)
                        nxt.append(u)
            frontier = nxt
        return out_e, out_s, out_d

    def _numpy_sample_edges(self, seed_src, seed_dst, seed_ids, rng_seed,
                            max_edges, max_nodes) -> SampledSubgraph:
        rng = np.random.RandomState(rng_seed % (2**32))
        seen = set(int(e) for e in seed_ids)
        frontier = list(dict.fromkeys(
            list(map(int, seed_src)) + list(map(int, seed_dst))))
        e2, s2, d2 = self._expand(frontier, seen, rng)
        edge_ids = list(map(int, seed_ids)) + e2
        esrc = list(map(int, seed_src)) + s2
        edst = list(map(int, seed_dst)) + d2
        kept = min(len(edge_ids), max_edges)
        node_order = sorted(set(esrc[:kept]) | set(edst[:kept]))
        return self._pack(edge_ids, esrc, edst, node_order, len(seed_ids),
                          max_edges, max_nodes)

    def _numpy_sample_nodes(self, seed_nodes, rng_seed, max_edges,
                            max_nodes) -> SampledSubgraph:
        rng = np.random.RandomState(rng_seed % (2**32))
        e2, s2, d2 = self._expand(list(map(int, seed_nodes)), set(), rng)
        kept = min(len(e2), max_edges)
        node_order = list(dict.fromkeys(map(int, seed_nodes)))
        rest = (set(s2[:kept]) | set(d2[:kept])) - set(node_order)
        return self._pack(e2, s2, d2, node_order + sorted(rest),
                          len(seed_nodes), max_edges, max_nodes)

    def _pack(self, edge_ids, esrc, edst, node_order, n_seeds, max_edges,
              max_nodes) -> SampledSubgraph:
        total = len(edge_ids)
        kept = min(total, max_edges)
        if len(node_order) > max_nodes:
            raise RuntimeError(
                f"sampler node capacity exceeded (max_nodes={max_nodes})")
        local = {v: i for i, v in enumerate(node_order)}
        out_eid = np.full(max_edges, -1, dtype=np.int64)
        out_src = np.zeros(max_edges, dtype=np.int64)
        out_dst = np.zeros(max_edges, dtype=np.int64)
        out_eid[:kept] = edge_ids[:kept]
        out_src[:kept] = [local[v] for v in esrc[:kept]]
        out_dst[:kept] = [local[v] for v in edst[:kept]]
        out_nodes = np.full(max_nodes, -1, dtype=np.int64)
        out_nodes[:len(node_order)] = node_order
        return SampledSubgraph(
            edge_ids=out_eid, edge_index=np.stack([out_src, out_dst]),
            edge_mask=out_eid >= 0, node_ids=out_nodes,
            node_mask=out_nodes >= 0, num_seeds=n_seeds,
            num_edges=kept, num_nodes=len(node_order),
            num_dropped=total - kept)
