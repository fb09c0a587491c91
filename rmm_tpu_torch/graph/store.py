"""Per-split graph store: the train graph holds split-0 edges, val splits
{0, 1}, test all edges; each split has its own sampler, and every edge
keeps its global row id into the edge table. Without a split (the node
families) every mode samples the one graph of all edges. Port numbering
(``--ports``) runs in the C++ engine over the full graph."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

from .build import load_library
from .sampler import NeighborSampler, SampledSubgraph


class GraphStore:
    def __init__(self, src: np.ndarray, dst: np.ndarray,
                 split: Optional[np.ndarray] = None,
                 fanouts: Sequence[int] = (100, 100),
                 num_nodes: Optional[int] = None, use_native: bool = True,
                 timestamps: Optional[np.ndarray] = None):
        self.src = np.ascontiguousarray(src, np.int64)
        self.dst = np.ascontiguousarray(dst, np.int64)
        self.timestamps = (np.ascontiguousarray(timestamps, np.int64)
                           if timestamps is not None else None)
        self.num_edges = len(self.src)
        self.num_nodes = (int(num_nodes) if num_nodes is not None
                          else int(max(self.src.max(initial=-1),
                                       self.dst.max(initial=-1))) + 1)
        self.edge_ids = np.arange(self.num_edges, dtype=np.int64)

        def make(mask):
            ei = np.stack([self.src[mask], self.dst[mask]])
            return NeighborSampler(ei, self.edge_ids[mask], self.num_nodes,
                                   fanouts=fanouts, use_native=use_native)

        if split is not None:
            split = np.asarray(split)
            self.train_sampler = make(split == 0)
            self.val_sampler = make(np.isin(split, (0, 1)))
            self.test_sampler = make(np.ones(len(split), dtype=bool))
        else:
            self.test_sampler = make(np.ones(self.num_edges, dtype=bool))
            self.train_sampler = self.val_sampler = self.test_sampler

    def sampler(self, mode: str) -> NeighborSampler:
        try:
            return {"train": self.train_sampler, "val": self.val_sampler,
                    "test": self.test_sampler}[mode]
        except KeyError:
            raise ValueError(
                "Invalid sampling mode! Valid values: ['train', 'val', 'test']")

    def sample_edges(self, seed_edges: np.ndarray, mode: str, max_edges: int,
                     max_nodes: int, rng_seed: int) -> SampledSubgraph:
        """seed_edges: [B, 3] rows (src, dst, edge_id)."""
        se = np.asarray(seed_edges, dtype=np.int64)
        return self.sampler(mode).sample_edges(
            se[:, 0], se[:, 1], se[:, 2], max_edges, max_nodes, rng_seed)

    def sample_nodes(self, seed_nodes: np.ndarray, mode: str, max_edges: int,
                     max_nodes: int, rng_seed: int) -> SampledSubgraph:
        """seed_nodes: [B] global node ids (node classification)."""
        return self.sampler(mode).sample_nodes(
            np.asarray(seed_nodes, np.int64).reshape(-1), max_edges,
            max_nodes, rng_seed)

    def in_degree_histogram(self) -> np.ndarray:
        """In-degree histogram of the train graph (PNA degree scalers)."""
        return self.train_sampler.in_degree_histogram()

    def ports(self) -> tuple[np.ndarray, np.ndarray]:
        """(in ports, out ports) per edge, float64, over the full graph: an
        edge u → v's in port is u's rank among v's distinct in-neighbours
        in time order (ties in row order), its out port v's among u's
        out-neighbours; without timestamps every edge has time 0."""
        lib = load_library()
        in_p = np.zeros(self.num_edges, dtype=np.float64)
        out_p = np.zeros(self.num_edges, dtype=np.float64)
        ts = (self.timestamps if self.timestamps is not None
              else np.zeros(self.num_edges, dtype=np.int64))

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        def f64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

        lib.rmm_ports(p64(self.src), p64(self.dst), p64(ts), self.num_edges,
                      self.num_nodes, f64(in_p), f64(out_p))
        return in_p, out_p


def ports_numpy(key: np.ndarray, other: np.ndarray,
                ts: Optional[np.ndarray]) -> np.ndarray:
    """The plain twin of the engine's port numbering, for tests: each
    edge's rank of ``other`` among its ``key`` node's distinct
    ``other``-neighbours in time order (``key = dst, other = src`` gives
    the in ports)."""
    n = len(key)
    out = np.zeros(n, dtype=np.float64)
    t = ts if ts is not None else np.zeros(n, dtype=np.int64)
    order = np.lexsort((t, key))
    rank: dict[int, int] = {}
    prev_key = None
    nxt = 0
    for i in order:
        k = int(key[i])
        if k != prev_key:
            rank = {}
            nxt = 0
            prev_key = k
        u = int(other[i])
        if u not in rank:
            rank[u] = nxt
            nxt += 1
        out[i] = rank[u]
    return out
