"""Per-split graph store: the train graph holds split-0 edges, val splits
{0, 1}, test all edges; each split has its own sampler, and every edge
keeps its global row id into the edge table. Without a split (node
classification) every mode samples the one graph of all edges."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .sampler import NeighborSampler, SampledSubgraph


class GraphStore:
    def __init__(self, src: np.ndarray, dst: np.ndarray,
                 split: Optional[np.ndarray] = None,
                 fanouts: Sequence[int] = (100, 100),
                 num_nodes: Optional[int] = None, use_native: bool = True):
        self.src = np.ascontiguousarray(src, np.int64)
        self.dst = np.ascontiguousarray(dst, np.int64)
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
