"""GraphBatch: the fixed-capacity id/mask arrays of one k-hop minibatch.

The host builds it in numpy from a sampled subgraph; ``.to(device)`` ships
it to the card as pinned, non-blocking copies. Features are gathered on the
device from the resident tables (``edge_table[edge_gather]``). Seed edges
occupy lanes ``[0, num_seeds)`` (seed nodes, in a node-classification
batch, node lanes ``[0, num_seeds)``); ``seed_mask`` marks the real rows
(the last batch is padded). A link-prediction batch also carries
``neg_edge_index``, ``num_neg`` corrupted edges for each seed edge. A batch
sampled on the device (:class:`SeedBatch` in, ``graph/device_sampler.py``)
is born there as a GraphBatch of tensors and never passes through ``to``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graph.negative import generate_negative_samples
from ..graph.sampler import SampledSubgraph


@dataclasses.dataclass
class SeedBatch:
    """What a batch ships when it is sampled on the device
    (``graph/device_sampler.py``): the seed ids, the packed target and the
    batch's sampler seed, a few KB where a sampled subgraph takes MBs."""

    seeds: np.ndarray           # [B, 3] int32 (src, dst, edge id); a node
                                # batch puts its node ids in column 0
    y: Optional[np.ndarray]     # [B, T] float32 packed target (leading slots)
    seed_mask: np.ndarray       # [B] bool: the loss mask (no padding, no
                                # ignore-label row)
    sampler_seed: int           # the batch's mix_seed(...), as uint32
    sample_mask: Optional[np.ndarray] = None   # [B] bool: the lanes that
                                # seed the expansion (default seed_mask;
                                # a node batch keeps ignore-label rows here)

    @property
    def num_seeds(self) -> int:
        return int(self.seed_mask.shape[0])

    def to(self, device) -> "SeedBatch":
        """The arrays on ``device`` (pinned + non-blocking on CUDA)."""
        device = torch.device(device)

        def put(a):
            if a is None:
                return None
            t = torch.from_numpy(np.ascontiguousarray(a))
            if device.type == "cuda":
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        return SeedBatch(seeds=put(self.seeds), y=put(self.y),
                         seed_mask=put(self.seed_mask),
                         sampler_seed=self.sampler_seed,
                         sample_mask=put(self.sample_mask))


@dataclasses.dataclass
class GraphBatch:
    edge_gather: np.ndarray        # [E_cap] int32 row ids into the edge table
    edge_mask: np.ndarray          # [E_cap] bool
    edge_index: np.ndarray         # [2, E_cap] int32 local node ids
    node_gather: np.ndarray        # [N_cap] int32 row ids into the node table
    node_mask: np.ndarray          # [N_cap] bool
    seed_mask: np.ndarray          # [B] bool
    y: Optional[np.ndarray]        # [B, T] packed target (leading slots)
    num_dropped: int = 0           # edges the sampler dropped at capacity
    neg_edge_index: Optional[np.ndarray] = None  # [2, B*num_neg] local ids

    @property
    def num_seeds(self) -> int:
        return int(self.seed_mask.shape[0])

    def to(self, device) -> "GraphBatch":
        """Copy every array to ``device`` (pinned + non-blocking on CUDA);
        index arrays become int64, as torch's gathers and scatters want."""
        device = torch.device(device)

        def put(a, dtype=None):
            if a is None:
                return None
            t = torch.from_numpy(np.ascontiguousarray(a))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            return t if dtype is None else t.to(dtype)

        return GraphBatch(
            edge_gather=put(self.edge_gather, torch.int64),
            edge_mask=put(self.edge_mask),
            edge_index=put(self.edge_index, torch.int64),
            node_gather=put(self.node_gather, torch.int64),
            node_mask=put(self.node_mask),
            seed_mask=put(self.seed_mask),
            y=put(self.y),
            num_dropped=self.num_dropped,
            neg_edge_index=put(self.neg_edge_index, torch.int64))


def _pack_sub(sub: SampledSubgraph, valid_seeds: int, y) -> GraphBatch:
    seed_mask = np.zeros(sub.num_seeds, dtype=bool)
    seed_mask[:valid_seeds] = True
    return GraphBatch(
        edge_gather=np.maximum(sub.edge_ids, 0).astype(np.int32),
        edge_mask=sub.edge_mask.copy(),
        edge_index=sub.edge_index.astype(np.int32),
        node_gather=np.maximum(sub.node_ids, 0).astype(np.int32),
        node_mask=sub.node_mask.copy(),
        seed_mask=seed_mask,
        y=None if y is None else np.asarray(y),
        num_dropped=sub.num_dropped)


def graph_inputs(batch_y: np.ndarray, valid: int, store, mode: str,
                 edge_capacity: int, node_capacity: int,
                 rng_seed: int) -> GraphBatch:
    """Edge-seeded batch: seeds are the packed target's last 3 slots
    [src, dst, edge_id]; y keeps the leading slots."""
    edges = batch_y[:, -3:].astype(np.int64)
    sub = store.sample_edges(edges, mode, edge_capacity, node_capacity,
                             rng_seed)
    return _pack_sub(sub, valid, batch_y[:, :-3])


def node_inputs(node_ids: np.ndarray, y: np.ndarray, valid: int, store,
                mode: str, edge_capacity: int, node_capacity: int,
                rng_seed: int) -> GraphBatch:
    """Node-seeded batch (node classification): the seed nodes occupy node
    lanes ``[0, B)`` in input order; y is the label column."""
    sub = store.sample_nodes(node_ids, mode, edge_capacity, node_capacity,
                             rng_seed)
    return _pack_sub(sub, valid, y)


def lp_inputs(batch_y: np.ndarray, valid: int, store, mode: str,
              edge_capacity: int, node_capacity: int, num_neg_samples: int,
              rng_seed: int, neg_seed: int) -> GraphBatch:
    """Link-prediction batch: the edge-seeded subgraph of
    :func:`graph_inputs`, then ``num_neg_samples`` negatives for each seed
    edge, drawn over the local subgraph (its kept edges and its
    ``node_mask.sum()`` nodes) with ``neg_seed``."""
    gb = graph_inputs(batch_y, valid, store, mode, edge_capacity,
                      node_capacity, rng_seed)
    b = gb.num_seeds
    n_edges = int(gb.edge_mask.sum())
    neg = generate_negative_samples(gb.edge_index[:, :n_edges],
                                    gb.edge_index[:, :b], num_neg_samples,
                                    num_nodes=int(gb.node_mask.sum()),
                                    seed=neg_seed)
    gb.neg_edge_index = neg.astype(np.int32)
    return gb
