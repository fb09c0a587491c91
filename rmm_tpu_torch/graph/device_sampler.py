"""k-hop neighbour sampling on the device, in fixed-size buffers
(``rmm_tpu/graph/device_sampler.py`` without its graph-partition mode).

The per-split CSR lives in device memory (int32, uploaded once); each batch
ships only its seed ids, and the expansion, the edge dedup, the
capacity-bounded truncation and the local relabelling run on the batch's
device. Every buffer has a size fixed by the capacities and the fanouts,
and every data-dependent count (kept, dropped, the negatives' residual)
stays a 0-d tensor on the device: nothing here waits for the device, so a
batch is sampled, trained and counted without a host sync. Fixed-size
dedup and compaction are a sort, a mark on the first lane of each run, a
``cumsum`` and a ``searchsorted`` into it, then a gather
(:func:`_take_marked`): ``torch.unique``, ``nonzero`` and boolean-mask
indexing give data-dependent sizes and would synchronise.

Contracts of the host sampler kept (``graph/sampler.py``): seed edges take
lanes ``[0, B)`` in input order; node ids are sorted-unique (node-seeded:
the seeds first in input order, then the other nodes sorted); each hop
draws over incoming edges (and, on an undirected graph, outgoing ones);
capacity overflow is counted (``num_dropped``, ``num_node_dropped``),
never silent.

As in the reference: a node of degree above the fanout draws ``fanout``
edges uniformly with replacement and keeps the distinct ones; one of
degree at most the fanout takes all its edges, deterministically (the
regime in which the output equals the reference's bit for bit); duplicate
edges are removed after the expansion; truncation keeps the smallest edge
ids, and the final hop's draws past its budget are cut in frontier order.
The random draws come from a ``torch.Generator`` on the sampling device,
one ``torch.rand`` a hop, so they follow the reference's order but not its
stream.

Sentinels: a node lane out of use holds ``num_nodes``, an edge lane the
total edge count; every gather reads a clipped index and is masked after.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .sampler import group_by

INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class DeviceGraph:
    """One split's in-CSR (and, undirected, out-CSR) with the global edge
    endpoints, as int32 tensors on one device. ``nbr_all``/``eid_all`` are
    the views' neighbour and edge-id arrays end to end (the out-CSR's
    offsets shifted by ``view_offsets``), which the expansion gathers
    from."""

    indptr: torch.Tensor          # [N+1] in-CSR offsets
    nbr: torch.Tensor             # [E_split] source endpoint of each in-edge
    eid: torch.Tensor             # [E_split] global edge-table row id
    src: torch.Tensor             # [E_total] global endpoints by edge id
    dst: torch.Tensor             # [E_total]
    out_indptr: Optional[torch.Tensor] = None   # undirected expansion
    out_nbr: Optional[torch.Tensor] = None
    out_eid: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.out_indptr is None:
            self.nbr_all, self.eid_all = self.nbr, self.eid
            self.view_offsets = (0,)
        else:
            self.nbr_all = torch.cat([self.nbr, self.out_nbr])
            self.eid_all = torch.cat([self.eid, self.out_eid])
            self.view_offsets = (0, self.nbr.shape[0])

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        """Edges of the whole table (the edge sentinel)."""
        return self.src.shape[0]

    def views(self) -> list[torch.Tensor]:
        return ([self.indptr] if self.out_indptr is None
                else [self.indptr, self.out_indptr])

    @classmethod
    def from_arrays(cls, src, dst, edge_ids, num_nodes: int, device,
                    undirected: bool = False, full_src=None,
                    full_dst=None) -> "DeviceGraph":
        """From a split's edge list. ``full_src``/``full_dst`` are the whole
        edge table's endpoints (``edge_ids`` index them); by default the
        split's own. A split without edges keeps one unreachable lane, so
        that a clipped gather always has a row to read."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        edge_ids = np.asarray(edge_ids, np.int64)
        fs = src if full_src is None else np.asarray(full_src, np.int64)
        fd = dst if full_dst is None else np.asarray(full_dst, np.int64)
        if max(len(fs), int(num_nodes)) >= INT32_MAX:
            raise ValueError("the device CSR holds int32 ids: "
                             f"{len(fs)} edges, {num_nodes} nodes")

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
                device)

        def csr(key, other):
            indptr, order = group_by(key, num_nodes)
            o, e = other[order], edge_ids[order]
            if len(o) == 0:
                o = e = np.zeros(1, np.int64)
            return put(indptr), put(o), put(e)

        indptr, nbr, eid = csr(dst, src)   # in-edges grouped by dst
        out = csr(src, dst) if undirected else (None, None, None)
        return cls(indptr=indptr, nbr=nbr, eid=eid, src=put(fs),
                   dst=put(fd), out_indptr=out[0], out_nbr=out[1],
                   out_eid=out[2])

    @classmethod
    def from_store(cls, store, mode: str, device) -> "DeviceGraph":
        """The device graph of one split of a
        :class:`~rmm_tpu_torch.graph.store.GraphStore` (whose samplers,
        like every sampler of the reference's CLIs, draw incoming edges
        only)."""
        s = store.sampler(mode)
        return cls.from_arrays(s.src, s.dst, s.edge_ids, store.num_nodes,
                               device, full_src=store.src,
                               full_dst=store.dst)


def use_device_sampler(cfg) -> bool:
    """``--sampler``: ``device`` samples on the device, ``host`` in the C++
    engine; ``auto`` is the host, as the reference's ``auto`` is for one
    process (its measured single-process winner), and the port runs one
    process."""
    mode = getattr(cfg, "sampler", "auto")
    if mode not in ("auto", "host", "device"):
        raise ValueError(f"sampler must be auto, host or device: {mode!r}")
    return mode == "device"


def cached_dgraph(store, cache: dict, mode: str, device) -> DeviceGraph:
    """A split's :class:`DeviceGraph`, uploaded once (splits that share a
    sampler share the upload)."""
    key = id(store.sampler(mode))
    if key not in cache:
        cache[key] = DeviceGraph.from_store(store, mode, device)
    return cache[key]


def batch_generator(seed: int, device) -> torch.Generator:
    """The batch's generator on the sampling device, seeded with the
    batch's sampler seed."""
    return torch.Generator(device).manual_seed(int(seed))


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _isin_sorted(sorted_ref: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Membership of ``vals`` in the ascending ``sorted_ref`` (sentinel
    padding matches sentinels only)."""
    pos = torch.searchsorted(sorted_ref, vals).clamp_(
        max=sorted_ref.shape[0] - 1)
    return sorted_ref[pos] == vals


def _take_marked(x: torch.Tensor, marks: torch.Tensor, size: int,
                 sentinel: int):
    """The first ``size`` marked lanes of ``x``, in order, sentinel-filled:
    a ``cumsum``, a ``searchsorted`` and a gather. Returns (buffer
    [size], the marked count as a 0-d tensor)."""
    cs = torch.cumsum(marks, 0)
    total = cs[-1]
    j = torch.searchsorted(cs, _arange(size, x) + 1).clamp_(
        max=x.shape[0] - 1)
    return torch.where(_arange(size, x) < total, x[j], sentinel), total


def _unique_count(x: torch.Tensor, size: int, sentinel: int):
    """(sorted-unique buffer [size], sentinel-filled; the distinct count
    without the sentinel) from one sort. Because the sentinel is above every
    id, it is also ``jnp.unique(x, size=size, fill_value=sentinel)``."""
    xs = torch.sort(x).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=x.device),
                       xs[1:] != xs[:-1]]) & (xs != sentinel)
    return _take_marked(xs, first, size, sentinel)


def _compact(x: torch.Tensor, size: int, sentinel: int):
    """The non-sentinel lanes of ``x`` in order, in a buffer of ``size``:
    (buffer, overflow count)."""
    buf, total = _take_marked(x, x != sentinel, size, sentinel)
    return buf, (total - size).clamp(min=0)


def _expand_ranked(dg: DeviceGraph, frontier: torch.Tensor,
                   fmask: torch.Tensor, gen: torch.Generator, fanout: int,
                   budget: int, sent_node: int, sent_edge: int):
    """One hop in exactly ``budget`` lanes: each frontier lane (of each
    view) claims ``min(deg, fanout)`` ranks through a ``cumsum``; lane j
    finds its owner by binary search and reads the owner's j-th edge (all
    of them when deg <= fanout) or a uniform draw (``floor(u · deg)`` in
    float32, clipped, as the reference). Draws past ``budget`` are cut in
    frontier order and counted. Returns (edge ids [budget], neighbours
    [budget], overflow)."""
    fr = torch.where(fmask, frontier, 0)
    degs, p0s = [], []
    for indptr, off in zip(dg.views(), dg.view_offsets):
        p0 = indptr[fr].long()
        degs.append(torch.where(fmask, indptr[fr + 1].long() - p0, 0))
        p0s.append(p0 + off)
    deg_all = torch.cat(degs)
    p0_all = torch.cat(p0s)
    take = deg_all.clamp(max=fanout)
    cum = torch.cumsum(take, 0)
    total = cum[-1]
    j = _arange(budget, frontier)
    owner = torch.searchsorted(cum, j, right=True).clamp_(
        max=deg_all.shape[0] - 1)
    r = j - (cum[owner] - take[owner])
    deg_o = deg_all[owner]
    u = torch.rand(budget, generator=gen, device=frontier.device)
    rand_pos = torch.minimum(torch.floor(u * deg_o.float()).long(),
                             (deg_o - 1).clamp(min=0)).clamp(min=0)
    pos = torch.where(deg_o <= fanout, r, rand_pos)
    valid = (j < total) & (deg_o > 0)
    gpos = (p0_all[owner] + pos).clamp(0, dg.eid_all.shape[0] - 1)
    eids = torch.where(valid, dg.eid_all[gpos].long(), sent_edge)
    nbrs = torch.where(valid, dg.nbr_all[gpos].long(), sent_node)
    return eids, nbrs, (total - budget).clamp(min=0)


def _expand_all(dg: DeviceGraph, frontier, fmask, node_set, gen,
                fanouts: Sequence[int], node_capacity: int, sent_node: int,
                sent_edge: int, frontier_capacity: Optional[int] = None,
                edge_budget: int = 0):
    """The hop loop. ``frontier_capacity`` sizes the buffer of the
    distinct next-hop nodes (by default ``node_capacity``). Non-final hops
    keep the full budget of ``frontier · views · fanout`` lanes, since
    their neighbours seed the next frontier; only the final hop is capped at
    ``edge_budget``. Returns (candidate edge ids, frontier overflow: the
    distinct next-hop nodes that did not fit, expansion overflow: the
    draws past a hop's budget)."""
    fcap = int(frontier_capacity) if frontier_capacity else int(node_capacity)
    n_views = len(dg.views())
    cand = []
    f_overflow = x_overflow = torch.zeros((), dtype=torch.int64,
                                          device=frontier.device)
    for h, fanout in enumerate(fanouts):
        full = frontier.shape[0] * n_views * int(fanout)
        budget = min(int(edge_budget), full) if h + 1 == len(fanouts) \
            else full
        eids, nbrs, ovf = _expand_ranked(dg, frontier, fmask, gen,
                                         int(fanout), budget, sent_node,
                                         sent_edge)
        cand.append(eids)
        x_overflow = x_overflow + ovf
        if h + 1 < len(fanouts):
            new = torch.where(_isin_sorted(node_set, nbrs), sent_node, nbrs)
            frontier, distinct = _unique_count(new, fcap, sent_node)
            fmask = frontier != sent_node
            f_overflow = f_overflow + (distinct - fmask.sum()).clamp(min=0)
            if h + 2 < len(fanouts):
                # the seen set is read only by the next frontier's build
                node_set = _unique_count(torch.cat([node_set, frontier]),
                                         node_capacity, sent_node)[0]
    return torch.cat(cand), f_overflow, x_overflow


def negative_samples_device(edge_index: torch.Tensor,
                            edge_mask: torch.Tensor, pos_src: torch.Tensor,
                            pos_dst: torch.Tensor, pos_mask: torch.Tensor,
                            num_neg: int, node_capacity: int,
                            num_nodes: torch.Tensor, gen: torch.Generator,
                            rounds: int = 8):
    """Negatives of each positive edge (s, d) over the local subgraph: the
    first ``num_neg // 2`` keep s and corrupt d, the rest keep d and
    corrupt s. A corruption v is banned when v ∈ {s, d} ∪ adj(s) ∪ adj(d)
    (the subgraph's undirected adjacency). ``rounds`` rounds of uniform
    redraws over ``[0, num_nodes)``; returns (neg_edge_index
    [2, B·num_neg], the count of real lanes still banned, each holding its
    last draw).

    The pair set holds exact int64 keys ``u · (node_capacity + 2) + v``, so
    it bans exactly the subgraph's pairs; the reference's uint32 pair hash
    (``rmm_tpu/graph/device_sampler.py:373-381``, there because JAX runs
    without 64-bit integers) can also ban a candidate whose hash collides."""
    stride = int(node_capacity) + 2
    cpad = int(node_capacity) + 1          # no lane's pair: masked edges

    def key(u, v):
        return u * stride + v

    e0, e1 = edge_index[0], edge_index[1]
    keys = torch.sort(torch.cat([
        torch.where(edge_mask, key(e0, e1), key(cpad, cpad)),
        torch.where(edge_mask, key(e1, e0), key(cpad, cpad))])).values
    s, d = pos_src.long()[:, None], pos_dst.long()[:, None]
    n = num_nodes.clamp(min=1)

    def banned(v):
        return ((v == s) | (v == d) | _isin_sorted(keys, key(s, v))
                | _isin_sorted(keys, key(d, v)))

    b = pos_src.shape[0]
    res = torch.zeros((b, num_neg), dtype=torch.int64, device=s.device)
    done = torch.zeros((b, num_neg), dtype=torch.bool, device=s.device)
    for _ in range(rounds):
        v = torch.randint(0, 2**62, (b, num_neg), generator=gen,
                          device=s.device) % n
        take = ~done & ~banned(v)
        # a lane never accepted keeps its last draw, a valid id
        res = torch.where(done | take, torch.where(take, v, res), v)
        done = done | take
    residual = (~done & pos_mask[:, None]).sum()
    corrupt_dst = _arange(num_neg, s)[None, :] < num_neg // 2
    neg_src = torch.where(corrupt_dst, s, res)
    neg_dst = torch.where(corrupt_dst, res, d)
    return torch.stack([neg_src.reshape(-1), neg_dst.reshape(-1)]), residual


def sample_nodes_device(dg: DeviceGraph, seed_nodes: torch.Tensor,
                        seed_mask: torch.Tensor, gen: torch.Generator,
                        fanouts: Sequence[int], edge_capacity: int,
                        node_capacity: int,
                        frontier_capacity: Optional[int] = None) -> dict:
    """Node-seeded k-hop sample: node lanes ``[0, B)`` hold the seeds in
    input order, the other sampled nodes follow sorted. The seeds are
    assumed distinct (a duplicate relabels to its first lane)."""
    b = seed_nodes.shape[0]
    sent_node, sent_edge = dg.num_nodes, dg.num_edges
    seed_nodes = seed_nodes.long()
    seeds_m = torch.where(seed_mask, seed_nodes, sent_node)
    node_set = _unique_count(seeds_m, node_capacity, sent_node)[0]
    slack = 2 if dg.out_indptr is not None else 1
    e_lanes = int(edge_capacity) * slack
    cand, f_overflow, x_overflow = _expand_all(
        dg, seed_nodes, seed_mask, node_set, gen, fanouts, node_capacity,
        sent_node, sent_edge, frontier_capacity, edge_budget=e_lanes)

    cand, overflow = _compact(cand, e_lanes, sent_edge)
    uniq, distinct = _unique_count(cand, int(edge_capacity), sent_edge)
    edge_mask = uniq != sent_edge
    num_dropped = ((distinct - edge_mask.sum()).clamp(min=0) + overflow
                   + x_overflow)
    edge_gather = torch.where(edge_mask, uniq, 0)

    src_g = torch.where(edge_mask, dg.src[edge_gather].long(), sent_node)
    dst_g = torch.where(edge_mask, dg.dst[edge_gather].long(), sent_node)
    ends = torch.cat([src_g, dst_g])
    rest_cand = torch.where(
        _isin_sorted(torch.sort(seeds_m).values, ends), sent_node, ends)
    r_n = int(node_capacity) - b
    if r_n <= 0:
        raise ValueError("node_capacity must exceed the seed batch size")
    rest, n_distinct = _unique_count(rest_cand, r_n, sent_node)
    rest_mask = rest != sent_node
    num_node_dropped = ((n_distinct - rest_mask.sum()).clamp(min=0)
                        + f_overflow)
    node_gather = torch.cat([torch.where(seed_mask, seed_nodes, 0),
                             torch.where(rest_mask, rest, 0)])
    node_mask = torch.cat([seed_mask, rest_mask])

    # a stable sort puts the first of duplicated seeds first among equals,
    # so the leftmost search finds a seed's first lane
    seeds_sorted, seed_order = torch.sort(seeds_m, stable=True)

    def relabel(g):
        q = torch.searchsorted(seeds_sorted, g).clamp_(max=b - 1)
        in_seed = seeds_sorted[q] == g
        p = torch.searchsorted(rest, g).clamp_(max=r_n - 1)
        local = torch.where(in_seed, seed_order[q], b + p)
        return local, in_seed | (rest[p] == g)

    lsrc, ok_s = relabel(src_g)
    ldst, ok_d = relabel(dst_g)
    edge_mask = edge_mask & ok_s & ok_d
    return {"edge_gather": edge_gather, "edge_mask": edge_mask,
            "edge_index": torch.stack([torch.where(edge_mask, lsrc, 0),
                                       torch.where(edge_mask, ldst, 0)]),
            "node_gather": node_gather, "node_mask": node_mask,
            "num_dropped": num_dropped, "num_node_dropped": num_node_dropped}


def sample_edges_device(dg: DeviceGraph, seeds: torch.Tensor,
                        seed_mask: torch.Tensor, gen: torch.Generator,
                        fanouts: Sequence[int], edge_capacity: int,
                        node_capacity: int,
                        frontier_capacity: Optional[int] = None) -> dict:
    """Edge-seeded k-hop sample around ``seeds`` [B, 3] (src, dst, edge
    id): a dict of GraphBatch-shaped device tensors (int64 ids) and the
    truncation counts ``num_dropped`` and ``num_node_dropped`` (0-d)."""
    b = seeds.shape[0]
    sent_node, sent_edge = dg.num_nodes, dg.num_edges
    seeds = seeds.long()
    seed_src = torch.where(seed_mask, seeds[:, 0], sent_node)
    seed_dst = torch.where(seed_mask, seeds[:, 1], sent_node)
    seed_eid = torch.where(seed_mask, seeds[:, 2], sent_edge)
    frontier = torch.cat([seeds[:, 0], seeds[:, 1]])
    fmask = torch.cat([seed_mask, seed_mask])
    node_set = _unique_count(torch.cat([seed_src, seed_dst]), node_capacity,
                             sent_node)[0]
    # an edge can be drawn from both of its endpoints' views
    slack = 2 if dg.out_indptr is not None else 1
    e_lanes = int(edge_capacity) * slack
    cand, f_overflow, x_overflow = _expand_all(
        dg, frontier, fmask, node_set, gen, fanouts, node_capacity,
        sent_node, sent_edge, frontier_capacity, edge_budget=e_lanes)
    # the seed lanes already carry the seed edges
    cand = torch.where(_isin_sorted(torch.sort(seed_eid).values, cand),
                       sent_edge, cand)
    r = int(edge_capacity) - b
    if r <= 0:
        raise ValueError("edge_capacity must exceed the seed batch size")
    cand, overflow = _compact(cand, e_lanes, sent_edge)
    uniq, distinct = _unique_count(cand, r, sent_edge)
    kept_mask = uniq != sent_edge
    num_dropped = ((distinct - kept_mask.sum()).clamp(min=0) + overflow
                   + x_overflow)
    edge_gather = torch.cat([torch.where(seed_mask, seeds[:, 2], 0),
                             torch.where(kept_mask, uniq, 0)])
    edge_mask = torch.cat([seed_mask, kept_mask])

    src_g = torch.where(edge_mask, dg.src[edge_gather].long(), sent_node)
    dst_g = torch.where(edge_mask, dg.dst[edge_gather].long(), sent_node)
    nodes, n_distinct = _unique_count(torch.cat([src_g, dst_g]),
                                      node_capacity, sent_node)
    node_mask = nodes != sent_node
    num_node_dropped = ((n_distinct - node_mask.sum()).clamp(min=0)
                        + f_overflow)

    def relabel(g):
        p = torch.searchsorted(nodes, g).clamp_(max=node_capacity - 1)
        return p, nodes[p] == g

    lsrc, ok_s = relabel(src_g)
    ldst, ok_d = relabel(dst_g)
    edge_mask = edge_mask & ok_s & ok_d
    return {"edge_gather": edge_gather, "edge_mask": edge_mask,
            "edge_index": torch.stack([torch.where(edge_mask, lsrc, 0),
                                       torch.where(edge_mask, ldst, 0)]),
            "node_gather": torch.where(node_mask, nodes, 0),
            "node_mask": node_mask, "num_dropped": num_dropped,
            "num_node_dropped": num_node_dropped}
