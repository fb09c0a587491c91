"""The port's device sampler (``rmm_tpu_torch/graph/device_sampler.py``) on
the CPU against ``rmm_tpu.graph.device_sampler`` under ``jax.jit``, on the
cases of ``tests/test_device_sampler.py``.

Where every degree is at most the fanout no random draw is read, and every
output (ids, masks, local edge index, the drop counts) must be bit-identical
to the reference's: directed and undirected, edge- and node-seeded, three
hops, padded seed lanes, an edge capacity too small, an ample and a tiny
frontier buffer. With degrees above the fanout the two streams differ, and
the structural invariants are checked instead. The negatives against a
brute-force banned set; ``use_device_sampler``'s resolution; the
calibrated ``frontier_capacity`` against the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from rmm_tpu.graph import device_sampler as jds
from rmm_tpu_torch.graph import device_sampler as ds
from rmm_tpu_torch.graph.sampler import NeighborSampler
from tests.torch_port_util import one_torch_thread  # noqa: F401

KEYS = ("edge_gather", "edge_mask", "edge_index", "node_gather", "node_mask",
        "num_dropped", "num_node_dropped")


def random_graph(rng, num_nodes=40, num_edges=300):
    src = rng.randint(0, num_nodes, num_edges).astype(np.int64)
    dst = rng.randint(0, num_nodes, num_edges).astype(np.int64)
    return src, dst, num_nodes


def graphs(src, dst, n, undirected=False):
    eids = np.arange(len(src))
    return (jds.DeviceGraph.from_arrays(src, dst, eids, n,
                                        undirected=undirected),
            ds.DeviceGraph.from_arrays(src, dst, eids, n, "cpu",
                                       undirected=undirected))


def seed_batch(rng, src, dst, b):
    idx = rng.choice(len(src), size=b, replace=False)
    return np.stack([src[idx], dst[idx], idx], axis=1).astype(np.int32)


def run_edges(pair, seeds, mask, fanouts, e_cap, n_cap, fcap=None, seed=0):
    jdg, tdg = pair
    jout = jax.jit(lambda s, m, k: jds.sample_edges_device(
        jdg, s, m, k, fanouts, e_cap, n_cap, fcap))(
            seeds, mask, jax.random.PRNGKey(seed))
    tout = ds.sample_edges_device(
        tdg, torch.from_numpy(seeds), torch.from_numpy(mask),
        ds.batch_generator(seed, "cpu"), fanouts, e_cap, n_cap, fcap)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()})


def run_nodes(pair, nodes, mask, fanouts, e_cap, n_cap, seed=0):
    jdg, tdg = pair
    jout = jax.jit(lambda s, m, k: jds.sample_nodes_device(
        jdg, s, m, k, fanouts, e_cap, n_cap))(
            nodes, mask, jax.random.PRNGKey(seed))
    tout = ds.sample_nodes_device(
        tdg, torch.from_numpy(nodes), torch.from_numpy(mask),
        ds.batch_generator(seed, "cpu"), fanouts, e_cap, n_cap)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.numpy() for k, v in tout.items()})


def assert_identical(jout, tout):
    for k in KEYS:
        assert tout[k].dtype == (np.bool_ if "mask" in k else np.int64), k
        np.testing.assert_array_equal(tout[k], jout[k].astype(tout[k].dtype),
                                      err_msg=k)


def assert_consistent(out, src, dst, b, seed_ids=None):
    """Seed lanes first, kept edges real and distinct, nodes sorted-unique
    (after the seeds of a node batch), the relabelling maps back."""
    eg, em, ei = out["edge_gather"], out["edge_mask"], out["edge_index"]
    nodes = out["node_gather"][out["node_mask"]]
    kept = eg[em]
    assert len(set(kept.tolist())) == len(kept)
    if seed_ids is not None:
        np.testing.assert_array_equal(eg[:b], seed_ids)
    np.testing.assert_array_equal(out["node_gather"][ei[0][em]], src[kept])
    np.testing.assert_array_equal(out["node_gather"][ei[1][em]], dst[kept])
    return nodes


@pytest.mark.parametrize("undirected", [False, True])
def test_edge_seeded_bit_identical_when_fanout_covers_degree(undirected):
    rng = np.random.RandomState(0)
    src, dst, n = random_graph(rng)
    pair = graphs(src, dst, n, undirected)
    seeds = seed_batch(rng, src, dst, 8)
    jout, tout = run_edges(pair, seeds, np.ones(8, bool), (512, 512), 512,
                           128)
    assert_identical(jout, tout)
    assert int(tout["num_dropped"]) == int(tout["num_node_dropped"]) == 0
    nodes = assert_consistent(tout, src, dst, 8, seeds[:, 2])
    assert (np.diff(nodes) > 0).all()
    if not undirected:   # the host sampler's edge set and node order
        host = NeighborSampler(np.stack([src, dst]), None, n, (512, 512),
                               use_native=False)
        sub = host.sample_edges(seeds[:, 0], seeds[:, 1], seeds[:, 2], 512,
                                128, rng_seed=7)
        assert (set(sub.edge_ids[sub.edge_mask].tolist())
                == set(tout["edge_gather"][tout["edge_mask"]].tolist()))
        np.testing.assert_array_equal(sub.node_ids[sub.node_mask], nodes)


def test_node_seeded_bit_identical_when_fanout_covers_degree():
    rng = np.random.RandomState(5)
    src, dst, n = random_graph(rng)
    pair = graphs(src, dst, n)
    seed_nodes = rng.choice(n, size=6, replace=False).astype(np.int32)
    jout, tout = run_nodes(pair, seed_nodes, np.ones(6, bool), (512, 512),
                           512, 128)
    assert_identical(jout, tout)
    nodes = assert_consistent(tout, src, dst, 6)
    np.testing.assert_array_equal(nodes[:6], seed_nodes)
    host = NeighborSampler(np.stack([src, dst]), None, n, (512, 512),
                           use_native=False)
    sub = host.sample_nodes(seed_nodes.astype(np.int64), 512, 128,
                            rng_seed=3)
    np.testing.assert_array_equal(sub.node_ids[sub.node_mask], nodes)


def test_three_hops_bit_identical():
    rng = np.random.RandomState(7)
    src, dst, n = random_graph(rng, num_nodes=60, num_edges=240)
    pair = graphs(src, dst, n)
    seeds = seed_batch(rng, src, dst, 4)
    jout, tout = run_edges(pair, seeds, np.ones(4, bool), (256, 256, 256),
                           512, 128)
    assert_identical(jout, tout)
    assert int(tout["num_dropped"]) == 0


def test_padded_seed_lanes_bit_identical():
    rng = np.random.RandomState(2)
    src, dst, n = random_graph(rng)
    pair = graphs(src, dst, n)
    seeds = seed_batch(rng, src, dst, 8)
    mask = np.array([True] * 5 + [False] * 3)
    jout, tout = run_edges(pair, seeds, mask, (512, 512), 1024, 128)
    assert_identical(jout, tout)
    np.testing.assert_array_equal(tout["edge_mask"][:8], mask)
    _, real = run_edges(pair, seeds[:5], np.ones(5, bool), (512, 512), 1024,
                        128)
    assert (set(tout["node_gather"][tout["node_mask"]].tolist())
            == set(real["node_gather"][real["node_mask"]].tolist()))
    # a padded node-seed lane stays out of the node set too
    nodes = np.unique(src)[:6].astype(np.int32)
    nmask = np.array([True] * 4 + [False] * 2)
    jout, tout = run_nodes(pair, nodes, nmask, (512, 512), 1024, 128)
    assert_identical(jout, tout)


@pytest.mark.parametrize("node_capacity", [64, 12])
def test_too_small_capacity_keeps_and_counts_as_the_reference(
        node_capacity):
    """Degrees ~25 under fanouts of 64: 32 edge lanes keep the smallest
    edge ids and count the rest; 12 node lanes (of 20 nodes) also evict
    nodes (their edges leave ``edge_mask``, a seed's too)."""
    rng = np.random.RandomState(3)
    src, dst, n = random_graph(rng, num_nodes=20, num_edges=500)
    pair = graphs(src, dst, n)
    seeds = seed_batch(rng, src, dst, 4)
    jout, tout = run_edges(pair, seeds, np.ones(4, bool), (64, 64), 32,
                           node_capacity)
    assert_identical(jout, tout)
    _, loose = run_edges(pair, seeds, np.ones(4, bool), (64, 64), 1024, 64)
    dropped = int(tout["num_dropped"])
    assert dropped == int(loose["edge_mask"].sum()) - 32 > 0
    if node_capacity == 12:
        assert int(tout["num_node_dropped"]) > 0


def test_frontier_capacity_ample_and_tiny():
    rng = np.random.RandomState(3)
    src, dst, n = random_graph(rng)
    pair = graphs(src, dst, n)
    seeds = seed_batch(rng, src, dst, 8)
    _, base = run_edges(pair, seeds, np.ones(8, bool), (512, 512), 512, 128)
    for fcap in (128, 4):
        jout, tout = run_edges(pair, seeds, np.ones(8, bool), (512, 512),
                               512, 128, fcap)
        assert_identical(jout, tout)
    jout, ample = run_edges(pair, seeds, np.ones(8, bool), (512, 512), 512,
                            128, 128)
    for k in KEYS:
        np.testing.assert_array_equal(ample[k], base[k], err_msg=k)
    _, tiny = run_edges(pair, seeds, np.ones(8, bool), (512, 512), 512, 128,
                        4)
    assert int(tiny["num_node_dropped"]) > 0
    assert tiny["edge_mask"].sum() < ample["edge_mask"].sum()


def test_random_regime_invariants():
    rng = np.random.RandomState(1)
    src, dst, n = random_graph(rng, num_nodes=30, num_edges=600)
    _, tdg = graphs(src, dst, n)
    seeds = seed_batch(rng, src, dst, 6)
    runs = []
    for seed in (10, 11, 10):
        out = ds.sample_edges_device(
            tdg, torch.from_numpy(seeds), torch.ones(6, dtype=torch.bool),
            ds.batch_generator(seed, "cpu"), (4, 4), 256, 128)
        out = {k: v.numpy() for k, v in out.items()}
        nodes = assert_consistent(out, src, dst, 6, seeds[:, 2])
        assert (np.diff(nodes) > 0).all()
        assert out["edge_mask"].sum() <= 256
        # hop 1 draws at most 4 edges a seed endpoint, hop 2 4 a frontier
        # node
        assert out["edge_mask"].sum() <= 6 + 12 * 4 + 12 * 4 * 4 * 4
        runs.append(set(out["edge_gather"][out["edge_mask"]].tolist()))
    assert runs[0] != runs[1] and runs[0] == runs[2]
    out = ds.sample_nodes_device(
        tdg, torch.arange(6, dtype=torch.int32),
        torch.ones(6, dtype=torch.bool), ds.batch_generator(3, "cpu"),
        (4, 4), 256, 128)
    out = {k: v.numpy() for k, v in out.items()}
    nodes = assert_consistent(out, src, dst, 6)
    np.testing.assert_array_equal(nodes[:6], np.arange(6))
    assert (np.diff(nodes[6:]) > 0).all()


def brute_force_adjacency(ei, mask):
    adj = {}
    for u, v in ei[:, mask].T:
        adj.setdefault(int(u), set()).add(int(v))
        adj.setdefault(int(v), set()).add(int(u))
    return adj


@pytest.mark.parametrize("n_nodes", [50, 6])
def test_negatives_avoid_the_banned_set(n_nodes):
    """50 nodes: every lane finds a negative (residual 0). 6 nodes with
    every pair an edge: nothing can be drawn, every real lane counts in the
    residual (the padded seed lane does not)."""
    rng = np.random.RandomState(9)
    b, num_neg = 6, 8
    if n_nodes == 50:
        ei = rng.randint(0, n_nodes, (2, 120))
    else:
        u, v = np.meshgrid(np.arange(n_nodes), np.arange(n_nodes))
        ei = np.stack([u.ravel(), v.ravel()])
    mask = np.ones(ei.shape[1], bool)
    mask[-3:] = n_nodes != 50   # masked lanes ban nothing
    pos = ei[:, :b]
    pos_mask = np.array([True] * (b - 1) + [False])
    neg, residual = ds.negative_samples_device(
        torch.from_numpy(ei), torch.from_numpy(mask),
        torch.from_numpy(pos[0]), torch.from_numpy(pos[1]),
        torch.from_numpy(pos_mask), num_neg, 64, torch.tensor(n_nodes),
        ds.batch_generator(0, "cpu"))
    neg = neg.numpy()
    assert neg.shape == (2, b * num_neg)
    assert ((neg >= 0) & (neg < n_nodes)).all()
    half = num_neg // 2
    adj = brute_force_adjacency(ei, mask)
    stuck = 0
    for i in range(b):
        s, d = int(pos[0, i]), int(pos[1, i])
        block = neg[:, i * num_neg:(i + 1) * num_neg]
        np.testing.assert_array_equal(block[0, :half], s)
        np.testing.assert_array_equal(block[1, half:], d)
        for j in range(num_neg):
            v = int(block[1, j] if j < half else block[0, j])
            bad = v in (s, d) or v in adj.get(s, ()) or v in adj.get(d, ())
            stuck += bad and bool(pos_mask[i])
            if n_nodes == 50:
                assert not bad
    assert int(residual) == stuck == (0 if n_nodes == 50
                                      else (b - 1) * num_neg)


def test_use_device_sampler_resolution():
    from rmm_tpu_torch.utils.config import Config

    assert ds.use_device_sampler(Config(sampler="device"))
    assert not ds.use_device_sampler(Config(sampler="host"))
    assert not ds.use_device_sampler(Config())      # auto: one process
    with pytest.raises(ValueError, match="sampler"):
        ds.use_device_sampler(Config(sampler="tpu"))


def test_cached_dgraph_uploads_each_sampler_once():
    from rmm_tpu_torch.graph.store import GraphStore

    rng = np.random.RandomState(4)
    src, dst, n = random_graph(rng)
    split = rng.randint(0, 3, len(src))
    store = GraphStore(src, dst, split=split, fanouts=(4, 4))
    nosplit = GraphStore(src, dst, fanouts=(4, 4))
    cache = {}
    g_train = ds.cached_dgraph(store, cache, "train", "cpu")
    assert ds.cached_dgraph(store, cache, "train", "cpu") is g_train
    assert g_train.nbr.dtype == torch.int32
    assert int(g_train.indptr[-1]) == int((split == 0).sum())
    assert g_train.num_edges == len(src)
    one = ds.cached_dgraph(nosplit, cache, "val", "cpu")
    assert ds.cached_dgraph(nosplit, cache, "test", "cpu") is one


def test_calibration_sets_the_reference_frontier_capacity(tmp_path):
    from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
    from rmm_tpu.datasets import write_synthetic_aml_csv
    from rmm_tpu_torch.datasets import IBMTransactionsAML

    csv = write_synthetic_aml_csv(str(tmp_path / "aml.csv"), num_rows=600,
                                  num_accounts=60, seed=1)
    ref = JaxAML(root=csv, khop_neighbors=(8, 8), channels=8)
    port = IBMTransactionsAML(root=csv, khop_neighbors=(8, 8))
    for b in (16, 64):
        assert ref.calibrate_capacities(b) == port.calibrate_capacities(b)
        assert port.frontier_capacity == ref.frontier_capacity
        assert 256 <= port.frontier_capacity <= port.node_capacity
