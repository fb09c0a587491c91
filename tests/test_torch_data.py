"""The PyTorch port's numpy data layer against the JAX package's pandas one,
on a 2,000-row synthetic AML: generator columns, CSV text both ways, the
temporal split, categorical codes, materialized blocks, calibrated
capacities and the first GraphBatches of the test split (exactly equal)."""
import numpy as np
import pandas as pd
import pytest

from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
from rmm_tpu.datasets import synthetic_aml_frame as jax_frame
from rmm_tpu.frame.loader import DataLoader as JaxLoader
from rmm_tpu.frame.stats import StatType as JaxStatType
from rmm_tpu.utils.seeding import mix_seed as jax_mix_seed
from rmm_tpu_torch.datasets import IBMTransactionsAML
from rmm_tpu_torch.datasets import synthetic_aml_frame
from rmm_tpu_torch.datasets.base import read_csv_columns, write_csv_columns
from rmm_tpu_torch.frame.loader import DataLoader
from rmm_tpu_torch.frame.stats import StatType, value_counts
from rmm_tpu_torch.utils.seeding import mix_seed

ROWS, ACCOUNTS, FANOUTS, BATCH = 2000, 125, (10, 10), 64


@pytest.fixture(scope="module")
def aml(tmp_path_factory):
    d = tmp_path_factory.mktemp("aml")
    df = jax_frame(num_rows=ROWS, num_accounts=ACCOUNTS, seed=0)
    jax_csv = str(d / "jax.csv")
    df.to_csv(jax_csv, index=False)
    cols = synthetic_aml_frame(num_rows=ROWS, num_accounts=ACCOUNTS, seed=0)
    port_csv = str(d / "port.csv")
    write_csv_columns(port_csv, cols)
    return dict(df=df, cols=cols, jax_csv=jax_csv, port_csv=port_csv,
                jax=JaxAML(jax_csv, khop_neighbors=FANOUTS, channels=16),
                port=IBMTransactionsAML(jax_csv, khop_neighbors=FANOUTS))


def same_column(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "iuf":
        return b.dtype.kind == a.dtype.kind and np.array_equal(a, b)
    return list(a.astype(str)) == list(b.astype(str))


def test_generator_matches_jax(aml):
    assert list(aml["cols"]) == list(aml["df"].columns)
    for name in aml["df"].columns:
        assert same_column(aml["df"][name].to_numpy(), aml["cols"][name]), \
            name


def test_csv_text_both_ways(aml):
    with open(aml["jax_csv"]) as f, open(aml["port_csv"]) as g:
        assert f.read() == g.read()
    # the port parses floats correctly rounded, so it reads back the very
    # values written; pandas' default parser may land 1 ulp off (float64),
    # which no float32 block or statistic below can see
    read = read_csv_columns(aml["jax_csv"])
    pdf = pd.read_csv(aml["jax_csv"], float_precision="round_trip")
    assert list(read) == list(pdf.columns)
    for name in pdf.columns:
        assert same_column(pdf[name].to_numpy(), read[name]), name
        assert same_column(aml["df"][name].to_numpy(), read[name]), name


def test_split_codes_and_blocks_equal(aml):
    jax_edges, edges = aml["jax"].edges, aml["port"].edges
    np.testing.assert_array_equal(jax_edges.df["split"].to_numpy(),
                                  edges.columns["split"])
    for col in ("Payment Currency", "Receiving Currency", "Payment Format"):
        assert (list(map(str, jax_edges.col_stats[col][JaxStatType.COUNT][0]))
                == list(map(str, edges.col_stats[col][StatType.COUNT][0])))
    for stat in ("MEAN", "STD"):
        np.testing.assert_allclose(
            jax_edges.col_stats["Amount Paid"][JaxStatType[stat]],
            edges.col_stats["Amount Paid"][StatType[stat]], rtol=1e-12)
    for jax_tf, tf in ((jax_edges.tensor_frame, edges.tensor_frame),
                       (aml["jax"].nodes.tensor_frame,
                        aml["port"].nodes.tensor_frame)):
        assert ({int(k): v for k, v in jax_tf.col_names.items()}
                == {int(k): v for k, v in tf.col_names.items()})
        for st, block in jax_tf.feats.items():
            np.testing.assert_array_equal(np.asarray(block), tf.feats[int(st)])
        if jax_tf.y is not None:
            np.testing.assert_array_equal(np.asarray(jax_tf.y), tf.y)


def test_calibrated_capacities_equal(aml):
    assert (aml["jax"].calibrate_capacities(BATCH)
            == aml["port"].calibrate_capacities(BATCH))


def test_first_test_batches_equal(aml):
    jax_ds, ds = aml["jax"], aml["port"]
    jax_ds.calibrate_capacities(BATCH)
    ds.calibrate_capacities(BATCH)
    jax_items = enumerate(JaxLoader(jax_ds.edges.split()[2].tensor_frame,
                                    BATCH))
    items = enumerate(DataLoader(ds.edges.split()[2].tensor_frame, BATCH))
    for _ in range(3):
        (i, (jax_tf, jax_valid)), (j, (tf, valid)) = next(jax_items), \
            next(items)
        assert (i, jax_valid) == (j, valid)
        assert jax_mix_seed(1, 0, i) == mix_seed(1, 0, j)
        jax_gb = jax_ds.get_graph_inputs(np.asarray(jax_tf.y), jax_valid,
                                         "test", rng_seed=jax_mix_seed(1, 0, i))
        gb = ds.get_graph_inputs(tf.y, valid, "test",
                                 rng_seed=mix_seed(1, 0, j))
        for field in ("edge_gather", "edge_mask", "edge_index",
                      "node_gather", "node_mask", "seed_mask", "y"):
            a, b = np.asarray(getattr(jax_gb, field)), getattr(gb, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert jax_gb.num_dropped == gb.num_dropped


@pytest.mark.parametrize("seed", range(3))
def test_value_counts_order_matches_pandas(seed):
    rng = np.random.RandomState(seed)
    vals = np.array([f"v{i}" for i in rng.randint(0, 25, 80)], dtype=object)
    vals[rng.rand(80) < 0.1] = None
    expect = pd.Series(vals).dropna().value_counts()
    got = value_counts(vals)
    assert got == (list(expect.index), expect.to_list())


def test_numpy_sampler_matches_native_when_fanouts_cover_degrees(aml):
    """With fanouts above every in-degree no draw is random, so the numpy
    reference sampler (``use_native=False``) and the C++ engine sample the
    same edges and nodes (in another visiting order): seeds first in input
    order, node ids sorted, local ids relabelling the global endpoints."""
    from rmm_tpu_torch.graph.store import GraphStore

    g = aml["port"].graph
    big = int(g.test_sampler.in_degrees().max()) + 1
    idx = np.arange(0, 40)
    seeds = np.stack([g.src[idx], g.dst[idx], idx], axis=1)
    subs = [GraphStore(g.src, g.dst, fanouts=(big, big), use_native=native
                       ).sample_edges(seeds, "test", 4096, 1024, rng_seed=5)
            for native in (True, False)]
    for sub in subs:
        e, n = sub.num_edges, sub.num_nodes
        assert sub.num_dropped == 0
        np.testing.assert_array_equal(sub.edge_ids[:40], idx)
        nodes = sub.node_ids[:n]
        assert (np.diff(nodes) > 0).all()
        np.testing.assert_array_equal(nodes[sub.edge_index[0, :e]],
                                      g.src[sub.edge_ids[:e]])
        np.testing.assert_array_equal(nodes[sub.edge_index[1, :e]],
                                      g.dst[sub.edge_ids[:e]])
    native, numpy_ref = subs
    assert (native.num_edges, native.num_nodes) == (numpy_ref.num_edges,
                                                    numpy_ref.num_nodes)
    np.testing.assert_array_equal(np.sort(native.edge_ids),
                                  np.sort(numpy_ref.edge_ids))
    np.testing.assert_array_equal(native.node_ids, numpy_ref.node_ids)
