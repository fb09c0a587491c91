"""The data layer of the node datasets (Ethereum phishing, ogbn-arxiv,
MUSAE GitHub, LastFM Asia) and of ``--ports`` in the PyTorch port against
the JAX package on the CPU: port numbering (the C++ engine and the plain
twin against the JAX store's engine and numpy path, with and without
timestamps), the four split types, each synthetic writer's CSVs byte for
byte, each dataset's tables (column order, stypes, blocks, targets,
splits, ``n_classes``, the Ethereum cut-offs with ties, ``in_port`` /
``out_port``, ``EgoID``) and calibrated capacities, the dispatch of the
supervised and the SSL CLIs by path, and node-seeded batches in each
sampling mode of a graph with an edge split.

Everything here is exact: integer ports stored as float64, float64 CSV
cells (read on the JAX side with ``float_precision="round_trip"``, as
``tests/test_torch_data.py`` does: pandas' default parser may land 1 ulp
off), float32 blocks."""
import functools
import os

import numpy as np
import pandas as pd
import pytest

from rmm_tpu.datasets import base as jax_base
from rmm_tpu.datasets import build_dataset as jax_build_dataset
from rmm_tpu.datasets.eth_phishing import \
    EthereumPhishingNodes as JaxEthNodes
from rmm_tpu.datasets.synthetic import \
    write_synthetic_node_dataset as jax_write
from rmm_tpu.graph import store as jax_store
from rmm_tpu.utils.config import config_from_args as jax_config_from_args
from rmm_tpu.utils.config import create_parser as jax_parser
from rmm_tpu_torch.cli import fused
from rmm_tpu_torch.datasets import base, build_dataset
from rmm_tpu_torch.datasets import eth_phishing
from rmm_tpu_torch.datasets.synthetic import write_synthetic_node_dataset
from rmm_tpu_torch.frame.stype import Stype
from rmm_tpu_torch.graph.store import GraphStore, ports_numpy
from rmm_tpu_torch.utils.config import config_from_args, create_parser
from tests.torch_port_util import one_torch_thread  # noqa: F401

FANOUTS = ("6", "6")
#: family → (directory, nodes, edges, feature columns, classes)
DATA = {"eth": ("ethereum-phishing", 300, 1368, 8, 2),
        "ogbn": ("ogbn-arxiv", 200, 1378, 5, 40),
        "musae": ("musae-github", 150, 1150, 7, 2),
        "lastfm": ("lastfm-asia", 250, 912, 4, 18)}


@pytest.fixture(autouse=True)
def round_trip_floats(monkeypatch):
    """The reference's CSV reads with correctly rounded floats."""
    monkeypatch.setattr(pd, "read_csv", functools.partial(
        pd.read_csv, float_precision="round_trip"))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base_dir = tmp_path_factory.mktemp("node_data")
    out = {}
    for family, (name, nodes, edges, feats, classes) in DATA.items():
        out[family] = write_synthetic_node_dataset(
            str(base_dir / name), family=family, num_nodes=nodes,
            num_edges=edges, num_feats=feats, n_classes=classes, seed=2)
    return out


# ---------------------------------------------------------------------------
# ports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("timed", [False, True])
@pytest.mark.parametrize("seed,nodes,edges", [(0, 30, 500), (1, 200, 300),
                                              (2, 5, 64)])
def test_ports_equal_the_jax_store(seed, nodes, edges, timed):
    rng = np.random.RandomState(seed)
    src, dst = rng.randint(0, nodes, edges), rng.randint(0, nodes, edges)
    ts = rng.randint(0, 10, edges) if timed else None
    port = GraphStore(src, dst, timestamps=ts).ports()
    native = jax_store.GraphStore(src, dst, timestamps=ts).ports()
    plain = jax_store.GraphStore(src, dst, timestamps=ts,
                                 use_native=False).ports()
    twin = (ports_numpy(dst, src, ts), ports_numpy(src, dst, ts))
    for got in (port, twin):
        for a, b, c in zip(got, native, plain):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_ports_rank_distinct_neighbours_in_time_order():
    # node 0 receives from 5 (t=3), 7 (t=1), 5 (t=0), 9 (t=1)
    src, dst = np.array([5, 7, 5, 9]), np.array([0, 0, 0, 0])
    in_p, out_p = GraphStore(src, dst, timestamps=[3, 1, 0, 1]).ports()
    np.testing.assert_array_equal(in_p, [0, 1, 0, 2])
    np.testing.assert_array_equal(out_p, [0, 0, 0, 0])


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split_type,splits", [
    ("temporal_daily", (0.6, 0.2, 0.2)), ("temporal", (0.5, 0.3, 0.2)),
    ("cutoff", (3 * 86400, 6 * 86400)), ("random", (0.6, 0.2, 0.2)),
    ("anything_else", (0.7, 0.1, 0.2))])
def test_apply_split_equals_jax(split_type, splits):
    rng = np.random.RandomState(4)
    n = 997
    ts = rng.randint(0, 10, n) * 86400 + rng.randint(0, 3, n)  # ties
    cols = {"t": ts.copy(), "v": rng.randn(n)}
    got = base.apply_split(cols, split_type, splits, "t")
    want = jax_base.apply_split(pd.DataFrame({"t": ts.copy(),
                                              "v": cols["v"]}),
                                split_type, list(splits), "t")
    np.testing.assert_array_equal(got["split"], want["split"].to_numpy())
    np.testing.assert_array_equal(got["t"], want["t"].to_numpy())
    assert set(np.unique(got["split"])) == {0, 1, 2}


def test_cutoff_split_keeps_both_cutoffs_in_val():
    cols = base.cutoff_split({"t": np.array([1, 2, 3, 4, 5])}, (2, 4), "t")
    np.testing.assert_array_equal(cols["split"], [0, 1, 1, 1, 2])


# ---------------------------------------------------------------------------
# synthetic writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["eth", "ogbn", "musae", "lastfm"])
@pytest.mark.parametrize("nodes,edges,feats,classes,seed", [
    (300, 900, 8, 4, 0), (257, 1100, 128, 18, 3), (40, 7, 2, 2, 1)])
def test_synthetic_writer_equals_jax_byte_for_byte(tmp_path, family, nodes,
                                                   edges, feats, classes,
                                                   seed):
    kw = dict(num_nodes=nodes, num_edges=edges, num_feats=feats,
              n_classes=classes, seed=seed)
    write_synthetic_node_dataset(str(tmp_path / "port"), family=family, **kw)
    jax_write(str(tmp_path / "jax"), family=family, **kw)
    for name in ("nodes.csv", "edges.csv"):
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name


# ---------------------------------------------------------------------------
# dataset tables
# ---------------------------------------------------------------------------

def argv(root: str, *extra) -> list:
    return ["--data", root, "--model", "tabgnn", "--task",
            "node_classification", "--num_neighs", *FANOUTS, *extra]


def both(root: str, *extra):
    port = build_dataset(config_from_args(create_parser().parse_args(
        argv(root, *extra, "--device", "cpu"))))
    ref = jax_build_dataset(jax_config_from_args(jax_parser().parse_args(
        argv(root, *extra))))
    return port, ref


def same_table(port, ref):
    """Column order, stypes, blocks, target and split of a table."""
    assert port.col_to_stype.keys() == ref.col_to_stype.keys()
    assert [s.value for s in port.col_to_stype.values()] == \
        [s.value for s in ref.col_to_stype.values()]
    tf, jtf = port.tensor_frame, ref.tensor_frame
    assert {st.value: n for st, n in tf.col_names.items()} == \
        {st.value: n for st, n in jtf.col_names.items()}
    for st, block in tf.feats.items():
        (jst,) = [k for k in jtf.feats if k.value == st.value]
        np.testing.assert_array_equal(block, np.asarray(jtf.feats[jst]),
                                      err_msg=st.value)
    if jtf.y is None:
        assert tf.y is None
    else:
        np.testing.assert_array_equal(tf.y, np.asarray(jtf.y))
    if ref.split_col is not None:
        np.testing.assert_array_equal(port.columns["split"],
                                      ref.df["split"].to_numpy())


@pytest.mark.parametrize("flags", [(), ("--ports",), ("--ego",)],
                         ids=["plain", "ports", "ego"])
@pytest.mark.parametrize("family", list(DATA))
def test_dataset_tables_equal_jax(roots, family, flags):
    port, ref = both(roots[family], *flags)
    assert type(port).__name__ == type(ref).__name__
    assert port.n_classes == ref.n_classes == DATA[family][4]
    same_table(port.nodes, ref.nodes)
    same_table(port.edges, ref.edges)
    edge_cols = list(port.edges.col_to_stype)
    assert ("in_port" in edge_cols) == ("--ports" in flags)
    assert ("EgoID" in port.nodes.col_to_stype) == ("--ego" in flags)
    if "--ports" in flags:
        np.testing.assert_array_equal(port.edges.columns["in_port"],
                                      ref.edges.df["in_port"].to_numpy())
        want = Stype.relation if family == "ogbn" else Stype.numerical
        assert port.edges.col_to_stype["out_port"] == want
    assert port.calibrate_capacities(64) == \
        ref.calibrate_capacities(64)[:2]


def test_ogbn_year_is_a_feature_and_the_split_key(roots):
    port, _ = both(roots["ogbn"])
    nodes = port.nodes
    assert "year" in nodes.tensor_frame.col_names[Stype.numerical]
    assert port.edges.col_to_stype == {"edge_attr": Stype.relation}
    year, split = nodes.columns["year"], nodes.columns["split"]
    assert year[split == 0].max() <= year[split == 1].min()
    assert year[split == 1].max() <= year[split == 2].min()


def test_eth_tables(roots):
    port, ref = both(roots["eth"])
    assert port.nodes.cutoffs == list(ref.nodes.cutoffs)
    # supervised: no edge label and no pretraining target
    assert port.edges.tensor_frame.y is None
    assert port.edges.col_to_stype["block_timestamp"] == Stype.timestamp
    assert port.nodes.tensor_frame.col_names == {
        Stype.relation: ["node_attr"]}
    np.testing.assert_array_equal(port.nodes.tensor_frame.y[:, 1],
                                  np.arange(DATA["eth"][1]))


@pytest.mark.parametrize("n,splits", [(20, (0.65, 0.15, 0.2)),
                                      (7, (0.65, 0.15, 0.2)),
                                      (1, (0.6, 0.2, 0.2)),
                                      (100, (0.6, 0.2, 0.2))])
@pytest.mark.parametrize("ego", [False, True])
def test_eth_cutoffs_with_ties_equal_jax(n, splits, ego):
    rng = np.random.RandomState(n)
    cols = {"node": np.arange(n), "label": rng.randint(0, 2, n),
            "first_transaction": rng.randint(0, 4, n) * 100}  # many ties
    port = eth_phishing.EthereumPhishingNodes(dict(cols), splits, ego)
    ref = JaxEthNodes(pd.DataFrame(cols), splits, ego)
    assert port.cutoffs == list(ref.cutoffs)
    np.testing.assert_array_equal(port.columns["split"],
                                  ref.df["split"].to_numpy())
    first = cols["first_transaction"]
    split = port.columns["split"]
    assert (split[np.isin(first, port.cutoffs)] == 1).all()
    port.materialize()
    ref.materialize()
    same_table(port, ref)


def test_ssl_cli_cutoff_split_equals_jax(tmp_path):
    """The SSL CLI's ``--split_type cutoff``: its ``--splits`` are the
    edges' cut-off times (both in val), as the reference reads them."""
    from rmm_tpu.datasets.ibm_aml import IBMTransactionsAML as JaxAML
    from rmm_tpu_torch.datasets.synthetic import write_synthetic_aml_csv

    csv = write_synthetic_aml_csv(str(tmp_path / "aml.csv"), num_rows=600,
                                  num_accounts=80, seed=3)
    cfg = fused.config_from_args(fused.build_parser().parse_args([
        "--dataset", csv, "--khop_neighbors", *FANOUTS, "--device",
        "cpu"]))
    t = np.sort(fused.build_ssl_dataset(cfg).edges.columns["Timestamp"])
    lo, hi = float(t[len(t) // 2]), float(t[3 * len(t) // 4])
    port = fused.build_ssl_dataset(cfg.replace(split_type="cutoff",
                                               splits=(lo, hi)))
    ref = JaxAML(csv, split_type="cutoff", splits=[lo, hi],
                 khop_neighbors=(6, 6))
    split = port.edges.columns["split"]
    np.testing.assert_array_equal(split, ref.edges.df["split"].to_numpy())
    t = port.edges.columns["Timestamp"]
    assert (split[(t >= lo) & (t <= hi)] == 1).all()
    assert set(np.unique(split)) == {0, 1, 2}


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

class Picked(Exception):
    pass


def stub(name):
    def make(*args, **kw):
        raise Picked(name, kw)
    return make


PORT_CLASSES = ("EthereumPhishing", "EllipticBitcoin", "OgbnArxiv",
                "MusaeGitHub", "LastFMAsia", "IBMTransactionsAML")
JAX_CLASSES = {"EthereumPhishing": "rmm_tpu.datasets.eth_phishing",
               "EllipticBitcoin": "rmm_tpu.datasets.elliptic",
               "OgbnArxiv": "rmm_tpu.datasets.ogbn_arxiv",
               "MusaeGitHub": "rmm_tpu.datasets.musae_github",
               "LastFMAsia": "rmm_tpu.datasets.lastfm_asia",
               "IBMTransactionsAML": "rmm_tpu.datasets"}


def picked(fn, *args):
    with pytest.raises(Picked) as info:
        fn(*args)
    return info.value.args


@pytest.mark.parametrize("path", [
    "/d/ethereum-phishing", "/d/elliptic", "/d/ogbn-arxiv", "/d/musae",
    "/d/lastfm", "/d/aml.csv", "/d/eth.csv", "/d/ethereum-phishing-ogbn",
    "/d/ogbn-musae", "/d/HI-Small_Trans.csv"])
@pytest.mark.parametrize("flags", [(), ("--ports", "--ego")])
def test_build_dataset_dispatch_equals_jax(monkeypatch, path, flags):
    import importlib

    import rmm_tpu_torch.datasets as port_datasets

    for name in PORT_CLASSES:
        monkeypatch.setattr(port_datasets, name, stub(name))
        monkeypatch.setattr(importlib.import_module(JAX_CLASSES[name]),
                            name, stub(name))
    got = picked(build_dataset, config_from_args(create_parser().parse_args(
        argv(path, *flags))))
    want = picked(jax_build_dataset, jax_config_from_args(
        jax_parser().parse_args(argv(path, *flags))))
    assert got[0] == want[0]
    for key in ("split_type", "ports", "ego", "khop_neighbors", "root"):
        assert got[1].get(key) == want[1].get(key), key
    assert got[1]["pretrain"] == set()


@pytest.mark.parametrize("path,name", [
    ("/d/eth.csv", "EthereumPhishing"), ("/d/ETH", "EthereumPhishing"),
    ("/d/Method-1.csv", "EthereumPhishing"),   # 'eth' inside a word
    ("/d/ethereum-phishing", "EthereumPhishing"),
    ("/d/aml.csv", "IBMTransactionsAML"),
    ("/d/phishing", "IBMTransactionsAML")])
@pytest.mark.parametrize("flags", [(), ("--ports", "--ego", "--split_type",
                                        "temporal", "--splits", "0.5",
                                        "0.3", "0.2")])
def test_ssl_cli_dispatch_equals_jax(monkeypatch, tmp_path, path, name,
                                     flags):
    """The SSL CLI's own dispatch: ``eth`` anywhere in the lower-cased
    path, with ``--split_type`` and ``--splits`` as given (the supervised
    CLI fixes ``temporal_daily`` and matches ``ethereum-phishing``)."""
    import rmm_tpu.cli.fused as jax_fused
    import rmm_tpu.datasets.eth_phishing as jax_eth
    import rmm_tpu_torch.datasets as port_datasets

    for mod in (port_datasets, jax_eth):
        monkeypatch.setattr(mod, "EthereumPhishing",
                            stub("EthereumPhishing"))
    for mod in (port_datasets, jax_fused):
        monkeypatch.setattr(mod, "IBMTransactionsAML",
                            stub("IBMTransactionsAML"))
    monkeypatch.chdir(tmp_path)   # the reference's CLI logs to ./logs
    args = ["--dataset", path, "--wandb_dir", str(tmp_path), *flags]
    got = picked(fused.build_ssl_dataset, fused.config_from_args(
        fused.build_parser().parse_args(args + ["--device", "cpu"])))
    want = picked(jax_fused.main, args)
    assert got[0] == want[0] == name
    for key in ("split_type", "ports", "ego"):
        assert got[1][key] == want[1][key], key
    assert {p.name for p in got[1]["pretrain"]} == \
        {p.name for p in want[1]["pretrain"]} == {"MASK", "LINK_PRED"}
    assert tuple(got[1]["splits"]) == tuple(want[1]["splits"])


# ---------------------------------------------------------------------------
# node batches on a graph with an edge split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "val", "test"])
def test_node_batches_sample_each_modes_graph(roots, mode):
    port, ref = both(roots["eth"])
    caps = ref.calibrate_capacities(64)[:2]
    port.edge_capacity, port.node_capacity = caps
    edge_split = port.edges.columns["split"]
    allowed = {"train": (0,), "val": (0, 1), "test": (0, 1, 2)}[mode]
    assert set(np.unique(edge_split)) == {0, 1, 2}
    view = port.nodes.split()[("train", "val", "test").index(mode)]
    y = port.nodes.tensor_frame.y[view.indices]
    for i, lo in enumerate(range(0, len(y), 64)):
        rows = y[lo:lo + 64]
        ids = rows[:, 1].astype(np.int64)
        a = port.get_node_inputs(ids, rows[:, :1], len(rows), mode,
                                 rng_seed=i)
        b = ref.get_node_inputs(ids, rows[:, :1], len(rows), mode,
                                rng_seed=i)
        for field in ("edge_gather", "edge_mask", "edge_index",
                      "node_gather", "node_mask", "seed_mask"):
            np.testing.assert_array_equal(getattr(a, field),
                                          np.asarray(getattr(b, field)),
                                          err_msg=f"{mode} {i} {field}")
        np.testing.assert_array_equal(a.node_gather[:len(ids)], ids)
        kept = a.edge_gather[a.edge_mask]
        assert np.isin(edge_split[kept], allowed).all()


def test_node_tables_refuse_their_pretraining_targets(roots):
    with pytest.raises(NotImplementedError, match="pretraining"):
        build_dataset(config_from_args(create_parser().parse_args(
            argv(roots["musae"], "--device", "cpu"))).replace(
            pretrain=("mask",)))


def test_eth_pretraining_targets_without_a_label_column(roots):
    """The edge table without a label packs the MASK + LINK_PRED target;
    every masked column is numerical."""
    cfg = config_from_args(create_parser().parse_args(
        argv(roots["eth"], "--device", "cpu"))).replace(
        task="mcm_edge_table")
    ds = build_dataset(cfg)
    y = ds.edges.tensor_frame.y
    assert y.shape[1] == 5
    assert set(np.unique(y[:, 1])) <= {0.0, 1.0, 2.0, 3.0}
    np.testing.assert_array_equal(y[:, 2:4], np.stack(
        [ds.edges.columns["from_address"], ds.edges.columns["to_address"]],
        axis=1))
    assert ds.edges.masked_categorical_cardinalities() == []
    for name in eth_phishing.ETH_MASKED:
        assert np.isnan(ds.edges.columns[name]).any(), name
    assert os.path.exists(os.path.join(roots["eth"], "edges.mask.npy"))
