"""Elliptic node classification of the PyTorch port against the JAX package
on the CPU: the synthetic CSVs byte for byte, the ``temporal`` and
``random`` splits, node-seeded k-hop sampling (the C++ engine and the
numpy path), the dataset's tables, targets and calibrated capacities, the
node classifier head and the ``tabgnn`` node-task forward, three train
steps against the JAX record ``node_record.npz`` and the predict CLI's ids
and scores against the same record.

The record (``tools/make_torch_port_node_fixture.py``) is the slice's
widths: 166 feature columns (node tokens S = 167), C = 32, 8 heads, 2
layers, fanouts 100/100, batch 200, on a 2,000-node cut. Tolerances: the
forwards 1e-5 abs/rel (float32, sums in another order), the three steps
``convert.check_record``'s float32 limits (each loss 1e-4 relative at step
1 and 1e-3 after, each parameter 6.05·lr), served scores 1e-4 (PNA sums in
another order) with the ids and classes equal."""
import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from rmm_tpu.datasets import base as jax_base
from rmm_tpu.datasets.elliptic import EllipticBitcoin as JaxElliptic
from rmm_tpu.datasets.synthetic import \
    write_synthetic_node_dataset as jax_write_nodes
from rmm_tpu.graph.store import GraphStore as JaxStore
from rmm_tpu.nn.decoders import NodeClassificationHead as JaxHead
from rmm_tpu.train.trainer import Trainer as JaxTrainer
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.cli import main as train_cli
from rmm_tpu_torch.cli import predict
from rmm_tpu_torch.convert import (check_record, from_jax, load_record,
                                   loss_terms, random_variables, torch_key)
from rmm_tpu_torch.datasets import base
from rmm_tpu_torch.datasets.elliptic import EllipticBitcoin
from rmm_tpu_torch.datasets.synthetic import write_synthetic_node_dataset
from rmm_tpu_torch.graph.store import GraphStore
from rmm_tpu_torch.nn.decoders import NodeClassificationHead
from rmm_tpu_torch.train.trainer import Trainer
from rmm_tpu_torch.utils.checkpoint import save_checkpoint
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import (init_random, load_from_jax,  # noqa: F401
                                   one_torch_thread,
                                   randomize_jax_variables)

TOL = dict(rtol=1e-5, atol=1e-5)
RECORD = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port",
                      "node_record.npz")


def elliptic_dir(tmp, nodes=400, edges=460, feats=166, seed=0) -> str:
    """A synthetic Elliptic directory (its path names ``elliptic``, which
    the dataset dispatch and the config override read)."""
    root = str(tmp / f"elliptic_{nodes}_{feats}_{seed}")
    write_synthetic_node_dataset(root, num_nodes=nodes, num_edges=edges,
                                 num_feats=feats, seed=seed)
    return root


@pytest.mark.parametrize("nodes,edges,feats,classes,seed", [
    (300, 900, 8, 4, 0), (500, 575, 166, 4, 3), (97, 50, 3, 2, 1)])
def test_synthetic_csvs_equal_the_jax_generator_byte_for_byte(
        tmp_path, nodes, edges, feats, classes, seed):
    kw = dict(num_nodes=nodes, num_edges=edges, num_feats=feats,
              n_classes=classes, seed=seed)
    write_synthetic_node_dataset(str(tmp_path / "port"), **kw)
    jax_write_nodes(str(tmp_path / "jax"), family="elliptic", **kw)
    for name in ("nodes.csv", "edges.csv"):
        with open(tmp_path / "port" / name, "rb") as a, \
                open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read()


def test_synthetic_refuses_the_unported_families(tmp_path):
    """Every family of the JAX writer is ported (tests/test_torch_node_
    data.py holds each CSV to it byte for byte): ``ogbn`` writes its
    schema."""
    write_synthetic_node_dataset(str(tmp_path), family="ogbn", num_nodes=20,
                                 num_edges=30, num_feats=2)
    cols = base.read_csv_columns(str(tmp_path / "nodes.csv"))
    assert list(cols) == ["f0", "f1", "id", "label", "year"]
    assert list(base.read_csv_columns(str(tmp_path / "edges.csv"))) == [
        "src", "dst"]


@pytest.mark.parametrize("splits", [(0.6, 0.2, 0.2), (0.5, 0.3, 0.2)])
@pytest.mark.parametrize("n,span", [(1000, 49), (37, 5), (500, 1)])
def test_temporal_and_random_splits_equal_the_jax_ones(n, span, splits):
    """Many ties in time (a stable rank keeps the file's order)."""
    ts = np.random.RandomState(n).randint(1, 1 + span, n).astype(float)
    got = base.temporal_split({"t": ts.copy()}, splits, "t")
    want = jax_base.temporal_split(pd.DataFrame({"t": ts}), splits, "t")
    np.testing.assert_array_equal(got["split"], want["split"].to_numpy())
    np.testing.assert_array_equal(got["t"], ts)   # the time is kept
    got = base.apply_split({"t": ts}, "random", splits, None)
    want = jax_base.random_split(pd.DataFrame({"t": ts}), splits)
    np.testing.assert_array_equal(got["split"], want["split"].to_numpy())


def random_graph(seed, nodes=300, edges=1200):
    rng = np.random.RandomState(seed)
    return rng.randint(0, nodes, edges), rng.randint(0, nodes, edges), nodes


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("fanouts,max_edges,rng_seed", [
    ((100, 100), 4096, 3), ((5, 3), 4096, 11), ((4, 4), 40, 7),
    ((10,), 2048, 0)])
def test_node_sampling_equals_the_jax_engine(native, fanouts, max_edges,
                                             rng_seed):
    """Same graph, seeds (one repeated) and random seed: the same edges,
    local endpoints and nodes (seed nodes first in input order, the rest
    sorted), counts and drops, from the C++ engine and from the numpy
    path."""
    src, dst, n = random_graph(rng_seed)
    seeds = np.array([5, 17, 5, 250, 3, 99])
    got = GraphStore(src, dst, None, fanouts, num_nodes=n,
                     use_native=native).sample_nodes(
        seeds, "train", max_edges, 512, rng_seed)
    want = JaxStore(src, dst, None, fanouts=fanouts, num_nodes=n,
                    use_native=native).sample_nodes(
        seeds, "train", max_edges, 512, rng_seed)
    for field in ("edge_ids", "edge_index", "edge_mask", "node_ids",
                  "node_mask"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert (got.num_seeds, got.num_edges, got.num_nodes, got.num_dropped) \
        == (want.num_seeds, want.num_edges, want.num_nodes, want.num_dropped)
    np.testing.assert_array_equal(got.node_ids[:5], [5, 17, 250, 3, 99])
    assert got.num_dropped == 0 or max_edges == 40


@pytest.mark.parametrize("native", [True, False])
def test_node_sampling_raises_past_the_node_capacity(native):
    src, dst, n = random_graph(1)
    for store in (GraphStore(src, dst, None, (100, 100), num_nodes=n,
                             use_native=native),
                  JaxStore(src, dst, None, fanouts=(100, 100), num_nodes=n,
                           use_native=native)):
        with pytest.raises(RuntimeError, match="capacity"):
            store.sample_nodes(np.arange(20), "train", 8192, 16, 0)


@pytest.fixture(scope="module")
def elliptic_pair(tmp_path_factory):
    root = elliptic_dir(tmp_path_factory.mktemp("elliptic"))
    return (root, EllipticBitcoin(root, khop_neighbors=(8, 8)),
            JaxElliptic(root, khop_neighbors=(8, 8), channels=32))


def test_elliptic_tables_and_targets_equal_the_jax_ones(elliptic_pair):
    _, port, ref = elliptic_pair
    assert (port.ignore_label, port.n_classes) == (2, 2)
    assert (ref.ignore_label, ref.n_classes) == (2, 2)
    for table in ("nodes", "edges"):
        got = getattr(port, table).tensor_frame
        want = getattr(ref, table).tensor_frame
        assert {st.value: v for st, v in got.col_names.items()} == {
            st.value: v for st, v in want.col_names.items()}
        for st, feats in got.feats.items():
            want_st = next(k for k in want.feats if k.value == st.value)
            np.testing.assert_array_equal(feats, np.asarray(
                want.feats[want_st]))
    np.testing.assert_array_equal(port.nodes.tensor_frame.y,
                                  np.asarray(ref.nodes.tensor_frame.y))
    y = port.nodes.tensor_frame.y
    assert set(np.unique(y[:, 0])) <= {0.0, 1.0, 2.0}
    np.testing.assert_array_equal(y[:, 1], np.arange(len(y)))
    assert port.nodes.tensor_frame.feats[
        next(iter(port.nodes.tensor_frame.feats))].shape[1] == 166
    np.testing.assert_array_equal(port.nodes.columns["split"],
                                  ref.nodes.df["split"].to_numpy())
    np.testing.assert_array_equal(port.graph.src, ref.graph.src)
    np.testing.assert_array_equal(port.graph.dst, ref.graph.dst)
    np.testing.assert_array_equal(port.in_degree_histogram(),
                                  ref.in_degree_histogram())
    assert port.calibrate_capacities(64) == ref.calibrate_capacities(64)


def test_node_classification_head_matches_flax():
    x = np.random.RandomState(0).randn(13, 32).astype(np.float32)
    flax_head = JaxHead(2, 32, 0.0)
    variables = init_random(flax_head, jnp.asarray(x), seed=3)
    port = load_from_jax(NodeClassificationHead(2, 32, 0.0), variables)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(flax_head.apply(
        variables, jnp.asarray(x))), **TOL)


def test_tabgnn_node_forward_matches_jax(elliptic_pair, monkeypatch):
    """A test batch of the node task (S = 167 node tokens, S = 2 edge
    tokens, C = 32, 8 heads) through both models from the same randomized
    variables: the seed nodes fill node lanes [0, B) alike, the "unknown"
    rows leave seed_mask alike, and the logits agree. The reference's PNA
    sums go through its scatter path: its default path takes them as
    differences of one running float32 cumsum, which lands its logits here
    2.3e-5 off (``test_torch_transfer.py`` measures that path)."""
    monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")
    root, port_ds, jax_ds = elliptic_pair
    kw = dict(model="tabgnn", data=root, task="node_classification",
              batch_size=32, n_hidden=32, n_gnn_layers=2, num_neighs=(8, 8))
    jax_tr = JaxTrainer(JaxConfig(**kw, sampler="host"), jax_ds)
    variables = randomize_jax_variables(jax_tr.variables, 17)
    jax_gb = next(jax_tr._batches(jax_ds.nodes.split()[2], "test"))
    ref = jax_tr.model.apply(variables, jax_tr.edge_table, jax_tr.node_table,
                             jax_gb, False)
    tr = Trainer(Config(**kw, device="cpu"), port_ds)
    assert (tr.cfg.edge_capacity, tr.cfg.node_capacity) == (
        jax_tr.cfg.edge_capacity, jax_tr.cfg.node_capacity)
    load_from_jax(tr.model, variables)
    gb = next(tr._batches(port_ds.nodes.split()[2], "test"))
    np.testing.assert_array_equal(gb.node_gather, jax_gb.node_gather)
    np.testing.assert_array_equal(gb.seed_mask, jax_gb.seed_mask)
    assert gb.seed_mask.sum() < gb.seed_mask.size   # unknown rows left out
    with torch.no_grad():
        out = tr.model(tr.edge_table, tr.node_table, gb.to("cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    rec = load_record(RECORD)
    st = json.loads(str(rec["settings"]))
    root = str(tmp_path_factory.mktemp("record") / f"elliptic_{st['nodes']}")
    write_synthetic_node_dataset(root, num_nodes=st["nodes"],
                                 num_edges=st["edges"],
                                 num_feats=st["num_feats"],
                                 seed=st["data_seed"])
    return rec, st, root


def record_args(st: dict, root: str) -> list[str]:
    return ["--data", root, "--model", "tabgnn", "--n_hidden",
            str(st["n_hidden"]), "--n_gnn_layers", str(st["n_gnn_layers"]),
            "--num_neighs", *map(str, st["num_neighs"]), "--batch_size",
            str(st["batch_size"]), "--seed", str(st["seed"]), "--lr",
            str(st["lr"]), "--edge_capacity", str(st["edge_capacity"]),
            "--node_capacity", str(st["node_capacity"]), "--device", "cpu"]


def test_three_node_steps_match_the_jax_record(record):
    """The record's start (its variables from their shapes), three steps
    on the first three shuffled train batches (dropout 0), by
    ``check_record``'s float32 limits; the same parameters unmoved."""
    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    rec, st, root = record
    cfg = config_from_args(create_parser().parse_args(
        record_args(st, root) + ["--dropout", "0"]))
    assert cfg.task == "node_classification"
    tr = Trainer(cfg, build_dataset(cfg))
    tr.model.load_state_dict(from_jax(
        random_variables(st["shapes"], st["var_seed"]), tr.model))
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    batches = list(itertools.islice(
        tr._batches(tr.dataset.nodes.split()[0], "train", st["epoch"]),
        st["steps"]))
    tr.model.train()
    terms = [loss_terms(tr._step(gb.to(tr.device))[0], {})
             for gb in batches]
    state = tr.model.state_dict()
    faults, summary = check_record(state, terms, rec, "sup/", st["lr"],
                                   st["steps"], st["n_hidden"])
    assert not faults, (faults, summary)
    unmoved = {name for name, _ in tr.model.named_parameters()
               if torch.equal(state[name], before[name])}
    assert unmoved == {torch_key(k)[0] for k in st["unmoved"]}


@pytest.fixture(scope="module")
def served(record, tmp_path_factory):
    rec, st, root = record
    d = tmp_path_factory.mktemp("served")
    ckpt = save_checkpoint(str(d / "ckpt"), from_jax(
        random_variables(st["shapes"], st["var_seed"])))
    stats = {}
    out = predict.main(record_args(st, root) + [
        "--load_model", ckpt, "--split", "test", "--output",
        str(d / "preds.csv")], stats)
    return rec, st, root, out, stats


def test_predict_cli_serves_the_jax_records_nodes(served):
    rec, st, _, out, stats = served
    assert stats["rows"] == st["served_rows"] == len(rec["serve/id"])
    np.testing.assert_array_equal(out["id"], rec["serve/id"])
    np.testing.assert_array_equal(out["pred"], rec["serve/pred"])
    np.testing.assert_allclose(out["score"], rec["serve/score"], rtol=1e-4,
                               atol=1e-4)


def test_predict_skips_the_unknown_class_and_serves_node_ids(served):
    _, st, root, out, _ = served
    ds = EllipticBitcoin(root)
    y = ds.nodes.tensor_frame.y
    test = ds.nodes.split()[2].indices
    labelled = test[y[test, 0] != 2]
    assert sorted(out["id"].tolist()) == sorted(y[labelled, 1].astype(
        int).tolist())


def test_train_cli_then_predict_cli_on_the_cpu(tmp_path):
    """The training CLI trains the node task an epoch at small widths and
    saves; the predict CLI serves the checkpoint's test split."""
    root = elliptic_dir(tmp_path, nodes=300, edges=345, feats=20)
    args = ["--data", root, "--model", "tabgnn", "--n_hidden", "16",
            "--num_neighs", "8", "8", "--batch_size", "64", "--device",
            "cpu"]
    stats = {}
    history, _ = train_cli.main(args + [
        "--epochs", "1", "--testing", "--save_model", "--wandb_dir",
        str(tmp_path / "runs")], stats)
    (ep,) = history
    assert np.isfinite(ep["loss"]) and 0 <= ep["val_f1"] <= 1
    assert stats["split_rows"] == [180, 60, 60]
    out = predict.main(args + ["--load_model",
                               os.path.join(stats["run_dir"], "-1"),
                               "--output", str(tmp_path / "p.csv")])
    assert len(out["id"]) > 0 and np.isfinite(out["score"]).all()


def test_node_families_refuse_what_is_not_ported(tmp_path):
    from rmm_tpu_torch.datasets import build_dataset
    from rmm_tpu_torch.utils.config import config_from_args, create_parser

    root = elliptic_dir(tmp_path, nodes=50, edges=60, feats=4)

    def cfg(*extra):
        return config_from_args(create_parser().parse_args(
            ["--data", root, "--model", "tabgnn", "--device", "cpu",
             *extra]))

    # --ports and --ego are ported: the port columns, the EgoID column
    ports = build_dataset(cfg("--ports"))
    assert list(ports.edges.col_to_stype) == ["in_port", "out_port"]
    ego = build_dataset(cfg("--ego"))
    assert list(ego.nodes.col_to_stype)[-1] == "EgoID"
    # the pretraining targets of the node families stay refused: no entry
    # point reaches them
    with pytest.raises(NotImplementedError, match="pretraining"):
        build_dataset(cfg().replace(pretrain=("mask",)))
    # every split type is ported: cutoff takes the splits as cut-offs
    cut = EllipticBitcoin(root, split_type="cutoff", splits=(10, 30))
    ts = cut.nodes.columns["1"]
    assert (cut.nodes.columns["split"][ts < 10] == 0).all()
    assert (cut.nodes.columns["split"][ts > 30] == 2).all()
    # ogbn-arxiv is ported: its path dispatches to it
    with pytest.raises(FileNotFoundError, match="ogbn-arxiv"):
        build_dataset(cfg().replace(data=str(tmp_path / "ogbn-arxiv")))
