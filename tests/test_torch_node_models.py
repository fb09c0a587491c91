"""Node classification on every task wrapper of the PyTorch port
(``TT``, ``GNNWrap``, ``TABGNNS`` for ``tabgnn`` and
``tabgnninterleaved``, ``TABGNNFusedS``) against ``rmm_tpu``'s trainer on
the CPU, on small synthetic Ethereum phishing, ogbn-arxiv, MUSAE GitHub and
LastFM Asia sets: a served batch's logits from the same randomized
variables (every variable, BatchNorm statistics included, carried over by
``convert.from_jax`` strictly both ways), three train steps (dropout 0),
``--ports`` and ``--ego``, a ``cli/main.py --save_model`` epoch served by
``cli/predict.py`` (the served ids are the test split's nodes) and the
default device's refusal without CUDA.

The reference's PNA sums go through its scatter path
(``RMM_SEGMENT_IMPL=scatter``); ``cpnatab``'s fixed row dropout runs at 0
on both sides. Tolerances: served logits 1e-5 (float32, sums in another
order); the steps ``convert.check_states``' limits (each loss 1e-4
relative at step 1 and 1e-3 after, parameters 6.05·lr and each
component's median 0.05·lr), ``cpna`` and ``cpnatab`` too, with
``--ego`` and without it, at these widths (C = 16)."""
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.datasets import build_dataset as jax_build_dataset
from rmm_tpu.train.trainer import Trainer as JaxTrainer
from rmm_tpu.utils.config import config_from_args as jax_config_from_args
from rmm_tpu.utils.config import create_parser as jax_parser
from rmm_tpu_torch.cli import fused
from rmm_tpu_torch.cli import main as train_cli
from rmm_tpu_torch.cli import predict
from rmm_tpu_torch.convert import check_states, from_jax
from rmm_tpu_torch.datasets import build_dataset, write_synthetic_node_dataset
from rmm_tpu_torch.nn.decoders import NodeClassificationHead
from rmm_tpu_torch.nn.dropout import set_rate
from rmm_tpu_torch.train import task_models
from rmm_tpu_torch.train.trainer import Trainer
from rmm_tpu_torch.utils.config import config_from_args, create_parser
from tests.torch_port_util import jax_cpnatab_without_row_dropout, \
    load_from_jax, one_torch_thread, randomize_jax_variables  # noqa: F401

MODELS = ("fttransformer", "gin", "pna", "cpna", "cpnatab", "tabgnn",
          "tabgnninterleaved", "tabgnnfused")
FLAGS = ["--n_hidden", "16", "--num_neighs", "8", "8", "--batch_size",
         "32", "--task", "node_classification"]
#: family → (directory, nodes, edges, feature columns, classes)
DATA = {"eth": ("ethereum-phishing", 300, 1368, 8, 2),
        "ogbn": ("ogbn-arxiv", 200, 1378, 5, 40),
        "musae": ("musae-github", 150, 1150, 7, 2),
        "lastfm": ("lastfm-asia", 250, 912, 4, 18)}
#: (family, model, extra flags) of the served-batch and step comparisons
CASES = ([("eth", m, ()) for m in MODELS]
         + [("eth", "cpna", ("--ego",)), ("eth", "cpnatab", ("--ego",)),
            ("eth", "tabgnn", ("--ports",)), ("eth", "gin", ("--ports",)),
            ("ogbn", "tabgnn", ()), ("ogbn", "fttransformer", ()),
            ("ogbn", "tabgnnfused", ("--ports",)), ("musae", "cpna", ()),
            ("musae", "tabgnninterleaved", ("--ego",)),
            ("lastfm", "tabgnnfused", ()), ("lastfm", "pna", ())])


def case_id(case):
    family, model, extra = case
    return "-".join([family, model, *[e.strip("-") for e in extra]])


@pytest.fixture(autouse=True)
def scatter_sums_no_row_dropout(monkeypatch):
    monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")
    with jax_cpnatab_without_row_dropout():
        yield


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    d = tmp_path_factory.mktemp("node_models")
    return {family: write_synthetic_node_dataset(
        str(d / name), family=family, num_nodes=nodes, num_edges=edges,
        num_feats=feats, n_classes=classes, seed=5)
        for family, (name, nodes, edges, feats, classes) in DATA.items()}


def trainer_pair(root, model, extra, seed):
    """The reference's trainer and the port's on the same data and flags
    (the dataset's ``n_classes``, dropout 0), the port holding the
    reference's variables, randomized from ``seed``."""
    argv = ["--data", root, "--model", model, *FLAGS, *extra]
    jcfg = jax_config_from_args(jax_parser().parse_args(argv))
    jds = jax_build_dataset(jcfg)
    jtr = JaxTrainer(jcfg.replace(n_classes=jds.n_classes, dropout=0.0,
                                  sampler="host"), jds)
    jtr.variables = jax.tree_util.tree_map(
        jnp.asarray, randomize_jax_variables(jtr.variables, seed))
    jtr.opt_state = jtr.tx.init(jtr.variables["params"])
    cfg = config_from_args(create_parser().parse_args(
        argv + ["--device", "cpu"]))
    ds = build_dataset(cfg)
    tr = Trainer(cfg.replace(n_classes=ds.n_classes, dropout=0.0,
                             edge_capacity=jtr.cfg.edge_capacity,
                             node_capacity=jtr.cfg.node_capacity), ds)
    load_from_jax(tr.model, jax.tree_util.tree_map(np.asarray,
                                                   jtr.variables))
    set_rate(tr.model, 0.0)
    return jtr, jds, tr, ds


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_served_node_batch_matches_jax(roots, case):
    family, model, extra = case
    jtr, jds, tr, ds = trainer_pair(roots[family], model, extra, 31)
    assert isinstance(tr.model.decoder, NodeClassificationHead)
    jgb = next(jtr._batches(jds.nodes.split()[2], "test"))
    gb = next(tr._batches(ds.nodes.split()[2], "test"))
    np.testing.assert_array_equal(gb.node_gather, np.asarray(jgb.node_gather))
    np.testing.assert_array_equal(gb.edge_gather, np.asarray(jgb.edge_gather))
    ref = jtr.model.apply(jtr.variables, jtr.edge_table, jtr.node_table,
                          jgb, False)
    with torch.no_grad():
        out = tr.model(tr.edge_table, tr.node_table, gb.to("cpu"))
    assert out.shape == (32, DATA[family][4])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_three_node_steps_match_jax(roots, case):
    family, model, extra = case
    jtr, jds, tr, ds = trainer_pair(roots[family], model, extra, 41)
    jb = list(itertools.islice(
        jtr._batches(jds.nodes.split()[0], "train", 0), 3))
    pb = list(itertools.islice(tr._batches(ds.nodes.split()[0], "train", 0),
                               3))
    assert len(pb) == 3
    for a, b in zip(jb, pb):
        for field in ("edge_gather", "edge_mask", "edge_index",
                      "node_gather", "node_mask", "seed_mask", "y"):
            np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                          getattr(b, field), err_msg=field)
    key = jax.random.PRNGKey(0)
    jax_terms, terms = [], []
    tr.model.train()
    for a, b in zip(jb, pb):
        jtr.variables, jtr.opt_state, jl, _ = jtr._train_step(
            jtr.variables, jtr.opt_state, a, key, jtr.edge_table,
            jtr.node_table)
        jax_terms.append({"loss": float(jl)})
        terms.append({"loss": float(tr._step(b.to("cpu"))[0])})
    ref = from_jax(jax.tree_util.tree_map(np.asarray, jtr.variables),
                   tr.model)
    faults, summary = check_states(tr.model.state_dict(), terms, ref,
                                   jax_terms, tr.cfg.lr, 3, 16)
    assert not faults, (faults, summary)


def test_node_heads_take_the_node_states_width(roots):
    """Every wrapper's node head reads node states ``n_hidden`` wide, the
    column-wise ``cpna``/``cpnatab`` too (the reference declares
    ``num_edge_cols · n_hidden``, but its dense layers take their width
    from the input); ``TT`` builds no edge encoder for the task, as the
    reference's leaves none."""
    for model in MODELS:
        cfg = config_from_args(create_parser().parse_args(
            ["--data", roots["eth"], "--model", model, *FLAGS, "--device",
             "cpu"]))
        tr = Trainer(cfg, build_dataset(cfg))
        assert tr.model.decoder.mlp.fc1.in_features == 16, model
        assert hasattr(tr.model, "edge_encoder") == (model !=
                                                     "fttransformer")
    assert "mcm_edge_table" not in task_models.TT.TASKS


@pytest.mark.parametrize("model", MODELS)
def test_node_checkpoint_serves_through_predict(roots, model, tmp_path):
    args = ["--data", roots["eth"], "--model", model, *FLAGS, "--device",
            "cpu"]
    stats = {}
    history, best = train_cli.main(
        args + ["--epochs", "1", "--testing", "--save_model",
                "--wandb_dir", str(tmp_path)], stats)
    (rec,) = history
    assert np.isfinite(rec["loss"]) and best == rec["val_f1"]
    assert 0 <= rec["val_auc"] <= 1
    served = predict.main(args + [
        "--load_model", os.path.join(stats["run_dir"], "-1"),
        "--output", str(tmp_path / "p.csv")])
    cfg = config_from_args(create_parser().parse_args(args))
    test = build_dataset(cfg).nodes.split()[2]
    np.testing.assert_array_equal(served["id"], test.indices)
    assert np.isfinite(served["score"]).all()
    again = predict.main(args + [
        "--load_model", os.path.join(stats["run_dir"], "-1"),
        "--output", str(tmp_path / "q.csv")])
    for key in ("id", "pred", "score"):
        np.testing.assert_array_equal(served[key], again[key])


@pytest.mark.parametrize("family", ["ogbn", "musae", "lastfm"])
def test_family_checkpoint_serves_with_its_metrics(roots, family, tmp_path):
    """f1 is binary at 2 classes and support-weighted above, AUC and the
    served scores only at 2 (``rmm_tpu/train/trainer.py:543``, ``:610``);
    the served ids are the test split's nodes."""
    args = ["--data", roots[family], "--model", "tabgnn", *FLAGS,
            "--device", "cpu"]
    stats = {}
    (rec,), _ = train_cli.main(args + ["--epochs", "1", "--testing",
                                       "--save_model", "--wandb_dir",
                                       str(tmp_path)], stats)
    binary = DATA[family][4] == 2
    assert ("val_auc" in rec) == binary and 0 <= rec["val_f1"] <= 1
    served = predict.main(args + [
        "--load_model", os.path.join(stats["run_dir"], "0"), "--output",
        str(tmp_path / "p.csv")])
    assert ("score" in served) == binary
    assert served["pred"].max() < DATA[family][4]
    cfg = config_from_args(create_parser().parse_args(args))
    np.testing.assert_array_equal(
        served["id"], build_dataset(cfg).nodes.split()[2].indices)


@pytest.mark.parametrize("family", list(DATA))
@pytest.mark.parametrize("extra", [(), ("--ports", "--ego")])
def test_node_paths_need_cuda_unless_asked_for_cpu(roots, family, extra,
                                                   tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    args = ["--data", roots[family], "--model", "tabgnn", *FLAGS, *extra,
            "--wandb_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(args + ["--load_model", str(tmp_path)])
    if family == "eth":
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fused.main(["--dataset", roots[family], "--wandb_dir",
                        str(tmp_path), *extra])
