"""Node classification across the model menu and the other node datasets
on the CPU against the JAX record that ``chip_smoke.py``'s
``node_family_parity`` phase holds the card to
(``tests/fixtures/torch_port/node_family_record.npz``, written by
``tools/make_torch_port_node_family_fixture.py``: the supervised
launcher's widths, C = 32, 8 heads, 2 layers, fanouts 100/100, batch 200,
dropout 0, on synthetic Ethereum phishing, ogbn-arxiv, MUSAE GitHub and
LastFM Asia cuts).

From the record's start, per run: the first test batch served (the same
seed-node ids, logits within 1e-4: PNA sums in another order) and three
train steps within ``convert.check_record``'s float32 limits (each loss
1e-4 relative at step 1 and 1e-3 after, parameters 6.05·lr and each
component's median 0.05·lr), the same parameters unmoved. ``cpna`` and
``cpnatab`` hold those default limits with ``--ego``; without it (every
node token the constant ``node_attr``) they are held to
``convert.CPNA_*``, and to nothing wider. Then three mcm-lp steps on the
Ethereum data through the SSL CLI's dispatch at the SSL widths (batch 64;
each loss term, the first batch's negatives equal) and the MCM accuracy of
a table with no categorical masked column over an evaluated batch: 0, as
the reference reports it. A step planted wrong (a component's last update
skipped) fails the record."""
import itertools
import json
import os

import numpy as np
import pytest
import torch

from rmm_tpu_torch.cli import fused
from rmm_tpu_torch.convert import (check_record, from_jax, load_record,
                                   loss_terms, random_variables, torch_key)
from rmm_tpu_torch.datasets import build_dataset, write_synthetic_node_dataset
from rmm_tpu_torch.frame.dataset import DatasetView
from rmm_tpu_torch.nn.dropout import set_rate
from rmm_tpu_torch.train.pretrain import PretrainTrainer
from rmm_tpu_torch.train.trainer import Trainer
from rmm_tpu_torch.utils.config import config_from_args, create_parser
from tests.torch_port_util import one_torch_thread  # noqa: F401

RECORD = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port",
                      "node_family_record.npz")
LOGIT_TOL = 1e-4
REC = load_record(RECORD)
ST = json.loads(str(REC["settings"]))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("node_family")
    out = {}
    for name, d in ST["data"].items():
        out[name] = write_synthetic_node_dataset(
            str(base / f"{d['dir']}_{d['nodes']}"), family=d["family"],
            num_nodes=d["nodes"], num_edges=d["edges"],
            num_feats=d["num_feats"], n_classes=d["n_classes"],
            seed=ST["data_seed"])
    return out


def run_argv(root: str, run: dict) -> list:
    return ["--data", root, "--model", run["model"], "--task",
            "node_classification", "--n_hidden", str(ST["n_hidden"]),
            "--n_gnn_layers", str(ST["n_gnn_layers"]), "--num_neighs",
            *map(str, ST["num_neighs"]), "--batch_size",
            str(ST["batch_size"]), "--seed", str(ST["seed"]), *run["flags"]]


def limits_of(run: dict):
    """``check_record``'s ``model``: the CPNA limits for ``cpna`` and
    ``cpnatab`` without ``--ego``, the default ones otherwise."""
    return None if "--ego" in run["flags"] else run["model"]


def record_steps(roots, name: str, skip: str = ""):
    """A record run on the CPU from the record's start: (its config, the
    trainer, the first test batch's served ids and logits, the three
    steps' loss terms, the state before them). ``skip`` plants a
    fault: the parameters of that component (``decoder``, the node head;
    ``node_encoder``; ...) keep their values through the last step."""
    run = ST["runs"][name]
    cfg = config_from_args(create_parser().parse_args(
        run_argv(roots[run["data"]], run) + ["--device", "cpu"]))
    cfg = cfg.replace(dropout=0.0, **ST["capacities"][run["data"]])
    ds = build_dataset(cfg)
    tr = Trainer(cfg.replace(n_classes=ds.n_classes), ds)
    assert (tr.cfg.lr, tr.cfg.n_classes) == (run["lr"], run["n_classes"])
    tr.model.load_state_dict(from_jax(
        random_variables(run["shapes"], ST["var_seed"]), tr.model))
    set_rate(tr.model, 0.0)
    train, _, test = ds.nodes.split()

    gb = next(tr._batches(test, "test"))
    with torch.no_grad():
        logits = tr._logits(gb.to("cpu")).numpy()[gb.seed_mask]
    ids = gb.node_gather[:cfg.batch_size][gb.seed_mask]

    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.model.train()
    batches = list(itertools.islice(tr._batches(train, "train", ST["epoch"]),
                                    ST["steps"]))
    terms = []
    for i, b in enumerate(batches):
        held = {n: p.detach().clone() for n, p in tr.model.named_parameters()
                if skip and n.split(".")[0] == skip
                and i == len(batches) - 1}
        terms.append(loss_terms(tr._step(b.to("cpu"))[0], {}))
        with torch.no_grad():
            for n, p in tr.model.named_parameters():
                if n in held:
                    p.copy_(held[n])
    return cfg, tr, ids, logits, terms, before


@pytest.mark.parametrize("name", sorted(ST["runs"]))
def test_node_family_record_on_the_cpu(roots, name):
    run = ST["runs"][name]
    cfg, tr, ids, logits, terms, before = record_steps(roots, name)
    state = tr.model.state_dict()
    np.testing.assert_array_equal(ids, REC[f"{name}/serve/id"])
    np.testing.assert_allclose(logits, REC[f"{name}/serve/logits"], rtol=0,
                               atol=LOGIT_TOL)
    faults, summary = check_record(state, terms, REC, f"{name}/", cfg.lr,
                                   ST["steps"], ST["n_hidden"],
                                   model=limits_of(run))
    assert not faults, (faults, summary)
    unmoved = {n for n, _ in tr.model.named_parameters()
               if torch.equal(state[n], before[n])}
    assert unmoved == {torch_key(k)[0] for k in run["unmoved"]}


#: planted faults that the record must catch at its sampled entries: the
#: run and the component whose last step is skipped. ``cpna`` (held to
#: ``convert.CPNA_*``: its node encoder sees only the constant
#: ``node_attr``, so its parameters move on rounding-level gradients) and
#: ``ogbn`` (the run whose ``model`` median sits nearest its limit, with the
#: 40-class node head)
PLANTED = [("cpna", "node_encoder"), ("cpna", "decoder"),
           ("ogbn", "decoder"), ("ogbn", "node_encoder")]


@pytest.mark.parametrize("name,skip", PLANTED)
def test_a_skipped_step_fails_the_record(roots, name, skip):
    run = ST["runs"][name]
    cfg, tr, _, _, terms, _ = record_steps(roots, name, skip)
    faults, summary = check_record(tr.model.state_dict(), terms, REC,
                                   f"{name}/", cfg.lr, ST["steps"],
                                   ST["n_hidden"], model=limits_of(run))
    assert any(f.startswith(f"median parameter error of {skip}:")
               for f in faults), (faults, summary)


def test_cpna_models_hold_the_default_limits_only_with_ego():
    """The record's split of limits, as the test above applies it."""
    runs = ST["runs"]
    assert limits_of(runs["cpna_ego"]) is None
    assert limits_of(runs["cpnatab_ego"]) is None
    assert limits_of(runs["cpna"]) == "cpna"
    assert limits_of(runs["cpnatab"]) == "cpnatab"


@pytest.fixture(scope="module")
def ssl_trainer(roots):
    ssl = ST["ssl"]
    cfg = fused.config_from_args(fused.build_parser().parse_args([
        "--dataset", roots["eth"], "--mode", "mcm-lp", "--channels",
        str(ssl["channels"]), "--num_layers", str(ssl["num_layers"]),
        "--num_neg_samples", str(ssl["num_neg_samples"]), "--batch_size",
        str(ssl["batch_size"]), "--khop_neighbors",
        *map(str, ssl["khop_neighbors"]), "--dropout", "0", "--lr",
        str(ssl["lr"]), "--device", "cpu"])).replace(
        edge_capacity=ssl["edge_capacity"],
        node_capacity=ssl["node_capacity"], seed=ST["seed"])
    tr = PretrainTrainer(cfg, fused.build_ssl_dataset(cfg), "mcm-lp")
    tr.model.load_state_dict(from_jax(
        random_variables(ssl["shapes"], ST["var_seed"]), tr.model))
    return tr


def test_eth_mcm_lp_steps_match_the_record(ssl_trainer):
    tr = ssl_trainer
    ssl = ST["ssl"]
    batches = list(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", ST["epoch"]),
        ST["steps"]))
    np.testing.assert_array_equal(batches[0].neg_edge_index,
                                  REC["ssl/neg0"])
    tr.model.train()
    terms = [loss_terms(*tr._step(gb.to("cpu"))) for gb in batches]
    faults, summary = check_record(tr.model.state_dict(), terms, REC, "ssl/",
                                   ssl["lr"], 2 * ST["steps"],
                                   ssl["channels"])
    assert not faults, (faults, summary)
    # no categorical masked column: no categorical loss term
    assert all(t["mcm_cat"] == 0.0 for t in terms)


def test_mcm_accuracy_without_a_categorical_column(ssl_trainer):
    """Ethereum phishing masks four numerical columns and no categorical
    one: the accuracy over no categorical cell is 0 on both sides, and the
    evaluation reports the same keys."""
    tr = ssl_trainer
    assert tr.dataset.edges.masked_categorical_columns == []
    view = tr.dataset.edges.split()[1]
    val = tr.evaluate(DatasetView(view.parent,
                                  view.indices[:tr.cfg.batch_size]), "val")
    assert val["accuracy"] == ST["ssl"]["val_accuracy"] == 0.0
    assert sorted(val) == ST["ssl"]["val_keys"]
    assert np.isfinite(val["rmse"]) and 0 < val["mrr"] <= 1
