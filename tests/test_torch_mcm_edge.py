"""The supervised CLI's masked-cell task (``--task mcm_edge_table``) on the
CPU against ``rmm_tpu``'s ``Trainer``, for the seven wrappers that have
the branch (``tabgnn``, ``tabgnninterleaved``, ``gin``, ``pna``, ``cpna``,
``cpnatab``, ``tabgnnfused``): the MCM outputs of a validation batch from
the same randomized JAX variables, the same MCM batches, and three Adam
steps (dropout 0, ``--emlps``); ``fttransformer``'s refusal, as the
reference's ``TT`` has no such branch; the CLI's epoch (metrics, the best
rule, checkpoints) and the predict CLI's refusal of an MCM checkpoint;
the default device's refusal without CUDA.

The reference's PNA sums go through its scatter path
(``RMM_SEGMENT_IMPL=scatter``); ``cpnatab``'s fixed row dropout runs at 0
on both sides. ``cpna`` and ``cpnatab`` take their steps with ``--ego``:
without it every node feature is one, the node encoder's gradient lies in
the BatchNorms' degenerate directions and is rounding noise, which Adam
turns into ±lr steps, so float32 runs of the reference and of the port
alike land 0.15-0.28·lr (median) from a float64 run of the port in the
node encoder there, against 0.02-0.04·lr with the ego flag (this file's
data and seeds).

Tolerances: outputs 1e-4; the three steps ``convert.check_states``'
limits (each loss 1e-4 relative at step 1 and 1e-3 after, parameters
6.05·lr and each component's median 0.05·lr, BatchNorm statistics by the
updates they made).
"""
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
from rmm_tpu.datasets import write_synthetic_aml_csv
from rmm_tpu.datasets.base import PretrainType as JaxPretrainType
from rmm_tpu.train.trainer import Trainer as JaxTrainer
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.cli import main as train_cli
from rmm_tpu_torch.cli import predict
from rmm_tpu_torch.convert import LOSS_RTOL, check_states, from_jax
from rmm_tpu_torch.datasets import build_dataset
from rmm_tpu_torch.nn.decoders import MCMHead
from rmm_tpu_torch.nn.dropout import set_rate
from rmm_tpu_torch.train.trainer import (MCM_SUMS, Trainer,
                                         build_task_model, mcm_improves)
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import jax_cpnatab_without_row_dropout, \
    one_torch_thread, randomize_jax_variables  # noqa: F401

MODELS = ("tabgnn", "tabgnninterleaved", "gin", "pna", "cpna", "cpnatab",
          "tabgnnfused")
KW = dict(batch_size=32, n_hidden=16, n_gnn_layers=2, num_neighs=(8, 8),
          dropout=0.0, emlps=True, task="mcm_edge_table")
#: the models whose steps run with the ego flag (see above)
EGO = ("cpna", "cpnatab")


@pytest.fixture(autouse=True)
def scatter_sums_no_row_dropout(monkeypatch):
    monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")
    with jax_cpnatab_without_row_dropout():
        yield


@pytest.fixture(scope="module")
def aml_csv(tmp_path_factory):
    csv = str(tmp_path_factory.mktemp("mcm_edge") / "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=1000, num_accounts=62, seed=3)
    return csv


def trainer_pair(csv, model, seed, ego=False):
    """The reference's trainer and the port's under ``mcm_edge_table`` on
    the same data (the MASK and LINK_PRED targets), the port holding the
    reference's variables, randomized from ``seed``."""
    kw = dict(KW, ego=ego)
    jds = JaxAML(csv, khop_neighbors=kw["num_neighs"], channels=16, ego=ego,
                 pretrain={JaxPretrainType.MASK, JaxPretrainType.LINK_PRED})
    jtr = JaxTrainer(JaxConfig(data=csv, model=model, **kw), jds)
    jtr.variables = jax.tree_util.tree_map(
        jnp.asarray, randomize_jax_variables(jtr.variables, seed))
    jtr.opt_state = jtr.tx.init(jtr.variables["params"])
    cfg = Config(data=csv, model=model, **kw, device="cpu")
    ds = build_dataset(cfg)
    tr = Trainer(cfg, ds)
    tr.model.load_state_dict(from_jax(jax.tree_util.tree_map(
        np.asarray, jtr.variables), tr.model))
    set_rate(tr.model, 0.0)
    return jtr, jds, tr, ds


@pytest.mark.parametrize("model", MODELS)
def test_mcm_outputs_match_jax(aml_csv, model):
    jtr, jds, tr, ds = trainer_pair(aml_csv, model, 7)
    width = 3 if model not in ("cpna", "cpnatab") else (
        ds.edges.tensor_frame.num_cols + 2)
    assert isinstance(tr.model.decoder, MCMHead)
    assert tr.model.decoder.num_norm.weight.shape[0] == width * KW[
        "n_hidden"]
    jgb = next(jtr._batches(jds.edges.split()[1], "val"))
    gb = next(tr._batches(ds.edges.split()[1], "val"))
    np.testing.assert_array_equal(np.asarray(jgb.y), gb.y)
    jnum, jcat = jtr.model.apply(jtr.variables, jtr.edge_table,
                                 jtr.node_table, jgb, False)
    with torch.no_grad():
        num, cat = tr.model(tr.edge_table, tr.node_table, gb.to("cpu"))
    assert len(cat) == len(jcat)
    for got, want in zip([num, *cat], [jnum, *jcat]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model", MODELS)
def test_three_mcm_steps_match_jax(aml_csv, model):
    jtr, jds, tr, ds = trainer_pair(aml_csv, model, 7, ego=model in EGO)
    jb = list(itertools.islice(
        jtr._batches(jds.edges.split()[0], "train", 0), 3))
    pb = list(itertools.islice(tr._batches(ds.edges.split()[0], "train", 0),
                               3))
    key = jax.random.PRNGKey(0)
    jax_terms, terms = [], []
    tr.model.train()
    for i, (a, b) in enumerate(zip(jb, pb)):
        for field in ("edge_gather", "edge_index", "seed_mask", "y"):
            np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                          getattr(b, field), err_msg=field)
        jtr.variables, jtr.opt_state, jl, jaux = jtr._train_step(
            jtr.variables, jtr.opt_state, a, key, jtr.edge_table,
            jtr.node_table)
        loss, aux = tr._step(b.to("cpu"))
        jax_terms.append({"loss": float(jl)})
        terms.append({"loss": float(loss)})
        # the step's sums (loss_c, t_c, acc, loss_n, t_n), at the loss's
        # limit of the step
        np.testing.assert_allclose(
            aux["sums"].numpy(), [float(jaux[k]) for k in MCM_SUMS],
            rtol=LOSS_RTOL[min(i, 1)])
    ref = from_jax(jax.tree_util.tree_map(np.asarray, jtr.variables),
                   tr.model)
    faults, summary = check_states(tr.model.state_dict(), terms, ref,
                                   jax_terms, tr.cfg.lr, 3, KW["n_hidden"])
    assert not faults, (faults, summary)


def test_fttransformer_refuses_the_task_by_name(aml_csv):
    ds = build_dataset(Config(data=aml_csv, **KW, model="fttransformer"))
    with pytest.raises(NotImplementedError,
                       match="'mcm_edge_table'.*'fttransformer'"):
        build_task_model(Config(data=aml_csv, model="fttransformer", **KW),
                         ds)


def argv(csv, model, *extra):
    return ["--data", csv, "--model", model, "--task", "mcm_edge_table",
            "--n_hidden", "16", "--num_neighs", "8", "8", "--batch_size",
            "32", "--device", "cpu", *extra]


@pytest.mark.parametrize("model", ["tabgnn", "tabgnnfused"])
def test_cli_epoch_keeps_the_reference_best_rule(aml_csv, tmp_path, model):
    """An epoch through the training CLI: the train and evaluation
    metrics, ``best_m = [val_rmse, val_acc]`` after the first epoch (the
    reference's start ``[1000, -1]`` always improves), the checkpoints; a
    resume keeps the rule's best."""
    stats = {}
    history, best = train_cli.main(argv(
        aml_csv, model, "--epochs", "1", "--testing", "--save_model",
        "--wandb_dir", str(tmp_path)), stats)
    (rec,) = history
    for key in ("train_rmse", "val_rmse", "test_rmse"):
        assert np.isfinite(rec[key]) and rec[key] >= 0, key
    for key in ("train_acc", "val_acc", "test_acc"):
        assert 0 <= rec[key] <= 1, key
    assert "f1" not in rec and rec["best"] is True
    assert best == [rec["val_rmse"], rec["val_acc"]]
    ck = os.path.join(stats["run_dir"], "0")
    assert {"0", "-1"} <= set(os.listdir(stats["run_dir"]))
    with open(os.path.join(ck, "best_m.json")) as f:
        assert json.load(f)["best_m"] == best
    resumed, best2 = train_cli.main(argv(
        aml_csv, model, "--epochs", "1", "--testing", "--checkpoint",
        "--load_model", ck, "--wandb_dir", str(tmp_path)))
    assert [h["epoch"] for h in resumed] == [1]
    val = [resumed[0]["val_rmse"], resumed[0]["val_acc"]]
    assert best2 == (val if mcm_improves(val, best) else best)


def test_predict_cli_refuses_an_mcm_checkpoint(aml_csv, tmp_path):
    stats = {}
    train_cli.main(argv(aml_csv, "tabgnn", "--epochs", "1", "--testing",
                        "--wandb_dir", str(tmp_path)), stats)
    ck = os.path.join(stats["run_dir"], "0")
    out = str(tmp_path / "p.csv")
    with pytest.raises(ValueError, match="MCM is a pretraining objective"):
        predict.main(argv(aml_csv, "tabgnn", "--load_model", ck,
                          "--output", out))
    # as a classifier the checkpoint does not load: its head is MCM's
    with pytest.raises(RuntimeError, match="decoder"):
        predict.main(["--data", aml_csv, "--model", "tabgnn", "--n_hidden",
                      "16", "--num_neighs", "8", "8", "--batch_size", "32",
                      "--device", "cpu", "--load_model", ck, "--output",
                      out])
    assert not os.path.exists(out)


@pytest.mark.parametrize("model", ["tabgnn", "gin", "tabgnnfused"])
def test_cli_needs_cuda_unless_asked_for_cpu(aml_csv, tmp_path, model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--data", aml_csv, "--model", model, "--task",
                        "mcm_edge_table", "--wandb_dir", str(tmp_path)])
