"""The tabular MCM entry point (``rmm_tpu_torch.cli.fttransformer``,
``train/tabular.py``) on the CPU against ``rmm_tpu``'s
``TabularMCMTrainer``, plain and with ``--mask_vector``: the same batches,
three AdamW steps (dropout 0) from the same randomized JAX variables, the
evaluation's accuracy, RMSE and mask-vector accuracy; the CLI's save,
resume and best-metric files; a JAX msgpack tabular checkpoint read by
``restore`` (its optimizer state not read); and the default device's
refusal without CUDA.

Tolerances: the three steps ``convert.check_states``' limits (each loss
1e-4 relative at step 1 and 1e-3 after, parameters 6.05·lr and each
component's median 0.05·lr); evaluation metrics 1e-6 relative.
"""
import itertools
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
from rmm_tpu.datasets import write_synthetic_aml_csv
from rmm_tpu.datasets.base import PretrainType as JaxPretrainType
from rmm_tpu.train.tabular import TabularMCMTrainer as JaxTabular
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.cli import fttransformer
from rmm_tpu_torch.convert import check_states, from_jax, tabular_variables
from rmm_tpu_torch.datasets import IBMTransactionsAML
from rmm_tpu_torch.datasets.base import PretrainType
from rmm_tpu_torch.nn.transformer import MultiHeadSelfAttention
from rmm_tpu_torch.train.tabular import TabularMCMTrainer
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import one_torch_thread, \
    randomize_jax_variables  # noqa: F401

KW = dict(model="fttransformer", batch_size=64, n_hidden=16, n_gnn_layers=2,
          dropout=0.0, lr=2e-4, weight_decay=1e-3)


@pytest.fixture(scope="module")
def aml_csv(tmp_path_factory):
    csv = str(tmp_path_factory.mktemp("tabular") / "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=1000, num_accounts=62, seed=3)
    return csv


def trainer_pair(csv, mask_vector, seed):
    """The reference's tabular trainer and the port's on the same data,
    the port holding the reference's variables, randomized from
    ``seed``."""
    jds = JaxAML(csv, pretrain={JaxPretrainType.MASK}, channels=16)
    jtr = JaxTabular(JaxConfig(data=csv, **KW), jds.edges,
                     mask_vector=mask_vector)
    jtr.params = jax.tree_util.tree_map(
        jnp.asarray, randomize_jax_variables(jtr.params, seed))
    jtr.opt_state = jtr.tx.init(jtr.params)
    ds = IBMTransactionsAML(csv, pretrain={PretrainType.MASK})
    tr = TabularMCMTrainer(Config(data=csv, **KW, device="cpu"), ds.edges,
                           mask_vector=mask_vector)
    tr.model.load_state_dict(from_jax(tabular_variables(
        jax.tree_util.tree_map(np.asarray, jtr.params)), tr.model))
    return jtr, jds, tr, ds


@pytest.mark.parametrize("mask_vector", [False, True], ids=["mcm", "mv"])
def test_three_steps_and_the_evaluation_match_jax(aml_csv, mask_vector):
    jtr, jds, tr, ds = trainer_pair(aml_csv, mask_vector, 5)
    jtrain, jval, _ = jds.edges.split()
    train, val, _ = ds.edges.split()
    # the attention rows: [batch, the edge table's columns + CLS, C]
    rows = []
    hooks = [m.register_forward_pre_hook(lambda _, a: rows.append(
        tuple(a[0].shape))) for m in tr.model.modules()
        if isinstance(m, MultiHeadSelfAttention)]
    tf, _, _, _ = next(tr._batches(train, False))
    with torch.no_grad():
        tr.model(tf)
    for h in hooks:
        h.remove()
    assert rows == [(KW["batch_size"], tf.num_cols + 1, KW["n_hidden"])] * 2
    tr.model.train()
    jax_terms, terms = [], []
    for (jtf, valid), (ptf, mask, pvalid, _) in zip(
            itertools.islice(jtr._loader(jtrain, True, 0), 3),
            itertools.islice(tr._batches(train, True, 0), 3)):
        assert valid == pvalid
        np.testing.assert_array_equal(np.asarray(jtf.y), ptf.y.numpy())
        jmask = np.arange(KW["batch_size"]) < valid
        jtr.params, jtr.opt_state, loss, _ = jtr._train_step(
            jtr.params, jtr.opt_state, jtf, jmask, jax.random.PRNGKey(0))
        jax_terms.append({"loss": float(loss)})
        terms.append({"loss": float(tr._step(ptf, mask)[0])})
    ref = from_jax(tabular_variables(jax.tree_util.tree_map(
        np.asarray, jtr.params)), tr.model)
    faults, summary = check_states(tr.model.state_dict(), terms, ref,
                                   jax_terms, KW["lr"], 3, KW["n_hidden"])
    assert not faults, (faults, summary)
    # the evaluation from the same weights
    tr.model.load_state_dict(ref)
    want, got = jtr.evaluate(jval), tr.evaluate(val)
    assert set(got) == set(want) == (
        {"accuracy", "rmse", "mv_accuracy"} if mask_vector
        else {"accuracy", "rmse"})
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def argv(csv, wandb, *extra):
    return ["--dataset", csv, "--epochs", "1", "--testing", "--device",
            "cpu", "--channels", "16", "--num_layers", "2", "--batch_size",
            "64", "--wandb_dir", wandb, *extra]


@pytest.mark.parametrize("mask_vector", [False, True], ids=["mcm", "mv"])
def test_cli_saves_resumes_and_keeps_the_best(aml_csv, tmp_path,
                                              mask_vector):
    mv = ["--mask_vector"] if mask_vector else []
    wandb = str(tmp_path / "runs")
    stats = {}
    history, best = fttransformer.main(argv(aml_csv, wandb, "--save_model",
                                            *mv), stats)
    (rec,) = history
    run_dir = stats["run_dir"]
    assert run_dir == os.path.join(wandb, "run_fttransformer")
    assert rec["epoch"] == 0 and np.isfinite(rec["loss"])
    assert 0 <= rec["val_accuracy"] <= 1 and np.isfinite(rec["val_rmse"])
    assert ("val_mv_accuracy" in rec) == mask_vector
    if mask_vector:
        assert 0 <= rec["val_mv_accuracy"] <= 1
    assert best == {"accuracy": rec["val_accuracy"],
                    "rmse": rec["val_rmse"]}
    assert {"0", "best_acc", "best_rmse"} <= set(os.listdir(run_dir))
    ck = os.path.join(run_dir, "0")
    assert {"model.pt", "optimizer.pt", "best_m.json", "meta.json"} <= set(
        os.listdir(ck))
    assert not os.path.exists(os.path.join(run_dir, "best_acc",
                                           "optimizer.pt"))
    with open(os.path.join(ck, "best_m.json")) as f:
        assert json.load(f)["best_m"] == best
    resumed, best2 = fttransformer.main(argv(aml_csv, wandb, "--checkpoint",
                                             ck, *mv))
    assert [h["epoch"] for h in resumed] == [1]
    assert os.path.isdir(os.path.join(run_dir, "1"))
    assert not os.path.exists(ck)       # the previous epoch pruned
    assert best2["accuracy"] >= best["accuracy"]
    assert best2["rmse"] <= best["rmse"]


@pytest.mark.parametrize("mask_vector", [False, True], ids=["mcm", "mv"])
def test_restore_reads_a_jax_tabular_checkpoint(aml_csv, tmp_path, caplog,
                                                mask_vector):
    """``TabularMCMTrainer.save`` of the reference (msgpack components
    ``edge_encoder``, ``model``, ``head``, its ``opt_state`` and
    ``best_m.json``) loads into the port with every entry, its best
    metrics read and its optimizer state not."""
    jtr, _, tr, _ = trainer_pair(aml_csv, mask_vector, 11)
    jtr.params = jax.tree_util.tree_map(
        jnp.asarray, randomize_jax_variables(jtr.params, 12))
    best = {"accuracy": 0.25, "rmse": 3.5}
    ck = jtr.save(str(tmp_path / "jax_run"), 4, best)
    assert os.path.exists(os.path.join(ck, "opt_state"))
    tr.model.load_state_dict({k: torch.zeros_like(v) for k, v in
                              tr.model.state_dict().items()})
    with caplog.at_level(logging.WARNING):
        got = tr.restore(ck)
    assert got == best
    assert "optimizer state is not read" in caplog.text
    want = from_jax(tabular_variables(jax.tree_util.tree_map(
        np.asarray, jtr.params)), tr.model)
    state = tr.model.state_dict()
    assert set(state) == set(want)
    for k, v in want.items():
        assert torch.equal(state[k], v), k


def test_a_checkpoint_of_the_other_head_is_refused(aml_csv, tmp_path):
    wandb = str(tmp_path / "runs")
    stats = {}
    fttransformer.main(argv(aml_csv, wandb, "--save_model"), stats)
    with pytest.raises(RuntimeError, match="mask_vector_decoder"):
        fttransformer.main(argv(aml_csv, wandb, "--mask_vector",
                                "--checkpoint",
                                os.path.join(stats["run_dir"], "0")))


@pytest.mark.parametrize("mask_vector", [False, True], ids=["mcm", "mv"])
def test_cli_needs_cuda_unless_asked_for_cpu(aml_csv, tmp_path,
                                             mask_vector):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    args = ["--dataset", aml_csv, "--wandb_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fttransformer.main(args + (["--mask_vector"] if mask_vector
                                   else []))
