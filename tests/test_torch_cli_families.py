"""The model families ``fttransformer``, ``gin``, ``pna``, ``cpna``,
``cpnatab`` and ``tabgnninterleaved`` through the port's trainer and CLIs
on the CPU, against ``rmm_tpu``'s trainer on the same data: a served
batch's logits from the same randomized variables, three train steps
(dropout 0, ``--emlps`` on), a ``cli/main.py --save_model`` epoch served
by ``cli/predict.py``, and the default device's refusal without CUDA.

The reference's PNA sums go through its scatter path
(``RMM_SEGMENT_IMPL=scatter``, as in ``test_torch_node.py``). ``cpnatab``'s
row attention has a fixed dropout of 0.1 that no flag reaches; the steps
run it at 0 on both sides (``nn.dropout.set_rate`` on the port,
``jax_cpnatab_without_row_dropout`` on the reference).

Tolerances: served logits 1e-5 (float32, sums in another order); the
three steps ``convert.check_states``' limits (each loss 1e-4 relative at
step 1 and 1e-3 after, parameters 6.05·lr and each component's median
0.05·lr, BatchNorm statistics by the updates they made).
"""
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
from rmm_tpu.datasets import write_synthetic_aml_csv
from rmm_tpu.train.trainer import Trainer as JaxTrainer
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.cli import main as train_cli
from rmm_tpu_torch.cli import predict
from rmm_tpu_torch.convert import check_states, from_jax
from rmm_tpu_torch.datasets import IBMTransactionsAML
from rmm_tpu_torch.nn.dropout import set_rate
from rmm_tpu_torch.train.trainer import Trainer
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import jax_cpnatab_without_row_dropout, \
    load_from_jax, one_torch_thread, randomize_jax_variables  # noqa: F401

FAMILIES = ("fttransformer", "gin", "pna", "cpna", "cpnatab",
            "tabgnninterleaved")
KW = dict(batch_size=32, n_hidden=16, n_gnn_layers=2, num_neighs=(8, 8),
          dropout=0.0, emlps=True)


@pytest.fixture(autouse=True)
def scatter_sums_no_row_dropout(monkeypatch):
    """The reference's scatter PNA sums and, as the reference builds its
    modules at every trace, its ``CPNATAB`` row dropout at 0 for the whole
    test."""
    monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")
    with jax_cpnatab_without_row_dropout():
        yield


@pytest.fixture(scope="module")
def aml_csv(tmp_path_factory):
    csv = str(tmp_path_factory.mktemp("families") / "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=1000, num_accounts=62, seed=3)
    return csv


def trainer_pair(csv, model, seed):
    """The reference's trainer and the port's on the same data, the port
    holding the reference's variables, randomized from ``seed``."""
    jds = JaxAML(csv, khop_neighbors=KW["num_neighs"], channels=16)
    jtr = JaxTrainer(JaxConfig(data=csv, model=model, **KW), jds)
    jtr.variables = jax.tree_util.tree_map(
        jnp.asarray, randomize_jax_variables(jtr.variables, seed))
    jtr.opt_state = jtr.tx.init(jtr.variables["params"])
    ds = IBMTransactionsAML(csv, khop_neighbors=KW["num_neighs"])
    tr = Trainer(Config(data=csv, model=model, **KW, device="cpu"), ds)
    load_from_jax(tr.model, jax.tree_util.tree_map(np.asarray,
                                                   jtr.variables))
    set_rate(tr.model, 0.0)
    return jtr, jds, tr, ds


@pytest.mark.parametrize("model", FAMILIES)
def test_served_batch_matches_jax(aml_csv, model):
    jtr, jds, tr, ds = trainer_pair(aml_csv, model, 31)
    jgb = next(jtr._batches(jds.edges.split()[2], "test"))
    gb = next(tr._batches(ds.edges.split()[2], "test"))
    np.testing.assert_array_equal(gb.edge_gather, np.asarray(jgb.edge_gather))
    ref = jtr.model.apply(jtr.variables, jtr.edge_table, jtr.node_table,
                          jgb, False)
    with torch.no_grad():
        out = tr.model(tr.edge_table, tr.node_table, gb.to("cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("model", FAMILIES)
def test_three_trainer_steps_match_jax(aml_csv, model):
    jtr, jds, tr, ds = trainer_pair(aml_csv, model, 41)
    jb = list(itertools.islice(
        jtr._batches(jds.edges.split()[0], "train", 0), 3))
    pb = list(itertools.islice(tr._batches(ds.edges.split()[0], "train", 0),
                               3))
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
                                   jax_terms, tr.cfg.lr, 3, KW["n_hidden"])
    assert not faults, (faults, summary)


@pytest.mark.parametrize("model", FAMILIES)
def test_train_cli_checkpoint_serves(aml_csv, model, tmp_path):
    args = ["--data", aml_csv, "--model", model, "--n_hidden", "16",
            "--num_neighs", "8", "8", "--batch_size", "32", "--device",
            "cpu"]
    stats = {}
    history, best = train_cli.main(
        args + ["--epochs", "1", "--testing", "--save_model",
                "--wandb_dir", str(tmp_path)], stats)
    (rec,) = history
    assert np.isfinite(rec["loss"]) and best == rec["val_f1"]
    assert {"0", "-1"} <= set(os.listdir(stats["run_dir"]))
    served = predict.main(args + [
        "--load_model", os.path.join(stats["run_dir"], "-1"),
        "--output", str(tmp_path / "p.csv")])
    test = IBMTransactionsAML(aml_csv).edges.split()[2]
    assert np.array_equal(np.sort(served["id"]), np.sort(test.indices))
    assert np.isfinite(served["score"]).all()


@pytest.mark.parametrize("model", FAMILIES)
def test_cli_needs_cuda_unless_asked_for_cpu(aml_csv, model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    args = ["--data", aml_csv, "--model", model, "--wandb_dir",
            str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(args + ["--load_model", str(tmp_path)])
