"""MoCo gradient weighting of mcm-lp pretraining (``--moo moco``) on the CPU
against ``rmm_tpu``'s ``PretrainTrainer(moo="moco")`` at tiny widths (C =
16, 2 layers, 8 negatives, fanouts 8/8, batch 32, dropout 0): the same
batches and negatives, three steps from the same randomized JAX variables
(each loss, λ after each step, every parameter), the MoCo state's round
trip through the port's save and resume, the two ``torch.autograd.grad``
pulls on one forward (bitwise the gradients of one ``backward()`` of each
loss alone, each pull reaching only its own view's attention calls),
the CLI, and a JAX checkpoint's ``moco_state`` left unread.

Tolerances: losses, parameters and BatchNorm statistics
``convert.check_states``' limits; λ 1e-5 after each step.
"""
import itertools
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
from rmm_tpu.train.pretrain import PretrainTrainer as JaxPretrainer
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.cli import fused
from rmm_tpu_torch.convert import check_states, from_jax, pretrain_variables
from rmm_tpu_torch.datasets import IBMTransactionsAML
from rmm_tpu_torch.datasets.base import PretrainType
from rmm_tpu_torch.nn.transformer import MultiHeadSelfAttention
from rmm_tpu_torch.train.pretrain import MOCO_FILE, PretrainTrainer
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import one_torch_thread, \
    randomize_jax_variables  # noqa: F401

KW = dict(model="tabgnnfused", batch_size=32, n_hidden=16, n_gnn_layers=2,
          dropout=0.0, num_neg_samples=8, num_neighs=(8, 8), lr=2e-4,
          weight_decay=1e-3, moo="moco")
LAMBDA_TOL = 1e-5


@pytest.fixture(autouse=True)
def scatter_sums(monkeypatch):
    monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")


@pytest.fixture(scope="module")
def aml_csv(tmp_path_factory):
    csv = str(tmp_path_factory.mktemp("moco") / "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=1000, num_accounts=62, seed=3)
    return csv


def port_trainer(csv, caps, mode="mcm-lp", **kw):
    ds = IBMTransactionsAML(csv, khop_neighbors=KW["num_neighs"],
                            pretrain={PretrainType.MASK,
                                      PretrainType.LINK_PRED})
    cfg = Config(data=csv, **{**KW, **kw}, device="cpu",
                 edge_capacity=caps[0], node_capacity=caps[1])
    return PretrainTrainer(cfg, ds, mode)


def trainer_pair(csv, seed):
    jds = JaxAML(csv, khop_neighbors=KW["num_neighs"], channels=16,
                 pretrain={JaxPretrainType.MASK, JaxPretrainType.LINK_PRED})
    jtr = JaxPretrainer(JaxConfig(data=csv, **KW), jds, mode="mcm-lp")
    jtr.params = jax.tree_util.tree_map(
        jnp.asarray, randomize_jax_variables(jtr.params, seed))
    jtr.opt_state = jtr.tx.init(jtr.params)
    tr = port_trainer(csv, (jtr.cfg.edge_capacity, jtr.cfg.node_capacity))
    tr.model.load_state_dict(from_jax(jax.tree_util.tree_map(
        np.asarray, pretrain_variables(jtr.params, jtr.batch_stats)),
        tr.model))
    return jtr, jds, tr


def jax_state(jtr, model):
    return from_jax(jax.tree_util.tree_map(np.asarray, pretrain_variables(
        jtr.params, jtr.batch_stats)), model)


def test_three_moco_steps_match_jax_and_the_state_round_trips(aml_csv,
                                                              tmp_path):
    jtr, jds, tr = trainer_pair(aml_csv, 9)
    jb = list(itertools.islice(jtr._batches(jds.edges.split()[0], "train",
                                            0), 4))
    pb = list(itertools.islice(tr._batches(tr.dataset.edges.split()[0],
                                           "train", 0), 4))
    tr.model.train()
    jax_terms, terms = [], []
    for a, b in zip(jb[:3], pb[:3]):
        np.testing.assert_array_equal(np.asarray(a.neg_edge_index),
                                      b.neg_edge_index)
        (jtr.params, jtr.batch_stats, jtr.opt_state, jtr.moco_state, jl,
         _) = jtr._train_step(jtr.params, jtr.batch_stats, jtr.opt_state,
                              jtr.moco_state, a, jax.random.PRNGKey(0),
                              jtr.edge_table)
        jax_terms.append({"loss": float(jl)})
        terms.append({"loss": float(tr._step(b.to("cpu"))[0])})
        lambd = tr.moco.lambd.numpy()
        np.testing.assert_allclose(lambd, np.asarray(jtr.moco_state.lambd),
                                   rtol=0, atol=LAMBDA_TOL)
        assert abs(float(lambd.sum()) - 1) <= 1e-6
        assert tr.moco.step == int(jtr.moco_state.step)
    np.testing.assert_allclose(
        torch.linalg.vector_norm(tr.moco.y.double(), dim=1).numpy(),
        np.linalg.norm(np.asarray(jtr.moco_state.y, np.float64), axis=1),
        rtol=1e-3)
    faults, summary = check_states(tr.model.state_dict(), terms,
                                   jax_state(jtr, tr.model), jax_terms,
                                   KW["lr"], 6, KW["n_hidden"])
    assert not faults, (faults, summary)

    # save, resume, and a fourth step on both: the same to the bit
    ck = tr.save(str(tmp_path / "run"), 0, {"accuracy": 0.5})
    assert os.path.exists(os.path.join(ck, MOCO_FILE))
    again = port_trainer(aml_csv, (tr.cfg.edge_capacity,
                                   tr.cfg.node_capacity))
    again.restore(ck)
    assert again.moco.step == tr.moco.step == 3
    assert torch.equal(again.moco.y, tr.moco.y)
    assert torch.equal(again.moco.lambd, tr.moco.lambd)
    again.model.train()
    a = tr._step(pb[3].to("cpu"))[0]
    b = again._step(pb[3].to("cpu"))[0]
    assert torch.equal(a, b)
    assert torch.equal(again.moco.y, tr.moco.y)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


def test_two_pulls_give_each_loss_its_own_gradients(aml_csv):
    """One forward, then ``task_grads``' two pulls (the LP loss first, the
    graph kept for the second): each passes through its own view's
    attention calls only (the LP view's and the MCM view's, 2 + layers
    each), and gives bitwise the gradients of ``backward()`` of its loss
    alone on a second forward of the same batch (dropout 0)."""
    tr = port_trainer(aml_csv, (0, 0))
    gb = next(tr._batches(tr.dataset.edges.split()[0], "train")).to("cpu")
    tr.model.train()
    visits = []

    def hook(_, __, out):
        out.register_hook(lambda g: visits.append(id(out)))

    handles = [m.register_forward_hook(hook) for m in tr.model.modules()
               if isinstance(m, MultiHeadSelfAttention)]
    losses, _ = tr._forward(gb)
    grads = tr.task_grads([losses["lp"], losses["mcm"]])
    calls = 2 + KW["n_gnn_layers"]
    assert len(visits) == 2 * calls
    assert len(set(visits)) == 2 * calls        # no call reached twice
    for h in handles:
        h.remove()
    losses, _ = tr._forward(gb)
    for loss, want, keep in ((losses["lp"], grads[0], True),
                             (losses["mcm"], grads[1], False)):
        for p in tr.params:
            p.grad = None
        loss.backward(retain_graph=keep)
        got = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                         .reshape(-1) for p in tr.params])
        assert torch.equal(got, want)


def cli_argv(csv, wandb, *extra):
    return ["--dataset", csv, "--epochs", "1", "--testing", "--device",
            "cpu", "--channels", "16", "--num_layers", "2",
            "--num_neg_samples", "8", "--khop_neighbors", "8", "8",
            "--batch_size", "64", "--dropout", "0.1", "--moo", "moco",
            "--wandb_dir", wandb, *extra]


def test_cli_pretrains_saves_and_resumes_with_moco(aml_csv, tmp_path):
    wandb = str(tmp_path / "runs")
    stats = {}
    (rec,), best = fused.main(cli_argv(aml_csv, wandb, "--save_model"),
                              stats)
    assert np.isfinite(rec["loss"]) and 0 < rec["val_mrr"] <= 1
    ck = os.path.join(stats["run_dir"], "0")
    state = torch.load(os.path.join(ck, MOCO_FILE), weights_only=True)
    assert state["step"] == -(-stats["split_rows"][0] // 64)
    assert abs(float(state["lambd"].sum()) - 1) <= 1e-6
    assert not os.path.exists(os.path.join(stats["run_dir"], "best_acc",
                                           MOCO_FILE))
    resumed, _ = fused.main(cli_argv(aml_csv, wandb, "--checkpoint", ck))
    assert [h["epoch"] for h in resumed] == [1]
    state1 = torch.load(os.path.join(stats["run_dir"], "1", MOCO_FILE),
                        weights_only=True)
    assert state1["step"] == 2 * state["step"]


@pytest.mark.parametrize("mode", ["mcm", "lp"])
def test_moco_weighs_mcm_lp_only(aml_csv, mode):
    """As in the reference, ``--moo moco`` reaches mcm-lp alone: the other
    modes have one loss and sum it."""
    assert port_trainer(aml_csv, (0, 0), mode).moco is None


def test_a_jax_checkpoints_moco_state_is_not_read(aml_csv, tmp_path, caplog):
    """A JAX checkpoint whose ``moco_state`` component holds the state
    (``y``, ``lambd``, ``step``) loads without it, with a warning. The
    reference's own ``save`` cannot write that component with its msgpack
    backend (flax serializes no ``MoCoState``; ``--moo moco --save_model``
    raises there), so the test writes it as flax would write the state's
    fields."""
    from flax import serialization

    jtr, _, tr = trainer_pair(aml_csv, 13)
    state, jtr.moco_state = jtr.moco_state, None
    ck = jtr.save(str(tmp_path / "jax_run"), 2, {"accuracy": 0.5})
    with open(os.path.join(ck, "moco_state"), "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"y": np.asarray(state.y) + 1, "lambd": np.asarray(state.lambd),
             "step": np.asarray(state.step)}))
    with caplog.at_level(logging.WARNING):
        tr.restore(ck)
    assert "moco_state is not read" in caplog.text
    assert tr.moco.step == 0 and not tr.moco.y.any()
    want = jax_state(jtr, tr.model)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_cli_needs_cuda_unless_asked_for_cpu(aml_csv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused.main(["--dataset", aml_csv, "--moo", "moco", "--wandb_dir",
                    str(tmp_path)])
