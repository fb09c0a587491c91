"""The training slice of the PyTorch port against ``rmm_tpu`` on the CPU:
PNA aggregation and masked BatchNorm gradients, the loss, the metrics,
explicit-generator dropout, the shuffled train-mode batches, three full
trainer steps (with and without ``--freeze``), and the training CLI whose
checkpoints serve through ``cli/predict.py``.

Tolerances, each with its reason:
  * PNA gradients 1e-5 rel + 2e-5 abs: float32, the JAX sums are
    differences of a running cumsum (messages are multiples of 1/4, so the
    sums themselves are exact; the rest is division and square roots);
  * BatchNorm, loss and metric values 1e-5 (float32, another order);
  * trainer losses 1e-4 rel after step 1 and 1e-3 after steps 2-3 (the PNA
    sums and the model's matmuls in another order), parameters 6.05·lr abs
    (Adam turns a near-zero gradient of either sign into a ±lr step, and
    its m̂/√v̂ is at most 1.0036 in the first 3 steps: two runs part by at
    most 6.01·lr).
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
from rmm_tpu.nn import norms as jnorms
from rmm_tpu.ops.segment import pna_aggregate as jax_pna
from rmm_tpu.train.trainer import Trainer as JaxTrainer
from rmm_tpu.utils import loss as jloss
from rmm_tpu.utils import metric as jmetric
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.cli import main as train_cli
from rmm_tpu_torch.cli import predict
from rmm_tpu_torch.convert import from_jax
from rmm_tpu_torch.datasets import IBMTransactionsAML
from rmm_tpu_torch.nn import dropout as port_dropout
from rmm_tpu_torch.nn import norms
from rmm_tpu_torch.ops.segment import pna_aggregate
from rmm_tpu_torch.train.trainer import Trainer, is_frozen
from rmm_tpu_torch.utils import checkpoint, loss, metric
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import init_random, load_from_jax, \
    one_torch_thread, randomize_jax_variables  # noqa: F401

KW = dict(model="tabgnn", batch_size=32, n_hidden=16, n_gnn_layers=2,
          num_neighs=(8, 8), dropout=0.0)
ARGS = ["--model", "tabgnn", "--n_hidden", "16", "--num_neighs", "8", "8",
        "--batch_size", "32"]


def t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- PNA


def pna_case(seed, n=10, f=4):
    """Segments of 6 messages (multiples of 1/4) on nodes 0..n-3, each with
    a triple tie and at least two distinct values per feature; masked
    lanes, an empty node (n-2) and a node that only masked lanes reach
    (n-1); lanes shuffled."""
    rng = np.random.RandomState(seed)
    dst = np.repeat(np.arange(n - 2), 6)
    msg = rng.randint(-8, 9, (len(dst), f)) / 4.0
    msg[1::6] = msg[0::6]
    msg[2::6] = msg[0::6]
    msg[3::6] = msg[0::6] + 0.5
    mask = np.ones(len(dst), bool)
    mask[5::12] = False
    dst = np.concatenate([dst, [n - 1, n - 1]])
    msg = np.concatenate([msg, rng.randint(-8, 9, (2, f)) / 4.0])
    mask = np.concatenate([mask, [False, False]])
    perm = rng.permutation(len(dst))
    return (msg[perm].astype(np.float32), dst[perm].astype(np.int32),
            mask[perm], n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pna_gradient_matches_jax_vjp(seed):
    msg, dst, mask, n = pna_case(seed)
    cot = np.random.RandomState(seed + 10).randn(
        n, 12 * msg.shape[1]).astype(np.float32)
    ald = 1.37
    ref, vjp = jax.vjp(lambda m: jax_pna(m, jnp.asarray(dst), n, ald,
                                         jnp.asarray(mask), impl="cv"),
                       jnp.asarray(msg))
    m = t(msg).requires_grad_()
    out = pna_aggregate(m, t(dst), n, ald, t(mask))
    grad, = torch.autograd.grad(out, m, t(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-5, atol=2e-5)
    assert (grad.numpy()[~mask] == 0).all()      # masked lanes get nothing


# ---------------------------------------------------------- BatchNorm


def test_masked_batchnorm_train_gradients_and_stats():
    c = 16
    rng = np.random.RandomState(4)
    x = (rng.randn(40, c) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(40) < 0.7
    cot = rng.randn(40, c).astype(np.float32)
    jax_bn = jnorms.MaskedBatchNorm(c)
    variables = init_random(jax_bn, jnp.asarray(x), jnp.asarray(mask),
                            False, seed=5)

    def f(params, xx):
        return jax_bn.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xx,
            jnp.asarray(mask), True, mutable=["batch_stats"])

    ref, vjp, mutated = jax.vjp(f, variables["params"], jnp.asarray(x),
                                has_aux=True)
    dparams, dx = vjp(jnp.asarray(cot))

    bn = load_from_jax(norms.MaskedBatchNorm(c), variables).train()
    xt = t(x).requires_grad_()
    out = bn(xt, t(mask))
    gx, gw, gb = torch.autograd.grad(out, (xt, bn.weight, bn.bias), t(cot))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(gx.numpy(), np.asarray(dx), **tol)
    np.testing.assert_allclose(gw.numpy(), np.asarray(dparams["scale"]),
                               **tol)
    np.testing.assert_allclose(gb.numpy(), np.asarray(dparams["bias"]),
                               **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]),
                               **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]),
                               **tol)


# ------------------------------------------------------ loss, metrics


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_and_its_gradient_match_jax(weighted):
    rng = np.random.RandomState(6)
    logits = rng.randn(24, 3).astype(np.float32)
    labels = rng.randint(0, 3, 24)
    labels[:2] = 3                          # out of range, masked out
    mask = rng.rand(24) < 0.8
    mask[:2] = False
    w = np.array([1.0, 9.23, 0.5], np.float32) if weighted else None

    def jf(lg):
        return jloss.cross_entropy(lg, jnp.asarray(labels),
                                   None if w is None else jnp.asarray(w),
                                   jnp.asarray(mask))

    ref, grad_ref = jax.value_and_grad(jf)(jnp.asarray(logits))
    lg = t(logits).requires_grad_()
    out = loss.cross_entropy(lg, t(labels).float(),
                             None if w is None else t(w), t(mask))
    grad, = torch.autograd.grad(out, lg)
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_f1_and_auc_match_jax(seed):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, 300)
    pred = np.where(rng.rand(300) < 0.7, y, 1 - y)
    score = np.round(rng.rand(300) * 0.5 + 0.4 * y, 2)   # tied scores
    y3, p3 = rng.randint(0, 3, 300), rng.randint(0, 3, 300)
    assert metric.f1_score(y, pred) == jmetric.f1_score(y, pred)
    assert (metric.f1_score(y3, p3, "weighted")
            == jmetric.f1_score(y3, p3, "weighted"))
    assert metric.roc_auc(y, score) == pytest.approx(
        jmetric.roc_auc(y, score), abs=1e-12)
    assert np.isnan(metric.roc_auc(np.zeros(5), np.arange(5.0)))


# ------------------------------------------------------------ dropout


def test_generator_dropout_is_flax_dropout_and_repeatable():
    x = torch.randn(64, 32)
    g = torch.Generator().manual_seed(3)
    y = port_dropout.dropout(x, 0.25, True, g)
    keep = port_dropout.keep_mask(x.shape, 0.25,
                                  torch.Generator().manual_seed(3), "cpu")
    torch.testing.assert_close(y, torch.where(keep, x / 0.75, 0.0))
    assert 0.6 < keep.float().mean() < 0.9
    assert port_dropout.dropout(x, 0.25, False, None) is x
    with pytest.raises(RuntimeError, match="Generator"):
        port_dropout.dropout(x, 0.25, True, None)


# ---------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def aml_csv(tmp_path_factory):
    csv = str(tmp_path_factory.mktemp("train") / "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=1000, num_accounts=62, seed=3)
    return csv


def jax_trainer(csv, freeze, variables=None):
    ds = JaxAML(csv, khop_neighbors=KW["num_neighs"], channels=16)
    tr = JaxTrainer(JaxConfig(data=csv, **KW), ds, freeze_tabular=freeze)
    if variables is not None:
        tr.variables = jax.tree_util.tree_map(jnp.asarray, variables)
        tr.opt_state = tr.tx.init(tr.variables["params"])
    return tr, ds


def port_trainer(csv, freeze, seed=1, dropout=0.0):
    ds = IBMTransactionsAML(csv, khop_neighbors=KW["num_neighs"])
    cfg = Config(data=csv, **{**KW, "dropout": dropout}, device="cpu",
                 freeze=freeze, seed=seed)
    return Trainer(cfg, ds), ds


@pytest.mark.parametrize("freeze", [False, True])
def test_three_trainer_steps_match_jax(aml_csv, freeze):
    jtr, jds = jax_trainer(aml_csv, freeze)
    variables = randomize_jax_variables(jtr.variables, 41)
    jtr.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    jtr.opt_state = jtr.tx.init(jtr.variables["params"])
    tr, ds = port_trainer(aml_csv, freeze)
    load_from_jax(tr.model, variables)
    start = {k: v.clone() for k, v in tr.model.state_dict().items()}

    # the shuffled train-mode batches of epoch 0 are the JAX trainer's
    jb = list(itertools.islice(
        jtr._batches(jds.edges.split()[0], "train", 0), 3))
    pb = list(itertools.islice(tr._batches(ds.edges.split()[0], "train", 0),
                               3))
    for a, b in zip(jb, pb):
        for field in ("edge_gather", "edge_mask", "edge_index",
                      "node_gather", "node_mask", "seed_mask", "y"):
            np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                          getattr(b, field), err_msg=field)

    jax_losses, port_losses = [], []
    key = jax.random.PRNGKey(0)
    tr.model.train()
    for a, b in zip(jb, pb):
        jtr.variables, jtr.opt_state, jl, _ = jtr._train_step(
            jtr.variables, jtr.opt_state, a, key, jtr.edge_table,
            jtr.node_table)
        jax_losses.append(float(jl))
        port_losses.append(float(tr._step(b.to("cpu"))[0]))
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=1e-4)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-3)

    ref = from_jax(jax.tree_util.tree_map(np.asarray, jtr.variables))
    state = tr.model.state_dict()
    assert set(ref) == set(state)
    lr = tr.cfg.lr
    errs = np.concatenate([np.abs(v.numpy() - ref[k].numpy()).ravel()
                           for k, v in state.items()])
    assert np.median(errs) <= 0.05 * lr     # a wrong gradient moves this
    for k, v in state.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=0,
                                   atol=6.05 * lr, err_msg=k)
        moved = not torch.equal(v, start[k])
        if freeze and is_frozen(k):
            assert not moved, k
        elif k.endswith(".weight") and not is_frozen(k):
            assert moved, k


def test_same_seed_same_training_run(aml_csv):
    runs = []
    for _ in range(2):
        tr, ds = port_trainer(aml_csv, False, seed=7, dropout=0.3)
        tr.model.train()
        batches = itertools.islice(tr._batches(ds.edges.split()[0], "train"),
                                   2)
        losses = [float(tr._step(b.to("cpu"))[0]) for b in batches]
        runs.append((losses, tr.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_train_cli_checkpoints_serve_and_resume(aml_csv, tmp_path):
    wandb = str(tmp_path / "runs")
    stats = {}
    history, best = train_cli.main(
        ["--data", aml_csv, *ARGS, "--epochs", "1", "--testing",
         "--save_model", "--device", "cpu", "--wandb_dir", wandb], stats)
    run_dir = stats["run_dir"]
    (rec,) = history
    assert rec["epoch"] == 0 and np.isfinite(rec["loss"])
    assert best == rec["val_f1"] and rec["best"]
    assert {"0", "-1", "metrics.jsonl", "config.json"} <= set(
        os.listdir(run_dir))
    assert {"model.pt", "meta.json", "optimizer.pt", "best_m.json"} <= set(
        os.listdir(os.path.join(run_dir, "0")))

    served = predict.main(["--data", aml_csv, *ARGS, "--load_model",
                           os.path.join(run_dir, "0"), "--device", "cpu",
                           "--output", str(tmp_path / "p.csv")])
    test_rows = IBMTransactionsAML(aml_csv).edges.split()[2].tensor_frame.num_rows
    assert len(served["id"]) == test_rows
    assert np.isfinite(served["score"]).all()

    assert checkpoint.parse_checkpoint_path(
        os.path.join(run_dir, "0")) == (os.path.basename(run_dir), 0)
    history, _ = train_cli.main(
        ["--data", aml_csv, *ARGS, "--epochs", "1", "--testing",
         "--device", "cpu", "--wandb_dir", wandb, "--checkpoint",
         "--load_model", os.path.join(run_dir, "0")])
    assert [h["epoch"] for h in history] == [1]
    assert os.path.isdir(os.path.join(run_dir, "1"))
    assert not os.path.exists(os.path.join(run_dir, "0"))   # pruned
    # --load_model alone transfers the encoders and, as the reference
    # merges a checkpoint's extras whatever the components, the BatchNorm
    # statistics of a task model's checkpoint
    run = {}
    train_cli.main(["--data", aml_csv, *ARGS, "--epochs", "1", "--testing",
                    "--device", "cpu", "--wandb_dir", wandb, "--load_model",
                    os.path.join(run_dir, "1")], run)
    saved = torch.load(os.path.join(run_dir, "1", "model.pt"),
                       weights_only=True)
    assert run["transfer"]["grafted"] == [
        k for k in saved if k.startswith(("node_encoder.", "edge_encoder."))
        or k.endswith(("running_mean", "running_var"))]


def test_train_cli_needs_cuda_unless_asked_for_cpu(aml_csv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--data", aml_csv, *ARGS, "--wandb_dir",
                        str(tmp_path)])
    with pytest.raises(NotImplementedError, match="--steps_per_dispatch"):
        train_cli.main(["--data", aml_csv, *ARGS, "--device", "cpu",
                        "--steps_per_dispatch", "4"])
