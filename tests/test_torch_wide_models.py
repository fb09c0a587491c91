"""The models at C = 256 (8 heads, head width 32: the width where the port's
kernels used to refuse and the reference's kernel runs) against the JAX
package on the CPU: three ``tabgnn`` edge-classification trainer steps and
one mcm-lp step of the ``TABGNNFused`` pretrainer, from the same
randomized variables (``convert.from_jax``), dropout 0, on a 1,000-row
synthetic AML, at ``convert.check_states``' default limits (each loss
1e-4 relative at step 1 and 1e-3 after, parameters 6.05·lr and each
component's median 0.05·lr, BatchNorm statistics by their updates).

The reference's PNA sums go through its scatter path
(``RMM_SEGMENT_IMPL=scatter``), as in ``tests/test_torch_cli_families.py``."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
from rmm_tpu.datasets import write_synthetic_aml_csv
from rmm_tpu.datasets.base import PretrainType as JaxPretrainType
from rmm_tpu.train.pretrain import PretrainTrainer as JaxPretrainTrainer
from rmm_tpu.train.trainer import Trainer as JaxTrainer
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.convert import (check_states, flatten_variables, from_jax,
                                   loss_terms, pretrain_variables,
                                   random_variables)
from rmm_tpu_torch.datasets import IBMTransactionsAML
from rmm_tpu_torch.datasets.base import PretrainType
from rmm_tpu_torch.nn.dropout import set_rate
from rmm_tpu_torch.train.pretrain import PretrainTrainer
from rmm_tpu_torch.train.trainer import Trainer
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import load_from_jax, nest, \
    one_torch_thread, randomize_jax_variables  # noqa: F401

C = 256
KW = dict(batch_size=32, n_hidden=C, n_gnn_layers=2, num_neighs=(8, 8),
          dropout=0.0)
SSL_KW = dict(batch_size=32, n_hidden=C, n_gnn_layers=2, dropout=0.0,
              num_neg_samples=8, num_neighs=(8, 8), lr=2e-4,
              weight_decay=1e-3, adam_eps=1e-8, seed=1)
FIELDS = ("edge_gather", "edge_mask", "edge_index", "node_gather",
          "node_mask", "seed_mask", "y")


@pytest.fixture(autouse=True)
def scatter_sums(monkeypatch):
    monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")


@pytest.fixture(scope="module")
def aml_csv(tmp_path_factory):
    csv = str(tmp_path_factory.mktemp("wide") / "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=1000, num_accounts=62, seed=3)
    return csv


def test_three_tabgnn_steps_at_c256_match_jax(aml_csv):
    jds = JaxAML(aml_csv, khop_neighbors=KW["num_neighs"], channels=C)
    jtr = JaxTrainer(JaxConfig(data=aml_csv, model="tabgnn", **KW), jds)
    jtr.variables = jax.tree_util.tree_map(
        jnp.asarray, randomize_jax_variables(jtr.variables, 43))
    jtr.opt_state = jtr.tx.init(jtr.variables["params"])
    ds = IBMTransactionsAML(aml_csv, khop_neighbors=KW["num_neighs"])
    tr = Trainer(Config(data=aml_csv, model="tabgnn", **KW, device="cpu"),
                 ds)
    assert tr.cfg.nhead == 8
    load_from_jax(tr.model, jax.tree_util.tree_map(np.asarray,
                                                   jtr.variables))
    set_rate(tr.model, 0.0)
    jb = list(itertools.islice(
        jtr._batches(jds.edges.split()[0], "train", 0), 3))
    pb = list(itertools.islice(tr._batches(ds.edges.split()[0], "train", 0),
                               3))
    assert len(pb) == 3
    for a, b in zip(jb, pb):
        for field in FIELDS:
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
                                   jax_terms, tr.cfg.lr, 3, C)
    assert not faults, (faults, summary)


def test_an_mcm_lp_step_of_tabgnnfused_at_c256_matches_jax(aml_csv):
    jds = JaxAML(root=aml_csv, channels=C, khop_neighbors=SSL_KW[
        "num_neighs"], pretrain={JaxPretrainType.LINK_PRED,
                                 JaxPretrainType.MASK})
    jtr = JaxPretrainTrainer(JaxConfig(model="tabgnnfused", data=aml_csv,
                                       **SSL_KW), jds, mode="mcm-lp")
    layout = flatten_variables(pretrain_variables(jtr.params,
                                                  jtr.batch_stats))
    start = random_variables({k: np.shape(v) for k, v in layout.items()}, 9)
    flat = nest(start)
    jtr.params = jax.tree_util.tree_map(jnp.asarray, {
        "encoder": {"params": flat["params"]["edge_encoder"]},
        "model": flat["params"]["model"],
        "mcm_head": {"params": flat["params"]["mcm_head"]},
        "lp_head": {"params": flat["params"]["lp_head"]}})
    jtr.batch_stats = jax.tree_util.tree_map(jnp.asarray,
                                             flat["batch_stats"]["model"])
    jtr.opt_state = jtr.tx.init(jtr.params)
    jgb = next(jtr._batches(jds.edges.split()[0], "train", 0))
    (jtr.params, jtr.batch_stats, jtr.opt_state, _, jloss,
     jsums) = jtr._train_step(jtr.params, jtr.batch_stats, jtr.opt_state,
                              None, jgb, jax.random.PRNGKey(0),
                              jtr.edge_table)
    jsums = {k: float(v) for k, v in jax.device_get(jsums).items()}

    ds = IBMTransactionsAML(aml_csv, khop_neighbors=SSL_KW["num_neighs"],
                            pretrain={PretrainType.LINK_PRED,
                                      PretrainType.MASK})
    tr = PretrainTrainer(Config(model="tabgnnfused", data=aml_csv, **SSL_KW,
                                edge_capacity=jtr.cfg.edge_capacity,
                                node_capacity=jtr.cfg.node_capacity,
                                device="cpu"), ds, "mcm-lp")
    tr.model.load_state_dict(from_jax(start, tr.model))
    gb = next(tr._batches(ds.edges.split()[0], "train", 0))
    for field in FIELDS + ("neg_edge_index",):
        np.testing.assert_array_equal(np.asarray(getattr(jgb, field)),
                                      getattr(gb, field), err_msg=field)
    tr.model.train()
    loss, sums = tr._step(gb.to("cpu"))
    ref_terms = loss_terms(jloss, jsums)
    # the JAX step's sums hold no LP term (its loss does)
    terms = {k: v for k, v in loss_terms(loss, sums).items()
             if k in ref_terms}
    assert set(terms) == {"loss", "mcm_cat", "mcm_num"}
    after = from_jax(flatten_variables(jax.device_get(
        pretrain_variables(jtr.params, jtr.batch_stats))), tr.model)
    faults, summary = check_states(tr.model.state_dict(), [terms], after,
                                   [ref_terms], SSL_KW["lr"], 2, C)
    assert not faults, (faults, summary)
