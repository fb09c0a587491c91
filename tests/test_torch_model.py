"""TABGNNS forward (eval mode) of the PyTorch port against the JAX model,
on the 12-node/22-edge fixture of ``test_model_parity`` and on a small
synthetic-AML batch built by each package's own data path. ``from_jax``
must map every leaf, with none left over. Tolerance 1e-4 abs/rel: the PNA
sums are taken in another order (the JAX ones as cumsum differences)."""
import jax
import numpy as np
import pytest
import torch

from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
from rmm_tpu.datasets import write_synthetic_aml_csv
from rmm_tpu.train.task_models import TABGNNS as JaxTABGNNS
from rmm_tpu.train.trainer import Trainer as JaxTrainer
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.datasets import IBMTransactionsAML
from rmm_tpu_torch.frame.stype import Stype
from rmm_tpu_torch.frame.tensor_frame import TensorFrame
from rmm_tpu_torch.nn.encoders import StypeWiseFeatureEncoder
from rmm_tpu_torch.train.task_models import TABGNNS
from rmm_tpu_torch.train.trainer import Trainer
from rmm_tpu_torch.utils.batch import GraphBatch
from rmm_tpu_torch.utils.config import Config
from tests.test_model_parity import (
    C, EDGE_CARDS, EDGE_MEANS, EDGE_STDS, NL, NODE_CARDS, NODE_MEANS,
    NODE_STDS, fixture, make_batch, make_flax_encoders, make_tables)
from tests.torch_port_util import load_from_jax, randomize_jax_variables

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("reverse_mp", [False, True])
def test_tabgnns_matches_jax_on_parity_fixture(reverse_mp):
    edge_index, node_num, node_cat, edge_num, edge_cat, ald = fixture()
    batch = make_batch(edge_index)
    edge_tf, node_tf = make_tables(node_num, node_cat, edge_num, edge_cat)
    node_enc, edge_enc = make_flax_encoders()
    wrap = JaxTABGNNS(node_encoder=node_enc, edge_encoder=edge_enc,
                      model_name="tabgnn", channels=C, n_gnn_layers=NL,
                      n_classes=2, dropout=0.0, avg_log_deg=ald,
                      reverse_mp=reverse_mp)
    variables = randomize_jax_variables(
        dict(wrap.init(jax.random.PRNGKey(0), edge_tf, node_tf, batch)), 21)
    ref = wrap.apply(variables, edge_tf, node_tf, batch, False)

    port = TABGNNS(
        StypeWiseFeatureEncoder(
            C, {Stype.numerical: ("n0",), Stype.categorical: ("n1",)},
            {Stype.numerical: {"means": NODE_MEANS, "stds": NODE_STDS},
             Stype.categorical: {"cardinalities": NODE_CARDS}}),
        StypeWiseFeatureEncoder(
            C, {Stype.numerical: ("e0", "e1"),
                Stype.categorical: ("e2", "e3")},
            {Stype.numerical: {"means": EDGE_MEANS, "stds": EDGE_STDS},
             Stype.categorical: {"cardinalities": EDGE_CARDS}}),
        C, NL, n_classes=2, dropout=0.0, avg_log_deg=ald,
        reverse_mp=reverse_mp)
    load_from_jax(port, variables)

    def table(num, cat, names):
        return TensorFrame(
            feats={Stype.numerical: torch.from_numpy(num),
                   Stype.categorical: torch.from_numpy(cat)},
            col_names={Stype.numerical: names[:num.shape[1]],
                       Stype.categorical: names[num.shape[1]:]})

    gb = GraphBatch(**{f: np.asarray(getattr(batch, f)) for f in (
        "edge_gather", "edge_mask", "edge_index", "node_gather",
        "node_mask", "seed_mask")}, y=None).to("cpu")
    with torch.no_grad():
        out = port(table(edge_num, edge_cat, ["e0", "e1", "e2", "e3"]),
                   table(node_num, node_cat, ["n0", "n1"]), gb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("ego", [False, True])
def test_tabgnns_matches_jax_on_aml_batch(tmp_path, ego):
    csv = str(tmp_path / "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=1000, num_accounts=62, seed=3)
    kw = dict(model="tabgnn", data=csv, batch_size=32, n_hidden=16,
              n_gnn_layers=2, num_neighs=(8, 8), ego=ego)
    jax_ds = JaxAML(csv, khop_neighbors=(8, 8), channels=16, ego=ego)
    jax_tr = JaxTrainer(JaxConfig(**kw), jax_ds)
    variables = randomize_jax_variables(jax_tr.variables, 31)
    jax_gb = next(jax_tr._batches(jax_ds.edges.split()[2], "test"))
    ref = jax_tr.model.apply(variables, jax_tr.edge_table, jax_tr.node_table,
                             jax_gb, False)

    ds = IBMTransactionsAML(csv, khop_neighbors=(8, 8), ego=ego)
    tr = Trainer(Config(**kw, device="cpu"), ds)
    load_from_jax(tr.model, variables)
    gb = next(tr._batches(ds.edges.split()[2], "test"))
    np.testing.assert_array_equal(gb.edge_gather, jax_gb.edge_gather)
    with torch.no_grad():
        out = tr.model(tr.edge_table, tr.node_table, gb.to("cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert np.isfinite(out.numpy()).all()


def test_from_jax_rejects_leftovers_on_either_side():
    from rmm_tpu_torch.convert import flatten_variables, from_jax

    edge_index, node_num, node_cat, edge_num, edge_cat, ald = fixture()
    edge_tf, node_tf = make_tables(node_num, node_cat, edge_num, edge_cat)
    node_enc, edge_enc = make_flax_encoders()
    wrap = JaxTABGNNS(node_encoder=node_enc, edge_encoder=edge_enc,
                      model_name="tabgnn", channels=C, n_gnn_layers=1,
                      avg_log_deg=ald)
    flat = flatten_variables(dict(wrap.init(
        jax.random.PRNGKey(0), edge_tf, node_tf, make_batch(edge_index))))
    port = TABGNNS(
        StypeWiseFeatureEncoder(
            C, {Stype.numerical: ("n0",), Stype.categorical: ("n1",)},
            {Stype.numerical: {"means": NODE_MEANS, "stds": NODE_STDS},
             Stype.categorical: {"cardinalities": NODE_CARDS}}),
        StypeWiseFeatureEncoder(
            C, {Stype.numerical: ("e0", "e1"),
                Stype.categorical: ("e2", "e3")},
            {Stype.numerical: {"means": EDGE_MEANS, "stds": EDGE_STDS},
             Stype.categorical: {"cardinalities": EDGE_CARDS}}),
        C, 1, avg_log_deg=ald)
    assert len(from_jax(flat, port)) == len(port.state_dict())
    key = "params/model/node_emb/kernel"
    with pytest.raises(KeyError):          # a JAX leaf left over
        from_jax({**flat, "params/model/extra/kernel": flat[key]}, port)
    with pytest.raises(KeyError):          # a torch entry left over
        from_jax({k: v for k, v in flat.items() if k != key}, port)
    with pytest.raises(ValueError):        # shapes disagree
        from_jax({**flat, key: flat[key][1:]}, port)
