"""The six model families on the CPU against the JAX record that
``chip_smoke.py``'s ``family_parity`` phase holds the card to
(``tests/fixtures/torch_port/family_record.npz``, written by
``tools/make_torch_port_family_fixture.py``: the supervised launcher's
widths, C = 32, 8 heads, 2 layers, fanouts 100/100, batch 200, with
``--emlps`` and dropout 0, on a 16,384-row cut of the config of record's
data). From the record's start, per model: the first test batch served
(the same seed-edge ids, scores within 1e-4: PNA sums in another order)
and three train steps within ``convert.check_record``'s float32 limits
(each loss 1e-4 relative at step 1 and 1e-3 after, parameters 6.05·lr and
each component's median 0.05·lr; for ``cpna`` and ``cpnatab``, whose ten
PNA layers and BatchNorms amplify float32 rounding, 1e-2 after step 1, a
median of 0.15·lr and four times the BatchNorm statistic limit, which the
reference's own sort path needs against its scatter record,
``convert.CPNA_*``), the same parameters unmoved.
``cpnatab``'s row attention runs at dropout 0, as the record's does."""
import itertools
import json
import os

import numpy as np
import pytest
import torch

from rmm_tpu_torch.convert import (check_record, from_jax, load_record,
                                   loss_terms, random_variables, torch_key)
from rmm_tpu_torch.datasets import build_dataset, write_synthetic_aml_csv
from rmm_tpu_torch.nn.dropout import set_rate
from rmm_tpu_torch.train.trainer import Trainer
from rmm_tpu_torch.utils.config import config_from_args, create_parser
from tests.torch_port_util import one_torch_thread  # noqa: F401

RECORD = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port",
                      "family_record.npz")
FAMILIES = ("fttransformer", "gin", "pna", "cpna", "cpnatab",
            "tabgnninterleaved")
SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    rec = load_record(RECORD)
    st = json.loads(str(rec["settings"]))
    csv = write_synthetic_aml_csv(
        str(tmp_path_factory.mktemp("family") / "aml.csv"),
        num_rows=st["rows"], num_accounts=st["num_accounts"],
        seed=st["data_seed"])
    return rec, st, csv


def record_argv(st: dict, csv: str, model: str) -> list:
    return ["--data", csv, "--model", model, "--n_hidden",
            str(st["n_hidden"]), "--n_gnn_layers", str(st["n_gnn_layers"]),
            "--num_neighs", *map(str, st["num_neighs"]), "--batch_size",
            str(st["batch_size"]), "--seed", str(st["seed"]), "--lr",
            str(st["lr"]), "--dropout", "0", "--edge_capacity",
            str(st["edge_capacity"]), "--node_capacity",
            str(st["node_capacity"]), *(["--emlps"] if st["emlps"] else [])]


@pytest.mark.parametrize("model", FAMILIES)
def test_family_record_on_the_cpu(record, model):
    rec, st, csv = record
    cfg = config_from_args(create_parser().parse_args(
        record_argv(st, csv, model) + ["--device", "cpu"]))
    tr = Trainer(cfg, build_dataset(cfg))
    run = st["models"][model]
    tr.model.load_state_dict(from_jax(
        random_variables(run["shapes"], st["var_seed"]), tr.model))
    set_rate(tr.model, 0.0)
    train, _, test = tr.dataset.edges.split()

    gb = next(tr._batches(test, "test"))
    aux = tr._forward_eval(gb.to("cpu"))
    ids = gb.edge_gather[:cfg.batch_size][gb.seed_mask]
    np.testing.assert_array_equal(ids, rec[f"{model}/serve/id"])
    np.testing.assert_allclose(aux["score"].numpy()[gb.seed_mask],
                               rec[f"{model}/serve/score"], rtol=0,
                               atol=SCORE_TOL)

    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.model.train()
    terms = [loss_terms(tr._step(b.to("cpu"))[0], {}) for b in
             itertools.islice(tr._batches(train, "train", st["epoch"]),
                              st["steps"])]
    state = tr.model.state_dict()
    faults, summary = check_record(state, terms, rec, f"{model}/", st["lr"],
                                   st["steps"], st["n_hidden"], model=model)
    assert not faults, (faults, summary)
    unmoved = {name for name, _ in tr.model.named_parameters()
               if (state[name] == before[name]).all()}
    assert unmoved == {torch_key(k)[0] for k in run["unmoved"]}


class FakeRecord(dict):
    """A parity record in memory: its keys as ``np.load``'s ``files``."""

    @property
    def files(self):
        return list(self)


@pytest.mark.parametrize("model,off,faulty", [
    ("pna", 0.03, False), ("pna", 0.05, True), ("cpnatab", 0.05, False),
    ("cpna", 0.13, False), ("cpnatab", 0.15, True), ("cpna", 0.15, True)])
def test_cpna_models_take_four_times_the_statistic_limit(model, off, faulty):
    """At lr 6.1e-4, 3 updates and C = 32 the statistic limit is 0.0355;
    ``cpna`` and ``cpnatab`` take 0.1421, every other model keeps 0.0355."""
    lr, c = 0.0006116418195373612, 32
    rec = FakeRecord({"m/term/loss": np.array([1.0, 1.0, 1.0])})
    for path, val in (("batch_stats/bn/var", 1.0), ("params/bn/bias", 0.0)):
        rec[f"m/idx/{path}"] = np.arange(c)
        rec[f"m/val/{path}"] = np.full(c, val)
        rec[f"m/sum/{path}"] = np.float64(c * val)
        rec[f"m/norm/{path}"] = np.float64(np.sqrt(c) * val)
    var = torch.ones(c, dtype=torch.float64)
    var[3] += off
    state = {"bn.running_var": var, "bn.bias": torch.zeros(c)}
    faults, summary = check_record(state, [{"loss": 1.0}] * 3, rec, "m/",
                                   lr, 3, c, model=model)
    want = 0.1421 if model in ("cpna", "cpnatab") else 0.0355
    assert summary["bn_stat_tol"] == pytest.approx(want, abs=1e-4)
    assert bool(faults) == faulty, faults
