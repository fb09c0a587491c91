"""The masked-cell objectives on the CPU against the JAX record that
``chip_smoke.py``'s ``mcm_parity`` phase holds the card to
(``tests/fixtures/torch_port/mcm_record.npz``, written by
``tools/make_torch_port_mcm_fixture.py``, dropout 0, the reference's
scatter PNA sums):

* the tabular MCM trainer at the CLI's widths (C = 128, 3 layers, batch
  200), plain and with the mask vector, on a 16,384-row cut;
* ``--task mcm_edge_table`` for ``tabgnn``, ``pna``, ``cpna`` and
  ``tabgnnfused`` at the supervised launcher's widths (C = 32, 2 layers,
  fanouts 100/100, batch 200, ``--emlps``) on the same cut;
* mcm-lp pretraining with ``--moo moco`` at the SSL widths (C = 128, 3
  layers, 64 negatives) on a 4,096-row cut.

From the record's start, each: the outputs on the first validation batch
within 1e-4 (relative to the largest entry where that exceeds 1), then
three train steps within ``convert.check_record``'s float32 limits (each
loss term 1e-4 relative at step 1 and 1e-3 after, parameters 6.05·lr and
each component's median 0.05·lr; ``cpna`` at ``convert.CPNA_*``'s), the
same parameters unmoved. Under MoCo, whose weights at these widths turn
on the tasks' gradient directions and on Adam's eps (the reasons stand in
``convert.py`` and ``chip_smoke.py`` beside the limits): the loss terms
1e-4 relative at step 1 and 1e-2 after (``model="moco"``), λ after each
step within 1e-5 of the reference's where that has an entry of 0, else
within half of the reference's smaller entry, and the norms of ``y``'s
rows within 5e-3 relative (``chip_smoke.moco_faults``); a λ collapsed to
[1, 0] fails them. ``tests/test_torch_moco.py`` holds three MoCo steps to
the default loss limits and λ to 1e-5 at small widths.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from chip_smoke import (MCM_FIXTURE, MCM_OUT_TOL, mcm_cuts, mcm_edge_trainer,
                        mcm_moco_trainer, mcm_output_error,
                        mcm_tabular_trainer, moco_faults)
from rmm_tpu_torch.convert import (check_record, load_record, loss_terms,
                                   torch_key)
from rmm_tpu_torch.nn.weighting import moco_combine
from rmm_tpu_torch.train import pretrain
from rmm_tpu_torch.train.trainer import MCM_SUMS
from tests.torch_port_util import one_torch_thread  # noqa: F401

EDGE_MODELS = ("tabgnn", "pna", "cpna", "tabgnnfused")


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    rec = load_record(MCM_FIXTURE)
    st = json.loads(str(rec["settings"]))
    assert tuple(st["edge_models"]) == EDGE_MODELS
    return rec, st, mcm_cuts(st, str(tmp_path_factory.mktemp("mcm")))


@pytest.fixture(scope="module")
def edge_data():
    """The MCM datasets, one a kind, loaded once for the module."""
    return {}


def unmoved(model, before) -> set:
    state = model.state_dict()
    return {name for name, _ in model.named_parameters()
            if torch.equal(state[name], before[name])}


@pytest.mark.parametrize("run", ["tabular", "tabular_mv"])
def test_tabular_trainer_matches_the_record(record, run):
    rec, st, csvs = record
    tr = mcm_tabular_trainer(st, csvs["cut"], run == "tabular_mv", "cpu")
    train, val, _ = tr.edges.split()
    tf, _, _, _ = next(tr._batches(val, False))
    with torch.no_grad():
        out = tr.model(tf)
    assert mcm_output_error(out, rec, f"{run}/") <= MCM_OUT_TOL
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.model.train()
    terms = []
    for tf, mask, _, _ in itertools.islice(tr._batches(train, True, 0),
                                           st["steps"]):
        loss, sums = tr._step(tf, mask)
        terms.append(loss_terms(loss, dict(zip(MCM_SUMS, sums.tolist()))))
    faults, summary = check_record(tr.model.state_dict(), terms, rec,
                                   f"{run}/", st["tabular"]["lr"],
                                   st["steps"], st["tabular"]["channels"])
    want = {torch_key(k)[0] for k in st["runs"][run]["unmoved"]}
    if unmoved(tr.model, before) != want:
        faults.append("unmoved parameters differ")
    assert not faults, (faults, summary)


@pytest.mark.parametrize("model", EDGE_MODELS)
def test_mcm_edge_table_matches_the_record(record, edge_data, model):
    rec, st, csvs = record
    tr = mcm_edge_trainer(st, csvs["cut"], model, "cpu",
                          edge_data.get("mcm"))
    edge_data["mcm"] = tr.dataset
    train, val, _ = tr.dataset.edges.split()
    gb = next(tr._batches(val, "val"))
    with torch.no_grad():
        out = tr.model(tr.edge_table, tr.node_table, gb.to("cpu"))
    assert mcm_output_error(out, rec, f"mcm_{model}/") <= MCM_OUT_TOL
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.model.train()
    terms = []
    for gb in itertools.islice(tr._batches(train, "train", 0), st["steps"]):
        loss, aux = tr._step(gb.to("cpu"))
        terms.append(loss_terms(loss, dict(zip(MCM_SUMS,
                                               aux["sums"].tolist()))))
    faults, summary = check_record(tr.model.state_dict(), terms, rec,
                                   f"mcm_{model}/", st["edge"]["lr"],
                                   st["steps"], st["edge"]["n_hidden"],
                                   model=model)
    want = {torch_key(k)[0] for k in st["runs"][f"mcm_{model}"]["unmoved"]}
    if unmoved(tr.model, before) != want:
        faults.append("unmoved parameters differ")
    assert not faults, (faults, summary)


def moco_steps(record):
    """Three MoCo steps from the record's start → (check_record's faults
    and errors, moco_faults' faults and errors)."""
    rec, st, csvs = record
    tr = mcm_moco_trainer(st, csvs["moco"], "cpu")
    batches = list(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", 0), st["steps"]))
    neg0 = rec["moco/neg0"]
    np.testing.assert_array_equal(batches[0].neg_edge_index[:, :neg0.shape[1]],
                                  neg0)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.model.train()
    terms, lambd, y_norm = [], [], []
    for gb in batches:
        terms.append(loss_terms(*tr._step(gb.to("cpu"))))
        lambd.append(tr.moco.lambd.numpy().copy())
        y_norm.append(torch.linalg.vector_norm(tr.moco.y, dim=1).numpy())
    faults, summary = check_record(tr.model.state_dict(), terms, rec,
                                   "moco/", st["moco"]["lr"],
                                   2 * st["steps"], st["moco"]["channels"],
                                   model="moco")
    want = {torch_key(k)[0] for k in st["runs"]["moco"]["unmoved"]}
    if unmoved(tr.model, before) != want:
        faults.append("unmoved parameters differ")
    return (faults, summary), moco_faults(lambd, y_norm, rec)


def test_moco_pretraining_matches_the_record(record):
    (faults, summary), (more, moco) = moco_steps(record)
    assert not faults + more, (faults + more, summary, moco)


def test_moco_record_catches_a_collapsed_lambda(record, monkeypatch):
    """A MoCo whose λ collapsed to [1, 0] (the LP task's gradient alone)
    fails the record on λ after steps 2 and 3 and on the MCM head's
    parameters."""
    def collapsed(state, grads, losses):
        _, state, _ = moco_combine(state, grads, losses)
        lambd = torch.tensor([1.0, 0.0])
        return state.y[0], dataclasses.replace(state, lambd=lambd), lambd

    monkeypatch.setattr(pretrain, "moco_combine", collapsed)
    (faults, summary), (more, moco) = moco_steps(record)
    assert {"λ after step 2", "λ after step 3"} <= {
        f.split(":")[0] for f in more}, more
    assert "λ after step 1" not in str(more), more
    assert any("mcm_head" in f for f in faults), (faults, summary)
