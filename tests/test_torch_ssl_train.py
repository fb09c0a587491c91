"""The SSL pretrainer of the PyTorch port against the JAX record on the CPU,
and the SSL CLI.

Three ``PretrainTrainer`` steps in each mode (``lp``, ``mcm``, ``mcm-lp``,
dropout 0) from the variables that ``tests/fixtures/torch_port/
ssl_tiny_record.npz`` was made from (``tools/make_torch_port_ssl_fixture.py``
takes the same steps with ``rmm_tpu``; no JAX step is compiled here), with
the record's first negatives. ``rmm_tpu_torch.convert.check_record``
holds each loss term of each step and the sampled variables against the
record, with the tolerances (and their reasons) stated there.

The CLI trains, saves, resumes and reports MRR, Hits@k, accuracy and RMSE
on the CPU; without ``--device cpu`` it raises where there is no CUDA, and
every flag whose behaviour is not ported raises by name (``--moo moco`` is
ported: ``tests/test_torch_moco.py``).
"""
import itertools
import json
import os

import numpy as np
import pytest
import torch

from rmm_tpu_torch.cli import fused
from rmm_tpu_torch.convert import (check_record, from_jax, load_record,
                                   loss_terms, random_variables)
from rmm_tpu_torch.datasets import (IBMTransactionsAML, write_synthetic_aml_csv,
                                    write_synthetic_node_dataset)
from rmm_tpu_torch.datasets.base import PretrainType
from rmm_tpu_torch.train.pretrain import PretrainTrainer
from rmm_tpu_torch.utils.config import Config
from tests.torch_port_util import one_torch_thread  # noqa: F401

RECORD = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port",
                      "ssl_tiny_record.npz")


@pytest.fixture(scope="module")
def record(tmp_path_factory):
    rec = load_record(RECORD)
    st = json.loads(str(rec["settings"]))
    csv = write_synthetic_aml_csv(
        str(tmp_path_factory.mktemp("ssl") / "aml.csv"), num_rows=st["rows"],
        num_accounts=st["num_accounts"], seed=st["data_seed"])
    return rec, st, csv


def pretrainer(st: dict, csv: str, mode: str) -> PretrainTrainer:
    ms = st["modes"][mode]
    pretrain = {PretrainType.LINK_PRED}
    if "mcm" in mode:
        pretrain.add(PretrainType.MASK)
    ds = IBMTransactionsAML(csv, khop_neighbors=st["khop_neighbors"],
                            pretrain=pretrain)
    cfg = Config(model="tabgnnfused", data=csv, batch_size=st["batch_size"],
                 n_hidden=st["channels"], n_gnn_layers=st["num_layers"],
                 dropout=st["dropout"], num_neg_samples=st["num_neg_samples"],
                 num_neighs=tuple(st["khop_neighbors"]), lr=st["lr"],
                 weight_decay=st["weight_decay"], adam_eps=st["adam_eps"],
                 seed=st["seed"], edge_capacity=ms["edge_capacity"],
                 node_capacity=ms["node_capacity"], device="cpu")
    tr = PretrainTrainer(cfg, ds, mode)
    tr.model.load_state_dict(from_jax(random_variables(ms["shapes"],
                                                       st["var_seed"]),
                                      tr.model))
    return tr


@pytest.mark.parametrize("mode", ["lp", "mcm", "mcm-lp"])
def test_three_pretrainer_steps_match_the_jax_record(record, mode):
    rec, st, csv = record
    tr = pretrainer(st, csv, mode)
    batches = list(itertools.islice(
        tr._batches(tr.dataset.edges.split()[0], "train", st["epoch"]),
        st["steps"]))
    np.testing.assert_array_equal(batches[0].neg_edge_index,
                                  rec[f"{mode}/neg0"])
    tr.model.train()
    terms = [loss_terms(*tr._step(gb.to("cpu"))) for gb in batches]
    updates = st["steps"] * (2 if mode == "mcm-lp" else 1)
    faults, _ = check_record(tr.model.state_dict(), terms, rec, f"{mode}/",
                             st["lr"], updates, st["channels"])
    assert not faults, faults


def test_a_mode_leaves_its_unused_head_to_weight_decay(record):
    rec, st, csv = record
    tr = pretrainer(st, csv, "lp")
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.model.train()
    gb = next(tr._batches(tr.dataset.edges.split()[0], "train"))
    tr._step(gb.to("cpu"))
    state = tr.model.state_dict()
    w = "mcm_head.num_lin.weight"        # decayed, no gradient in lp mode
    torch.testing.assert_close(state[w],
                               before[w] * (1 - st["lr"] * st["weight_decay"]))
    b = "mcm_head.num_lin.bias"          # no decay for 1-D parameters
    assert torch.equal(state[b], before[b])


def argv(csv, wandb, *extra):
    return ["--dataset", csv, "--mode", "mcm-lp", "--epochs", "1",
            "--testing", "--device", "cpu", "--channels", "16",
            "--num_layers", "2", "--num_neg_samples", "8",
            "--khop_neighbors", "8", "8", "--batch_size", "64",
            "--dropout", "0.1", "--wandb_dir", wandb, *extra]


def test_cli_trains_saves_and_resumes(record, tmp_path):
    _, _, csv = record
    wandb = str(tmp_path / "runs")
    stats = {}
    history, best = fused.main(argv(csv, wandb, "--save_model"), stats)
    (rec,) = history
    run_dir = stats["run_dir"]
    assert rec["epoch"] == 0 and np.isfinite(rec["loss"])
    for key in ("val_mrr", "val_hits@1", "val_hits@2", "val_hits@5",
                "val_hits@10", "val_accuracy", "val_rmse"):
        assert np.isfinite(rec[key]), key
    assert 0 < rec["val_mrr"] <= 1 and 0 <= rec["val_accuracy"] <= 1
    assert rec["val_hits@1"] <= rec["val_hits@10"]
    assert best == {"accuracy": rec["val_accuracy"], "rmse": rec["val_rmse"],
                    "mrr": rec["val_mrr"]}
    assert {"0", "best_acc", "best_rmse", "best_mrr", "metrics.jsonl",
            "config.json", "logs.log"} <= set(os.listdir(run_dir))
    assert {"model.pt", "meta.json", "optimizer.pt", "best_m.json"} <= set(
        os.listdir(os.path.join(run_dir, "0")))
    assert "optimizer.pt" not in os.listdir(os.path.join(run_dir,
                                                         "best_mrr"))

    # a checkpoint restores weights, BatchNorm statistics and AdamW state
    saved = torch.load(os.path.join(run_dir, "0", "model.pt"),
                       weights_only=True)
    args = fused.build_parser().parse_args(argv(csv, wandb))
    cfg = fused.config_from_args(args)
    ds = IBMTransactionsAML(csv, khop_neighbors=(8, 8), pretrain={
        PretrainType.MASK, PretrainType.LINK_PRED})
    tr = PretrainTrainer(cfg, ds, "mcm-lp")
    assert tr.restore(os.path.join(run_dir, "0")) == best
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert tr.optimizer.state_dict()["state"]

    history, best2 = fused.main(argv(csv, wandb, "--checkpoint",
                                     os.path.join(run_dir, "0")))
    assert [h["epoch"] for h in history] == [1]
    assert os.path.isdir(os.path.join(run_dir, "1"))
    assert not os.path.exists(os.path.join(run_dir, "0"))   # pruned
    assert best2["mrr"] >= best["mrr"]


def test_cli_needs_cuda_unless_asked_for_cpu(record, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    _, _, csv = record
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused.main(["--dataset", csv, "--wandb_dir", str(tmp_path)])


@pytest.mark.parametrize("flags,name", [
    (["--dp", "2"], "--dp"), (["--scan_layers"], "--scan_layers"),
    (["--steps_per_dispatch", "4"], "--steps_per_dispatch"),
    (["--inflight_groups", "3"], "--inflight_groups"),
])
def test_cli_refuses_unported_flags_by_name(record, tmp_path, flags, name):
    _, _, csv = record
    with pytest.raises(NotImplementedError, match=name):
        fused.main(argv(csv, str(tmp_path), *flags))


def test_cli_pretrains_an_epoch_in_bf16(record, tmp_path):
    """``--precision bf16`` (``bench.py``'s SSL precision) trains and
    evaluates an epoch, and the checkpoint keeps float32 masters."""
    _, _, csv = record
    stats = {}
    (rec,), _ = fused.main(argv(csv, str(tmp_path), "--precision", "bf16",
                                "--save_model"), stats)
    assert np.isfinite(rec["loss"]) and 0 < rec["val_mrr"] <= 1
    assert np.isfinite(rec["val_rmse"]) and 0 <= rec["val_accuracy"] <= 1
    ck = os.path.join(stats["run_dir"], "0")
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f)["precision"] == "bf16"
    saved = torch.load(os.path.join(ck, "model.pt"), weights_only=True)
    assert all(v.dtype == torch.float32 for v in saved.values()
               if v.is_floating_point())


def test_cli_refuses_the_ethereum_dataset(tmp_path):
    """Ethereum phishing is ported: a path holding ``eth`` pretrains on it
    (tests/test_torch_node_data.py holds the dispatch to the reference's,
    tests/test_torch_node_family_record.py the steps), with ``--ports``
    and another ``--split_type`` too."""
    root = write_synthetic_node_dataset(str(tmp_path / "ETH"),
                                        family="eth", num_nodes=120,
                                        num_edges=600, seed=1)
    stats = {}
    (rec,), _ = fused.main(argv(root, str(tmp_path), "--ports",
                                "--split_type", "temporal"), stats)
    assert np.isfinite(rec["loss"]) and 0 < rec["val_mrr"] <= 1
    assert rec["val_accuracy"] == 0.0   # no categorical masked column
    assert sum(stats["split_rows"]) == 600
