"""The device-sampled training path (``--sampler device``) on the CPU
against the JAX package's device path, recorded in
``tests/fixtures/torch_port/device_record.npz``
(``tools/make_torch_port_device_fixture.py``; every in-degree at most the
fanout, so the sampled arrays are a function of the seeds), through
``chip_smoke.replay_device_part``, which the card's ``device_parity`` runs:
for its edge, node and mcm-lp parts, the seed batches, each sampled array
and drop count bit for bit, and three steps from the record's start within
``convert.check_record``'s limits (the mcm-lp steps fed the record's
negatives, the port's own checked against the banned set); a sampler one
edge short fails it. Then the entry points: ``--sampler device`` and
``--frontier_capacity`` reach the trainers, the predict CLI serves the
same ids on either sampler, ``auto`` samples on the host, and the SSL
CLI trains an epoch on the device sampler with the calibrated frontier
buffer.
"""
import json
import os

import numpy as np
import pytest

import chip_smoke
from rmm_tpu_torch.cli import fused, predict
from rmm_tpu_torch.cli import main as train_cli
from rmm_tpu_torch.convert import load_record
from rmm_tpu_torch.datasets import IBMTransactionsAML
from rmm_tpu_torch.graph import device_sampler as ds
from rmm_tpu_torch.train import pretrain, trainer
from rmm_tpu_torch.train.trainer import Trainer
from rmm_tpu_torch.utils.checkpoint import load_best_m
from rmm_tpu_torch.utils.config import config_from_args, create_parser
from tests.torch_port_util import one_torch_thread  # noqa: F401

RECORD = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port",
                      "device_record.npz")
REC = load_record(RECORD)
ST = json.loads(str(REC["settings"]))


@pytest.fixture(autouse=True)
def scatter_sums(monkeypatch):
    monkeypatch.setenv("RMM_SEGMENT_IMPL", "scatter")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return chip_smoke.device_record_data(
        ST, str(tmp_path_factory.mktemp("device_record")))


@pytest.mark.parametrize("name", ["edge", "node", "mcm_lp"])
def test_device_record_on_the_cpu(data, name):
    """``chip_smoke.replay_device_part`` on the CPU: what the card's
    ``device_parity`` phase holds, with no residual among the negatives."""
    part = chip_smoke.replay_device_part(REC, ST, data, name, "cpu")
    assert part["neg_residual"] == 0
    assert len(part["terms"]) == ST["steps"]


def test_a_wrong_sample_fails_the_record(data, monkeypatch):
    """A sampler that keeps one edge fewer fails the record's arrays."""
    real = ds.sample_edges_device

    def short(*args, **kw):
        out = real(*args, **kw)
        mask = out["edge_mask"].clone()
        mask[int(mask.nonzero()[-1])] = False
        return {**out, "edge_mask": mask}

    monkeypatch.setattr(trainer, "sample_edges_device", short)
    with pytest.raises(chip_smoke.SmokeFailure, match="edge_mask differs"):
        chip_smoke.replay_device_part(REC, ST, data, "edge", "cpu")


def test_flags_reach_the_trainers(data, tmp_path):
    """``--sampler`` and ``--frontier_capacity`` are taken by the three
    CLIs' parsers (no longer refused) and by the trainers: an explicit
    frontier buffer wins over the calibrated one; ``auto`` is the host."""
    csv = data["edge"]
    flags = ["--sampler", "device", "--frontier_capacity", "320"]
    cfg = config_from_args(create_parser().parse_args(
        ["--data", csv, "--model", "tabgnn", "--device", "cpu", *flags]))
    assert (cfg.sampler, cfg.frontier_capacity) == ("device", 320)
    scfg = fused.config_from_args(fused.build_parser().parse_args(
        ["--dataset", csv, "--device", "cpu", *flags]))
    assert (scfg.sampler, scfg.frontier_capacity) == ("device", 320)
    small = cfg.replace(n_hidden=8, num_neighs=(4, 4), batch_size=64)
    tr = Trainer(small, IBMTransactionsAML(csv, khop_neighbors=(4, 4)))
    assert tr.device_sampling and tr.cfg.frontier_capacity == 320
    assert tr.dataset.frontier_capacity == 320
    auto = Trainer(small.replace(sampler="auto", frontier_capacity=0),
                   IBMTransactionsAML(csv, khop_neighbors=(4, 4)))
    assert not auto.device_sampling
    assert 256 <= auto.cfg.frontier_capacity <= auto.cfg.node_capacity


@pytest.mark.parametrize("task", ["edge", "node"])
def test_predict_serves_the_same_ids_on_either_sampler(data, tmp_path,
                                                       task):
    path = data[task]
    common = ["--data", path, "--model", "tabgnn", "--n_hidden", "8",
              "--n_gnn_layers", "1", "--num_neighs", "4", "4",
              "--batch_size", "64", "--device", "cpu"]
    stats = {}
    hist, _ = train_cli.main(common + [
        "--epochs", "1", "--testing", "--sampler", "device",
        "--wandb_dir", str(tmp_path)], stats)
    assert np.isfinite(hist[0]["loss"]) and hist[0]["drop_rate"] == 0
    outs = {}
    for sampler in ("host", "device"):
        outs[sampler] = predict.main(common + [
            "--sampler", sampler, "--load_model",
            os.path.join(stats["run_dir"], "0"), "--output",
            str(tmp_path / f"{sampler}.csv")])
    np.testing.assert_array_equal(outs["device"]["id"], outs["host"]["id"])
    assert len(outs["device"]["id"]) > 0
    assert np.isfinite(outs["device"]["score"]).all()


def test_ssl_cli_trains_an_epoch_on_the_device_sampler(data, tmp_path,
                                                       monkeypatch):
    """``cli/fused.py --sampler device`` for an epoch with ``--save_model``
    and no capacity given, as a user runs it: every batch sampled on the
    device with the calibrated frontier buffer (above 0, at most the node
    buffer), finite losses, MRR in (0, 1], no residual among the
    negatives, the checkpoint's ``best_m.json`` the epoch's."""
    real, frontiers = pretrain.sample_edges_device, []

    def sample(*args):
        frontiers.append(args[-1])
        return real(*args)

    monkeypatch.setattr(pretrain, "sample_edges_device", sample)
    stats = {}
    (ep,), best = fused.main([
        "--dataset", data["mcm_lp"], "--mode", "mcm-lp", "--epochs", "1",
        "--testing", "--device", "cpu", "--channels", "16",
        "--num_layers", "2", "--num_neg_samples", "8", "--khop_neighbors",
        "8", "8", "--batch_size", "64", "--dropout", "0.1", "--sampler",
        "device", "--save_model", "--wandb_dir", str(tmp_path)], stats)
    fcap = stats["frontier_capacity"]
    assert 0 < fcap <= stats["node_capacity"]
    train_rows, val_rows, _ = stats["split_rows"]
    assert frontiers == [fcap] * (-(-train_rows // 64) + -(-val_rows // 64))
    assert np.isfinite(ep["loss"]) and np.isfinite(ep["val_rmse"])
    assert 0 < ep["val_mrr"] <= 1 and ep["neg_residual"] == 0
    assert 0 <= ep["drop_rate"] <= 1
    assert load_best_m(os.path.join(stats["run_dir"], "0")) == best == {
        "accuracy": ep["val_accuracy"], "rmse": ep["val_rmse"],
        "mrr": ep["val_mrr"]}
