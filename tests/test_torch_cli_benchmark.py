"""The port's profiling CLI (``rmm_tpu_torch.cli.benchmark``) on the CPU: the
reference's summary keys and phase names for both loops, a forward phase
that trains nothing (the parameters and BatchNorm statistics after a run
are those of the same trainer after the same train steps alone), and a
``--profile`` Chrome trace that parses as JSON."""
import json

import numpy as np
import pytest
import torch

from rmm_tpu_torch.cli import benchmark
from rmm_tpu_torch.datasets import build_dataset
from rmm_tpu_torch.datasets.synthetic import write_synthetic_aml_csv
from rmm_tpu_torch.train.trainer import Trainer
from rmm_tpu_torch.utils.config import config_from_args

#: the reference summary's keys (rmm_tpu/cli/benchmark.py:103-114, 160-168)
SUPERVISED_KEYS = {"iters", "batch_size", "train_rows_per_sec", "phases"}
PRETRAIN_KEYS = {"loop", "iters", "batch_size", "rows_per_sec", "phases"}
PHASE_KEYS = {"mean_ms", "p50_ms", "total_s"}
FLAGS = ["--model", "tabgnn", "--batch_size", "16", "--n_hidden", "8",
         "--n_gnn_layers", "1", "--num_neighs", "4", "4", "--testing",
         "--device", "cpu"]


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("aml") / "bench.csv")
    return write_synthetic_aml_csv(path, num_rows=400, num_accounts=60,
                                   seed=0)


def test_supervised_summary_has_the_reference_keys(csv):
    out = benchmark.main(["--data", csv, *FLAGS, "--iters", "3"])
    assert SUPERVISED_KEYS <= set(out)
    assert out["iters"] == 3 and out["batch_size"] == 16
    assert out["device"] == "cpu"
    assert out["train_rows_per_sec"] > 0
    assert tuple(out["phases"]) == benchmark.SUPERVISED_PHASES == (
        "pre-processing", "cpu-to-device", "forward", "train-step",
        "copy-back")
    for phase in out["phases"].values():
        assert set(phase) == PHASE_KEYS
        assert all(np.isfinite(v) and v >= 0 for v in phase.values())


def test_forward_phase_trains_nothing(csv):
    """After a run (a warm-up and 3 iterations: 4 steps on the train
    split's batches 0, 0, 1 and 2), the parameters and buffers equal those
    of the same trainer after those 4 steps alone: the forward phase, in
    eval mode, moves no parameter and no BatchNorm statistic, and draws
    no dropout."""
    args = benchmark.build_parser().parse_args(["--data", csv, *FLAGS])
    cfg = config_from_args(args)
    dataset = build_dataset(cfg)
    ran = Trainer(cfg, dataset)
    benchmark.benchmark_trainer(ran, iters=3)
    ref = Trainer(cfg, dataset)
    tr, _, _ = ref.seed_table().split()
    batches = list(ref._batches(tr, "train"))
    ref.model.train()
    for i in (0, 0, 1, 2):
        ref._step(batches[i].to(ref.device))
    ref.model.eval()
    got, want = ran.model.state_dict(), ref.model.state_dict()
    assert set(got) == set(want)
    assert any("running_mean" in k for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # and they did move: the steps trained
    fresh = Trainer(cfg, dataset).model.state_dict()
    assert any(not torch.equal(fresh[k], want[k]) for k in want)


def test_profile_writes_a_chrome_trace(csv, tmp_path):
    trace_dir = str(tmp_path / "trace")
    out = benchmark.main(["--data", csv, *FLAGS, "--iters", "2",
                          "--profile", "--trace_dir", trace_dir])
    with open(out["trace"]) as f:
        trace = json.load(f)
    assert out["trace"].startswith(trace_dir)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("aten::" in str(n) for n in names)
    assert out["phases"]["train-step"]["mean_ms"] > 0


def test_pretrain_loop_summary_has_the_reference_keys(csv):
    out = benchmark.main(["--data", csv, *FLAGS, "--model", "tabgnnfused",
                          "--iters", "2", "--loop", "mcm-lp"])
    assert PRETRAIN_KEYS <= set(out)
    assert out["loop"] == "pretrain:mcm-lp"
    assert out["rows_per_sec"] > 0 and out["device"] == "cpu"
    assert set(out["phases"]) == {"pre-processing", "train-step"}
    for phase in out["phases"].values():
        assert set(phase) == {"mean_ms", "p50_ms"}
        assert all(np.isfinite(v) for v in phase.values())
