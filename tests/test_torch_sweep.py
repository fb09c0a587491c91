"""The port's sweep CLI (``rmm_tpu_torch.cli.sweep``) on the CPU: the
reference's spaces, the same trials from the same seed as
``rmm_tpu.cli.sweep.sample_params``, and JSONL leaderboards with the
reference's keys from a supervised and a fused sweep."""
import json

import numpy as np
import pytest

from rmm_tpu.cli import sweep as jax_sweep
from rmm_tpu_torch.cli import sweep
from rmm_tpu_torch.datasets.synthetic import write_synthetic_aml_csv


def test_spaces_are_the_reference_s():
    assert sweep.SUPERVISED_SPACE == jax_sweep.SUPERVISED_SPACE
    assert sweep.FUSED_SPACE == jax_sweep.FUSED_SPACE


@pytest.mark.parametrize("space", ["SUPERVISED_SPACE", "FUSED_SPACE"])
@pytest.mark.parametrize("seed", range(5))
def test_same_seed_draws_the_reference_s_trials(seed, space):
    ours, theirs = (np.random.RandomState(seed) for _ in range(2))
    for _ in range(3):       # a sweep's consecutive trials
        assert (sweep.sample_params(getattr(sweep, space), ours)
                == jax_sweep.sample_params(getattr(jax_sweep, space),
                                           theirs))


@pytest.fixture(scope="module")
def csv(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("aml") / "aml.csv")
    return write_synthetic_aml_csv(path, num_rows=400, num_accounts=60,
                                   seed=0)


def read_lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_supervised_sweep_writes_its_leaderboard(csv, tmp_path):
    out = str(tmp_path / "sweeps" / "results.jsonl")
    results, best = sweep.main([
        "--kind", "supervised", "--data", csv, "--model", "tabgnn",
        "--trials", "2", "--epochs", "1", "--batch_size", "32",
        "--num_neighs", "4", "4", "--edge_capacity", "256",
        "--node_capacity", "256", "--out", out, "--testing",
        "--device", "cpu"])
    rows = read_lines(out)
    assert rows == results and len(rows) == 2
    assert [r["trial"] for r in rows] == [0, 1]
    assert all(set(r) == {"trial", "params", "val_f1"} for r in rows)
    assert all(np.isfinite(r["val_f1"]) for r in rows)
    rng = np.random.RandomState(0)
    assert [r["params"] for r in rows] == [
        jax_sweep.sample_params(jax_sweep.SUPERVISED_SPACE, rng)
        for _ in range(2)]
    assert best == max(rows, key=lambda r: r["val_f1"])


def test_fused_sweep_writes_its_leaderboard(csv, tmp_path):
    out = str(tmp_path / "fused.jsonl")
    results, best = sweep.main([
        "--kind", "fused", "--data", csv, "--trials", "1", "--epochs", "1",
        "--num_neighs", "4", "4", "--edge_capacity", "512",
        "--node_capacity", "512", "--num_neg_samples", "4", "--out", out,
        "--testing", "--device", "cpu"])
    (row,) = read_lines(out)
    assert row == results[0] == best
    assert set(row) == {"trial", "params", "val_mrr"}
    assert set(row["params"]) == {"dropout", "batch_size"}
    assert 0 < row["val_mrr"] <= 1
