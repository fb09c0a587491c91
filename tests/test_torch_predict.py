"""The whole serving slice: JAX ``Trainer.predict`` against the PyTorch
port's predict CLI on the CPU, on a 2,000-row synthetic AML (tabgnn,
C = 16, 2 layers, fanouts 10/10, batch 64). The port reads a checkpoint
written from the converted JAX variables. ``id`` and ``pred`` must be
equal, ``score`` within 1e-4 (PNA sums in another order)."""
import csv

import numpy as np
import pytest

from rmm_tpu.datasets import IBMTransactionsAML as JaxAML
from rmm_tpu.datasets import write_synthetic_aml_csv
from rmm_tpu.train.trainer import Trainer as JaxTrainer
from rmm_tpu.utils.config import Config as JaxConfig
from rmm_tpu_torch.cli import predict
from rmm_tpu_torch.convert import from_jax
from rmm_tpu_torch.utils.checkpoint import save_checkpoint
from tests.torch_port_util import one_torch_thread, \
    randomize_jax_variables  # noqa: F401

ARGS = ["--model", "tabgnn", "--n_hidden", "16", "--n_gnn_layers", "2",
        "--num_neighs", "10", "10", "--batch_size", "64"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    data = str(d / "aml.csv")
    write_synthetic_aml_csv(data, num_rows=2000, num_accounts=125, seed=0)
    cfg = JaxConfig(model="tabgnn", data=data, batch_size=64, n_hidden=16,
                    n_gnn_layers=2, num_neighs=(10, 10))
    ds = JaxAML(data, khop_neighbors=cfg.num_neighs, channels=16)
    trainer = JaxTrainer(cfg, ds)
    trainer.variables = randomize_jax_variables(trainer.variables, 4)
    ref = trainer.predict(ds.edges.split()[2], mode="test")
    ckpt = save_checkpoint(str(d / "ckpt"), from_jax(trainer.variables))
    out_csv = str(d / "preds.csv")
    stats = {}
    out = predict.main(["--data", data, *ARGS, "--load_model", ckpt,
                        "--split", "test", "--output", out_csv,
                        "--device", "cpu"], stats)
    assert stats["rows"] == len(out["id"])
    return ref, out, out_csv, data, ckpt


def test_port_cli_matches_jax_predict(served):
    ref, out, _, _, _ = served
    assert 0 < ref["pred"].mean() < 1          # both classes are served
    np.testing.assert_array_equal(out["id"], ref["id"])
    np.testing.assert_array_equal(out["pred"], ref["pred"])
    np.testing.assert_allclose(out["score"], ref["score"], rtol=1e-4,
                               atol=1e-4)


def test_port_cli_writes_csv(served):
    _, out, out_csv, _, _ = served
    with open(out_csv) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["id", "pred", "score"]
    assert [int(r[0]) for r in rows[1:]] == out["id"].tolist()


def test_port_cli_needs_cuda_unless_asked_for_cpu(served, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    _, _, _, data, ckpt = served
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--data", data, *ARGS, "--load_model", ckpt,
                      "--output", str(tmp_path / "p.csv")])
    with pytest.raises(NotImplementedError, match="--dp"):
        predict.main(["--data", data, *ARGS, "--load_model", ckpt,
                      "--dp", "8", "--device", "cpu"])


def test_port_cli_refuses_a_partial_checkpoint(served, tmp_path):
    import torch

    from rmm_tpu_torch.utils.checkpoint import save_checkpoint

    _, _, _, data, ckpt = served
    state = torch.load(f"{ckpt}/model.pt", weights_only=True)
    state.pop("decoder.mlp.fc3.bias")
    partial = save_checkpoint(str(tmp_path / "partial"), state)
    with pytest.raises(RuntimeError, match="fc3.bias"):
        predict.main(["--data", data, *ARGS, "--load_model", partial,
                      "--output", str(tmp_path / "p.csv"), "--device",
                      "cpu"])
