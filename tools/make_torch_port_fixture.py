"""Write the JAX reference fixture that ``chip_smoke.py`` holds the PyTorch
port's serving path against on the GPU.

Builds the supervised config of record with ``rmm_tpu`` on the CPU
(synthetic AML, 131,072 rows, ``num_accounts = rows // 16``, data seed 0;
``tabgnn``, C = 32, 2 layers, fanouts 100/100, batch 200, f32), replaces
every JAX variable with seeded random values, and runs the JAX
``Trainer.predict`` over the first 3 batches of the test split. Saves the
flattened variables, the ``id``/``pred``/``score`` arrays and the run's
settings (capacities included) to ``tests/fixtures/torch_port/
aml_record.npz``, which the smoke reads with numpy alone.

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixture.py

This tool imports both packages; it is not part of the port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from rmm_tpu.datasets import IBMTransactionsAML, write_synthetic_aml_csv  # noqa: E402
from rmm_tpu.frame.dataset import DatasetView  # noqa: E402
from rmm_tpu.train.trainer import Trainer  # noqa: E402
from rmm_tpu.utils.config import Config  # noqa: E402
from rmm_tpu_torch.convert import flatten_variables  # noqa: E402
from tests.torch_port_util import randomize_jax_variables  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=131072)
    p.add_argument("--batches", type=int, default=3)
    p.add_argument("--var_seed", type=int, default=7)
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    p.add_argument("--out", default=os.path.join(
        ROOT, "tests", "fixtures", "torch_port", "aml_record.npz"))
    args = p.parse_args(argv)

    settings = dict(rows=args.rows, num_accounts=max(args.rows // 16, 64),
                    data_seed=0, model="tabgnn", n_hidden=32, n_gnn_layers=2,
                    num_neighs=[100, 100], batch_size=200, seed=1,
                    var_seed=args.var_seed, batches=args.batches)
    os.makedirs(args.workdir, exist_ok=True)
    csv = os.path.join(args.workdir, f"aml_{args.rows}.csv")
    write_synthetic_aml_csv(csv, num_rows=args.rows,
                            num_accounts=settings["num_accounts"], seed=0)
    cfg = Config(model="tabgnn", data=csv, task="edge_classification",
                 batch_size=200, n_hidden=32, n_gnn_layers=2,
                 num_neighs=(100, 100), seed=1)
    ds = IBMTransactionsAML(root=csv, khop_neighbors=cfg.num_neighs,
                            channels=cfg.n_hidden)
    trainer = Trainer(cfg, ds)
    trainer.variables = randomize_jax_variables(trainer.variables,
                                                args.var_seed)
    test = ds.edges.split()[2]
    view = DatasetView(test.parent,
                       test.indices[:args.batches * cfg.batch_size])
    out = trainer.predict(view, mode="test")
    settings.update(edge_capacity=trainer.cfg.edge_capacity,
                    node_capacity=trainer.cfg.node_capacity,
                    test_rows=len(test))

    arrays = {f"variables/{k}": v.astype(np.float32)
              for k, v in flatten_variables(trainer.variables).items()}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez(args.out, **arrays, id=out["id"].astype(np.int64),
             pred=out["pred"].astype(np.int64),
             score=out["score"].astype(np.float32),
             settings=np.array(json.dumps(settings)))
    print(json.dumps({**settings, "out": os.path.relpath(args.out, ROOT),
                      "bytes": os.path.getsize(args.out),
                      "pred_mean": float(out["pred"].mean())}))


if __name__ == "__main__":
    main()
