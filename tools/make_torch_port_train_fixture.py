"""Write the JAX reference of three training steps that ``chip_smoke.py``
holds the PyTorch port's training path against on the GPU.

Builds the supervised config of record with ``rmm_tpu`` on the CPU (the
widths of ``tools/make_torch_port_fixture.py``: ``tabgnn``, C = 32, 8
heads, 2 layers, fanouts 100/100, batch 200, f32, Adam at the config's lr)
with dropout 0, starts from the variables of
``tests/fixtures/torch_port/aml_record.npz`` and takes three JAX train
steps on the first three shuffled train batches of epoch 0. Saves the three
losses, the variables after step 3 (BatchNorm statistics included) and the
run's settings (capacities included) to
``tests/fixtures/torch_port/aml_train_record.npz``.

The data scale is cut from the fixture's 131,072 rows to ``--rows``
(16,384 by default, ``num_accounts = rows // 16`` as there): the JAX step
on the CPU keeps the whole batch's activations for its backward. Widths,
fanouts, batch and the model are the config's own.

    JAX_PLATFORMS=cpu python tools/make_torch_port_train_fixture.py

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

import itertools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rmm_tpu.datasets import IBMTransactionsAML, write_synthetic_aml_csv  # noqa: E402
from rmm_tpu.train.trainer import Trainer  # noqa: E402
from rmm_tpu.utils.config import Config  # noqa: E402
from rmm_tpu_torch.convert import flatten_variables  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")


def nest(flat: dict) -> dict:
    """``{"a/b/c": arr}`` → ``{"a": {"b": {"c": arr}}}``."""
    out: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=16384)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--weights", default=os.path.join(FIXTURES,
                                                     "aml_record.npz"))
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    p.add_argument("--out", default=os.path.join(FIXTURES,
                                                 "aml_train_record.npz"))
    args = p.parse_args(argv)

    record = np.load(args.weights)
    base = json.loads(str(record["settings"]))
    prefix = "variables/"
    variables = nest({k[len(prefix):]: record[k] for k in record.files
                      if k.startswith(prefix)})
    settings = {k: base[k] for k in ("data_seed", "model", "n_hidden",
                                     "n_gnn_layers", "num_neighs",
                                     "batch_size", "seed", "var_seed")}
    settings.update(rows=args.rows, num_accounts=max(args.rows // 16, 64),
                    dropout=0.0, steps=args.steps, epoch=0)
    os.makedirs(args.workdir, exist_ok=True)
    csv = os.path.join(args.workdir, f"aml_{args.rows}.csv")
    write_synthetic_aml_csv(csv, num_rows=args.rows,
                            num_accounts=settings["num_accounts"],
                            seed=settings["data_seed"])
    cfg = Config(model=settings["model"], data=csv,
                 task="edge_classification",
                 batch_size=settings["batch_size"],
                 n_hidden=settings["n_hidden"],
                 n_gnn_layers=settings["n_gnn_layers"],
                 num_neighs=tuple(settings["num_neighs"]),
                 seed=settings["seed"], dropout=0.0)
    ds = IBMTransactionsAML(root=csv, khop_neighbors=cfg.num_neighs,
                            channels=cfg.n_hidden)
    trainer = Trainer(cfg, ds)
    trainer.variables = jax.tree_util.tree_map(jnp.asarray, variables)
    trainer.opt_state = trainer.tx.init(trainer.variables["params"])

    batches = itertools.islice(
        trainer._batches(ds.edges.split()[0], "train", settings["epoch"]),
        args.steps)
    losses = []
    for gb in batches:
        (trainer.variables, trainer.opt_state, loss,
         _) = trainer._train_step(trainer.variables, trainer.opt_state, gb,
                                  jax.random.PRNGKey(0), trainer.edge_table,
                                  trainer.node_table)
        losses.append(float(loss))
    settings.update(edge_capacity=trainer.cfg.edge_capacity,
                    node_capacity=trainer.cfg.node_capacity,
                    lr=trainer.cfg.lr, adam_eps=trainer.cfg.adam_eps)

    after = {f"after/{k}": np.asarray(v, np.float32) for k, v in
             flatten_variables(jax.device_get(trainer.variables)).items()}
    np.savez(args.out, **after, losses=np.asarray(losses, np.float64),
             settings=np.array(json.dumps(settings)))
    print(json.dumps({**settings, "losses": losses,
                      "out": os.path.relpath(args.out, ROOT),
                      "bytes": os.path.getsize(args.out)}))


if __name__ == "__main__":
    main()
