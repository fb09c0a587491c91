"""Write the JAX record of an SSL → supervised transfer that the PyTorch
port's transfer is held against: ``tests/test_torch_transfer.py`` on the
CPU and ``chip_smoke.py``'s ``transfer_parity`` phase on the GPU (where
there is no JAX, so it reads this record and the checkpoint beside it).

On the CPU, with ``rmm_tpu``:

1. pretrain ``TABGNNFused`` (``PretrainTrainer``, mcm-lp) for a few steps
   at tiny widths (C = 16, 2 layers, 8 heads, 8 negatives, fanouts 8/8,
   batch 32) on a 1,000-row synthetic AML, and save its JAX checkpoint
   directory with ``rmm_tpu.utils.checkpoint.save_checkpoint`` (the
   components ``edge_encoder``, ``model``, ``mcm_head``, ``lp_head``, the
   ``extras`` and ``meta.json``; no optimizer state) to
   ``tests/fixtures/torch_port/transfer_ssl_ckpt/``;
2. build the supervised ``tabgnnfused`` ``Trainer`` on the same CSV with
   ``--freeze`` (which freezes nothing there: no path of the fused model
   holds ``tab_layer``), dropout 0, its variables from
   ``rmm_tpu_torch.convert.random_variables`` over their shapes (which the
   record stores, so the port rebuilds the same start);
3. transfer the checkpoint's ``node_encoder`` and ``edge_encoder`` with
   ``rmm_tpu.utils.checkpoint.load_components`` (the supervised CLI's
   ``--load_model`` without ``--checkpoint``), and record which variables
   it grafted and which kept their start;
4. take three train steps on the first three shuffled train batches of
   epoch 0 and record each loss and, after step 3, each variable's seeded
   sample of entries, sum and norm (``rmm_tpu_torch.convert.check_record``
   reads them), and the parameters that no step moved. The steps take the
   reference's scatter PNA aggregation (``RMM_SEGMENT_IMPL=scatter``): its
   default path takes a segment's sums as differences of one running
   float32 cumsum, whose rounding lands its std block up to 4e-2 off the
   float64 aggregate (``tools/torch_bn_parity.py``) and takes the steps'
   losses near ``check_record``'s limits, away from the port's and the
   exact sums alike.

The record is ``tests/fixtures/torch_port/transfer_record.npz``; with the
checkpoint it stays under 1 MB.

    JAX_PLATFORMS=cpu python tools/make_torch_port_transfer_fixture.py

This tool imports both packages; it is not part of the port.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import make_torch_port_ssl_fixture as ssl_fixture  # noqa: E402
from rmm_tpu.datasets import IBMTransactionsAML, write_synthetic_aml_csv  # noqa: E402
from rmm_tpu.datasets.base import PretrainType  # noqa: E402
from rmm_tpu.train.pretrain import PretrainTrainer  # noqa: E402
from rmm_tpu.train.trainer import Trainer  # noqa: E402
from rmm_tpu.utils.checkpoint import load_components, save_checkpoint  # noqa: E402
from rmm_tpu.utils.config import Config  # noqa: E402
from rmm_tpu_torch.convert import (flatten_variables, pack_record,  # noqa: E402
                                   random_variables)
from tests.torch_port_util import nest  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
RECORD = os.path.join(FIXTURES, "transfer_record.npz")
CKPT_TAG = "transfer_ssl_ckpt"
SPEC = dict(rows=1000, num_accounts=62, data_seed=3, channels=16,
            num_layers=2, num_neg_samples=8, khop_neighbors=[8, 8],
            batch_size=32, ssl_steps=3, ssl_lr=2e-4, ssl_dropout=0.5,
            lr=0.0006116418195373612, sample=64)
STEPS, SEED, VAR_SEED = 3, 1, 23
TRANSFER = ["node_encoder", "edge_encoder"]


def pretrain(csv: str) -> str:
    """A few mcm-lp steps from the JAX initialization; the checkpoint."""
    cfg = Config(model="tabgnnfused", data=csv,
                 batch_size=SPEC["batch_size"], n_hidden=SPEC["channels"],
                 n_gnn_layers=SPEC["num_layers"],
                 dropout=SPEC["ssl_dropout"],
                 num_neg_samples=SPEC["num_neg_samples"],
                 num_neighs=tuple(SPEC["khop_neighbors"]),
                 lr=SPEC["ssl_lr"], seed=SEED)
    ds = IBMTransactionsAML(root=csv, pretrain={PretrainType.MASK,
                                                PretrainType.LINK_PRED},
                            khop_neighbors=cfg.num_neighs,
                            channels=cfg.n_hidden)
    tr = PretrainTrainer(cfg, ds, mode="mcm-lp")
    rng = jax.random.PRNGKey(SEED)
    for gb in itertools.islice(tr._batches(ds.edges.split()[0], "train", 0),
                               SPEC["ssl_steps"]):
        rng, key = jax.random.split(rng)
        (tr.params, tr.batch_stats, tr.opt_state, _, _,
         _) = tr._train_step(tr.params, tr.batch_stats, tr.opt_state, None,
                             gb, key, tr.edge_table)
    shutil.rmtree(os.path.join(FIXTURES, CKPT_TAG), ignore_errors=True)
    return save_checkpoint(FIXTURES, CKPT_TAG, tr._ckpt_variables())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    csv = os.path.join(args.workdir, "transfer.csv")
    write_synthetic_aml_csv(csv, num_rows=SPEC["rows"],
                            num_accounts=SPEC["num_accounts"],
                            seed=SPEC["data_seed"])
    ck = pretrain(csv)

    cfg = Config(model="tabgnnfused", data=csv,
                 batch_size=SPEC["batch_size"], n_hidden=SPEC["channels"],
                 n_gnn_layers=SPEC["num_layers"], dropout=0.0,
                 num_neighs=tuple(SPEC["khop_neighbors"]), lr=SPEC["lr"],
                 seed=SEED)
    ds = IBMTransactionsAML(root=csv, khop_neighbors=cfg.num_neighs,
                            channels=cfg.n_hidden)
    os.environ["RMM_SEGMENT_IMPL"] = "scatter"   # read when a step traces
    tr = Trainer(cfg, ds, freeze_tabular=True)
    shapes = {k: list(np.shape(v))
              for k, v in flatten_variables(tr.variables).items()}
    start = random_variables(shapes, VAR_SEED)
    variables = load_components(
        ck, jax.tree_util.tree_map(jnp.asarray, nest(start)), TRANSFER)
    moved = flatten_variables(jax.device_get(variables))
    grafted = sorted(k for k in start
                     if not np.array_equal(moved[k], start[k]))
    tr.variables = variables
    tr.opt_state = tr.tx.init(tr.variables["params"])

    losses = []
    key = jax.random.PRNGKey(0)
    for gb in itertools.islice(tr._batches(ds.edges.split()[0], "train", 0),
                               STEPS):
        tr.variables, tr.opt_state, loss, _ = tr._train_step(
            tr.variables, tr.opt_state, gb, key, tr.edge_table,
            tr.node_table)
        losses.append(float(loss))
    after = flatten_variables(jax.device_get(tr.variables))
    unmoved = sorted(k for k in after if k.startswith("params/")
                     and np.array_equal(after[k], moved[k]))

    arrays = {"sup/term/loss": np.asarray(losses, np.float64)}
    arrays.update(ssl_fixture.sampled(after, "sup/", SPEC["sample"]))
    settings = dict(SPEC, shapes=shapes, steps=STEPS, epoch=0, seed=SEED,
                    var_seed=VAR_SEED, dropout=0.0, nhead=8, freeze=True,
                    segment_impl="scatter",
                    checkpoint=os.path.relpath(ck, FIXTURES),
                    transfer=TRANSFER, grafted=grafted,
                    kept=sorted(set(start) - set(grafted)), unmoved=unmoved,
                    edge_capacity=tr.cfg.edge_capacity,
                    node_capacity=tr.cfg.node_capacity, losses=losses)
    np.savez_compressed(RECORD, **pack_record(arrays),
                        settings=np.array(json.dumps(settings)))
    sizes = {f: os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck)}
    print(json.dumps({"record": os.path.relpath(RECORD, ROOT),
                      "bytes": os.path.getsize(RECORD),
                      "checkpoint": os.path.relpath(ck, ROOT),
                      "checkpoint_bytes": sizes, "grafted": len(grafted),
                      "kept": len(start) - len(grafted),
                      "unmoved": unmoved, "losses": losses}))


if __name__ == "__main__":
    main()
