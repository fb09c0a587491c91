"""Write the JAX record of Elliptic node classification that the PyTorch
port is held against: ``tests/test_torch_node.py`` on the CPU and
``chip_smoke.py``'s ``node_parity`` phase on the GPU (where there is no
JAX, so it reads this record).

On the CPU, with ``rmm_tpu``:

1. write a synthetic Elliptic directory
   (``rmm_tpu.datasets.synthetic.write_synthetic_node_dataset``, family
   ``elliptic``) at the slice's widths, 166 feature columns (node tokens
   S = 167), cut to ``--nodes`` transactions (2,000) and Elliptic's ratio
   of edges to nodes (234,355 / 203,769);
2. build the supervised ``tabgnn`` node-classification ``Trainer`` (the
   ``elliptic`` config: C = 32, 8 heads, 2 layers, fanouts 100/100, batch
   200, float32) with dropout 0, the host sampler and fixed capacities
   (the calibrated edge capacity; 1,024 node lanes, which every batch of
   the cut fills to at most ~800), its variables from
   ``rmm_tpu_torch.convert.random_variables`` over their shapes (which the
   record stores, so the port rebuilds the same start);
3. serve the test split from that start (``Trainer.predict``: node ids,
   classes and scores; the "unknown" rows are skipped);
4. take three train steps on the first three shuffled train batches of
   epoch 0 and record each loss and, after step 3, each variable's seeded
   sample of entries, sum and norm (``rmm_tpu_torch.convert.check_record``
   reads them) and the parameters that no step moved. The steps take the
   reference's scatter PNA aggregation (``RMM_SEGMENT_IMPL=scatter``), as
   ``tools/make_torch_port_transfer_fixture.py`` does.

The record is ``tests/fixtures/torch_port/node_record.npz`` (~25 KB).
About 2 minutes and 6 GB of memory (the attention's [1024, 8, 167, 167]
scores a layer).

    JAX_PLATFORMS=cpu python tools/make_torch_port_node_fixture.py

This tool imports both packages; it is not part of the port.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import make_torch_port_ssl_fixture as ssl_fixture  # noqa: E402
from rmm_tpu.datasets.elliptic import EllipticBitcoin  # noqa: E402
from rmm_tpu.datasets.synthetic import write_synthetic_node_dataset  # noqa: E402
from rmm_tpu.train.trainer import Trainer  # noqa: E402
from rmm_tpu.utils.config import Config  # noqa: E402
from rmm_tpu_torch.convert import (flatten_variables, pack_record,  # noqa: E402
                                   random_variables)
from tests.torch_port_util import nest  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
RECORD = os.path.join(FIXTURES, "node_record.npz")
#: Elliptic's transactions and edges (Weber et al. 2019)
ELLIPTIC_NODES, ELLIPTIC_EDGES = 203769, 234355
SPEC = dict(num_feats=166, data_seed=5, n_hidden=32, n_gnn_layers=2,
            num_neighs=[100, 100], batch_size=200, node_capacity=1024,
            lr=0.0006116418195373612, sample=64)
STEPS, SEED, VAR_SEED = 3, 1, 31


def elliptic_dir(workdir: str, nodes: int) -> str:
    """The cut's directory (its path names ``elliptic``, which the CLIs'
    dataset dispatch and config override read)."""
    root = os.path.join(workdir, f"elliptic_{nodes}")
    write_synthetic_node_dataset(
        root, family="elliptic", num_nodes=nodes,
        num_edges=round(nodes * ELLIPTIC_EDGES / ELLIPTIC_NODES),
        num_feats=SPEC["num_feats"], seed=SPEC["data_seed"])
    return root


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=2000)
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    args = p.parse_args(argv)
    root = elliptic_dir(args.workdir, args.nodes)

    def config(**kw):
        return Config(model="tabgnn", data=root, task="node_classification",
                      batch_size=SPEC["batch_size"],
                      n_hidden=SPEC["n_hidden"],
                      n_gnn_layers=SPEC["n_gnn_layers"],
                      num_neighs=tuple(SPEC["num_neighs"]), lr=SPEC["lr"],
                      seed=SEED, dropout=0.0, sampler="host", **kw)

    probe = EllipticBitcoin(root=root, khop_neighbors=tuple(
        SPEC["num_neighs"]), channels=SPEC["n_hidden"])
    calibrated = probe.calibrate_capacities(SPEC["batch_size"])
    ds = EllipticBitcoin(root=root, khop_neighbors=tuple(SPEC["num_neighs"]),
                         channels=SPEC["n_hidden"])
    os.environ["RMM_SEGMENT_IMPL"] = "scatter"   # read when a step traces
    tr = Trainer(config(edge_capacity=calibrated[0],
                        node_capacity=SPEC["node_capacity"]), ds)
    shapes = {k: list(np.shape(v))
              for k, v in flatten_variables(tr.variables).items()}
    start = random_variables(shapes, VAR_SEED)
    tr.variables = jax.tree_util.tree_map(jnp.asarray, nest(start))
    tr.opt_state = tr.tx.init(tr.variables["params"])

    train, _, test = ds.nodes.split()
    served = tr.predict(test, mode="test")

    losses = []
    key = jax.random.PRNGKey(0)
    for gb in itertools.islice(tr._batches(train, "train", 0), STEPS):
        tr.variables, tr.opt_state, loss, _ = tr._train_step(
            tr.variables, tr.opt_state, gb, key, tr.edge_table,
            tr.node_table)
        losses.append(float(loss))
    after = flatten_variables(jax.device_get(tr.variables))
    unmoved = sorted(k for k in after if k.startswith("params/")
                     and np.array_equal(after[k], start[k]))

    arrays = {"sup/term/loss": np.asarray(losses, np.float64),
              "serve/id": served["id"], "serve/pred": served["pred"],
              "serve/score": np.asarray(served["score"], np.float32)}
    arrays.update(ssl_fixture.sampled(after, "sup/", SPEC["sample"]))
    split_rows = [len(v.indices) for v in ds.nodes.split()]
    settings = dict(SPEC, nodes=args.nodes,
                    edges=round(args.nodes * ELLIPTIC_EDGES / ELLIPTIC_NODES),
                    shapes=shapes, steps=STEPS, epoch=0, seed=SEED,
                    var_seed=VAR_SEED, dropout=0.0, nhead=8,
                    segment_impl="scatter", unmoved=unmoved,
                    calibrated_capacities=list(calibrated),
                    edge_capacity=tr.cfg.edge_capacity,
                    node_capacity=tr.cfg.node_capacity,
                    split_rows=split_rows, served_rows=len(served["id"]),
                    losses=losses)
    np.savez_compressed(RECORD, **pack_record(arrays),
                        settings=np.array(json.dumps(settings)))
    print(json.dumps({"record": os.path.relpath(RECORD, ROOT),
                      "bytes": os.path.getsize(RECORD),
                      "capacities": [tr.cfg.edge_capacity,
                                     tr.cfg.node_capacity],
                      "calibrated": list(calibrated),
                      "split_rows": split_rows,
                      "served": len(served["id"]), "unmoved": unmoved,
                      "losses": losses}))


if __name__ == "__main__":
    main()
