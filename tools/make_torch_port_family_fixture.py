"""Write the JAX record of the model families ``fttransformer``, ``gin``,
``pna``, ``cpna``, ``cpnatab`` and ``tabgnninterleaved`` that the PyTorch
port is held against on the GPU (``chip_smoke.py``'s ``family_parity``
phase, where there is no JAX, so it reads this record).

On the CPU, with ``rmm_tpu``, for each model in turn:

1. the supervised launcher's widths (``launchers/supervised/supervised.sh``:
   C = 32, 8 heads, 2 layers, fanouts 100/100, batch 200, float32, Adam
   at the config's lr) with dropout 0 and ``--emlps`` (the edge updates
   of the GNN baselines; the other two models ignore it), on the
   16,384-row cut of the config of record's data that
   ``tools/make_torch_port_train_fixture.py`` uses (data seed 0, 1,024
   accounts; its capacities, 32,768 edge and 2,048 node lanes);
2. the variables from ``rmm_tpu_torch.convert.random_variables`` over
   their shapes (which the record stores, so the port rebuilds the same
   start);
3. the first batch of the test split served from that start (its seed
   edges' ids and class-1 scores);
4. three train steps on the first three shuffled train batches of epoch
   0: each loss and, after step 3, each variable's seeded sample of
   entries, sum and norm (``rmm_tpu_torch.convert.check_record`` reads
   them), and the parameters that no step moved.

The PNA sums take the reference's scatter path (``RMM_SEGMENT_IMPL=
scatter``), as ``tools/make_torch_port_node_fixture.py``'s do; ``cpnatab``'s
row attention, whose dropout 0.1 no flag reaches, runs at 0
(``tests.torch_port_util.jax_cpnatab_without_row_dropout``; the port takes
``nn.dropout.set_rate(model, 0)``). The record is
``tests/fixtures/torch_port/family_record.npz`` (~0.17 MB, each model's
arrays under ``<model>/``). About 5 minutes and 5 GB of memory.

    JAX_PLATFORMS=cpu python tools/make_torch_port_family_fixture.py

``--against sort`` writes nothing: it runs the same steps on the
reference's own default PNA path (its sums as differences of one sorted
cumsum, the same sums up to rounding) and prints how far that lands from
the record by ``rmm_tpu_torch.convert.check_record``'s limits, which is
how far the reference reproduces itself when only the rounding changes.

    JAX_PLATFORMS=cpu python tools/make_torch_port_family_fixture.py \
        --against sort --models cpna,cpnatab

This tool imports both packages; it is not part of the port.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["RMM_SEGMENT_IMPL"] = "scatter"   # read when a step traces
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import make_torch_port_ssl_fixture as ssl_fixture  # noqa: E402
from rmm_tpu.datasets import IBMTransactionsAML, write_synthetic_aml_csv  # noqa: E402
from rmm_tpu.train.trainer import Trainer  # noqa: E402
from rmm_tpu.utils.config import Config  # noqa: E402
import torch  # noqa: E402

from rmm_tpu_torch.convert import (check_record, flatten_variables,  # noqa: E402
                                   load_record, pack_record,
                                   random_variables, torch_key)
from tests.torch_port_util import jax_cpnatab_without_row_dropout, nest  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
RECORD = os.path.join(FIXTURES, "family_record.npz")
MODELS = ("fttransformer", "gin", "pna", "cpna", "cpnatab",
          "tabgnninterleaved")
SPEC = dict(rows=16384, num_accounts=1024, data_seed=0, n_hidden=32,
            n_gnn_layers=2, num_neighs=[100, 100], batch_size=200,
            edge_capacity=32768, node_capacity=2048, emlps=True,
            lr=0.0006116418195373612, sample=64)
STEPS, SEED, VAR_SEED = 3, 1, 51


def run(model: str, csv: str) -> tuple[dict, dict, dict]:
    """One model's record arrays (under ``<model>/``), settings and flat
    variables after the steps."""
    cfg = Config(model=model, data=csv, task="edge_classification",
                 batch_size=SPEC["batch_size"], n_hidden=SPEC["n_hidden"],
                 n_gnn_layers=SPEC["n_gnn_layers"],
                 num_neighs=tuple(SPEC["num_neighs"]), lr=SPEC["lr"],
                 emlps=SPEC["emlps"], seed=SEED, dropout=0.0,
                 sampler="host", edge_capacity=SPEC["edge_capacity"],
                 node_capacity=SPEC["node_capacity"])
    ds = IBMTransactionsAML(root=csv, khop_neighbors=cfg.num_neighs,
                            channels=cfg.n_hidden)
    tr = Trainer(cfg, ds)
    shapes = {k: list(np.shape(v))
              for k, v in flatten_variables(tr.variables).items()}
    start = random_variables(shapes, VAR_SEED)
    tr.variables = jax.tree_util.tree_map(jnp.asarray, nest(start))
    tr.opt_state = tr.tx.init(tr.variables["params"])
    train, _, test = ds.edges.split()

    gb = next(tr._batches(test, "test"))
    logits = np.asarray(tr.model.apply(tr.variables, tr.edge_table,
                                       tr.node_table, gb, False))
    b, keep = cfg.batch_size, np.asarray(gb.seed_mask)
    score = np.asarray(jax.nn.softmax(logits, axis=-1)[:, 1])[keep]
    ids = np.asarray(gb.edge_gather)[:b][keep].astype(np.int64)

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
    p = f"{model}/"
    arrays = {f"{p}term/loss": np.asarray(losses, np.float64),
              f"{p}serve/id": ids,
              f"{p}serve/score": score.astype(np.float32)}
    arrays.update(ssl_fixture.sampled(after, p, SPEC["sample"]))
    assert (tr.cfg.edge_capacity, tr.cfg.node_capacity) == (
        SPEC["edge_capacity"], SPEC["node_capacity"])
    return arrays, {"shapes": shapes, "unmoved": unmoved, "losses": losses,
                    "served": int(len(ids))}, after


def against(model: str, csv: str, impl: str) -> dict:
    """The reference's steps on the PNA path ``impl`` against the record:
    its faults and errors by ``check_record``'s limits for ``model``."""
    os.environ["RMM_SEGMENT_IMPL"] = impl
    rec = load_record(RECORD)
    st = json.loads(str(rec["settings"]))
    _, info, after = run(model, csv)
    state = {}
    for path, arr in after.items():
        name, transpose = torch_key(path)
        state[name] = torch.from_numpy(np.array(arr.T if transpose
                                                else arr))
    faults, summary = check_record(state, [{"loss": x} for x in
                                           info["losses"]], rec, f"{model}/",
                                   st["lr"], STEPS, st["n_hidden"],
                                   model=model)
    return {"model": model, "impl": impl, "faults": faults, **summary}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--models", default=",".join(MODELS))
    p.add_argument("--against", choices=("sort",),
                   help="hold the reference's path to the record instead")
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    csv = os.path.join(args.workdir, f"aml_{SPEC['rows']}.csv")
    write_synthetic_aml_csv(csv, num_rows=SPEC["rows"],
                            num_accounts=SPEC["num_accounts"],
                            seed=SPEC["data_seed"])
    if args.against:
        with jax_cpnatab_without_row_dropout():
            for model in args.models.split(","):
                print(json.dumps(against(model, csv, args.against)),
                      flush=True)
        return
    arrays, models = {}, {}
    with jax_cpnatab_without_row_dropout():
        for model in args.models.split(","):
            a, models[model], _ = run(model, csv)
            arrays.update(a)
            print(json.dumps({"model": model, "losses":
                              models[model]["losses"]}), flush=True)
    settings = dict(SPEC, models=models, steps=STEPS, epoch=0, seed=SEED,
                    var_seed=VAR_SEED, dropout=0.0, nhead=8,
                    segment_impl="scatter")
    np.savez_compressed(RECORD, **pack_record(arrays),
                        settings=np.array(json.dumps(settings)))
    print(json.dumps({"record": os.path.relpath(RECORD, ROOT),
                      "bytes": os.path.getsize(RECORD)}))


if __name__ == "__main__":
    main()
