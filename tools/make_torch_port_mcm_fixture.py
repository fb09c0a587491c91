"""Write the JAX record of the masked-cell objectives that the PyTorch port
is held against: ``tests/test_torch_mcm_record.py`` on the CPU and
``chip_smoke.py``'s ``mcm_parity`` phase on the GPU (where there is no
JAX, so it reads this record).

On the CPU, with ``rmm_tpu``, three train steps (dropout 0) of each of:

1. ``tabular/`` and ``tabular_mv/``: the tabular MCM trainer of
   ``cli/fttransformer.py`` (``rmm_tpu.train.tabular.TabularMCMTrainer``)
   at the CLI's widths (C = 128, 8 heads, 3 layers, batch 200, AdamW at lr
   2e-4, weight decay 1e-3), plain and with ``--mask_vector``, on a
   16,384-row cut of the config of record's data (the cut of
   ``tools/make_torch_port_family_fixture.py``: data seed 0, 1,024
   accounts);
2. ``mcm_<model>/`` for ``tabgnn``, ``pna``, ``cpna`` and ``tabgnnfused``:
   the supervised trainer's ``--task mcm_edge_table`` at the supervised
   launcher's widths (C = 32, 8 heads, 2 layers, fanouts 100/100, batch
   200, ``--emlps``, Adam at the config's lr) on the same cut, with the
   family record's capacities (32,768 edge and 2,048 node lanes);
3. ``moco/``: SSL pretraining (mcm-lp) with ``--moo moco`` at the SSL
   config of record's widths (C = 128, 3 layers, 64 negatives, fanouts
   100/100, batch 200) on the 4,096-row cut of ``ssl_record.npz``.

Each starts from ``rmm_tpu_torch.convert.random_variables`` over the
variables' shapes in the port's module layout (which the record stores, so
the port rebuilds the same start) and takes the first three shuffled train
batches of epoch 0. The record holds: the start's outputs on the first
64 rows of the first validation batch (``out/...``: the MCM numerical and
categorical outputs, and the mask vector's), each step's loss and its terms
(``rmm_tpu_torch.convert.loss_terms``), and after step 3 each variable's
seeded sample of 16 entries, sum and norm (``convert.check_record``
reads them) and the parameters no step moved; under MoCo also λ and the norm of
each row of ``y`` after each step (both independent of the order in which
the parameters are flattened), and the first 16 seeds' negatives of the
first batch. The PNA sums take the reference's scatter
path (``RMM_SEGMENT_IMPL=scatter``), as the family record's do.

    JAX_PLATFORMS=cpu python tools/make_torch_port_mcm_fixture.py

The record is ``tests/fixtures/torch_port/mcm_record.npz`` (~0.13 MB). About
3 minutes and 4 GB of memory. This tool imports both packages; it is not
part of the port.
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
from rmm_tpu.datasets.base import PretrainType  # noqa: E402
from rmm_tpu.train.pretrain import PretrainTrainer  # noqa: E402
from rmm_tpu.train.tabular import TabularMCMTrainer  # noqa: E402
from rmm_tpu.train.trainer import Trainer  # noqa: E402
from rmm_tpu.utils.config import Config  # noqa: E402
from rmm_tpu_torch.convert import (flatten_variables, loss_terms,  # noqa: E402
                                   pack_record, pretrain_variables,
                                   random_variables, tabular_variables)
from rmm_tpu_torch.train.trainer import MCM_SUMS  # noqa: E402
from tests.torch_port_util import nest  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
RECORD = os.path.join(FIXTURES, "mcm_record.npz")
CUT = dict(rows=16384, num_accounts=1024, data_seed=0)
TABULAR = dict(channels=128, num_layers=3, batch_size=200, lr=2e-4,
               weight_decay=1e-3, adam_eps=1e-8, sample=16)
EDGE_MODELS = ("tabgnn", "pna", "cpna", "tabgnnfused")
EDGE = dict(n_hidden=32, n_gnn_layers=2, num_neighs=[100, 100],
            batch_size=200, edge_capacity=32768, node_capacity=2048,
            emlps=True, lr=0.0006116418195373612, sample=16)
MOCO = dict(rows=4096, num_accounts=256, channels=128, num_layers=3,
            num_neg_samples=64, khop_neighbors=[100, 100], batch_size=200,
            lr=2e-4, weight_decay=1e-3, adam_eps=1e-8, sample=16)
STEPS, SEED, VAR_SEED = 3, 1, 61
#: the rows of the first validation batch's outputs, and the seed edges of
#: the first MoCo batch whose negatives, that the record keeps
OUT_ROWS, NEG_SEEDS = 64, 16


def outputs(prefix: str, num_out, cat_out, mv_out=None) -> dict:
    out = {f"{prefix}out/num": np.asarray(num_out, np.float32)[:OUT_ROWS]}
    for i, c in enumerate(cat_out):
        out[f"{prefix}out/cat_{i}"] = np.asarray(c, np.float32)[:OUT_ROWS]
    if mv_out is not None:
        out[f"{prefix}out/mv"] = np.asarray(mv_out, np.float32)[:OUT_ROWS]
    return out


def unmoved(after: dict, start: dict) -> list:
    return sorted(k for k in after if k.startswith("params/")
                  and np.array_equal(after[k], start[k]))


def run_tabular(csv: str, mask_vector: bool) -> tuple[dict, dict]:
    t = TABULAR
    cfg = Config(model="fttransformer", data=csv, batch_size=t["batch_size"],
                 n_hidden=t["channels"], n_gnn_layers=t["num_layers"],
                 dropout=0.0, lr=t["lr"], weight_decay=t["weight_decay"],
                 adam_eps=t["adam_eps"], seed=SEED)
    ds = IBMTransactionsAML(root=csv, pretrain={PretrainType.MASK},
                            channels=cfg.n_hidden)
    tr = TabularMCMTrainer(cfg, ds.edges, mask_vector=mask_vector)
    layout = flatten_variables(tabular_variables(tr.params))
    shapes = {k: list(np.shape(v)) for k, v in layout.items()}
    start = random_variables(shapes, VAR_SEED)
    flat = nest(start)["params"]
    tr.params = jax.tree_util.tree_map(jnp.asarray, {
        "encoder": {"params": flat["edge_encoder"]},
        "model": {"params": flat["model"]},
        "head": {"params": flat["head"]}})
    tr.opt_state = tr.tx.init(tr.params)
    train, val, _ = ds.edges.split()
    p = "tabular_mv/" if mask_vector else "tabular/"
    tf, _ = next(iter(tr._loader(val, False)))
    arrays = outputs(p, *tr._eval_step(tr.params, tf))
    terms = []
    for tf, valid in itertools.islice(tr._loader(train, True, 0), STEPS):
        mask = np.zeros(cfg.batch_size, bool)
        mask[:valid] = True
        tr.params, tr.opt_state, loss, aux = tr._train_step(
            tr.params, tr.opt_state, tf, mask, jax.random.PRNGKey(0))
        terms.append(loss_terms(loss, {k: float(aux[k])
                                       for k in MCM_SUMS}))
    after = flatten_variables(jax.device_get(tabular_variables(tr.params)))
    arrays.update({f"{p}term/{k}": np.asarray([x[k] for x in terms])
                   for k in terms[0]})
    arrays.update(ssl_fixture.sampled(after, p, t["sample"]))
    return arrays, {"shapes": shapes, "terms": terms,
                    "unmoved": unmoved(after, start)}


def run_edge(csv: str, model: str) -> tuple[dict, dict]:
    e = EDGE
    cfg = Config(model=model, data=csv, task="mcm_edge_table",
                 batch_size=e["batch_size"], n_hidden=e["n_hidden"],
                 n_gnn_layers=e["n_gnn_layers"],
                 num_neighs=tuple(e["num_neighs"]), lr=e["lr"],
                 emlps=e["emlps"], seed=SEED, dropout=0.0, sampler="host",
                 edge_capacity=e["edge_capacity"],
                 node_capacity=e["node_capacity"])
    ds = IBMTransactionsAML(
        root=csv, khop_neighbors=cfg.num_neighs, channels=cfg.n_hidden,
        pretrain={PretrainType.MASK, PretrainType.LINK_PRED})
    tr = Trainer(cfg, ds)
    shapes = {k: list(np.shape(v))
              for k, v in flatten_variables(tr.variables).items()}
    start = random_variables(shapes, VAR_SEED)
    tr.variables = jax.tree_util.tree_map(jnp.asarray, nest(start))
    tr.opt_state = tr.tx.init(tr.variables["params"])
    train, val, _ = ds.edges.split()
    p = f"mcm_{model}/"
    gb = next(tr._batches(val, "val"))
    arrays = outputs(p, *tr.model.apply(tr.variables, tr.edge_table,
                                        tr.node_table, gb, False))
    terms = []
    key = jax.random.PRNGKey(0)
    for gb in itertools.islice(tr._batches(train, "train", 0), STEPS):
        tr.variables, tr.opt_state, loss, aux = tr._train_step(
            tr.variables, tr.opt_state, gb, key, tr.edge_table,
            tr.node_table)
        terms.append(loss_terms(loss, {k: float(aux[k])
                                       for k in MCM_SUMS}))
    after = flatten_variables(jax.device_get(tr.variables))
    arrays.update({f"{p}term/{k}": np.asarray([x[k] for x in terms])
                   for k in terms[0]})
    arrays.update(ssl_fixture.sampled(after, p, e["sample"]))
    assert (tr.cfg.edge_capacity, tr.cfg.node_capacity) == (
        e["edge_capacity"], e["node_capacity"])
    return arrays, {"shapes": shapes, "terms": terms,
                    "unmoved": unmoved(after, start)}


def run_moco(csv: str) -> tuple[dict, dict]:
    m = MOCO
    cfg = Config(model="tabgnnfused", data=csv, batch_size=m["batch_size"],
                 n_hidden=m["channels"], n_gnn_layers=m["num_layers"],
                 dropout=0.0, num_neg_samples=m["num_neg_samples"],
                 num_neighs=tuple(m["khop_neighbors"]), lr=m["lr"],
                 weight_decay=m["weight_decay"], adam_eps=m["adam_eps"],
                 seed=SEED, moo="moco")
    ds = IBMTransactionsAML(
        root=csv, khop_neighbors=cfg.num_neighs, channels=cfg.n_hidden,
        pretrain={PretrainType.MASK, PretrainType.LINK_PRED})
    tr = PretrainTrainer(cfg, ds, mode="mcm-lp")
    layout = flatten_variables(pretrain_variables(tr.params, tr.batch_stats))
    shapes = {k: list(np.shape(v)) for k, v in layout.items()}
    start = random_variables(shapes, VAR_SEED)
    flat = nest(start)
    tr.params = jax.tree_util.tree_map(jnp.asarray, {
        "encoder": {"params": flat["params"]["edge_encoder"]},
        "model": flat["params"]["model"],
        "mcm_head": {"params": flat["params"]["mcm_head"]},
        "lp_head": {"params": flat["params"]["lp_head"]}})
    tr.batch_stats = jax.tree_util.tree_map(jnp.asarray,
                                            flat["batch_stats"]["model"])
    tr.opt_state = tr.tx.init(tr.params)
    batches = list(itertools.islice(
        tr._batches(ds.edges.split()[0], "train", 0), STEPS))
    view_losses = jax.jit(tr.pm.mode_losses, static_argnums=(5, 6))
    terms, lambd, y_norm = [], [], []
    for gb in batches:
        rng = jax.random.PRNGKey(0)
        views, _, _ = view_losses(tr.params, tr.batch_stats, gb,
                                  tr.edge_table, rng, True, "mcm-lp")
        (tr.params, tr.batch_stats, tr.opt_state, tr.moco_state, loss,
         sums) = tr._train_step(tr.params, tr.batch_stats, tr.opt_state,
                                tr.moco_state, gb, rng, tr.edge_table)
        sums = {k: float(v) for k, v in jax.device_get(sums).items()}
        sums["lp"] = float(views["lp"])
        terms.append(loss_terms(loss, sums))
        lambd.append(np.asarray(tr.moco_state.lambd, np.float64))
        y_norm.append(np.linalg.norm(np.asarray(tr.moco_state.y,
                                                np.float64), axis=1))
    after = flatten_variables(jax.device_get(
        pretrain_variables(tr.params, tr.batch_stats)))
    arrays = {f"moco/term/{k}": np.asarray([x[k] for x in terms])
              for k in terms[0]}
    arrays["moco/neg0"] = np.asarray(
        batches[0].neg_edge_index, np.int32)[:, :NEG_SEEDS * m[
            "num_neg_samples"]]
    arrays["moco/lambd"] = np.stack(lambd)
    arrays["moco/y_norm"] = np.stack(y_norm)
    arrays.update(ssl_fixture.sampled(after, "moco/", m["sample"]))
    return arrays, {"shapes": shapes, "terms": terms,
                    "unmoved": unmoved(after, start),
                    "edge_capacity": tr.cfg.edge_capacity,
                    "node_capacity": tr.cfg.node_capacity,
                    "lambd": [x.tolist() for x in lambd]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    csv = write_synthetic_aml_csv(
        os.path.join(args.workdir, f"aml_{CUT['rows']}.csv"),
        num_rows=CUT["rows"], num_accounts=CUT["num_accounts"],
        seed=CUT["data_seed"])
    base = json.loads(str(np.load(os.path.join(
        FIXTURES, "aml_record.npz"))["settings"]))
    moco_seed = base["data_seed"]
    moco_csv = write_synthetic_aml_csv(
        os.path.join(args.workdir, f"aml_moco_{MOCO['rows']}.csv"),
        num_rows=MOCO["rows"], num_accounts=MOCO["num_accounts"],
        seed=moco_seed)
    arrays, runs = {}, {}
    for name, fn in ([("tabular", lambda: run_tabular(csv, False)),
                      ("tabular_mv", lambda: run_tabular(csv, True))]
                     + [(f"mcm_{m}", lambda m=m: run_edge(csv, m))
                        for m in EDGE_MODELS]
                     + [("moco", lambda: run_moco(moco_csv))]):
        a, runs[name] = fn()
        arrays.update(a)
        print(json.dumps({"run": name, "terms": runs[name]["terms"]}),
              flush=True)
    settings = dict(cut=CUT, tabular=TABULAR, edge=EDGE, edge_models=list(
        EDGE_MODELS), moco=dict(MOCO, data_seed=moco_seed), runs=runs,
        steps=STEPS, epoch=0, seed=SEED, var_seed=VAR_SEED, dropout=0.0,
        nhead=8, segment_impl="scatter")
    np.savez_compressed(RECORD, **pack_record(arrays),
                        settings=np.array(json.dumps(settings)))
    print(json.dumps({"record": os.path.relpath(RECORD, ROOT),
                      "bytes": os.path.getsize(RECORD)}))


if __name__ == "__main__":
    main()
