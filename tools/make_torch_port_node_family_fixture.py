"""Write the JAX record of node classification across the model menu and
of the other node datasets that the PyTorch port is held against:
``tests/test_torch_node_family_record.py`` on the CPU and
``chip_smoke.py``'s ``node_family_parity`` phase on the GPU (where there is
no JAX, so it reads this record).

On the CPU, with ``rmm_tpu``, on synthetic data written by
``rmm_tpu.datasets.synthetic.write_synthetic_node_dataset``:

1. Ethereum phishing (``eth``: 2,000 accounts, 9,120 transactions, the
   published network's ~4.56 transactions an account), node
   classification through the JAX CLI's config (``config_from_args``, whose
   ``ethereum-phishing`` override sets lr 8e-4, w_ce2 1.16 and 2 layers) at
   the supervised launcher's widths (C = 32, 8 heads, fanouts 100/100,
   batch 200, float32) with dropout 0, for every model of the menu
   (``fttransformer``, ``gin``, ``pna``, ``cpna``, ``cpnatab``, ``tabgnn``,
   ``tabgnninterleaved``, ``tabgnnfused``), ``cpna`` and ``cpnatab`` again
   with ``--ego``, and ``tabgnn`` with ``--ports``;
2. mcm-lp pretraining on the same data through the SSL CLI's dispatch (a
   path holding ``eth``: ``EthereumPhishing`` split by ``temporal_daily``
   at 0.6/0.2/0.2) at the SSL config of record's widths (C = 128, 3
   layers, 64 negatives, fanouts 100/100, lr 2e-4) with dropout 0 and
   batch 64 (a third of its 200, so that the CPU test's three steps take
   ~40 s on one core), and the MCM metrics of one evaluated batch;
3. ``tabgnn`` node classification at the launcher's widths on ogbn-arxiv
   (1,000 papers, 16 features and ``year``: S = 18), MUSAE GitHub (1,000
   developers, 128 features: S = 129) and LastFM Asia (1,000 users, 8
   features: S = 9), each at its published ratio of edges to nodes.

Each run starts from ``rmm_tpu_torch.convert.random_variables`` over its
variables' shapes (which the record stores, so the port rebuilds the same
start) and records: the first test batch served from that start (its seed
nodes' ids and logits; the SSL run: the first batch's negatives), three
train steps on the first three shuffled train batches of epoch 0 (each
loss term and, after step 3, each variable's seeded sample of entries, sum
and norm, which ``rmm_tpu_torch.convert.check_record`` reads) and the
parameters that no step moved. The capacities are calibrated once a
dataset (the node lanes no more than the graph's nodes need). The PNA
sums take the reference's scatter
path (``RMM_SEGMENT_IMPL=scatter``); ``cpnatab``'s row attention runs at
dropout 0 (``tests.torch_port_util.jax_cpnatab_without_row_dropout``). The
record is ``tests/fixtures/torch_port/node_family_record.npz`` (each run's
arrays under ``<run>/``, in ``rmm_tpu_torch.convert.pack_record``'s
layout, as every record; ``load_record`` reads it).
About 5 minutes and 4 GB of memory.

    JAX_PLATFORMS=cpu python tools/make_torch_port_node_family_fixture.py

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
from rmm_tpu.datasets import build_dataset  # noqa: E402
from rmm_tpu.datasets.base import PretrainType  # noqa: E402
from rmm_tpu.datasets.eth_phishing import EthereumPhishing  # noqa: E402
from rmm_tpu.datasets.synthetic import write_synthetic_node_dataset  # noqa: E402
from rmm_tpu.train.pretrain import PretrainTrainer  # noqa: E402
from rmm_tpu.train.trainer import Trainer  # noqa: E402
from rmm_tpu.utils.config import Config, config_from_args, create_parser  # noqa: E402
from rmm_tpu_torch.convert import (flatten_variables, loss_terms,  # noqa: E402
                                   pack_record, pretrain_variables,
                                   random_variables)
from tests.torch_port_util import jax_cpnatab_without_row_dropout, nest  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
RECORD = os.path.join(FIXTURES, "node_family_record.npz")
#: the datasets: (family, directory name, nodes, edges, feature columns,
#: classes); edges at each published network's ratio to its nodes
DATA = {
    "eth": ("eth", "ethereum-phishing", 2000, 9120, 8, 2),
    "ogbn": ("ogbn", "ogbn-arxiv", 1000, 6887, 16, 40),
    "musae": ("musae", "musae-github", 1000, 7666, 128, 2),
    "lastfm": ("lastfm", "lastfm-asia", 1000, 3647, 8, 18),
}
#: the supervised runs: name → (dataset, model, extra flags)
RUNS = {
    **{m: ("eth", m, []) for m in (
        "fttransformer", "gin", "pna", "cpna", "cpnatab", "tabgnn",
        "tabgnninterleaved", "tabgnnfused")},
    "cpna_ego": ("eth", "cpna", ["--ego"]),
    "cpnatab_ego": ("eth", "cpnatab", ["--ego"]),
    "tabgnn_ports": ("eth", "tabgnn", ["--ports"]),
    "ogbn": ("ogbn", "tabgnn", []),
    "musae": ("musae", "tabgnn", []),
    "lastfm": ("lastfm", "tabgnn", []),
}
SPEC = dict(n_hidden=32, n_gnn_layers=2, num_neighs=[100, 100],
            batch_size=200, data_seed=4, sample=64)
SSL = dict(channels=128, num_layers=3, num_neg_samples=64,
           khop_neighbors=[100, 100], batch_size=64, lr=2e-4,
           weight_decay=1e-3, adam_eps=1e-8, sample=48)
STEPS, SEED, VAR_SEED = 3, 1, 61


def data_dir(workdir: str, name: str) -> str:
    family, dirname, nodes, edges, feats, classes = DATA[name]
    root = os.path.join(workdir, f"{dirname}_{nodes}")
    write_synthetic_node_dataset(root, family=family, num_nodes=nodes,
                                 num_edges=edges, num_feats=feats,
                                 n_classes=classes, seed=SPEC["data_seed"])
    return root


def argv(root: str, model: str, extra: list) -> list:
    """The CLI flags of a supervised run (the port's test and
    ``chip_smoke.py`` parse the same)."""
    return ["--data", root, "--model", model, "--task",
            "node_classification", "--n_hidden", str(SPEC["n_hidden"]),
            "--n_gnn_layers", str(SPEC["n_gnn_layers"]), "--num_neighs",
            *map(str, SPEC["num_neighs"]), "--batch_size",
            str(SPEC["batch_size"]), "--seed", str(SEED), *extra]


def sup_run(name: str, root: str, caps: dict) -> tuple[dict, dict]:
    _, model, extra = RUNS[name]
    cfg = config_from_args(create_parser().parse_args(
        argv(root, model, extra))).replace(dropout=0.0, sampler="host")
    ds = build_dataset(cfg)
    cfg = cfg.replace(n_classes=ds.n_classes, **caps)
    tr = Trainer(cfg, ds)
    shapes = {k: list(np.shape(v))
              for k, v in flatten_variables(tr.variables).items()}
    start = random_variables(shapes, VAR_SEED)
    tr.variables = jax.tree_util.tree_map(jnp.asarray, nest(start))
    tr.opt_state = tr.tx.init(tr.variables["params"])
    train, _, test = ds.nodes.split()

    gb = next(tr._batches(test, "test"))
    logits = np.asarray(tr.model.apply(tr.variables, tr.edge_table,
                                       tr.node_table, gb, False))
    keep = np.asarray(gb.seed_mask)
    ids = np.asarray(gb.node_gather)[:cfg.batch_size][keep]

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
    p = f"{name}/"
    arrays = {f"{p}term/loss": np.asarray(losses, np.float64),
              f"{p}serve/id": ids.astype(np.int64),
              f"{p}serve/logits": logits[keep].astype(np.float32)}
    arrays.update(ssl_fixture.sampled(after, p, SPEC["sample"]))
    return arrays, {"model": model, "data": name if name in DATA
                    else "eth", "flags": extra, "lr": cfg.lr,
                    "n_classes": cfg.n_classes, "shapes": shapes,
                    "unmoved": unmoved, "losses": losses,
                    "served": int(len(ids))}


def ssl_run(root: str) -> tuple[dict, dict]:
    """Three mcm-lp steps as ``make_torch_port_ssl_fixture.run_mode``
    takes them, on Ethereum phishing as the JAX SSL CLI builds it."""
    cfg = Config(model="tabgnnfused", data=root,
                 batch_size=SSL["batch_size"], n_hidden=SSL["channels"],
                 n_gnn_layers=SSL["num_layers"], dropout=0.0,
                 num_neg_samples=SSL["num_neg_samples"],
                 num_neighs=tuple(SSL["khop_neighbors"]), lr=SSL["lr"],
                 weight_decay=SSL["weight_decay"], adam_eps=SSL["adam_eps"],
                 seed=SEED, sampler="host")
    ds = EthereumPhishing(
        root=root, pretrain={PretrainType.MASK, PretrainType.LINK_PRED},
        split_type=cfg.split_type, splits=cfg.splits,
        khop_neighbors=cfg.num_neighs, channels=cfg.n_hidden)
    tr = PretrainTrainer(cfg, ds, mode="mcm-lp")
    layout = flatten_variables(pretrain_variables(tr.params, tr.batch_stats))
    shapes = {k: list(np.shape(v)) for k, v in layout.items()}
    flat = nest(random_variables(shapes, VAR_SEED))
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
    terms = []
    for gb in batches:
        rng = jax.random.PRNGKey(0)
        views, _, _ = view_losses(tr.params, tr.batch_stats, gb,
                                  tr.edge_table, rng, True, "mcm-lp")
        (tr.params, tr.batch_stats, tr.opt_state, _, loss,
         sums) = tr._train_step(tr.params, tr.batch_stats, tr.opt_state,
                                None, gb, rng, tr.edge_table)
        sums = {k: float(v) for k, v in jax.device_get(sums).items()}
        sums["lp"] = float(views["lp"])
        terms.append(loss_terms(loss, sums))
    # the MCM metrics of one evaluated batch: no categorical masked column
    val_view = ds.edges.split()[1]
    val = tr.evaluate(type(val_view)(val_view.parent, val_view.indices[
        :cfg.batch_size]), "val")
    after = flatten_variables(jax.device_get(
        pretrain_variables(tr.params, tr.batch_stats)))
    out = {f"ssl/term/{k}": np.asarray([t[k] for t in terms], np.float64)
           for k in terms[0]}
    out["ssl/neg0"] = np.asarray(batches[0].neg_edge_index, np.int32)
    out.update(ssl_fixture.sampled(after, "ssl/", SSL["sample"]))
    return out, {"shapes": shapes, "edge_capacity": tr.cfg.edge_capacity,
                 "node_capacity": tr.cfg.node_capacity, "terms": terms,
                 "val_accuracy": float(val["accuracy"]),
                 "val_keys": sorted(val)}


def main(argv_=None):
    p = argparse.ArgumentParser()
    p.add_argument("--runs", default=",".join(RUNS))
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    args = p.parse_args(argv_)
    os.makedirs(args.workdir, exist_ok=True)
    roots = {name: data_dir(args.workdir, name) for name in DATA}
    # one pair of capacities a dataset, calibrated once, for every run
    caps = {}
    for name, root in roots.items():
        cfg = config_from_args(create_parser().parse_args(
            argv(root, "tabgnn", []) + ["--ports", "--ego"]))
        ec, nc = build_dataset(cfg).calibrate_capacities(SPEC["batch_size"])
        # no batch holds more nodes than the graph
        nodes = DATA[name][2]
        caps[name] = {"edge_capacity": ec,
                      "node_capacity": min(nc, 1 << (nodes - 1).bit_length())}
    arrays, runs = {}, {}
    with jax_cpnatab_without_row_dropout():
        for name in args.runs.split(","):
            data = RUNS[name][0]
            a, runs[name] = sup_run(name, roots[data], caps[data])
            arrays.update(a)
            print(json.dumps({"run": name, "losses": runs[name]["losses"]}),
                  flush=True)
    a, ssl = ssl_run(roots["eth"])
    arrays.update(a)
    print(json.dumps({"run": "ssl", "terms": ssl["terms"],
                      "val_accuracy": ssl["val_accuracy"]}), flush=True)
    settings = dict(SPEC, data={k: dict(zip(
        ("family", "dir", "nodes", "edges", "num_feats", "n_classes"), v))
        for k, v in DATA.items()}, capacities=caps, runs=runs,
        ssl=dict(SSL, **ssl), steps=STEPS, epoch=0, seed=SEED,
        var_seed=VAR_SEED, dropout=0.0, nhead=8, segment_impl="scatter")
    np.savez_compressed(RECORD, **pack_record(arrays),
                        settings=np.array(json.dumps(settings)))
    print(json.dumps({"record": os.path.relpath(RECORD, ROOT),
                      "bytes": os.path.getsize(RECORD), "capacities": caps}))


if __name__ == "__main__":
    main()
