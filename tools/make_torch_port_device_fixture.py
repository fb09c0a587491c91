"""Write the JAX records that the PyTorch port's device sampler and its
Rel-H&M dataset are held against: ``tests/test_torch_device_train.py`` and
``tests/test_torch_rel_hm.py`` on the CPU, ``chip_smoke.py``'s
``device_parity`` and ``rel_hm`` phases on the GPU (where there is no JAX).

``device_record.npz`` (``--records device``): the JAX package's device
sampling path (``Trainer._materialize_dev`` / ``PretrainTrainer.
_materialize_dev`` through ``_sample_one``, under ``jax.jit`` on the CPU),
on cuts whose every in-degree is at most the fanout (asserted here), where
no random draw is read and the sampled arrays are a function of the seeds:

1. ``edge``: ``tabgnn`` edge classification on a 2,000-row synthetic AML;
2. ``node``: ``tabgnn`` node classification on a 600-node synthetic
   Elliptic (its ``unknown`` rows in the expansion, out of the loss);
3. ``mcm_lp``: mcm-lp pretraining (``tabgnnfused``) on the AML cut; its
   negatives come from JAX's stream, which the port does not share (the
   port draws its own; the record's are what its steps are fed).

C = 16, 8 heads, 2 layers, fanouts 64/64, batch 64, dropout 0. Per part:
each of the first three shuffled train batches of epoch 0 as sampled (ids,
masks, local edge index, drop counts, the seed batch it came from), then
three steps from ``rmm_tpu_torch.convert.random_variables`` over the
variables' shapes (each loss term, and each variable's seeded sample of
entries, sum and norm after step 3, as every record).

``rel_hm_record.npz`` (``--records rel_hm``): Rel-H&M on an 800-row
synthetic cut (80 customers, 40 articles; 14 edge columns, S = 15
tokens with the CLS), host
sampling, C = 16, fanouts 8/8, batch 32, dropout 0: three ``--task
mcm_edge_table`` steps of ``tabgnn`` (``mcm_edge``) and three mcm-lp
pretraining steps (``mcm_lp``, 8 negatives; the first batch's negatives).

The PNA sums take the reference's scatter path
(``RMM_SEGMENT_IMPL=scatter``). About 3.5 minutes and 2 GB of memory.

    JAX_PLATFORMS=cpu python tools/make_torch_port_device_fixture.py

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
from rmm_tpu.datasets import IBMTransactionsAML  # noqa: E402
from rmm_tpu.datasets.base import PretrainType  # noqa: E402
from rmm_tpu.datasets.elliptic import EllipticBitcoin  # noqa: E402
from rmm_tpu.datasets.rel_hm import RelHM  # noqa: E402
from rmm_tpu.datasets.synthetic import (write_synthetic_aml_csv,  # noqa: E402
                                        write_synthetic_hm_csv,
                                        write_synthetic_node_dataset)
from rmm_tpu.graph.device_sampler import (sample_edges_device,  # noqa: E402
                                          sample_nodes_device)
from rmm_tpu.train.pretrain import PretrainTrainer  # noqa: E402
from rmm_tpu.train.trainer import Trainer  # noqa: E402
from rmm_tpu.utils.config import Config  # noqa: E402
from rmm_tpu_torch.convert import (flatten_variables, loss_terms,  # noqa: E402
                                   pack_record, pretrain_variables,
                                   random_variables)
from tests.torch_port_util import nest  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
#: the device record's data: AML rows (accounts rows // 16) and an
#: Elliptic cut
DEVICE_DATA = dict(aml_rows=2000, aml_seed=5, node_nodes=600, node_edges=690,
                   node_feats=20, node_seed=5)
DEVICE = dict(n_hidden=16, n_gnn_layers=2, num_neighs=[64, 64],
              batch_size=64, num_neg_samples=8, lr=2e-4, weight_decay=1e-3,
              sample=64)
HM_DATA = dict(rows=800, customers=80, articles=40, seed=0)
HM = dict(n_hidden=16, n_gnn_layers=2, num_neighs=[8, 8], batch_size=32,
          num_neg_samples=8, ssl_lr=2e-4, weight_decay=1e-3, sample=64)
STEPS, SEED, VAR_SEED = 3, 1, 23
#: what a device-sampled batch records
SAMPLED = ("edge_gather", "edge_mask", "edge_index", "node_gather",
           "node_mask", "seed_mask")
MCM_LP = {PretrainType.MASK, PretrainType.LINK_PRED}


def max_in_degree(store) -> int:
    return max(int(np.bincount(store.sampler(m).dst,
                               minlength=store.num_nodes).max())
               for m in ("train", "val", "test"))


def start_supervised(tr):
    shapes = {k: list(np.shape(v))
              for k, v in flatten_variables(tr.variables).items()}
    tr.variables = jax.tree_util.tree_map(
        jnp.asarray, nest(random_variables(shapes, VAR_SEED)))
    tr.opt_state = tr.tx.init(tr.variables["params"])
    return shapes


def start_pretrain(tr):
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
    return shapes


def node_dropped(tr, sb, dgraph, node_task: bool, split_key: bool):
    """The seed batch's ``num_node_dropped``, from the sampler itself
    (``_materialize_dev`` returns the edge drops alone), with the key
    ``_materialize_dev`` uses."""
    cfg = tr.cfg
    key = jax.random.PRNGKey(sb.sampler_seed)
    if split_key:
        key = jax.random.split(key)[0]
    if node_task:
        out = sample_nodes_device(dgraph, sb.seeds[:, 0], sb.sample_mask,
                                  key, cfg.num_neighs, cfg.edge_capacity,
                                  cfg.node_capacity,
                                  cfg.frontier_capacity or None)
    else:
        out = sample_edges_device(dgraph, sb.seeds, sb.seed_mask, key,
                                  cfg.num_neighs, cfg.edge_capacity,
                                  cfg.node_capacity,
                                  cfg.frontier_capacity or None)
    return int(out["num_node_dropped"])


def device_batches(tr, view, prefix: str, node_task: bool,
                   pretrain: bool) -> tuple[dict, list]:
    """The first three seed batches of epoch 0 and their device-sampled
    batches (``_sample_one``), recorded under ``<prefix>batch<i>/``."""
    dgraph = tr._dgraph("train")
    arrays, batches = {}, []
    seeds = tr._seed_batches(view, "train", 0)
    for i, sb in enumerate(itertools.islice(seeds, STEPS)):
        gb, dropped, kept = tr._sample_one(sb, dgraph)
        p = f"{prefix}batch{i}/"
        arrays[f"{p}seeds"] = np.asarray(sb.seeds, np.int32)
        arrays[f"{p}seed_mask_in"] = np.asarray(sb.seed_mask)
        arrays[f"{p}sampler_seed"] = np.asarray(sb.sampler_seed, np.uint32)
        arrays[f"{p}y"] = np.asarray(sb.y, np.float32)
        for k in SAMPLED:
            arrays[f"{p}{k}"] = np.asarray(getattr(gb, k))
        arrays[f"{p}num_dropped"] = np.asarray(int(dropped), np.int64)
        arrays[f"{p}kept"] = np.asarray(int(kept), np.int64)
        arrays[f"{p}num_node_dropped"] = np.asarray(
            node_dropped(tr, sb, dgraph, node_task, pretrain), np.int64)
        if pretrain:
            arrays[f"{p}neg_edge_index"] = np.asarray(gb.neg_edge_index)
        batches.append(gb)
    return arrays, batches


def supervised_steps(tr, batches) -> tuple[list, dict]:
    losses = []
    for gb in batches:
        tr.variables, tr.opt_state, loss, _ = tr._train_step(
            tr.variables, tr.opt_state, gb, jax.random.PRNGKey(0),
            tr.edge_table, tr.node_table)
        losses.append(float(loss))
    return losses, flatten_variables(jax.device_get(tr.variables))


def pretrain_steps(tr, batches, mode="mcm-lp") -> tuple[list, dict]:
    view_losses = jax.jit(tr.pm.mode_losses, static_argnums=(5, 6))
    terms = []
    for gb in batches:
        rng = jax.random.PRNGKey(0)
        views, _, _ = view_losses(tr.params, tr.batch_stats, gb,
                                  tr.edge_table, rng, True, mode)
        (tr.params, tr.batch_stats, tr.opt_state, _, loss,
         sums) = tr._train_step(tr.params, tr.batch_stats, tr.opt_state,
                                None, gb, rng, tr.edge_table)
        sums = {k: float(v) for k, v in jax.device_get(sums).items()}
        sums["lp"] = float(views["lp"])
        terms.append(loss_terms(loss, sums))
    return terms, flatten_variables(jax.device_get(
        pretrain_variables(tr.params, tr.batch_stats)))


def caps_of(cfg) -> dict:
    return {"edge_capacity": cfg.edge_capacity,
            "node_capacity": cfg.node_capacity,
            "frontier_capacity": cfg.frontier_capacity}


def device_record(workdir: str) -> tuple[dict, dict]:
    d = DEVICE_DATA
    csv = write_synthetic_aml_csv(
        os.path.join(workdir, f"aml_{d['aml_rows']}.csv"),
        num_rows=d["aml_rows"], num_accounts=d["aml_rows"] // 16,
        seed=d["aml_seed"])
    node_root = write_synthetic_node_dataset(
        os.path.join(workdir, f"elliptic_{d['node_nodes']}"),
        family="elliptic", num_nodes=d["node_nodes"],
        num_edges=d["node_edges"], num_feats=d["node_feats"],
        seed=d["node_seed"])
    fanouts = tuple(DEVICE["num_neighs"])
    common = dict(n_hidden=DEVICE["n_hidden"],
                  n_gnn_layers=DEVICE["n_gnn_layers"], num_neighs=fanouts,
                  batch_size=DEVICE["batch_size"], dropout=0.0, seed=SEED,
                  sampler="device")
    arrays, parts = {}, {}

    ds = IBMTransactionsAML(root=csv, khop_neighbors=fanouts,
                            channels=DEVICE["n_hidden"])
    deg = max_in_degree(ds.graph)
    assert deg <= min(fanouts), (deg, fanouts)
    tr = Trainer(Config(model="tabgnn", data=csv,
                        task="edge_classification", **common), ds)
    shapes = start_supervised(tr)
    a, batches = device_batches(tr, ds.edges.split()[0], "edge/", False,
                                False)
    losses, after = supervised_steps(tr, batches)
    arrays.update(a)
    arrays["edge/term/loss"] = np.asarray(losses, np.float64)
    arrays.update(ssl_fixture.sampled(after, "edge/", DEVICE["sample"]))
    parts["edge"] = {"model": "tabgnn", "task": "edge_classification",
                     "lr": tr.cfg.lr, "shapes": shapes, "losses": losses,
                     "max_in_degree": deg, **caps_of(tr.cfg)}

    ds = EllipticBitcoin(root=node_root, khop_neighbors=fanouts)
    deg = max_in_degree(ds.graph)
    assert deg <= min(fanouts), (deg, fanouts)
    tr = Trainer(Config(model="tabgnn", data=node_root,
                        task="node_classification", **common), ds)
    shapes = start_supervised(tr)
    a, batches = device_batches(tr, ds.nodes.split()[0], "node/", True,
                                False)
    losses, after = supervised_steps(tr, batches)
    arrays.update(a)
    arrays["node/term/loss"] = np.asarray(losses, np.float64)
    arrays.update(ssl_fixture.sampled(after, "node/", DEVICE["sample"]))
    parts["node"] = {"model": "tabgnn", "task": "node_classification",
                     "lr": tr.cfg.lr, "shapes": shapes, "losses": losses,
                     "max_in_degree": deg, **caps_of(tr.cfg)}

    ds = IBMTransactionsAML(root=csv, khop_neighbors=fanouts,
                            channels=DEVICE["n_hidden"], pretrain=MCM_LP)
    cfg = Config(model="tabgnnfused", data=csv, lr=DEVICE["lr"],
                 weight_decay=DEVICE["weight_decay"],
                 num_neg_samples=DEVICE["num_neg_samples"], **common)
    tr = PretrainTrainer(cfg, ds, mode="mcm-lp")
    shapes = start_pretrain(tr)
    a, batches = device_batches(tr, ds.edges.split()[0], "mcm_lp/", False,
                                True)
    terms, after = pretrain_steps(tr, batches)
    arrays.update(a)
    arrays.update({f"mcm_lp/term/{k}": np.asarray([t[k] for t in terms],
                                                  np.float64)
                   for k in terms[0]})
    arrays.update(ssl_fixture.sampled(after, "mcm_lp/", DEVICE["sample"]))
    parts["mcm_lp"] = {"model": "tabgnnfused", "lr": cfg.lr,
                       "shapes": shapes, "terms": terms,
                       "max_in_degree": max_in_degree(ds.graph),
                       **caps_of(tr.cfg)}
    return arrays, dict(DEVICE, data=DEVICE_DATA, parts=parts)


def rel_hm_record(workdir: str) -> tuple[dict, dict]:
    d = HM_DATA
    root = os.path.join(workdir, "rel-hm")
    os.makedirs(root, exist_ok=True)
    csv = write_synthetic_hm_csv(os.path.join(root, f"hm_{d['rows']}.csv"),
                                 num_rows=d["rows"],
                                 num_customers=d["customers"],
                                 num_articles=d["articles"], seed=d["seed"])
    fanouts = tuple(HM["num_neighs"])
    common = dict(n_hidden=HM["n_hidden"], n_gnn_layers=HM["n_gnn_layers"],
                  num_neighs=fanouts, batch_size=HM["batch_size"],
                  dropout=0.0, seed=SEED)
    arrays, parts = {}, {}
    ds = RelHM(root=csv, pretrain=MCM_LP, khop_neighbors=fanouts,
               channels=HM["n_hidden"])
    tr = Trainer(Config(model="tabgnn", data=csv, task="mcm_edge_table",
                        **common), ds)
    shapes = start_supervised(tr)
    batches = list(itertools.islice(tr._batches(ds.edges.split()[0],
                                                "train", 0), STEPS))
    losses, after = supervised_steps(tr, batches)
    arrays["mcm_edge/term/loss"] = np.asarray(losses, np.float64)
    arrays.update(ssl_fixture.sampled(after, "mcm_edge/", HM["sample"]))
    parts["mcm_edge"] = {"model": "tabgnn", "task": "mcm_edge_table",
                         "lr": tr.cfg.lr, "shapes": shapes,
                         "losses": losses, **caps_of(tr.cfg)}

    cfg = Config(model="tabgnnfused", data=csv, lr=HM["ssl_lr"],
                 weight_decay=HM["weight_decay"],
                 num_neg_samples=HM["num_neg_samples"], **common)
    tr = PretrainTrainer(cfg, ds, mode="mcm-lp")
    shapes = start_pretrain(tr)
    batches = list(itertools.islice(tr._batches(ds.edges.split()[0],
                                                "train", 0), STEPS))
    terms, after = pretrain_steps(tr, batches)
    arrays.update({f"mcm_lp/term/{k}": np.asarray([t[k] for t in terms],
                                                  np.float64)
                   for k in terms[0]})
    arrays["mcm_lp/neg0"] = np.asarray(batches[0].neg_edge_index, np.int32)
    arrays.update(ssl_fixture.sampled(after, "mcm_lp/", HM["sample"]))
    parts["mcm_lp"] = {"model": "tabgnnfused", "lr": cfg.lr,
                       "shapes": shapes, "terms": terms, **caps_of(tr.cfg)}
    return arrays, dict(HM, data=HM_DATA, parts=parts)


RECORDS = {"device": ("device_record.npz", device_record),
           "rel_hm": ("rel_hm_record.npz", rel_hm_record)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--records", default=",".join(RECORDS))
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    for name in args.records.split(","):
        fname, make = RECORDS[name]
        arrays, settings = make(args.workdir)
        settings.update(steps=STEPS, epoch=0, seed=SEED, var_seed=VAR_SEED,
                        dropout=0.0, nhead=8, segment_impl="scatter")
        out = os.path.join(FIXTURES, fname)
        np.savez_compressed(out, **pack_record(arrays),
                            settings=np.array(json.dumps(settings)))
        print(json.dumps({"record": os.path.relpath(out, ROOT),
                          "bytes": os.path.getsize(out),
                          "parts": {k: {kk: v[kk] for kk in v
                                        if kk != "shapes"}
                                    for k, v in settings["parts"].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
