"""Write the JAX records of three ``--precision bf16`` training steps that
the PyTorch port's bf16 paths are held against: ``tests/
test_torch_precision.py`` on the CPU and ``chip_smoke.py``'s
``train_parity_bf16`` and ``ssl_parity_bf16`` phases on the GPU.

Four records under ``tests/fixtures/torch_port/``, each under 1 MB:

* ``bf16_tiny_record.npz``: supervised ``tabgnn`` (C = 16, 2 layers,
  fanouts 8/8, batch 32; prefix ``sup/``) and SSL ``mcm-lp`` (C = 16,
  2 layers, 8 negatives, fanouts 8/8, batch 32; prefix ``mcm-lp/``) on the
  1,000-row synthetic AML of ``ssl_tiny_record.npz``;
* ``aml_train_bf16_record.npz``: supervised at the config of record's
  widths (C = 32, 8 heads, 2 layers, fanouts 100/100, batch 200) on the
  16,384-row cut of ``aml_train_record.npz``;
* ``ssl_bf16_record.npz``: ``mcm-lp`` at the SSL config of record's widths
  (C = 128, 3 layers, 64 negatives, fanouts 100/100, batch 200) on the
  4,096-row cut of ``ssl_record.npz``;
* ``aml_serve_bf16_record.npz``: ``Trainer.predict`` in bf16 over the first
  3 test batches of the config of record (131,072 rows), on the variables
  of ``aml_record.npz`` (``chip_smoke.py``'s ``serve_bf16``; the float32
  predictions are those of ``aml_record.npz``).

Each run builds the ``rmm_tpu`` trainer with ``precision="bf16"`` and
dropout 0, starts from ``rmm_tpu_torch.convert.random_variables`` over its
variables' shapes (stored, so the port rebuilds the start), takes three
train steps on the first three shuffled train batches of epoch 0 and saves
each step's loss terms and, after step 3, a seeded sample of each
variable's entries with its sum and norm (as
``tools/make_torch_port_ssl_fixture.py`` does). The same run in float32
goes under the prefix ``f32/``: how far bf16 moves the reference is what
the port's bf16 tolerances are set against.

The attention takes the reference's Pallas kernel in interpret mode
(``tests.torch_port_util.jax_kernel_attention``), its TPU path: the
port's kernels copy that path's semantics (float32 intermediates, float32
weight gradients), where the CPU einsum path would round each to bf16.

    JAX_PLATFORMS=cpu python tools/make_torch_port_bf16_fixture.py

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
sys.path.insert(0, os.path.join(ROOT, "tools"))

import itertools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import make_torch_port_ssl_fixture as ssl_fixture  # noqa: E402
from rmm_tpu.datasets import IBMTransactionsAML, write_synthetic_aml_csv  # noqa: E402
from rmm_tpu.frame.dataset import DatasetView  # noqa: E402
from rmm_tpu.train.trainer import Trainer  # noqa: E402
from rmm_tpu.utils.config import Config  # noqa: E402
from rmm_tpu_torch.convert import (flatten_variables, loss_terms,  # noqa: E402
                                   pack_record, random_variables)
from tests.torch_port_util import jax_kernel_attention, nest  # noqa: E402

FIXTURES = ssl_fixture.FIXTURES
STEPS, SEED, VAR_SEED = ssl_fixture.STEPS, ssl_fixture.SEED, \
    ssl_fixture.VAR_SEED
SUPERVISED = {
    "tiny": dict(rows=1000, num_accounts=62, data_seed=3, n_hidden=16,
                 n_gnn_layers=2, num_neighs=[8, 8], batch_size=32,
                 sample=64),
    "record": dict(rows=16384, num_accounts=1024, data_seed=None,
                   n_hidden=32, n_gnn_layers=2, num_neighs=[100, 100],
                   batch_size=200, sample=96),
}
RECORDS = {
    "tiny": dict(out="bf16_tiny_record.npz", supervised="tiny",
                 ssl="tiny"),
    "train": dict(out="aml_train_bf16_record.npz", supervised="record",
                  ssl=None),
    "ssl": dict(out="ssl_bf16_record.npz", supervised=None, ssl="ssl"),
    "serve": dict(out="aml_serve_bf16_record.npz", supervised=None,
                  ssl=None),
}


def run_serve(base: dict, fixture) -> tuple[dict, dict]:
    """bf16 predictions of the config of record over the first test
    batches, on the serving fixture's variables."""
    csv = os.path.join(ROOT, "outputs", "torch_port_fixture",
                       f"aml_{base['rows']}.csv")
    write_synthetic_aml_csv(csv, num_rows=base["rows"],
                            num_accounts=base["num_accounts"],
                            seed=base["data_seed"])
    cfg = Config(model="tabgnn", data=csv, task="edge_classification",
                 batch_size=base["batch_size"], n_hidden=base["n_hidden"],
                 n_gnn_layers=base["n_gnn_layers"],
                 num_neighs=tuple(base["num_neighs"]), seed=base["seed"],
                 precision="bf16")
    ds = IBMTransactionsAML(root=csv, khop_neighbors=cfg.num_neighs,
                            channels=cfg.n_hidden)
    tr = Trainer(cfg, ds)
    tr.variables = jax.tree_util.tree_map(jnp.asarray, nest(
        {k[len("variables/"):]: fixture[k] for k in fixture.files
         if k.startswith("variables/")}))
    test = ds.edges.split()[2]
    out = tr.predict(DatasetView(
        test.parent, test.indices[:base["batches"] * cfg.batch_size]),
        mode="test")
    return ({"id": out["id"].astype(np.int64),
             "pred": out["pred"].astype(np.int64),
             "score": out["score"].astype(np.float32)},
            {**base, "precision": "bf16", "pred_mean":
             float(out["pred"].mean())})


def run_supervised(spec: dict, csv: str,
                   precision: str) -> tuple[dict, dict]:
    """Three steps of the supervised trainer → (the record's arrays under
    ``sup/``, its settings)."""
    cfg = Config(model="tabgnn", data=csv, task="edge_classification",
                 batch_size=spec["batch_size"], n_hidden=spec["n_hidden"],
                 n_gnn_layers=spec["n_gnn_layers"],
                 num_neighs=tuple(spec["num_neighs"]), seed=SEED,
                 dropout=0.0, precision=precision)
    ds = IBMTransactionsAML(root=csv, khop_neighbors=cfg.num_neighs,
                            channels=cfg.n_hidden)
    tr = Trainer(cfg, ds)
    shapes = {k: list(np.shape(v)) for k, v in
              flatten_variables(jax.device_get(tr.variables)).items()}
    tr.variables = jax.tree_util.tree_map(
        jnp.asarray, nest(random_variables(shapes, VAR_SEED)))
    tr.opt_state = tr.tx.init(tr.variables["params"])
    terms = []
    for gb in itertools.islice(tr._batches(ds.edges.split()[0], "train", 0),
                               STEPS):
        tr.variables, tr.opt_state, loss, _ = tr._train_step(
            tr.variables, tr.opt_state, gb, jax.random.PRNGKey(0),
            tr.edge_table, tr.node_table)
        terms.append(loss_terms(loss, {}))
    after = flatten_variables(jax.device_get(tr.variables))
    out = {f"sup/term/{k}": np.asarray([t[k] for t in terms], np.float64)
           for k in terms[0]}
    out.update(ssl_fixture.sampled(after, "sup/", spec["sample"]))
    settings = {**{k: v for k, v in spec.items() if k != "sample"},
                "shapes": shapes, "edge_capacity": tr.cfg.edge_capacity,
                "node_capacity": tr.cfg.node_capacity, "lr": tr.cfg.lr,
                "adam_eps": tr.cfg.adam_eps, "terms": terms}
    return out, settings


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--records", nargs="+", default=list(RECORDS),
                   choices=list(RECORDS))
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    fixture = np.load(os.path.join(FIXTURES, "aml_record.npz"))
    base = json.loads(str(fixture["settings"]))

    def data(spec: dict) -> str:
        seed = base["data_seed"] if spec["data_seed"] is None \
            else spec["data_seed"]
        csv = os.path.join(args.workdir,
                           f"bf16_{spec['rows']}_{seed}.csv")
        write_synthetic_aml_csv(csv, num_rows=spec["rows"],
                                num_accounts=spec["num_accounts"], seed=seed)
        return csv

    for name in args.records:
        rec = RECORDS[name]
        if name == "serve":
            with jax_kernel_attention():
                arrays, settings = run_serve(base, fixture)
            path = os.path.join(FIXTURES, rec["out"])
            np.savez(path, **arrays, settings=np.array(json.dumps(settings)))
            print(json.dumps({"record": name, "out": os.path.relpath(
                path, ROOT), "bytes": os.path.getsize(path),
                "pred_mean": settings["pred_mean"]}))
            continue
        arrays, settings = {}, {"precision": "bf16", "steps": STEPS,
                                "epoch": 0, "seed": SEED,
                                "var_seed": VAR_SEED, "dropout": 0.0,
                                "attention": "pallas interpret"}
        for precision, prefix in (("bf16", ""), ("f32", "f32/")):
            with jax_kernel_attention():
                if rec["supervised"]:
                    spec = dict(SUPERVISED[rec["supervised"]])
                    if spec["data_seed"] is None:
                        spec["data_seed"] = base["data_seed"]
                    out, sup = run_supervised(spec, data(spec), precision)
                    settings[prefix + "sup"] = sup
                    arrays.update({prefix + k: v for k, v in out.items()})
                if rec["ssl"]:
                    spec = dict(ssl_fixture.RECORDS[rec["ssl"]])
                    if spec["data_seed"] is None:
                        spec["data_seed"] = base["data_seed"]
                    out, mode = ssl_fixture.run_mode(
                        spec, data(spec), "mcm-lp", precision=precision)
                    arrays.update({prefix + k: v for k, v in out.items()})
                    settings[prefix + "ssl"] = {
                        **{k: v for k, v in spec.items()
                           if k not in ("out", "modes")},
                        "modes": {"mcm-lp": mode}, "lr": 2e-4,
                        "weight_decay": 1e-3, "adam_eps": 1e-8, "nhead": 8}
        path = os.path.join(FIXTURES, rec["out"])
        np.savez_compressed(path, **pack_record(arrays),
                            settings=np.array(json.dumps(settings)))
        print(json.dumps({"record": name, "out": os.path.relpath(path, ROOT),
                          "bytes": os.path.getsize(path),
                          **{k + "_terms": v.get("terms") or v["modes"][
                              "mcm-lp"]["terms"] for k, v in settings.items()
                             if isinstance(v, dict)}}))


if __name__ == "__main__":
    main()
