"""Write the JAX records of three SSL pretraining steps that the PyTorch
port's SSL path is held against: ``tests/test_torch_ssl_train.py`` on the
CPU and ``chip_smoke.py``'s ``ssl_parity`` phase on the GPU.

Two records, each under 1 MB:

* ``tests/fixtures/torch_port/ssl_tiny_record.npz``: the three modes
  (``lp``, ``mcm``, ``mcm-lp``) at tiny widths (C = 16, 2 layers, 8 heads,
  8 negatives, fanouts 8/8, batch 32) on a 1,000-row synthetic AML;
* ``tests/fixtures/torch_port/ssl_record.npz``: ``mcm-lp`` at the SSL
  config of record's widths (C = 128, 3 layers, 8 heads, 64 negatives,
  fanouts 100/100, batch 200) on a 4,096-row cut of the synthetic AML
  (``num_accounts = rows // 16`` and the data seed of
  ``aml_record.npz``).

Each mode builds ``rmm_tpu.train.pretrain.PretrainTrainer`` on the CPU with
dropout 0, sets its variables from ``rmm_tpu_torch.convert.random_variables``
over the variables' shapes (which the record stores, in the port's module
layout, so the port rebuilds the same start), and takes three train steps
on the first three shuffled train batches of epoch 0. It saves each step's
loss and its terms (``rmm_tpu_torch.convert.loss_terms``: the LP loss from
the step's train-mode losses, the MCM categorical cross-entropy and
numerical √MSE from its sums), the first batch's negatives and, after
step 3, for each variable a seeded sample of entries with its sum and its
norm (the SSL widths hold ~12M parameters).

    JAX_PLATFORMS=cpu python tools/make_torch_port_ssl_fixture.py

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
from rmm_tpu.datasets.base import PretrainType  # noqa: E402
from rmm_tpu.train.pretrain import PretrainTrainer  # noqa: E402
from rmm_tpu.utils.config import Config  # noqa: E402
from rmm_tpu_torch.convert import (flatten_variables,  # noqa: E402
                                   loss_terms, pack_record,
                                   pretrain_variables, random_variables)
from tests.torch_port_util import nest  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port")
RECORDS = {
    "tiny": dict(out="ssl_tiny_record.npz", modes=("lp", "mcm", "mcm-lp"),
                 rows=1000, num_accounts=62, data_seed=3, channels=16,
                 num_layers=2, num_neg_samples=8, khop_neighbors=[8, 8],
                 batch_size=32, sample=64),
    "ssl": dict(out="ssl_record.npz", modes=("mcm-lp",), rows=4096,
                num_accounts=256, data_seed=None, channels=128, num_layers=3,
                num_neg_samples=64, khop_neighbors=[100, 100],
                batch_size=200, sample=48),
}
STEPS, SEED, VAR_SEED, SAMPLE_SEED = 3, 1, 7, 11


def sample_index(numel: int, k: int, i: int) -> np.ndarray:
    """The entries kept of the i-th variable (sorted paths)."""
    rng = np.random.RandomState(SAMPLE_SEED + i)
    return np.sort(rng.choice(numel, min(numel, k), replace=False))


def sampled(after: dict, prefix: str, k: int) -> dict:
    """A record's arrays for the variables ``after`` a run: for each, by
    its flat path, a seeded sample of ``k`` entries, its sum and its norm
    (``rmm_tpu_torch.convert.record_errors`` reads them)."""
    out = {}
    for i, key in enumerate(sorted(after)):
        arr = np.asarray(after[key], np.float32)
        idx = sample_index(arr.size, k, i)
        out[f"{prefix}idx/{key}"] = idx.astype(np.int32)
        out[f"{prefix}val/{key}"] = arr.reshape(-1)[idx]
        out[f"{prefix}sum/{key}"] = np.float64(arr.astype(np.float64).sum())
        out[f"{prefix}norm/{key}"] = np.float64(
            np.linalg.norm(arr.astype(np.float64)))
    return out


def run_mode(spec: dict, csv: str, mode: str,
             precision: str = "f32") -> dict:
    pretrain = {PretrainType.LINK_PRED}
    if "mcm" in mode:
        pretrain.add(PretrainType.MASK)
    cfg = Config(model="tabgnnfused", data=csv,
                 batch_size=spec["batch_size"], n_hidden=spec["channels"],
                 n_gnn_layers=spec["num_layers"], dropout=0.0,
                 num_neg_samples=spec["num_neg_samples"],
                 num_neighs=tuple(spec["khop_neighbors"]), lr=2e-4,
                 weight_decay=1e-3, adam_eps=1e-8, seed=SEED,
                 precision=precision)
    ds = IBMTransactionsAML(root=csv, pretrain=pretrain,
                            khop_neighbors=cfg.num_neighs,
                            channels=cfg.n_hidden)
    tr = PretrainTrainer(cfg, ds, mode=mode)
    layout = flatten_variables(pretrain_variables(tr.params, tr.batch_stats))
    shapes = {k: list(np.shape(v)) for k, v in layout.items()}
    flat = nest(random_variables(shapes, VAR_SEED))
    params = {"encoder": {"params": flat["params"]["edge_encoder"]},
              "model": flat["params"]["model"],
              "mcm_head": {"params": flat["params"]["mcm_head"]},
              "lp_head": {"params": flat["params"]["lp_head"]}}
    tr.params = jax.tree_util.tree_map(jnp.asarray, params)
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
                                  tr.edge_table, rng, True, mode)
        (tr.params, tr.batch_stats, tr.opt_state, _, loss,
         sums) = tr._train_step(tr.params, tr.batch_stats, tr.opt_state, None,
                                gb, rng, tr.edge_table)
        sums = {k: float(v) for k, v in jax.device_get(sums).items()}
        np.testing.assert_allclose(sum(float(v) for v in views.values()),
                                   float(loss), rtol=1e-5)
        if "lp" in views:
            sums["lp"] = float(views["lp"])
        terms.append(loss_terms(loss, sums))
    after = flatten_variables(jax.device_get(
        pretrain_variables(tr.params, tr.batch_stats)))
    out = {f"{mode}/term/{k}": np.asarray([t[k] for t in terms], np.float64)
           for k in terms[0]}
    out[f"{mode}/neg0"] = np.asarray(batches[0].neg_edge_index, np.int32)
    out.update(sampled(after, f"{mode}/", spec["sample"]))
    settings = {"shapes": shapes, "edge_capacity": tr.cfg.edge_capacity,
                "node_capacity": tr.cfg.node_capacity, "terms": terms}
    return out, settings


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--records", nargs="+", default=list(RECORDS),
                   choices=list(RECORDS))
    p.add_argument("--workdir", default=os.path.join(
        ROOT, "outputs", "torch_port_fixture"))
    args = p.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    base = json.loads(str(np.load(os.path.join(
        FIXTURES, "aml_record.npz"))["settings"]))
    for name in args.records:
        spec = dict(RECORDS[name])
        if spec["data_seed"] is None:
            spec["data_seed"] = base["data_seed"]
        csv = os.path.join(args.workdir, f"ssl_{name}.csv")
        write_synthetic_aml_csv(csv, num_rows=spec["rows"],
                                num_accounts=spec["num_accounts"],
                                seed=spec["data_seed"])
        arrays, modes = {}, {}
        for mode in spec["modes"]:
            out, settings = run_mode(spec, csv, mode)
            arrays.update(out)
            modes[mode] = settings
        settings = {k: v for k, v in spec.items() if k != "out"}
        settings.update(modes=modes, steps=STEPS, epoch=0, seed=SEED,
                        var_seed=VAR_SEED, lr=2e-4, weight_decay=1e-3,
                        adam_eps=1e-8, dropout=0.0, nhead=8)
        path = os.path.join(FIXTURES, spec["out"])
        np.savez_compressed(path, **pack_record(arrays),
                            settings=np.array(json.dumps(settings)))
        print(json.dumps({"record": name, "out": os.path.relpath(path, ROOT),
                          "bytes": os.path.getsize(path),
                          "terms": {m: s["terms"]
                                    for m, s in modes.items()}}))


if __name__ == "__main__":
    main()
