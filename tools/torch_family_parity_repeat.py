"""Repeat ``chip_smoke.py``'s ``family_parity`` steps and print, for each
model and run, every step's loss error relative to the JAX record
(``tests/fixtures/torch_port/family_record.npz``), the largest parameter
error and each component's median error (both in units of lr), the largest
BatchNorm statistic error and the statistic it is in, beside the limits of
``rmm_tpu_torch.convert.check_record``: how far from its limits each check
lands and how much that moves between runs (PyTorch's scatters on the card
add in no fixed order).

``--permute`` sums each PNA aggregation's edge lanes in a seeded random
order (run r takes seed r; the sums are the same up to rounding), which
shows on the CPU, where a run repeats bit for bit, the spread that the
order of the card's atomic adds gives.

    python tools/torch_family_parity_repeat.py --device cuda --reps 10 \
        --models cpna,cpnatab
    python tools/torch_family_parity_repeat.py --device cpu --reps 1
    python tools/torch_family_parity_repeat.py --device cpu --reps 20 \
        --models cpna,cpnatab --permute
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import rmm_tpu_torch.nn.gnn.conv as gnn_conv  # noqa: E402
from rmm_tpu_torch.convert import (check_record, from_jax,  # noqa: E402
                                   load_record, loss_terms,
                                   random_variables, record_errors)
from rmm_tpu_torch.datasets import (build_dataset,  # noqa: E402
                                    write_synthetic_aml_csv)
from rmm_tpu_torch.nn.dropout import set_rate  # noqa: E402
from rmm_tpu_torch.ops.segment import pna_aggregate  # noqa: E402
from rmm_tpu_torch.train.trainer import Trainer  # noqa: E402
from rmm_tpu_torch.utils.config import (config_from_args,  # noqa: E402
                                        create_parser)


def permuted_pna(seed: int):
    """``pna_aggregate`` over the lanes in an order drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def aggregate(messages, dst, num_nodes, avg_log_deg, mask=None):
        p = torch.randperm(messages.shape[0], generator=gen).to(dst.device)
        return pna_aggregate(messages[p], dst[p], num_nodes, avg_log_deg,
                             None if mask is None else mask[p])
    return aggregate


def worst_stat(state: dict, rec, prefix: str) -> str:
    """The BatchNorm statistic with the largest sampled error."""
    errs = {k: float(e[0].max())
            for k, e in record_errors(state, rec, prefix).items()
            if k.endswith(("running_mean", "running_var"))}
    return max(errs, key=errs.get) if errs else ""


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--reps", default=10, type=int)
    p.add_argument("--models", default=",".join(cs.FAMILIES))
    p.add_argument("--permute", action="store_true",
                   help="sum the PNA lanes in a seeded random order")
    args = p.parse_args(argv)
    os.makedirs(cs.WORK, exist_ok=True)
    if args.device == "cuda":
        from rmm_tpu_torch.ops.build import build_all
        build_all()
    rec = load_record(cs.FAMILY_FIXTURE)
    st = json.loads(str(rec["settings"]))
    csv = write_synthetic_aml_csv(os.path.join(cs.WORK, "aml_family.csv"),
                                  num_rows=st["rows"],
                                  num_accounts=st["num_accounts"],
                                  seed=st["data_seed"])
    dataset, lr, n = None, st["lr"], st["steps"]
    for model in args.models.split(","):
        cfg = config_from_args(create_parser().parse_args([
            "--data", csv, "--model", model, "--n_hidden",
            str(st["n_hidden"]), "--n_gnn_layers", str(st["n_gnn_layers"]),
            "--num_neighs", *map(str, st["num_neighs"]), "--batch_size",
            str(st["batch_size"]), "--seed", str(st["seed"]), "--lr",
            str(lr), "--dropout", "0", "--edge_capacity",
            str(st["edge_capacity"]), "--node_capacity",
            str(st["node_capacity"]), "--device", args.device,
            *(["--emlps"] if st["emlps"] else [])]))
        dataset = dataset or build_dataset(cfg)
        for r in range(args.reps):
            if args.permute:
                gnn_conv.pna_aggregate = permuted_pna(r)
            tr = Trainer(cfg, dataset)
            tr.model.load_state_dict(from_jax(random_variables(
                st["models"][model]["shapes"], st["var_seed"]), tr.model))
            set_rate(tr.model, 0.0)
            tr.model.train()
            terms = [loss_terms(tr._step(g.to(tr.device))[0], {})
                     for g in itertools.islice(tr._batches(
                         dataset.edges.split()[0], "train", st["epoch"]), n)]
            faults, s = check_record(tr.model.state_dict(), terms, rec,
                                     f"{model}/", lr, n, st["n_hidden"],
                                     model=model)
            print(json.dumps({
                "device": args.device, "model": model, "rep": r,
                "faults": len(faults),
                "loss_rel_err": s["loss_rel_err"]["loss"],
                "loss_rtol": s["loss_rtol"],
                "param_max_lr": s["param_max_abs_err"] / lr,
                "median_lr": {k: v / lr for k, v in
                              s["param_median_abs_err"].items()},
                "median_tol_lr": s["param_median_tol"] / lr,
                "bn_stat_max": s["bn_stat_max_abs_err"],
                "bn_stat_tol": s["bn_stat_tol"],
                "bn_stat_worst": worst_stat(tr.model.state_dict(), rec,
                                            f"{model}/"),
                "permute": args.permute}), flush=True)
            del tr


if __name__ == "__main__":
    main()
