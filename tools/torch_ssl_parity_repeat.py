"""Repeat ``chip_smoke.py``'s ``ssl_parity`` steps and print, for each run,
every loss term's relative error against the JAX record
(``tests/fixtures/torch_port/ssl_record.npz``), the largest parameter error
and each component's median error (both in units of lr): how far from its
limits each check of ``rmm_tpu_torch.convert.check_record`` lands, and how
much that moves between runs (PyTorch's scatters on the card add in no
fixed order).

With ``--precision bf16`` the steps are ``ssl_parity_bf16``'s, against
``ssl_bf16_record.npz``, and each run also prints how far the port's bf16
steps land from the record's float32 run of the same steps, and how far
the record's own bf16 run lies from it (the reference's bf16 gap, that
the bf16 tolerances are set against).

    python tools/torch_ssl_parity_repeat.py --device cuda --reps 6
    python tools/torch_ssl_parity_repeat.py --device cpu --reps 1
    python tools/torch_ssl_parity_repeat.py --device cpu --reps 1 \
        --precision bf16
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

import chip_smoke as cs  # noqa: E402
from rmm_tpu_torch.cli import fused  # noqa: E402
from rmm_tpu_torch.convert import (check_record, from_jax,  # noqa: E402
                                   loss_terms, random_variables)
from rmm_tpu_torch.datasets import build_dataset  # noqa: E402
from rmm_tpu_torch.train.pretrain import PretrainTrainer  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--reps", default=6, type=int)
    p.add_argument("--precision", default="f32", choices=("f32", "bf16"))
    args = p.parse_args(argv)
    bf16 = args.precision == "bf16"
    os.makedirs(cs.WORK, exist_ok=True)
    if args.device == "cuda":
        from rmm_tpu_torch.ops.build import build_all
        build_all()
    csv = cs.ssl_parity_csv()
    rec, st = cs.ssl_record(cs.SSL_BF16_FIXTURE if bf16 else cs.SSL_FIXTURE)
    ms = st["modes"]["mcm-lp"]
    flags = ["--mode", "mcm-lp", "--channels", str(st["channels"]),
             "--num_layers", str(st["num_layers"]),
             "--num_neg_samples", str(st["num_neg_samples"]),
             "--batch_size", str(st["batch_size"]), "--khop_neighbors",
             *map(str, st["khop_neighbors"]), "--dropout", "0",
             "--lr", str(st["lr"]), "--precision", args.precision,
             "--device", args.device]
    cfg = fused.config_from_args(fused.build_parser().parse_args(
        ["--dataset", csv, *flags])).replace(
        edge_capacity=ms["edge_capacity"], node_capacity=ms["node_capacity"],
        seed=st["seed"])
    ds = build_dataset(cfg)
    lr = st["lr"]
    if bf16:   # the reference's bf16 run against its float32 run
        gap = {k[len("mcm-lp/term/"):]: (np.abs(
            rec[k] - rec["f32/" + k]) / np.abs(rec["f32/" + k])).tolist()
            for k in rec.files if k.startswith("mcm-lp/term/")}
        vals = [np.abs(rec[k] - rec["f32/" + k]) for k in rec.files
                if k.startswith("mcm-lp/val/params/")]
        print(json.dumps({"jax_bf16_vs_f32": {
            "loss_rel_err": gap,
            "param_max_lr": float(max(v.max() for v in vals)) / lr,
            "param_median_lr": float(np.median(np.concatenate(vals)))
            / lr}}), flush=True)
    for r in range(args.reps):
        tr = PretrainTrainer(cfg, ds, "mcm-lp")
        tr.model.load_state_dict(from_jax(
            random_variables(ms["shapes"], st["var_seed"]), tr.model))
        batches = list(itertools.islice(
            tr._batches(ds.edges.split()[0], "train", st["epoch"]),
            st["steps"]))
        tr.model.train()
        terms = [loss_terms(*tr._step(gb.to(tr.device))) for gb in batches]
        state = tr.model.state_dict()
        for prefix in ("mcm-lp/", "f32/mcm-lp/") if bf16 else ("mcm-lp/",):
            faults, s = check_record(state, terms, rec, prefix, lr,
                                     2 * st["steps"], st["channels"],
                                     args.precision)
            print(json.dumps({
                "device": args.device, "precision": args.precision,
                "record": prefix.rstrip("/"), "rep": r,
                "faults": len(faults), "loss_rel_err": s["loss_rel_err"],
                "loss_rtol": s["loss_rtol"],
                "param_max_lr": s["param_max_abs_err"] / lr,
                "median_lr": {k: v / lr for k, v in
                              s["param_median_abs_err"].items()}}),
                flush=True)


if __name__ == "__main__":
    main()
