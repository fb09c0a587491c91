"""How far a run of the node-family record
(``tests/fixtures/torch_port/node_family_record.npz``) lands from
``rmm_tpu_torch.convert.check_record``'s limits when its start is moved by
rounding alone: repetition 0 takes the record's weights, each later one
those weights times ``1 + eps · N(0, 1)`` (seeded by the repetition; eps
1e-7 is about one float32 rounding). Each repetition prints its three
losses' errors relative to the record and each component's median
parameter error over its limit. ``--flips`` also prints the parameters
whose first update differs by more than lr between repetitions 0 and 1:
Adam's first step is about lr · sign(g), so an entry whose gradient is
rounding noise above Adam's eps moves a full lr either way.

    JAX_PLATFORMS=cpu python tools/torch_node_family_margin.py --run ogbn \\
        --reps 13 --flips
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rmm_tpu_torch.convert import (check_record, from_jax,  # noqa: E402
                                   load_record, loss_terms,
                                   random_variables)
from rmm_tpu_torch.datasets import (build_dataset,  # noqa: E402
                                    write_synthetic_node_dataset)
from rmm_tpu_torch.nn.dropout import set_rate  # noqa: E402
from rmm_tpu_torch.train.trainer import Trainer  # noqa: E402
from rmm_tpu_torch.utils.config import (config_from_args,  # noqa: E402
                                        create_parser)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--run", default="ogbn")
    p.add_argument("--reps", type=int, default=13)
    p.add_argument("--eps", type=float, default=1e-7)
    p.add_argument("--flips", action="store_true")
    args = p.parse_args()
    torch.set_num_threads(1)
    rec = load_record(cs.NODE_FAMILY_FIXTURE)
    st = json.loads(str(rec["settings"]))
    run = st["runs"][args.run]
    d = st["data"][run["data"]]
    root = write_synthetic_node_dataset(
        os.path.join(tempfile.mkdtemp(), f"{d['dir']}_{d['nodes']}"),
        family=d["family"], num_nodes=d["nodes"], num_edges=d["edges"],
        num_feats=d["num_feats"], n_classes=d["n_classes"],
        seed=st["data_seed"])
    cfg = config_from_args(create_parser().parse_args([
        "--data", root, "--model", run["model"], "--task",
        "node_classification", "--n_hidden", str(st["n_hidden"]),
        "--n_gnn_layers", str(st["n_gnn_layers"]), "--num_neighs",
        *map(str, st["num_neighs"]), "--batch_size", str(st["batch_size"]),
        "--seed", str(st["seed"]), *run["flags"], "--device", "cpu"]))
    cfg = cfg.replace(dropout=0.0, **st["capacities"][run["data"]])
    ds = build_dataset(cfg)
    limits = "" if "--ego" in run["flags"] else run["model"]
    batches, first = None, []
    for r in range(args.reps):
        tr = Trainer(cfg.replace(n_classes=ds.n_classes), ds)
        tr.model.load_state_dict(from_jax(
            random_variables(run["shapes"], st["var_seed"]), tr.model))
        set_rate(tr.model, 0.0)
        if r:
            gen = torch.Generator().manual_seed(r)
            with torch.no_grad():
                for q in tr.model.parameters():
                    q.mul_(1 + args.eps * torch.randn(q.shape,
                                                      generator=gen))
        if batches is None:
            batches = list(itertools.islice(tr._batches(
                ds.nodes.split()[0], "train", st["epoch"]), st["steps"]))
        tr.model.train()
        terms = []
        for i, b in enumerate(batches):
            before = {n: q.detach().clone()
                      for n, q in tr.model.named_parameters()}
            terms.append(loss_terms(tr._step(b.to("cpu"))[0], {}))
            if i == 0 and r < 2:
                first.append({n: q.detach() - before[n]
                              for n, q in tr.model.named_parameters()})
        faults, s = check_record(tr.model.state_dict(), terms, rec,
                                 f"{args.run}/", cfg.lr, st["steps"],
                                 st["n_hidden"], model=limits)
        print(json.dumps({
            "rep": r, "faults": len(faults),
            "loss_rel_err": s["loss_rel_err"]["loss"],
            "median_over_limit": {c: m / s["param_median_tol"] for c, m in
                                  s["param_median_abs_err"].items()}}))
    if args.flips and len(first) == 2:
        for n, u in first[0].items():
            diff = (u - first[1][n]).abs() / cfg.lr
            if diff.max() > 1:
                print(json.dumps({"param": n, "flipped": int((diff > 1).sum()),
                                  "entries": u.numel(),
                                  "max_over_lr": float(diff.max())}))


if __name__ == "__main__":
    main()
