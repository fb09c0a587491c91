"""Batch-inference CLI (the serving path):

    python -m rmm_tpu_torch.cli.predict --data <csv> --model tabgnn \\
        --load_model <checkpoint dir> --split test --output preds.csv

``--model`` is any of the training CLI's: ``fttransformer``, ``gin``,
``pna``, ``cpna``, ``cpnatab``, ``tabgnn``, ``tabgnninterleaved`` or
``tabgnnfused``; the checkpoint is the port's or the JAX package's
(``utils/checkpoint.py::load_strict``), its float32 masters served under
``--precision f32`` or ``bf16`` whatever precision trained them.

Same flags as ``rmm_tpu.cli.predict`` plus ``--device`` (``cuda`` by
default, which raises without CUDA; ``cpu`` runs the kernels' plain
versions). Writes one row per scored seed edge, or seed node for node
classification (any node dataset; Elliptic's "unknown" rows are not
scored):
``id,pred[,score]``.
``--split all`` scores every row with the full-graph sampler.

``main(argv, stats)`` fills the dict ``stats``, when given, with the run's
wall-clock split: ``setup_s`` (CSV, dataset, calibration, model,
checkpoint), ``predict_s`` (sampling and the forward up to the results on
the host), the rows scored and the capacities used.
"""
from __future__ import annotations

import csv
import logging
import time
from typing import Optional


def main(argv=None, stats: Optional[dict] = None) -> dict:
    from ..datasets import build_dataset
    from ..train.trainer import Trainer
    from ..utils.checkpoint import load_strict
    from ..utils.config import config_from_args, create_parser
    from ..utils.device import resolve_device

    p = create_parser()
    p.add_argument("--split", default="test",
                   choices=("train", "val", "test", "all"))
    p.add_argument("--output", default="predictions.csv", type=str)
    args = p.parse_args(argv)
    if not args.load_model:
        raise SystemExit("--load_model <checkpoint dir> is required")
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)

    t0 = time.perf_counter()
    dataset = build_dataset(cfg)
    if hasattr(dataset, "n_classes"):
        cfg = cfg.replace(n_classes=dataset.n_classes)
    trainer = Trainer(cfg, dataset, device)
    # serving never runs on fresh-init weights: any missing or mis-shaped
    # entry raises (and any extra one in a port checkpoint)
    load_strict(args.load_model, trainer.model)
    t1 = time.perf_counter()

    table = trainer.seed_table()
    if args.split == "all":
        out = trainer.predict(table, mode="test")
    else:
        idx = ("train", "val", "test").index(args.split)
        out = trainer.predict(table.split()[idx], mode=args.split)
    t2 = time.perf_counter()

    cols = list(out)
    with open(args.output, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        w.writerows(zip(*(out[c] for c in cols)))
    if stats is not None:
        stats.update(setup_s=t1 - t0, predict_s=t2 - t1, rows=len(out["id"]),
                     edge_capacity=trainer.cfg.edge_capacity,
                     frontier_capacity=trainer.cfg.frontier_capacity,
                     node_capacity=trainer.cfg.node_capacity,
                     device=str(device))
    logging.info("wrote %d predictions to %s", len(out["id"]), args.output)
    return out


if __name__ == "__main__":
    main()
