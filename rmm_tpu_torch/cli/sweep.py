"""Hyperparameter sweeps (the counterpart of ``rmm_tpu.cli.sweep``): random
search over the reference's spaces, each trial a full fit, the results
streamed to a JSONL leaderboard.

    python -m rmm_tpu_torch.cli.sweep --kind supervised --data <csv> \\
        --model tabgnn --trials 8 --epochs 3 --testing [--device cpu]

``--kind supervised`` trains ``Trainer.fit`` (lr, dropout, layers and
width; the trial's score is its best validation f1), ``--kind fused``
pretrains ``PretrainTrainer.fit`` in mcm-lp (dropout and batch size; its
best validation MRR). The spaces and :func:`sample_params` are the
reference's, so one ``--seed`` draws the same trials in both packages.
Each trial appends ``{"trial", "params", "val_f1" | "val_mrr"}`` to
``--out``; the best trial is returned. Flags: the reference's, plus
``--device`` (``cuda`` by default, which raises without CUDA; ``cpu`` runs
the kernels' plain versions).
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

SUPERVISED_SPACE = {
    "lr": ("log_uniform", 1e-4, 1e-2),
    "dropout": ("uniform", 0.0, 0.5),
    "n_gnn_layers": ("choice", [1, 2, 3]),
    "n_hidden": ("choice", [16, 32, 64]),
}

FUSED_SPACE = {
    "dropout": ("uniform", 0.1, 0.6),
    "batch_size": ("choice", [64, 128, 200, 256]),
}


def sample_params(space: dict, rng: np.random.RandomState) -> dict:
    out = {}
    for name, spec in space.items():
        kind = spec[0]
        if kind == "log_uniform":
            lo, hi = np.log(spec[1]), np.log(spec[2])
            out[name] = float(np.exp(rng.uniform(lo, hi)))
        elif kind == "uniform":
            out[name] = float(rng.uniform(spec[1], spec[2]))
        elif kind == "choice":
            out[name] = spec[1][rng.randint(len(spec[1]))]
    return out


def run_trial(kind: str, cfg) -> tuple[str, float]:
    """One trial's fit: (metric name, its best validation value)."""
    if kind == "supervised":
        from ..datasets import build_dataset
        from ..train.trainer import Trainer

        dataset = build_dataset(cfg)
        if hasattr(dataset, "n_classes"):
            cfg = cfg.replace(n_classes=dataset.n_classes)
        _, best = Trainer(cfg, dataset).fit()
        return "val_f1", float(best)
    from ..datasets import IBMTransactionsAML
    from ..datasets.base import PretrainType
    from ..train.pretrain import PretrainTrainer

    dataset = IBMTransactionsAML(
        root=cfg.data, pretrain={PretrainType.MASK, PretrainType.LINK_PRED},
        khop_neighbors=cfg.num_neighs, edge_capacity=cfg.edge_capacity,
        node_capacity=cfg.node_capacity)
    _, best = PretrainTrainer(cfg, dataset, mode="mcm-lp").fit()
    return "val_mrr", float(best["mrr"])


def run_sweep(kind: str, base_cfg, trials: int, out_path: str,
              seed: int = 0):
    rng = np.random.RandomState(seed)
    space = SUPERVISED_SPACE if kind == "supervised" else FUSED_SPACE
    results = []
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "a") as f:
        for trial in range(trials):
            params = sample_params(space, rng)
            logging.info(f"trial {trial}: {params}")
            metric, score = run_trial(kind, base_cfg.replace(**params))
            rec = {"trial": trial, "params": params, metric: score}
            results.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            logging.info(f"trial {trial}: {metric}={score:.4f}")
    best = max(results, key=lambda r: r[metric])
    logging.info(f"best trial: {best}")
    return results, best


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--kind", default="supervised",
                   choices=["supervised", "fused"])
    p.add_argument("--data", required=True, type=str)
    p.add_argument("--model", default="tabgnn", type=str)
    p.add_argument("--task", default="edge_classification", type=str)
    p.add_argument("--trials", default=8, type=int)
    p.add_argument("--epochs", default=3, type=int)
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--num_neighs", nargs="+", type=int, default=[10, 10])
    p.add_argument("--edge_capacity", default=2048, type=int)
    p.add_argument("--node_capacity", default=2048, type=int)
    p.add_argument("--num_neg_samples", default=16, type=int)
    p.add_argument("--out", default="sweeps/results.jsonl", type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--testing", action="store_true")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def main(argv=None):
    from ..utils.config import Config
    from ..utils.logging import logger_setup

    args = build_parser().parse_args(argv)
    logger_setup()
    cfg = Config(model=args.model, data=args.data, task=args.task,
                 epochs=args.epochs, batch_size=args.batch_size,
                 num_neighs=tuple(args.num_neighs),
                 edge_capacity=args.edge_capacity,
                 node_capacity=args.node_capacity,
                 num_neg_samples=args.num_neg_samples, testing=args.testing,
                 device=args.device)
    return run_sweep(args.kind, cfg, args.trials, args.out, args.seed)


if __name__ == "__main__":
    main()
