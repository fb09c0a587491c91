"""Tabular masked-cell modeling CLI (the counterpart of
``rmm_tpu.cli.fttransformer``):

    python -m rmm_tpu_torch.cli.fttransformer --dataset <csv> --epochs 3 \\
        --testing [--mask_vector] [--device cpu]

An ``FTTransformer`` over the edge table's rows alone pretrains on the
masked-cell target (each row has one cell masked, ``PretrainType.MASK``);
``--mask_vector`` adds the mask-vector head and its loss, which read the
same target's masked-column index. Same flags and defaults as the JAX CLI
(C = 128, 3 layers, 8 heads, dropout 0.5, batch 200, lr 2e-4, weight decay
1e-3, AdamW) plus ``--device`` (``cuda`` by default, which raises without
CUDA; ``cpu`` runs the kernels' plain versions). The run directory is
``<wandb_dir>/run_fttransformer``: ``metrics.jsonl``, ``config.json``,
``logs.log`` and, under ``--save_model`` or ``--checkpoint``, the per-epoch
checkpoints ``<epoch>/`` and the best-metric snapshots ``best_acc`` and
``best_rmse``. ``--checkpoint <run_dir>/<epoch>`` resumes at the next epoch
with the weights, AdamW state and best metrics; a JAX tabular checkpoint
loads too (its optimizer state is not read).

``main(argv, stats)`` fills the dict ``stats``, when given, with the run
directory, the wall-clock split (``setup_s``, ``fit_s``), the rows of each
split and the device.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True, type=str)
    p.add_argument("--testing", action="store_true")
    p.add_argument("--checkpoint", default=None, type=str,
                   help="epoch checkpoint dir to resume from")
    p.add_argument("--save_model", action="store_true")
    p.add_argument("--mask_vector", action="store_true",
                   help="add the mask-vector head and its loss")
    p.add_argument("--batch_size", default=200, type=int)
    p.add_argument("--lr", default=2e-4, type=float)
    p.add_argument("--eps", default=1e-8, type=float)
    p.add_argument("--weight_decay", default=1e-3, type=float)
    p.add_argument("--epochs", default=50, type=int)
    p.add_argument("--channels", default=128, type=int)
    p.add_argument("--num_layers", default=3, type=int)
    p.add_argument("--dropout", default=0.5, type=float)
    p.add_argument("--split_type", default="temporal_daily", type=str)
    p.add_argument("--wandb_dir", default="wandb/", type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def config_from_args(args: argparse.Namespace):
    from ..utils.config import Config

    return Config(model="fttransformer", data=args.dataset,
                  batch_size=args.batch_size, lr=args.lr, adam_eps=args.eps,
                  weight_decay=args.weight_decay, epochs=args.epochs,
                  n_hidden=args.channels, n_gnn_layers=args.num_layers,
                  dropout=args.dropout, split_type=args.split_type,
                  testing=args.testing, wandb_dir=args.wandb_dir,
                  device=args.device)


def main(argv=None, stats: Optional[dict] = None):
    from ..datasets import IBMTransactionsAML
    from ..datasets.base import PretrainType
    from ..train.tabular import TabularMCMTrainer
    from ..utils.checkpoint import parse_checkpoint_path
    from ..utils.device import resolve_device
    from ..utils.logging import RunLogger, logger_setup

    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)
    run_dir = os.path.join(cfg.wandb_dir, "run_fttransformer")
    logger_setup(run_dir)
    logging.info(cfg.to_json())

    t0 = time.perf_counter()
    dataset = IBMTransactionsAML(root=cfg.data, split_type=cfg.split_type,
                                 pretrain={PretrainType.MASK})
    trainer = TabularMCMTrainer(cfg, dataset.edges,
                                mask_vector=args.mask_vector)
    start_epoch, best = 0, None
    if args.checkpoint:
        _, start_epoch = parse_checkpoint_path(args.checkpoint)
        start_epoch += 1
        best = trainer.restore(args.checkpoint)
        logging.info("Resumed from %s (next epoch %d, best %s)",
                     args.checkpoint, start_epoch, best)
    run_logger = RunLogger(run_dir, config=json.loads(cfg.to_json()))
    ckpt_dir = run_dir if (args.save_model or args.checkpoint) else None
    t1 = time.perf_counter()
    history, best = trainer.fit(run_logger, ckpt_dir, start_epoch, best)
    run_logger.close()
    logging.info("best: %s", best)
    if stats is not None:
        stats.update(run_dir=run_dir, setup_s=t1 - t0,
                     fit_s=time.perf_counter() - t1,
                     split_rows=[v.tensor_frame.num_rows
                                 for v in dataset.edges.split()],
                     device=str(device))
    return history, best


if __name__ == "__main__":
    main()
