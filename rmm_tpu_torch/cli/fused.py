"""Self-supervised pretraining CLI (the counterpart of ``rmm_tpu.cli.fused``):

    python -m rmm_tpu_torch.cli.fused --dataset <csv> --mode mcm-lp \\
        --epochs 1 --testing [--device cpu]

Same flags and defaults as ``rmm_tpu.cli.fused`` (the SSL config of record:
C = 128, 3 layers, 64 negatives, batch 200, fanouts 100/100, dropout 0.5,
lr 2e-4; ``bench.py`` pretrains it with ``--precision bf16``; ``--moo
moco`` weights mcm-lp's two gradients by MoCo) plus
``--device`` (``cuda`` by default, which raises without CUDA; ``cpu`` runs
the kernels' plain versions). Flags whose behaviour is not
ported are refused by name. ``--dataset`` is an IBM AML CSV, or an
Ethereum phishing directory (any path holding ``eth``, in any case):
``build_ssl_dataset``. The run directory is
``<wandb_dir>/run_<run_name>``: ``metrics.jsonl``, ``config.json``,
``logs.log`` and, under ``--save_model`` or ``--checkpoint``, the per-epoch
checkpoints ``<epoch>/`` and the best-metric snapshots ``best_acc``,
``best_rmse`` and ``best_mrr``. ``--checkpoint <run_dir>/<epoch>`` resumes
at the next epoch with the weights, BatchNorm statistics, AdamW state (and
MoCo's) and best metrics.

``main(argv, stats)`` fills the dict ``stats``, when given, with the run
directory, the wall-clock split (``setup_s``, ``fit_s``), the rows of each
split and the capacities used.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional

#: flag → the only value the port accepts (the JAX CLI's default)
UNPORTED = {"dp": 0, "scan_layers": False, "steps_per_dispatch": 1,
            "inflight_groups": 2}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True, type=str)
    p.add_argument("--mode", default="mcm-lp",
                   choices=["mcm", "lp", "mcm-lp"])
    p.add_argument("--run_name", default="fused", type=str)
    p.add_argument("--checkpoint", default=None, type=str,
                   help="epoch checkpoint dir to resume from "
                        "(<run_dir>/<epoch>)")
    p.add_argument("--save_model", action="store_true")
    p.add_argument("--testing", action="store_true")
    p.add_argument("--group", default=None, type=str)
    p.add_argument("--moo", default="sum", choices=["sum", "moco"])
    p.add_argument("--batch_size", default=200, type=int)
    p.add_argument("--lr", default=2e-4, type=float)
    p.add_argument("--eps", default=1e-8, type=float)
    p.add_argument("--weight_decay", default=1e-3, type=float)
    p.add_argument("--epochs", default=50, type=int)
    p.add_argument("--channels", default=128, type=int)
    p.add_argument("--num_layers", default=3, type=int)
    p.add_argument("--dropout", default=0.5, type=float)
    p.add_argument("--num_neg_samples", default=64, type=int)
    p.add_argument("--khop_neighbors", nargs="+", type=int,
                   default=[100, 100])
    p.add_argument("--split_type", default="temporal_daily", type=str)
    p.add_argument("--splits", nargs="+", type=float,
                   default=[0.6, 0.2, 0.2])
    p.add_argument("--reverse_mp", action="store_true")
    p.add_argument("--ego", action="store_true")
    p.add_argument("--ports", action="store_true")
    p.add_argument("--edge_capacity", default=0, type=int,
                   help="0 = auto-calibrate")
    p.add_argument("--node_capacity", default=0, type=int,
                   help="0 = auto-calibrate")
    p.add_argument("--wandb_dir", default="wandb/", type=str)
    p.add_argument("--precision", default="f32", choices=("f32", "bf16"))
    p.add_argument("--scan_layers", action="store_true")
    p.add_argument("--dp", default=0, type=int)
    p.add_argument("--frontier_capacity", default=0, type=int)
    p.add_argument("--sampler", default="auto",
                   choices=("auto", "host", "device"))
    p.add_argument("--steps_per_dispatch", default=1, type=int)
    p.add_argument("--sampler_threads", default=1, type=int)
    p.add_argument("--inflight_groups", default=2, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def config_from_args(args: argparse.Namespace):
    from ..utils.config import Config

    for flag, default in UNPORTED.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)} is not ported yet")
    return Config(
        model="tabgnnfused", data=args.dataset, batch_size=args.batch_size,
        lr=args.lr, adam_eps=args.eps, weight_decay=args.weight_decay,
        epochs=args.epochs, n_hidden=args.channels,
        n_gnn_layers=args.num_layers, dropout=args.dropout,
        num_neg_samples=args.num_neg_samples,
        num_neighs=tuple(args.khop_neighbors), split_type=args.split_type,
        splits=tuple(args.splits), reverse_mp=args.reverse_mp, ego=args.ego,
        ports=args.ports, edge_capacity=args.edge_capacity,
        node_capacity=args.node_capacity,
        frontier_capacity=args.frontier_capacity, sampler=args.sampler,
        pretrain=(("mask",) if "mcm" in args.mode else ()) + ("lp",),
        save_model=args.save_model, testing=args.testing,
        wandb_dir=args.wandb_dir, group=str(args.group),
        sampler_threads=args.sampler_threads, precision=args.precision,
        moo=args.moo, device=args.device)


def build_ssl_dataset(cfg):
    """The SSL CLI's own dispatch (``rmm_tpu/cli/fused.py``): a path whose
    lower case holds ``eth`` is Ethereum phishing (split by
    ``--split_type`` at ``--splits``), any other IBM AML; both with the
    pretraining targets of ``cfg.pretrain``, ``--ports`` and ``--ego``.
    (The supervised CLI's ``build_dataset`` matches ``ethereum-phishing``
    instead and fixes ``temporal_daily``.)"""
    from ..datasets import EthereumPhishing, IBMTransactionsAML
    from ..datasets.base import parse_pretrain_args

    kw = dict(pretrain=parse_pretrain_args(cfg.pretrain),
              split_type=cfg.split_type, splits=tuple(cfg.splits),
              khop_neighbors=tuple(cfg.num_neighs), ports=cfg.ports,
              ego=cfg.ego, edge_capacity=cfg.edge_capacity,
              node_capacity=cfg.node_capacity)
    if "eth" in cfg.data.lower():
        return EthereumPhishing(root=cfg.data, **kw)
    return IBMTransactionsAML(root=cfg.data, **kw)


def main(argv=None, stats: Optional[dict] = None):
    from ..train.pretrain import PretrainTrainer
    from ..utils.checkpoint import parse_checkpoint_path
    from ..utils.device import resolve_device
    from ..utils.logging import RunLogger, logger_setup

    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)
    run_dir = os.path.join(cfg.wandb_dir, f"run_{args.run_name}")
    logger_setup(run_dir)
    logging.info(cfg.to_json())

    t0 = time.perf_counter()
    dataset = build_ssl_dataset(cfg)
    trainer = PretrainTrainer(cfg, dataset, mode=args.mode)
    start_epoch, best = 0, None
    if args.checkpoint:
        _, start_epoch = parse_checkpoint_path(args.checkpoint)
        start_epoch += 1
        best = trainer.restore(args.checkpoint)
        logging.info("Resumed from %s (next epoch %d, best %s)",
                     args.checkpoint, start_epoch, best)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logging.info("Number of trainable parameters: %d", n_params)
    run_logger = RunLogger(run_dir, config=json.loads(trainer.cfg.to_json()))
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
                     edge_capacity=trainer.cfg.edge_capacity,
                     frontier_capacity=trainer.cfg.frontier_capacity,
                     node_capacity=trainer.cfg.node_capacity,
                     device=str(device))
    return history, best


if __name__ == "__main__":
    main()
