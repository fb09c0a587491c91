"""Supervised training CLI (the counterpart of ``rmm_tpu.cli.main``):

    python -m rmm_tpu_torch.cli.main --data <csv> --model tabgnn \\
        --epochs 20 --testing [--device cpu]

``--model`` is one of ``fttransformer`` (the column transformer alone),
``gin``, ``pna``, ``cpna``, ``cpnatab`` (the GNN baselines; ``--emlps``
turns their edge updates on), ``tabgnn``, ``tabgnninterleaved`` and
``tabgnnfused``; ``--precision bf16`` runs ``tabgnn`` and ``tabgnnfused``.
Same flags as ``rmm_tpu.cli.main`` plus ``--device`` (``cuda`` by default,
which raises without CUDA; ``cpu`` runs the kernels' plain versions), and
without ``--dp``. The run directory is ``<wandb_dir>/run_<pid>`` (or the
resumed run's): ``metrics.jsonl`` (one line per epoch), ``config.json``,
``logs.log`` and the per-epoch checkpoints ``<epoch>/`` that
``cli/predict.py`` serves. ``--checkpoint --load_model <run_dir>/<epoch>``
resumes that run at the next epoch with its weights, BatchNorm statistics
and best validation f1 (every entry, or it raises); like the JAX trainer it
starts Adam afresh. ``--load_model <ck>`` alone is the SSL → supervised
transfer (``rmm_tpu/cli/main.py:62-70``): the ``node_encoder`` and
``edge_encoder`` leaves that the checkpoint holds at the model's shapes
(and its BatchNorm statistics where they match by name), every other
leaf at its initialization, and the counts logged. Either package's
checkpoint loads, the port's or the JAX package's (told apart by
``meta.json``), e.g. ``cli/fused.py --save_model``'s epoch directory:

    python -m rmm_tpu_torch.cli.main --data <csv> --model tabgnnfused \
        --n_hidden 128 --n_gnn_layers 3 --load_model <ssl run>/<epoch>

``main(argv, stats)`` fills the dict ``stats``, when given, with the run
directory, the wall-clock split (``setup_s``: CSV, dataset, calibration,
model; ``fit_s``: the epochs), the rows of each split, the capacities
used and, after a transfer, its ``grafted`` and ``kept`` keys.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional


def main(argv=None, stats: Optional[dict] = None):
    from ..datasets import build_dataset
    from ..train.trainer import Trainer
    from ..utils.checkpoint import (load_best_m, load_components,
                                    load_strict, parse_checkpoint_path)
    from ..utils.config import config_from_args, create_parser
    from ..utils.device import resolve_device
    from ..utils.logging import RunLogger, logger_setup

    args = create_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = resolve_device(cfg.device)

    start_epoch, run_id, best_m = 0, None, None
    if cfg.checkpoint and cfg.load_model:
        run_id, start_epoch = parse_checkpoint_path(cfg.load_model)
        start_epoch += 1
        try:
            best_m = load_best_m(cfg.load_model)
        except OSError:
            best_m = None
    run_dir = os.path.join(cfg.wandb_dir, run_id or f"run_{os.getpid()}")
    logger_setup(run_dir)
    logging.info(cfg.to_json())
    if run_id:
        logging.info("Resuming run %s from epoch %d", run_id, start_epoch)

    t0 = time.perf_counter()
    dataset = build_dataset(cfg)
    if hasattr(dataset, "n_classes"):
        cfg = cfg.replace(n_classes=dataset.n_classes)
    trainer = Trainer(cfg, dataset, device)
    if cfg.load_model and cfg.checkpoint:
        logging.info("Loading all weights from %s", cfg.load_model)
        load_strict(cfg.load_model, trainer.model)
    elif cfg.load_model:
        loaded = load_components(cfg.load_model, trainer.model,
                                 ["node_encoder", "edge_encoder"])
        logging.info("Transferred %d leaves from %s; %d kept their "
                     "initialization", len(loaded["grafted"]),
                     cfg.load_model, len(loaded["kept"]))
        if stats is not None:
            stats["transfer"] = loaded
    n_params = sum(p.numel() for p in trainer.model.parameters())
    logging.info("Number of trainable parameters: %d", n_params)
    run_logger = RunLogger(run_dir, config=json.loads(trainer.cfg.to_json()))
    t1 = time.perf_counter()
    history, best = trainer.fit(run_logger, run_dir, start_epoch, best_m)
    run_logger.close()
    if stats is not None:
        stats.update(run_dir=run_dir, setup_s=t1 - t0,
                     fit_s=time.perf_counter() - t1,
                     split_rows=[v.tensor_frame.num_rows
                                 for v in trainer.seed_table().split()],
                     edge_capacity=trainer.cfg.edge_capacity,
                     node_capacity=trainer.cfg.node_capacity,
                     device=str(device))
    return history, best


if __name__ == "__main__":
    main()
