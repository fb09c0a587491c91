"""Text + tabular downstream CLI (the counterpart of
``rmm_tpu.cli.downstream_llm``): Amazon Fashion reviews → rating
regression with frozen text vectors or a text LM trained inside the
forward:

    python -m rmm_tpu_torch.cli.downstream_llm --dataset <reviews.csv> \\
        --text_path frozen|finetune --epochs 1 --testing [--device cpu]

``--text_path frozen`` embeds the ``reviewText`` and ``summary`` columns
once with the hashing embedder (128 wide); ``finetune`` tokenizes them
(the hashing tokenizer, 64 ids) and trains a one-layer LM of the model's
width with LoRA of ``--lora_rank`` on its output projection
(``train/downstream_text.py``). ``--text_model`` takes ``hashing`` alone:
pretrained LMs are not ported, and any other name is refused (the JAX CLI
falls back to its own LM instead). The JAX CLI's flags and defaults
(channels 64, 2 layers, batch 256, lr 1e-3, dropout 0.1, lora_rank 8, 10
epochs) plus ``--device`` (``cuda`` by default, which raises without
CUDA). The run directory is ``<wandb_dir>/run_downstream_llm``
(``metrics.jsonl``, ``config.json``, ``logs.log``).

``main(argv, stats)`` fills the dict ``stats``, when given, with the run
directory, the wall-clock split (``materialize_s``: the CSV read and the
text columns materialized; ``setup_s``: that and the trainer built;
``fit_s``), the rows of each split, the device, the last epoch's step
losses and the val and test RMSE of a constant prediction, the train
ratings' mean (``train/downstream_text.constant_rmse``).
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
    p.add_argument("--text_path", default="frozen",
                   choices=["frozen", "finetune"])
    p.add_argument("--text_model", default="hashing", type=str,
                   help="'hashing' (the only text model ported)")
    p.add_argument("--lora_rank", default=8, type=int)
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--channels", default=64, type=int)
    p.add_argument("--num_layers", default=2, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--dropout", default=0.1, type=float)
    p.add_argument("--testing", action="store_true")
    p.add_argument("--wandb_dir", default="wandb/", type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def check_text_model(name: str) -> None:
    """Refuses every text model but the hashing one, by name."""
    if name != "hashing":
        raise ValueError(f"--text_model {name!r} is not ported: the port "
                         "has the 'hashing' embedder and LM only "
                         "(pretrained LMs need HuggingFace weights)")


def main(argv=None, stats: Optional[dict] = None):
    from ..datasets.amazon_fashion import AmazonFashionDataset
    from ..frame.stype import Stype
    from ..train.downstream_text import (TextTabularRegressionTrainer,
                                         constant_rmse)
    from ..utils.config import Config
    from ..utils.device import resolve_device
    from ..utils.logging import RunLogger, logger_setup

    args = build_parser().parse_args(argv)
    check_text_model(args.text_model)
    cfg = Config(model="fttransformer", data=args.dataset,
                 batch_size=args.batch_size, epochs=args.epochs,
                 n_hidden=args.channels, n_gnn_layers=args.num_layers,
                 lr=args.lr, dropout=args.dropout, testing=args.testing,
                 wandb_dir=args.wandb_dir, device=args.device)
    device = resolve_device(cfg.device)
    run_dir = os.path.join(cfg.wandb_dir, "run_downstream_llm")
    logger_setup(run_dir)
    logging.info(cfg.to_json())

    finetune = args.text_path == "finetune"
    t0 = time.perf_counter()
    dataset = AmazonFashionDataset(
        cfg.data, text_stype=(Stype.text_tokenized if finetune
                              else Stype.text_embedded))
    t1 = time.perf_counter()
    trainer = TextTabularRegressionTrainer(cfg, dataset,
                                           finetune_text=finetune,
                                           lora_rank=args.lora_rank)
    run_logger = RunLogger(run_dir, config=json.loads(cfg.to_json()))
    t2 = time.perf_counter()
    history, best = trainer.fit(run_logger)
    run_logger.close()
    logging.info("best val rmse: %.4f", best)
    if stats is not None:
        stats.update(run_dir=run_dir, materialize_s=t1 - t0,
                     setup_s=t2 - t0, fit_s=time.perf_counter() - t2,
                     split_rows=[v.tensor_frame.num_rows
                                 for v in dataset.edges.split()],
                     device=str(device), step_losses=trainer.step_losses,
                     constant_rmse=constant_rmse(dataset))
    return history, best


if __name__ == "__main__":
    main()
