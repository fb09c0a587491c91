"""Pure-LM finetuning CLI (the counterpart of ``rmm_tpu.cli.finetune_llm``):
review text → rating regression with the from-scratch LM
(``nn/text/finetune.py``, LoRA on its output projection) and a linear head,
MSE eval:

    python -m rmm_tpu_torch.cli.finetune_llm --dataset <reviews.csv> \\
        --epochs 1 [--save_model <dir>] [--device cpu]

The JAX CLI's flags and defaults (hidden 128, 2 layers, 4 heads, LoRA rank
8, max_length 64, batch 128, lr 1e-3, 5 epochs) plus ``--device``
(``cuda`` by default, which raises without CUDA). At these defaults the
LM's attention rows are 128 × 64 × 128/4, whose backward runs the long
attention core one block an SM. ``--text_model`` takes ``hashing`` alone
(pretrained LMs are not ported; any other name is refused).

As in the reference: the ``reviewText`` column tokenized by the hashing
tokenizer; an 80/20 split by ``RandomState(seed)``'s permutation; each
epoch that state shuffles the train rows and the last partial batch is
dropped; the eval rows are padded with all-padding rows to whole batches;
the head ``w [hidden, 1]``, ``b [1]`` starts at zero; AdamW at lr with
``optax.adamw``'s default weight decay 1e-4 on every parameter; dropout
0.1 in the LM.
``--save_model <dir>`` writes the encoder and head as the port's
checkpoint in ``<dir>/final`` (``model.pt`` and ``meta.json`` with the LM's
widths), which :func:`load_finetuned` reads back.
"""
from __future__ import annotations

import argparse
import logging
import os
import statistics
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

logger = logging.getLogger(__name__)

WEIGHT_DECAY = 1e-4   # optax.adamw's default


def read_dataset(csv_path: str, max_length: int = 64
                 ) -> tuple[np.ndarray, np.ndarray]:
    """CSV → (the hashing tokenizer's ids of ``reviewText`` ``[N,
    max_length]`` int32, the ``overall`` ratings ``[N]`` float32); a
    missing text is the empty one."""
    from ..datasets.base import read_csv_columns, text_cells
    from ..nn.text import HashingTokenizer

    columns = read_csv_columns(csv_path)
    texts = text_cells(columns["reviewText"])
    y = np.asarray(columns["overall"], np.float32)
    return HashingTokenizer(max_length=max_length)(texts), y


class RatingHead(nn.Module):
    """``h @ w + b`` → ``[B]`` (the reference's ``{"w", "b"}`` head)."""

    def __init__(self, hidden: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(hidden, 1))
        self.b = nn.Parameter(torch.zeros(1))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return (h @ self.w)[:, 0] + self.b[0]


class LLMRegressor(nn.Module):
    """``encoder`` (the LM) → ``head``: token ids → the rating."""

    def __init__(self, hidden: int = 128, num_layers: int = 2,
                 lora_rank: int = 8, max_length: int = 64,
                 dropout: float = 0.1, vocab_size: int = 8192):
        super().__init__()
        from ..nn.text import TextToEmbeddingFinetune

        self.encoder = TextToEmbeddingFinetune(
            hidden=hidden, num_layers=num_layers, lora_rank=lora_rank,
            max_length=max_length, dropout=dropout, vocab_size=vocab_size)
        self.head = RatingHead(hidden)

    def forward(self, tok: torch.Tensor) -> torch.Tensor:
        return self.head(self.encoder(tok))


def build_model(hidden: int = 128, num_layers: int = 2, lora_rank: int = 8,
                max_length: int = 64, seed: int = 0) -> LLMRegressor:
    """The seeded LM (``task_models.init_parameters``) and a zero head."""
    from ..train.task_models import init_parameters

    model = init_parameters(LLMRegressor(hidden, num_layers, lora_rank,
                                         max_length), seed)
    with torch.no_grad():
        model.head.w.zero_()
        model.head.b.zero_()
    return model


def load_finetuned(ck_dir: str, device="cpu") -> LLMRegressor:
    """A ``--save_model`` export (its ``final`` directory, or the export
    directory holding it) as an ``LLMRegressor`` in eval mode."""
    import json

    from ..utils.checkpoint import load_checkpoint

    if os.path.isdir(os.path.join(ck_dir, "final")):
        ck_dir = os.path.join(ck_dir, "final")
    with open(os.path.join(ck_dir, "meta.json")) as f:
        widths = json.load(f)["lm"]
    model = LLMRegressor(**widths)
    load_checkpoint(ck_dir, model)
    return model.to(device).eval()


def split(n: int, seed: int):
    """(the ``RandomState(seed)`` that shuffles the train rows each epoch,
    the train rows, the eval rows): its permutation's first 80% and the
    rest."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_train = int(n * 0.8)
    return rng, perm[:n_train], perm[n_train:]


def _on(idx: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(idx)).to(dev)


def eval_mse(model: nn.Module, ids: torch.Tensor, y: np.ndarray,
             te_idx: np.ndarray, batch_size: int) -> float:
    """The MSE over the eval rows (``ids`` on the model's device), in
    batches padded with all-padding rows to ``batch_size``."""
    model.eval()
    preds = []
    with torch.inference_mode():
        for s in range(0, len(te_idx), batch_size):
            sel = te_idx[s:s + batch_size]
            tok = ids[_on(sel, ids.device)]
            if len(sel) < batch_size:
                tok = nn.functional.pad(tok, (0, 0, 0, batch_size - len(sel)))
            preds.append(model(tok).cpu().numpy()[:len(sel)])
    if not preds:
        return float("nan")
    return float(np.mean((np.concatenate(preds) - y[te_idx]) ** 2))


def finetune_llm(csv_path: str, epochs: int = 5, batch_size: int = 128,
                 lr: float = 1e-3, hidden: int = 128, num_layers: int = 2,
                 lora_rank: int = 8, max_length: int = 64, seed: int = 0,
                 text_model: str = "hashing", run_logger=None,
                 save_model: Optional[str] = None, device="cuda",
                 model: Optional[nn.Module] = None):
    """Train and evaluate; → (history, the model). ``model`` (an
    ``LLMRegressor`` of these widths) replaces the seeded start (parity
    runs pass one built with dropout 0)."""
    from ..nn.dropout import set_generator
    from ..utils.checkpoint import save_checkpoint
    from ..utils.device import resolve_device
    from .downstream_llm import check_text_model

    check_text_model(text_model)
    dev = resolve_device(device)
    ids, y = read_dataset(csv_path, max_length=max_length)
    rng, tr_idx, te_idx = split(len(y), seed)

    if model is None:
        model = build_model(hidden, num_layers, lora_rank, max_length, seed)
    model = model.to(dev)
    set_generator(model, torch.Generator(dev).manual_seed(seed))
    params = list(model.parameters())
    opt = torch.optim.AdamW(params, lr=lr, eps=1e-8,
                            weight_decay=WEIGHT_DECAY)
    for p in params:
        p.grad = torch.zeros_like(p)
    ids_d = torch.from_numpy(ids).to(dev)
    y_d = torch.from_numpy(y).to(dev)
    cuda = dev.type == "cuda"

    history = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        rng.shuffle(tr_idx)
        model.train()
        losses, events = [], []
        for s in range(0, len(tr_idx) - batch_size + 1, batch_size):
            sel = _on(tr_idx[s:s + batch_size], dev)
            loss = torch.mean((model(ids_d[sel]) - y_d[sel]) ** 2)
            opt.zero_grad(set_to_none=False)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        mse = eval_mse(model, ids_d, y, te_idx, batch_size)
        rec = {"epoch": epoch, "train_mse": float(np.mean(losses))
               if losses else 0.0, "eval_mse": mse, "steps": len(losses),
               "sec": time.perf_counter() - t0}
        if len(events) > 1:
            rec["step_ms"] = statistics.median(
                a.elapsed_time(b) for a, b in zip(events, events[1:]))
        logger.info(str(rec))
        if run_logger is not None:
            run_logger.log(rec, step=epoch)
        history.append(rec)
    if save_model:
        enc = model.encoder
        save_checkpoint(os.path.join(save_model, "final"),
                        model.state_dict(), meta={"lm": {
                            "hidden": enc.hidden,
                            "num_layers": enc.num_layers,
                            "lora_rank": (enc.lora_out.rank
                                          if enc.lora_out is not None
                                          else 0),
                            "max_length": enc.max_length,
                            "vocab_size": enc.vocab_size}})
        logger.info("saved the encoder and head to %s", save_model)
    return history, model


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True, type=str)
    p.add_argument("--epochs", default=5, type=int)
    p.add_argument("--batch_size", default=128, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--hidden", default=128, type=int)
    p.add_argument("--num_layers", default=2, type=int)
    p.add_argument("--lora_rank", default=8, type=int)
    p.add_argument("--max_length", default=64, type=int)
    p.add_argument("--text_model", default="hashing", type=str,
                   help="'hashing' (the only text model ported)")
    p.add_argument("--testing", action="store_true")
    p.add_argument("--wandb_dir", default="wandb/", type=str)
    p.add_argument("--save_model", default=None, type=str,
                   help="export dir: the encoder and head in <dir>/final")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default; raises without CUDA) or cpu")
    return p


def main(argv=None, stats: Optional[dict] = None):
    """The CLI; fills ``stats``, when given, with the run directory and the
    wall-clock seconds (``fit_s``)."""
    from ..utils.logging import RunLogger, logger_setup

    args = build_parser().parse_args(argv)
    run_dir = os.path.join(args.wandb_dir, "run_finetune_llm")
    logger_setup(run_dir)
    rl = RunLogger(run_dir, config=vars(args))
    t0 = time.perf_counter()
    history, _ = finetune_llm(
        args.dataset, epochs=args.epochs, batch_size=args.batch_size,
        lr=args.lr, hidden=args.hidden, num_layers=args.num_layers,
        lora_rank=args.lora_rank, max_length=args.max_length,
        text_model=args.text_model, run_logger=rl,
        save_model=args.save_model, device=args.device)
    rl.close()
    if stats is not None:
        stats.update(run_dir=run_dir, fit_s=time.perf_counter() - t0)
    return history


if __name__ == "__main__":
    main()
