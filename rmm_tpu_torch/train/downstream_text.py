"""Text + tabular regression (``rmm_tpu/train/downstream_text.py``: the
trainer of ``cli/downstream_llm.py``): Amazon Fashion reviews → the
rating, an ``FTTransformer`` over the review's column tokens.

Two text paths: ``text_embedded`` columns (a frozen embedder's vectors,
``LinearEmbeddingEncoder``) or ``text_tokenized`` ones read inside the
forward by a trainable LM (``LinearModelEncoder`` over
:class:`~rmm_tpu_torch.nn.text.TextToEmbeddingFinetune`: one layer, the
FTTransformer's width, 4 heads, dropout 0.1, LoRA of ``lora_rank`` on its
output projection). :class:`TextTabularModel` is the encoder
(``encoder``), the backbone (``model``: C, layers and dropout of the
config, 8 heads) and the head (``head``: ``SupervisedHead`` off the CLS
state), the JAX trainer's components.

The loss is the MSE over a batch's real rows (the loader pads the last
batch), the metric the RMSE. AdamW at the config's rate, eps and weight
decay decays every parameter, as ``optax.adamw`` without a mask does
(unlike the pretrainer's, whose decay skips 1-D parameters); every
parameter keeps a gradient, zero where nothing reached it, so the decay
reaches them all. The train loader is rebuilt each epoch with the config's
seed, so every epoch takes the same order, as in the reference. The edge
table lives on the device; each batch's rows are gathered there. An
epoch's timers: ``data_load`` (the loader's row ids), ``transfer`` (the
ids to the device and the rows' gather) and ``step`` (each step up to its
loss on the host).
"""
from __future__ import annotations

import logging
import statistics
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..frame.loader import DataLoader
from ..frame.tensor_frame import TensorFrame
from ..nn.decoders import SupervisedHead
from ..nn.dropout import set_generator
from ..nn.encoders import make_stypewise_encoder
from ..nn.models.ft_transformer import FTTransformer
from ..nn.text import TextToEmbeddingFinetune
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.precision import apply, compute_cast
from .task_models import init_parameters

logger = logging.getLogger(__name__)

#: the text LM of the finetune path: one layer of 4 heads, dropout 0.1 (no
#: flag reaches it, as in the reference)
TEXT_LAYERS, TEXT_HEADS, TEXT_DROPOUT = 1, 4, 0.1


def constant_rmse(dataset) -> dict[str, float]:
    """The val and test RMSE of predicting every rating as the train
    ratings' mean: the yardstick a trained model should beat."""
    tr, va, te = dataset.edges.split()
    mean = float(np.mean(tr.tensor_frame.y[:, 0], dtype=np.float64))
    return {name: float(np.sqrt(np.mean(
        (v.tensor_frame.y[:, 0].astype(np.float64) - mean) ** 2)))
        for name, v in (("val", va), ("test", te))}


class TextTabularModel(nn.Module):
    """``encoder`` → ``model`` (FTTransformer) → ``head`` on the CLS state:
    a TensorFrame → the predicted rating ``[B]``."""

    def __init__(self, cfg: Config, edges, finetune_text: bool = False,
                 lora_rank: int = 8):
        super().__init__()
        text_model = None
        if finetune_text:
            text_model = TextToEmbeddingFinetune(
                hidden=cfg.n_hidden, num_layers=TEXT_LAYERS,
                nhead=TEXT_HEADS, dropout=TEXT_DROPOUT, lora_rank=lora_rank)
        self.encoder = make_stypewise_encoder(
            edges, cfg.n_hidden, text_model=text_model,
            model_dim=cfg.n_hidden if finetune_text else 0)
        self.model = FTTransformer(cfg.n_hidden, cfg.n_gnn_layers, nhead=8,
                                   dropout=cfg.dropout)
        self.head = SupervisedHead(cfg.n_hidden, 1)

    def forward(self, tf: TensorFrame) -> torch.Tensor:
        _, x_cls = self.model(self.encoder(tf))
        return self.head(x_cls)[:, 0]


class TextTabularRegressionTrainer:
    def __init__(self, cfg: Config, dataset, finetune_text: bool = False,
                 lora_rank: int = 8):
        """``dataset``: an ``AmazonFashionDataset`` whose text columns are
        ``text_tokenized`` where ``finetune_text``, else
        ``text_embedded``."""
        self.device = resolve_device(cfg.device)
        self.cfg = cfg
        self.dataset = dataset
        self.model = init_parameters(
            TextTabularModel(cfg, dataset.edges, finetune_text, lora_rank),
            cfg.seed).to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        set_generator(self.model, self.generator)
        params = list(self.model.parameters())
        self.optimizer = torch.optim.AdamW(params, lr=cfg.lr,
                                           eps=cfg.adam_eps,
                                           weight_decay=cfg.weight_decay)
        for p in params:
            p.grad = torch.zeros_like(p)
        self.table = dataset.edges.tensor_frame.to(self.device)
        self.step_losses: list[float] = []   # the last epoch's

    def _batches(self, view, shuffle: bool, timers: Optional[dict] = None):
        """(device TensorFrame with ``y``, mask of the real rows, their
        count) for each batch of a split view, the train loader seeded
        with the config's seed."""
        b = self.cfg.batch_size
        loader = DataLoader(view.tensor_frame, b, shuffle=shuffle,
                            seed=self.cfg.seed)
        lanes = torch.arange(b, device=self.device)
        timers = {} if timers is None else timers
        t_last = time.perf_counter()
        for idx, valid in loader.index_batches():
            t0 = time.perf_counter()
            timers["data_load"] = timers.get("data_load", 0.0) + t0 - t_last
            rows = torch.from_numpy(view.indices[idx])
            if self.device.type == "cuda":
                rows = rows.pin_memory().to(self.device, non_blocking=True)
            t = self.table
            tf = TensorFrame(
                feats={st: v.index_select(0, rows)
                       for st, v in t.feats.items()},
                col_names=t.col_names, y=t.y.index_select(0, rows))
            timers["transfer"] = (timers.get("transfer", 0.0)
                                  + time.perf_counter() - t0)
            yield tf, lanes < valid, valid
            t_last = time.perf_counter()

    def predict(self, tf: TensorFrame) -> torch.Tensor:
        """The float32 predicted rating ``[B]`` under the precision of the
        config."""
        prec = self.cfg.precision
        return apply(self.model, prec, compute_cast(tf, prec))

    def loss(self, tf: TensorFrame, mask: torch.Tensor) -> torch.Tensor:
        """The MSE of the predicted rating over the real rows."""
        pred = self.predict(tf)
        m = mask.to(torch.float32)
        err = (pred - tf.y[:, 0]) ** 2 * m
        return err.sum() / m.sum().clamp(min=1.0)

    def _step(self, tf: TensorFrame, mask: torch.Tensor) -> torch.Tensor:
        """One train step (the model in train mode): the loss, the backward
        and the AdamW update; → the loss on the device."""
        loss = self.loss(tf, mask)
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_epoch(self, view, epoch: int = 0) -> dict:
        """One pass over the train view: the mean loss, the timers, the
        steps and, on the card, the median step on the device's clock."""
        timers = {"data_load": 0.0, "transfer": 0.0, "step": 0.0}
        self.model.train()
        losses, events = [], []
        cuda = self.device.type == "cuda"
        for tf, mask, _ in self._batches(view, True, timers):
            t0 = time.perf_counter()
            losses.append(float(self._step(tf, mask)))
            timers["step"] += time.perf_counter() - t0
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        self.model.eval()
        self.step_losses = losses
        out = {"loss": float(np.mean(losses)) if losses else float("nan"),
               **timers, "steps": len(losses)}
        if len(events) > 1:
            out["step_ms"] = statistics.median(
                a.elapsed_time(b) for a, b in zip(events, events[1:]))
        return out

    def evaluate(self, view) -> float:
        """The RMSE of the predicted rating over the view's rows."""
        self.model.eval()
        se, n = 0.0, 0
        with torch.inference_mode():
            for tf, _, valid in self._batches(view, False):
                pred = self.predict(tf).cpu().numpy()[:valid]
                y = tf.y[:valid, 0].cpu().numpy()
                se += float(((pred - y) ** 2).sum())
                n += valid
        return float(np.sqrt(se / max(n, 1)))

    def fit(self, run_logger=None):
        """The epoch loop: train, then the val and test RMSE. Returns
        (history, the best val RMSE)."""
        tr, va, te = self.dataset.edges.split()
        history, best = [], float("inf")
        for epoch in range(self.cfg.epochs):
            t0 = time.perf_counter()
            tm = self.train_epoch(tr, epoch)
            rec = {"epoch": epoch, **tm, "val_rmse": self.evaluate(va),
                   "test_rmse": self.evaluate(te),
                   "sec": time.perf_counter() - t0}
            best = min(best, rec["val_rmse"])
            logger.info(str(rec))
            if run_logger is not None:
                run_logger.log(rec, step=epoch)
            history.append(rec)
        return history, best
