"""Tabular masked-cell modeling: the edge table's rows alone, no graph
(``rmm_tpu/train/tabular.py``: ``TabularMCMTrainer``, the trainer of the
``cli/fttransformer.py`` entry point).

:class:`TabularMCMModel` is the stype encoder (``edge_encoder``), the
``FTTransformer`` backbone (``model``) and the head (``head``): the
masked-cell head off the CLS state, with ``mask_vector`` the mask-vector
head beside it. Its components carry the names of the reference's
checkpoint, so a JAX tabular checkpoint loads into it by name.

:class:`TabularMCMTrainer` keeps the edge table (features and the MASK
target ``[masked_value, masked_col_idx]``) on the device and gathers each
batch's rows there; the loader's last batch is padded to ``batch_size``
and its real rows are the seed mask. The loss is ``SSLoss.mcm_loss`` (plus
``mv_loss`` with the mask vector) over the real rows; the optimizer AdamW
whose weight decay reaches the parameters of two or more dimensions, as
the pretrainer's. Losses and sums stay on the device until the end of a
pass: one host sync an epoch. ``Config.precision`` ``"bf16"`` casts as
``rmm_tpu/train/tabular.py`` does (``utils/precision.py``): the float32
parameters and the batch's feature blocks to bf16 at the top of each
forward, the outputs back to float32 before the loss and the metrics;
the parameters and AdamW's state stay float32. The entry point has no
precision flag, as the reference's has none.
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
from ..nn.decoders import SelfSupervisedHead, SelfSupervisedMVHead
from ..nn.dropout import set_generator
from ..nn.encoders import make_stypewise_encoder
from ..nn.models.ft_transformer import FTTransformer
from ..utils import checkpoint
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.loss import SSLoss
from ..utils.metric import MCMAccumulator, mv_accuracy
from ..utils.precision import apply, compute_cast
from ..utils.seeding import mix_seed
from .pretrain import adamw
from .task_models import init_parameters
from .trainer import mcm_metrics, mcm_sums

logger = logging.getLogger(__name__)


class TabularMCMModel(nn.Module):
    """``edge_encoder`` → ``model`` (FTTransformer) → ``head`` on the CLS
    state. → (num_out, cat_out, mv_out or None)."""

    def __init__(self, cfg: Config, edges, mask_vector: bool = False):
        super().__init__()
        self.edge_encoder = make_stypewise_encoder(edges, cfg.n_hidden)
        self.model = FTTransformer(cfg.n_hidden, cfg.n_gnn_layers,
                                   dropout=cfg.dropout)
        head = SelfSupervisedMVHead if mask_vector else SelfSupervisedHead
        self.head = head(cfg.n_hidden, len(edges.masked_numerical_columns),
                         edges.masked_categorical_cardinalities())

    def forward(self, tf: TensorFrame):
        _, x_cls = self.model(self.edge_encoder(tf))
        out = self.head(x_cls)
        return out if len(out) == 3 else (*out, None)


def no_best() -> dict:
    return {"accuracy": -1.0, "rmse": float("inf")}


class TabularMCMTrainer:
    def __init__(self, cfg: Config, edges, mask_vector: bool = False):
        """``edges``: a materialized EdgeTable with the MASK target."""
        self.device = resolve_device(cfg.device)
        self.cfg = cfg
        self.edges = edges
        self.mask_vector = mask_vector
        self.model = init_parameters(
            TabularMCMModel(cfg, edges, mask_vector),
            cfg.seed).to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        set_generator(self.model, self.generator)
        self.ssloss = SSLoss(len(edges.masked_numerical_columns))
        self.optimizer = adamw(list(self.model.parameters()), cfg)
        self.table = edges.tensor_frame.to(self.device)

    def _batches(self, view, shuffle: bool, epoch: int = 0):
        """(device TensorFrame with ``y``, seed mask, real rows, host ids of
        the view's rows) for each batch of a split view, in the loader's
        order (``mix_seed(seed, epoch)`` shuffles)."""
        b = self.cfg.batch_size
        loader = DataLoader(view.tensor_frame, b, shuffle=shuffle,
                            seed=mix_seed(self.cfg.seed, epoch))
        lanes = torch.arange(b, device=self.device)
        for idx, valid in loader.index_batches():
            rows = torch.from_numpy(view.indices[idx])
            if self.device.type == "cuda":
                rows = rows.pin_memory().to(self.device, non_blocking=True)
            t = self.table
            tf = TensorFrame(
                feats={st: v.index_select(0, rows)
                       for st, v in t.feats.items()},
                col_names=t.col_names, y=t.y.index_select(0, rows))
            yield tf, lanes < valid, valid, idx

    def _forward(self, tf: TensorFrame):
        """The model's float32 outputs under the precision of the
        config."""
        prec = self.cfg.precision
        return apply(self.model, prec, compute_cast(tf, prec))

    def _loss(self, tf: TensorFrame, mask: torch.Tensor):
        num_out, cat_out, mv_out = self._forward(tf)
        total, cat, num = self.ssloss.mcm_loss(cat_out, num_out, tf.y,
                                               valid_mask=mask)
        if mv_out is not None:
            total = total + self.ssloss.mv_loss(mv_out, tf.y, mask)
        return total, mcm_sums(cat, num)

    def _step(self, tf: TensorFrame, mask: torch.Tensor):
        """One train step (the model in train mode): the loss, the backward
        and the AdamW update. → the loss and its ``MCM_SUMS`` as device
        tensors."""
        loss, sums = self._loss(tf, mask)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return loss.detach(), sums.detach()

    def train_epoch(self, view, epoch: int) -> dict:
        """One pass over the shuffled train view: the mean loss, the MCM
        train accuracy and RMSE, seconds and, on the card, the median step
        on the device's clock."""
        t0 = time.time()
        self.model.train()
        rows, events = [], []
        cuda = self.device.type == "cuda"
        for tf, mask, _, _ in self._batches(view, True, epoch):
            loss, sums = self._step(tf, mask)
            rows.append(torch.cat([loss[None], sums]))
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        self.model.eval()
        out = {"loss": float("nan"), "train_acc": 0.0, "train_rmse": 0.0}
        if rows:
            sums = torch.stack(rows).cpu().numpy().astype(np.float64)
            out["loss"] = float(sums[:, 0].mean())
            out["train_rmse"], out["train_acc"] = mcm_metrics(
                sums[:, 1:].sum(axis=0))
        if len(events) > 1:
            out["step_ms"] = statistics.median(
                a.elapsed_time(b) for a, b in zip(events, events[1:]))
        out["sec"] = time.time() - t0
        return out

    def evaluate(self, view) -> dict:
        """MCM accuracy and RMSE over a view's real rows and, with the mask
        vector, its accuracy as a mean of the batches' means."""
        self.model.eval()
        outs = []
        with torch.inference_mode():
            for tf, _, valid, idx in self._batches(view, False):
                outs.append((valid, idx, self._forward(tf)))
        acc = MCMAccumulator(self.ssloss.num_numerical)
        mv_accs = []
        y_all = view.tensor_frame.y
        for valid, idx, (num_out, cat_out, mv_out) in outs:
            y = y_all[idx]
            acc.update([c.cpu().numpy() for c in cat_out],
                       num_out.cpu().numpy(), y, valid)
            if mv_out is not None:
                mv_accs.append(mv_accuracy(mv_out.cpu().numpy()[:valid],
                                           y[:valid]))
        out = {"accuracy": acc.accuracy, "rmse": acc.rmse}
        if mv_accs:
            out["mv_accuracy"] = float(np.mean(mv_accs))
        return out

    # -- checkpoint / resume ----------------------------------------------
    def save(self, run_dir: str, epoch, best: Optional[dict] = None,
             with_opt: bool = True) -> str:
        """``<run_dir>/<epoch>/``: the model (``edge_encoder``, ``model``,
        ``head``), the AdamW state and ``best_m.json``; a ``best_*`` tag
        holds the weights alone."""
        return checkpoint.save_epoch(
            run_dir, epoch, self.model,
            self.optimizer if with_opt else None, best,
            prune_previous=isinstance(epoch, int),
            precision=self.cfg.precision)

    def restore(self, ck_dir: str, with_opt: bool = True) -> dict:
        """Load a checkpoint of either package, every entry or raise (the
        port's optimizer state too, when there; the JAX package's
        ``opt_state`` is not read, so AdamW starts afresh), and return its
        best metrics."""
        best = no_best()
        best.update(checkpoint.resume(
            ck_dir, self.model, self.optimizer if with_opt else None,
            self.device))
        return best

    def fit(self, run_logger=None, run_dir: Optional[str] = None,
            start_epoch: int = 0, best: Optional[dict] = None):
        """Epoch loop tracking the best val accuracy and RMSE; with a
        ``run_dir``, a checkpoint per epoch and a ``best_acc``/``best_rmse``
        snapshot for each improved metric. Returns (history, best)."""
        tr, va, _ = self.edges.split()
        best = no_best() if best is None else best
        history = []
        for epoch in range(start_epoch, start_epoch + self.cfg.epochs):
            tm = self.train_epoch(tr, epoch)
            vm = self.evaluate(va)
            rec = {"epoch": epoch, **tm,
                   **{f"val_{k}": v for k, v in vm.items()}}
            improved = []
            if vm["accuracy"] > best["accuracy"]:
                best["accuracy"] = vm["accuracy"]
                improved.append("acc")
            if vm["rmse"] < best["rmse"]:
                best["rmse"] = vm["rmse"]
                improved.append("rmse")
            logger.info(str(rec))
            if run_logger is not None:
                run_logger.log(rec, step=epoch)
            if run_dir is not None:
                self.save(run_dir, epoch, best)
                for k in improved:
                    self.save(run_dir, f"best_{k}", best, with_opt=False)
            history.append(rec)
        return history, best
