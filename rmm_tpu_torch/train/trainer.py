"""Trainer: capacities, model, device-resident tables, host-sampled
batches, the train step, the epoch loop, evaluation and batch inference
(``rmm_tpu/train/trainer.py``: ``Trainer`` without the scan/device-sampler
paths) for the task models of ``TASK_MODELS``: ``fttransformer``, ``gin``,
``pna``, ``cpna``, ``cpnatab``, ``tabgnn``, ``tabgnninterleaved`` and
``tabgnnfused``.

The host runs the C++ k-hop sampler and ships small id/mask arrays to the
card as pinned, non-blocking copies; the edge and node feature tables go to
the card once. Steps and forwards are only enqueued per batch: losses and
predictions stay on the device until the end of the epoch (one host sync),
so the host samples the next batch while the card computes the last one.

Node classification (``--task node_classification``, Elliptic's) seeds
each batch with the view's node ids, which fill node lanes ``[0, B)``; rows
of the dataset's ``ignore_label`` class are left out of the loss, the
metrics and the predictions.

Training: weighted cross-entropy on the seed edges (or nodes),
``torch.optim.Adam(lr, eps=adam_eps)`` with no weight decay (the JAX
trainer's ``optax.adam``), ``--freeze`` keeping every ``tab_layer_*``
parameter out of the update.
Dropout draws from one ``torch.Generator`` on the model's device, seeded
from ``cfg.seed``.

``--precision bf16`` (``utils/precision.py``): the float32 parameters are
cast to bf16 at the top of each train and eval step, the feature tables
once when they go to the device (the same values the reference's
per-step cast gives), the logits back to float32 before the loss and the
metrics; the parameters, Adam's state and the BatchNorm statistics stay
float32.
"""
from __future__ import annotations

import collections
import concurrent.futures
import logging
import statistics
import time
from typing import Optional

import numpy as np
import torch

from ..frame.loader import DataLoader
from ..frame.tensor_frame import TensorFrame
from ..nn.dropout import set_generator
from ..nn.encoders import make_stypewise_encoder
from ..utils import checkpoint
from ..utils.batch import GraphBatch
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.loss import cross_entropy
from ..utils.metric import f1_score, roc_auc
from ..utils.precision import apply, compute_cast
from ..utils.seeding import mix_seed
from . import task_models

logger = logging.getLogger(__name__)


#: the ported task models, by ``--model`` (``rmm_tpu/train/trainer.py:55-76``)
TASK_MODELS = {"fttransformer": task_models.TT,
               **dict.fromkeys(task_models.GNNWrap.MODELS,
                               task_models.GNNWrap),
               "tabgnn": task_models.TABGNNS,
               "tabgnninterleaved": task_models.TABGNNS,
               "tabgnnfused": task_models.TABGNNFusedS}
#: the models that run under ``--precision bf16``
BF16_MODELS = ("tabgnn", "tabgnnfused")


def build_task_model(cfg: Config, dataset) -> torch.nn.Module:
    if cfg.model not in TASK_MODELS:
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet")
    if cfg.precision != "f32" and cfg.model not in BF16_MODELS:
        raise NotImplementedError(f"--precision {cfg.precision} is not "
                                  f"ported yet for model {cfg.model!r}")
    common = dict(
        node_encoder=make_stypewise_encoder(dataset.nodes, cfg.n_hidden),
        edge_encoder=make_stypewise_encoder(dataset.edges, cfg.n_hidden),
        n_classes=cfg.n_classes, dropout=cfg.dropout, ego=cfg.ego,
        task=cfg.task)
    if cfg.model == "fttransformer":
        return task_models.TT(channels=cfg.n_hidden,
                              num_layers=cfg.n_gnn_layers, **common)
    common.update(avg_log_deg=task_models._deghist_to_avg_log(
        dataset.in_degree_histogram()), reverse_mp=cfg.reverse_mp)
    if cfg.model in task_models.GNNWrap.MODELS:
        return task_models.GNNWrap(
            model_name=cfg.model, n_hidden=cfg.n_hidden,
            n_gnn_layers=cfg.n_gnn_layers,
            num_edge_cols=dataset.edges.tensor_frame.num_cols,
            emlps=cfg.emlps, **common)
    if cfg.model != "tabgnnfused":
        common["model_name"] = cfg.model
    return TASK_MODELS[cfg.model](channels=cfg.n_hidden,
                                  n_gnn_layers=cfg.n_gnn_layers, **common)


def resolve_capacities(cfg: Config, dataset) -> Config:
    """Explicit config capacities win; otherwise the dataset's (calibrated
    if unset) are adopted."""
    if cfg.edge_capacity > 0 and cfg.node_capacity > 0:
        dataset.edge_capacity = cfg.edge_capacity
        dataset.node_capacity = cfg.node_capacity
        return cfg
    if dataset.edge_capacity <= 0 or dataset.node_capacity <= 0:
        ec, nc = dataset.calibrate_capacities(cfg.batch_size)
        logger.info("auto-calibrated capacities: edge=%d node=%d", ec, nc)
    if cfg.edge_capacity > 0:
        dataset.edge_capacity = cfg.edge_capacity
    if cfg.node_capacity > 0:
        dataset.node_capacity = cfg.node_capacity
    return cfg.replace(edge_capacity=dataset.edge_capacity,
                       node_capacity=dataset.node_capacity)


def threaded_map(fn, items, threads: int):
    """``map(fn, items)`` in order; with ``threads`` > 1 on a thread pool
    that keeps up to ``2 · threads`` items in flight (the host samples
    ahead while the card computes)."""
    if threads <= 1:
        yield from map(fn, items)
        return
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        pending = collections.deque()
        for item in items:
            pending.append(pool.submit(fn, item))
            if len(pending) >= 2 * threads:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


def features(tf: TensorFrame, device) -> TensorFrame:
    return TensorFrame(feats=tf.feats, col_names=tf.col_names).to(device)


def is_frozen(name: str) -> bool:
    """``--freeze``: the tabular backbone layers (JAX: any path key holding
    ``tab_layer``, ``rmm_tpu/train/trainer.py:141-150``). ``tabgnnfused``
    names its tabular layers ``tab_conv``, so there, as in the reference,
    it freezes nothing."""
    return any("tab_layer" in part for part in name.split("."))


class Trainer:
    def __init__(self, cfg: Config, dataset, device=None):
        self.device = resolve_device(cfg.device if device is None
                                     else device)
        cfg = resolve_capacities(cfg, dataset)
        self.cfg = cfg
        self.dataset = dataset
        self.model = task_models.init_parameters(
            build_task_model(cfg, dataset), cfg.seed).to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        set_generator(self.model, self.generator)
        if cfg.freeze:
            for name, p in self.model.named_parameters():
                if is_frozen(name):
                    p.requires_grad_(False)
        self.optimizer = torch.optim.Adam(
            [p for p in self.model.parameters() if p.requires_grad],
            lr=cfg.lr, eps=cfg.adam_eps)
        self.loss_weights = torch.tensor(cfg.loss_weights,
                                         dtype=torch.float32,
                                         device=self.device)
        self.edge_table = compute_cast(
            features(dataset.edges.tensor_frame, self.device), cfg.precision)
        self.node_table = compute_cast(
            features(dataset.nodes.tensor_frame, self.device), cfg.precision)

    @property
    def node_task(self) -> bool:
        return "node" in self.cfg.task

    def seed_table(self):
        """The table whose rows seed the batches: the nodes for node
        classification, else the edges."""
        return self.dataset.nodes if self.node_task else self.dataset.edges

    def _batches(self, view, mode: str, epoch: int = 0):
        """GraphBatches (host numpy) for a split view, in order. The
        sampler seed of batch i is ``mix_seed(seed, epoch, i)``, so threaded
        sampling gives the same batches as sequential sampling. A node
        batch's seeds are its rows' node ids (``y[:, 1]``); its rows of the
        dataset's ``ignore_label`` leave ``seed_mask``."""
        cfg = self.cfg
        loader = DataLoader(view.tensor_frame, cfg.batch_size,
                            shuffle=(mode == "train"),
                            seed=mix_seed(cfg.seed, epoch))
        ignore = getattr(self.dataset, "ignore_label", None)

        def build(item):
            i, (tf, valid) = item
            y = np.asarray(tf.y)
            seed = mix_seed(cfg.seed, epoch, i)
            if not self.node_task:
                return self.dataset.get_graph_inputs(y, valid, mode,
                                                     rng_seed=seed)
            gb = self.dataset.get_node_inputs(
                y[:, 1].astype(np.int64), y[:, :1], valid, mode,
                rng_seed=seed)
            if ignore is not None:
                gb.seed_mask = gb.seed_mask & (y[:, 0] != ignore)
            return gb

        yield from threaded_map(build, enumerate(loader),
                                int(cfg.sampler_threads))

    def _aux(self, logits: torch.Tensor) -> dict:
        """Device tensors ``pred_cls`` [B] and, for binary heads, ``score``
        [B] = P(class 1)."""
        logits = logits.detach()
        aux = {"pred_cls": logits.argmax(dim=-1)}
        if self.cfg.n_classes == 2:
            aux["score"] = torch.softmax(logits, dim=-1)[:, 1]
        return aux

    def _step(self, batch: GraphBatch):
        """One train step on a device batch (the model in train mode): the
        forward (BatchNorm running stats move here), the weighted loss on
        the seed edges, the backward and the Adam update. Returns the loss
        and ``_aux`` as device tensors; nothing waits for the card."""
        logits = self._logits(batch)
        loss = cross_entropy(logits, batch.y[:, 0], self.loss_weights,
                             batch.seed_mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), self._aux(logits)

    def _logits(self, batch: GraphBatch) -> torch.Tensor:
        """The model's float32 logits [B, n_classes] under the precision of
        the config."""
        return apply(self.model, self.cfg.precision, self.edge_table,
                     self.node_table, batch)

    @torch.inference_mode()
    def _forward_eval(self, batch: GraphBatch) -> dict:
        return self._aux(self._logits(batch))

    def _metrics(self, labels, preds, scores) -> dict:
        avg = "binary" if self.cfg.n_classes == 2 else "weighted"
        out = {"f1": f1_score(labels, preds, avg)}
        if scores is not None:
            out["auc"] = roc_auc(labels, scores)
        return out

    @staticmethod
    def _gather(auxes: list, masks: list) -> tuple:
        """Device aux tensors of a pass → host (preds, scores) on the real
        rows; the pass's one host sync."""
        m = np.concatenate(masks)
        preds = torch.cat([a["pred_cls"] for a in auxes]).cpu().numpy()[m]
        scores = None
        if "score" in auxes[0]:
            scores = torch.cat([a["score"] for a in auxes]).cpu().numpy()[m]
        return preds, scores

    def train_epoch(self, view, epoch: int) -> dict:
        """One pass over the shuffled train view (``mode="train"``
        sampling, per-epoch shuffle and sampler seeds): loss, seconds,
        sampler drop rate, f1 (and AUC) of the train predictions, and on
        the card the median step time on the device's clock."""
        cfg = self.cfg
        t0 = time.time()
        self.model.train()
        losses, auxes, masks, labels, events = [], [], [], [], []
        dropped = kept = 0
        cuda = self.device.type == "cuda"
        for gb in self._batches(view, "train", epoch):
            dropped += gb.num_dropped
            kept += int(gb.edge_mask.sum())
            masks.append(gb.seed_mask)
            labels.append(gb.y[gb.seed_mask, 0].astype(np.int64))
            loss, aux = self._step(gb.to(self.device))
            losses.append(loss)
            auxes.append(aux)
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        self.model.eval()
        out = {"loss": float("nan")}
        if losses:
            out["loss"] = float(torch.stack(losses).sum().cpu()) / len(losses)
            preds, scores = self._gather(auxes, masks)
            out.update(self._metrics(np.concatenate(labels), preds, scores))
        if len(events) > 1:
            out["step_ms"] = statistics.median(
                a.elapsed_time(b) for a, b in zip(events, events[1:]))
        out.update(sec=time.time() - t0,
                   drop_rate=dropped / max(dropped + kept, 1))
        if out["drop_rate"] > cfg.max_drop_rate:
            logger.warning(
                "sampler dropped %.2f%% of sampled edges at edge_capacity=%d"
                " — raise --edge_capacity (the reference keeps every sampled"
                " edge; parity needs ~zero drops)", 100 * out["drop_rate"],
                cfg.edge_capacity)
        return out

    def evaluate(self, view, mode: str) -> dict:
        """f1 (binary for two classes, else support-weighted) and, for
        binary heads, AUC over a view's real rows."""
        self.model.eval()
        auxes, masks, labels = [], [], []
        for gb in self._batches(view, mode):
            masks.append(gb.seed_mask)
            labels.append(gb.y[gb.seed_mask, 0].astype(np.int64))
            auxes.append(self._forward_eval(gb.to(self.device)))
        preds, scores = self._gather(auxes, masks)
        return self._metrics(np.concatenate(labels), preds, scores)

    def predict(self, view, mode: str = "test") -> dict:
        """Batch inference over a view's rows: ``id`` (edge-table row id,
        or node id for node classification), ``pred`` (argmax class) and,
        for binary heads, ``score``, aligned on real rows (for node
        classification those not of the ``ignore_label`` class). ``mode``
        picks the sampling graph ("test" = all edges)."""
        self.model.eval()
        b = self.cfg.batch_size
        rows, masks, auxes = [], [], []
        for gb in self._batches(view, mode):
            seeds = gb.node_gather if self.node_task else gb.edge_gather
            rows.append(seeds[:b].astype(np.int64))
            masks.append(gb.seed_mask)
            auxes.append(self._forward_eval(gb.to(self.device)))
        if not auxes:
            return {"id": np.zeros(0, np.int64), "pred": np.zeros(0, np.int64)}
        preds, scores = self._gather(auxes, masks)
        out = {"id": np.concatenate(rows)[np.concatenate(masks)],
               "pred": preds}
        if scores is not None:
            out["score"] = scores
        return out

    def fit(self, run_logger=None, run_dir: Optional[str] = None,
            start_epoch: int = 0, best_m: Optional[float] = None):
        """Epoch loop with best-val-f1 tracking and a checkpoint per epoch
        (``<run_dir>/<epoch>/``, the previous one pruned; ``-1`` keeps the
        best model under ``--save_model``). Returns (history, best_m)."""
        cfg = self.cfg
        tr, va, te = self.seed_table().split()
        best_m = -1.0 if best_m is None else best_m
        history = []
        for epoch in range(start_epoch, start_epoch + cfg.epochs):
            rec = {"epoch": epoch, **self.train_epoch(tr, epoch)}
            val_m = self.evaluate(va, "val")
            te_m = self.evaluate(te, "test")
            rec.update({"val_f1": val_m["f1"], "test_f1": te_m["f1"]})
            if "auc" in val_m:
                rec.update({"val_auc": val_m["auc"], "test_auc": te_m["auc"]})
            improved = val_m["f1"] > best_m
            if improved:
                best_m = val_m["f1"]
            rec["best"] = improved
            logger.info(" ".join(f"{k}={v:.4f}" if isinstance(v, float)
                                 else f"{k}={v}" for k, v in rec.items()))
            if run_logger is not None:
                run_logger.log(rec, step=epoch)
            if run_dir is not None:
                checkpoint.save_epoch(run_dir, epoch, self.model,
                                      self.optimizer, best_m,
                                      precision=cfg.precision)
                if improved and cfg.save_model:
                    checkpoint.save_epoch(run_dir, -1, self.model, None,
                                          best_m, prune_previous=False,
                                          precision=cfg.precision)
            history.append(rec)
        return history, best_m
