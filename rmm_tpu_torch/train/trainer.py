"""Trainer: capacities, model, device-resident tables, sampled batches,
the train step, the epoch loop, evaluation and batch inference
(``rmm_tpu/train/trainer.py``: ``Trainer`` without its scan and
graph-partition paths) for the task models of ``TASK_MODELS``: ``fttransformer``, ``gin``,
``pna``, ``cpna``, ``cpnatab``, ``tabgnn``, ``tabgnninterleaved`` and
``tabgnnfused``.

The host runs the C++ k-hop sampler and ships small id/mask arrays to the
card as pinned, non-blocking copies; the edge and node feature tables go to
the card once. Steps and forwards are only enqueued per batch: losses and
predictions stay on the device until the end of the epoch (one host sync),
so the host samples the next batch while the card computes the last one.

Node classification (``--task node_classification``: Elliptic, Ethereum
phishing, ogbn-arxiv, MUSAE GitHub, LastFM Asia; every model) seeds each
batch with the view's node ids, which fill node lanes ``[0, B)``, sampled
through the mode's graph (on a dataset with an edge split, such as
Ethereum phishing, the train graph holds the train edges alone); rows of
the dataset's ``ignore_label`` class are left out of the loss, the
metrics and the predictions.

``--sampler device`` samples on the card instead
(``graph/device_sampler.py``): each split's CSR goes to the device once,
each batch ships its seed ids (``SeedBatch``) and its k-hop subgraph is
drawn there from a generator seeded with the batch's sampler seed; the
batch is born on the device, and its drop counts stay there until the end
of the pass. A seed edge whose endpoint a full node buffer evicted leaves
``seed_mask`` (its loss, metrics and prediction). ``auto`` is the host.

Masked-cell modeling of the edge table (``--task mcm_edge_table``): the
seed edges' masked cells (``y = [masked_value, masked_col_idx]``) through
the wrapper's ``MCMHead``, the loss ``SSLoss.mcm_loss`` over the real
seeds; its metrics are the RMSE of the numerical cells and the accuracy of
the categorical ones, and ``fit`` keeps the reference's best rule
(:func:`mcm_improves`). ``predict`` refuses it, as the reference does.

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
from ..graph.device_sampler import (DeviceGraph, batch_generator,
                                    cached_dgraph, sample_edges_device,
                                    sample_nodes_device, use_device_sampler)
from ..nn.dropout import set_generator
from ..nn.encoders import make_stypewise_encoder
from ..utils import checkpoint
from ..utils.batch import GraphBatch, SeedBatch
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.loss import SSLoss, cross_entropy
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


def build_task_model(cfg: Config, dataset) -> torch.nn.Module:
    if cfg.model not in TASK_MODELS:
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet")
    edges = dataset.edges
    common = dict(
        node_encoder=make_stypewise_encoder(dataset.nodes, cfg.n_hidden),
        edge_encoder=make_stypewise_encoder(edges, cfg.n_hidden),
        n_classes=cfg.n_classes, dropout=cfg.dropout, ego=cfg.ego,
        task=cfg.task)
    if cfg.model == "fttransformer":
        return task_models.TT(channels=cfg.n_hidden,
                              num_layers=cfg.n_gnn_layers, **common)
    common.update(avg_log_deg=task_models._deghist_to_avg_log(
        dataset.in_degree_histogram()), reverse_mp=cfg.reverse_mp)
    if "mcm" in cfg.task:
        # the MCM head's sizes (the categorical ones from the blanked table)
        common.update(
            mcm_num_numerical=len(edges.masked_numerical_columns),
            mcm_categorical=edges.masked_categorical_cardinalities())
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
    if unset) are adopted; ``frontier_capacity > 0`` overrides the
    calibrated frontier buffer (``rmm_tpu/train/trainer.py:89-106``)."""
    if cfg.edge_capacity > 0 and cfg.node_capacity > 0:
        dataset.edge_capacity = cfg.edge_capacity
        dataset.node_capacity = cfg.node_capacity
        if cfg.frontier_capacity > 0:
            dataset.frontier_capacity = cfg.frontier_capacity
        return cfg
    if dataset.edge_capacity <= 0 or dataset.node_capacity <= 0:
        ec, nc = dataset.calibrate_capacities(cfg.batch_size)
        logger.info("auto-calibrated capacities: edge=%d node=%d "
                    "frontier=%d", ec, nc, dataset.frontier_capacity)
    if cfg.edge_capacity > 0:
        dataset.edge_capacity = cfg.edge_capacity
    if cfg.node_capacity > 0:
        dataset.node_capacity = cfg.node_capacity
    if cfg.frontier_capacity > 0:
        dataset.frontier_capacity = cfg.frontier_capacity
    return cfg.replace(edge_capacity=dataset.edge_capacity,
                       node_capacity=dataset.node_capacity,
                       frontier_capacity=dataset.frontier_capacity)


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


#: what an MCM step or forward gives beside its loss, in this order
MCM_SUMS = ("loss_c", "t_c", "acc", "loss_n", "t_n")


def mcm_improves(val_m: list, best_m: list) -> bool:
    """The reference's best rule for ``[rmse, accuracy]``
    (``rmm_tpu/train/trainer.py:685-687``), kept as it is: the RMSE must
    fall and the accuracy rise, unless the best accuracy is 1."""
    return (val_m[0] < best_m[0]) and (val_m[1] > best_m[1]
                                       or best_m[1] == 1)


def mcm_sums(cat: tuple, num: tuple) -> torch.Tensor:
    """``SSLoss.mcm_loss``'s ``(cat_loss, t_c, acc)`` and ``(num_loss,
    t_n)`` as one float tensor in ``MCM_SUMS`` order."""
    cl, tc, acc = cat
    nl, tn = num
    return torch.stack([cl, tc.to(cl), acc.to(cl), nl, tn.to(cl)])


def mcm_metrics(sums: np.ndarray) -> list:
    """Summed ``MCM_SUMS`` → ``[rmse, accuracy]``."""
    tot = dict(zip(MCM_SUMS, np.asarray(sums, np.float64)))
    return [float(np.sqrt(tot["loss_n"] / max(tot["t_n"], 1))),
            float(tot["acc"] / max(tot["t_c"], 1))]


def features(tf: TensorFrame, device) -> TensorFrame:
    return TensorFrame(feats=tf.feats, col_names=tf.col_names).to(device)


def to_host(parts: list) -> np.ndarray:
    """Numpy arrays, or device tensors (concatenated on the device and
    copied in one go: a pass's one host sync), as one numpy array."""
    if parts and torch.is_tensor(parts[0]):
        return torch.cat(parts).cpu().numpy()
    return np.concatenate(parts)


def seed_batches(cfg: Config, view, mode: str, epoch: int,
                 node_task: bool = False, ignore_label=None):
    """The ``SeedBatch`` of each batch of a split view, in the host
    batches' order and with their sampler seeds (``mix_seed(seed, epoch,
    i)``; the JAX device path's ``_seed_batches``). Edge batches: the packed
    target's last 3 slots seed, y keeps the rest. Node batches: the node
    ids (``y[:, 1]``) in column 0, y the label; a row of ``ignore_label``
    seeds the expansion but leaves ``seed_mask``."""
    loader = DataLoader(view.tensor_frame, cfg.batch_size,
                        shuffle=(mode == "train"),
                        seed=mix_seed(cfg.seed, epoch))
    for i, (tf, valid) in enumerate(loader):
        by = np.asarray(tf.y)
        mask = np.arange(len(by)) < valid
        seed = mix_seed(cfg.seed, epoch, i) & 0xFFFFFFFF
        if node_task:
            ids = by[:, 1].astype(np.int32)
            lmask = mask.copy()
            if ignore_label is not None:
                lmask &= by[:, 0] != ignore_label
            zeros = np.zeros_like(ids)
            yield SeedBatch(seeds=np.stack([ids, zeros, zeros], axis=1),
                            y=by[:, :1].astype(np.float32), seed_mask=lmask,
                            sampler_seed=seed, sample_mask=mask)
        else:
            yield SeedBatch(seeds=by[:, -3:].astype(np.int32),
                            y=by[:, :-3].astype(np.float32), seed_mask=mask,
                            sampler_seed=seed)


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
        self.ssloss = SSLoss(len(getattr(dataset.edges,
                                         "masked_numerical_columns", ())))
        self.edge_table = compute_cast(
            features(dataset.edges.tensor_frame, self.device), cfg.precision)
        self.node_table = compute_cast(
            features(dataset.nodes.tensor_frame, self.device), cfg.precision)
        self.device_sampling = use_device_sampler(cfg)
        self._dgraphs: dict = {}

    @property
    def node_task(self) -> bool:
        return "node" in self.cfg.task

    @property
    def mcm_task(self) -> bool:
        return "mcm" in self.cfg.task

    def seed_table(self):
        """The table whose rows seed the batches: the nodes for node
        classification, else the edges."""
        return self.dataset.nodes if self.node_task else self.dataset.edges

    def _batches(self, view, mode: str, epoch: int = 0):
        """GraphBatches (host numpy) for a split view, in order. The
        sampler seed of batch i is ``mix_seed(seed, epoch, i)``, so threaded
        sampling gives the same batches as sequential sampling. A masked
        cell batch is an edge batch whose y is the MASK target. A node
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

    def dgraph(self, mode: str) -> DeviceGraph:
        """The split's CSR on the trainer's device, uploaded once."""
        return cached_dgraph(self.dataset.graph, self._dgraphs, mode,
                             self.device)

    def _materialize_dev(self, sb: SeedBatch, dgraph: DeviceGraph):
        """The k-hop subgraph of a device ``SeedBatch``, sampled on the
        device: (GraphBatch of device tensors, dropped edges, kept edges),
        the counts 0-d device tensors. An edge batch's seed whose endpoint a
        full node buffer evicted (its lane out of ``edge_mask``) leaves
        ``seed_mask`` (``rmm_tpu/train/trainer.py:238-242``)."""
        cfg = self.cfg
        gen = batch_generator(sb.sampler_seed, self.device)
        args = (gen, cfg.num_neighs, cfg.edge_capacity, cfg.node_capacity,
                cfg.frontier_capacity or None)
        seed_mask = sb.seed_mask
        if self.node_task:
            smask = sb.seed_mask if sb.sample_mask is None else sb.sample_mask
            out = sample_nodes_device(dgraph, sb.seeds[:, 0], smask, *args)
        else:
            out = sample_edges_device(dgraph, sb.seeds, sb.seed_mask, *args)
            seed_mask = seed_mask & out["edge_mask"][:sb.num_seeds]
        gb = GraphBatch(
            edge_gather=out["edge_gather"], edge_mask=out["edge_mask"],
            edge_index=out["edge_index"], node_gather=out["node_gather"],
            node_mask=out["node_mask"], seed_mask=seed_mask, y=sb.y)
        return gb, out["num_dropped"], out["edge_mask"].sum()

    def _stream(self, view, mode: str, epoch: int = 0):
        """A pass's batches on the device, each as (device GraphBatch,
        seed_mask, y[:, 0], the seed rows' ids, dropped edges, kept edges).
        Host sampling: the mask and counts on the host. Device sampling:
        the mask and counts stay on the device, y and the ids (edge rows, or
        node ids) come from the seed batch."""
        if not self.device_sampling:
            b = self.cfg.batch_size
            for gb in self._batches(view, mode, epoch):
                seeds = gb.node_gather if self.node_task else gb.edge_gather
                yield (gb.to(self.device), gb.seed_mask, gb.y[:, 0],
                       seeds[:b].astype(np.int64), gb.num_dropped,
                       int(gb.edge_mask.sum()))
            return
        dgraph = self.dgraph(mode)
        for sb in seed_batches(self.cfg, view, mode, epoch, self.node_task,
                               getattr(self.dataset, "ignore_label", None)):
            gb, dropped, kept = self._materialize_dev(sb.to(self.device),
                                                      dgraph)
            ids = sb.seeds[:, 0 if self.node_task else 2].astype(np.int64)
            yield gb, gb.seed_mask, sb.y[:, 0], ids, dropped, kept

    def _mcm_loss(self, out, batch: GraphBatch):
        """The MCM loss of the model's ``(num_out, cat_out)`` on the real
        seeds, and its ``MCM_SUMS`` stacked as one device tensor."""
        num_out, cat_out = out
        total, cat, num = self.ssloss.mcm_loss(
            cat_out, num_out, batch.y, valid_mask=batch.seed_mask)
        return total, mcm_sums(cat, num).detach()

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
        the seed edges (the MCM loss under ``mcm_edge_table``), the backward
        and the Adam update. Returns the loss and ``_aux`` (under MCM its
        ``sums``) as device tensors; nothing waits for the card."""
        logits = self._logits(batch)
        if self.mcm_task:
            loss, sums = self._mcm_loss(logits, batch)
            aux = {"sums": sums}
        else:
            loss = cross_entropy(logits, batch.y[:, 0], self.loss_weights,
                                 batch.seed_mask)
            aux = self._aux(logits)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), aux

    def _logits(self, batch: GraphBatch):
        """The model's float32 logits [B, n_classes] (under MCM its
        ``(num_out, cat_out)``) under the precision of the config."""
        return apply(self.model, self.cfg.precision, self.edge_table,
                     self.node_table, batch)

    @torch.inference_mode()
    def _forward_eval(self, batch: GraphBatch) -> dict:
        if self.mcm_task:
            return {"sums": self._mcm_loss(self._logits(batch), batch)[1]}
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
        m = to_host(masks)
        preds = torch.cat([a["pred_cls"] for a in auxes]).cpu().numpy()[m]
        scores = None
        if "score" in auxes[0]:
            scores = torch.cat([a["score"] for a in auxes]).cpu().numpy()[m]
        return preds, scores

    def train_epoch(self, view, epoch: int) -> dict:
        """One pass over the shuffled train view (``mode="train"``
        sampling, per-epoch shuffle and sampler seeds): loss, seconds,
        sampler drop rate, f1 (and AUC) of the train predictions (under MCM
        the train RMSE and accuracy), and on the card the median step time
        on the device's clock."""
        cfg = self.cfg
        t0 = time.time()
        self.model.train()
        losses, auxes, masks, labels, events = [], [], [], [], []
        dropped = kept = 0
        cuda = self.device.type == "cuda"
        for gb, mask, y0, _, b_dropped, b_kept in self._stream(
                view, "train", epoch):
            dropped, kept = dropped + b_dropped, kept + b_kept
            masks.append(mask)
            labels.append(y0)
            loss, aux = self._step(gb)
            losses.append(loss)
            auxes.append(aux)
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        self.model.eval()
        out = {"loss": float("nan")}
        if losses:
            out["loss"] = float(torch.stack(losses).sum().cpu()) / len(losses)
            if self.mcm_task:
                out["train_rmse"], out["train_acc"] = self._mcm_pass(auxes)
            else:
                preds, scores = self._gather(auxes, masks)
                out.update(self._metrics(self._labels(labels, masks),
                                         preds, scores))
        if len(events) > 1:
            out["step_ms"] = statistics.median(
                a.elapsed_time(b) for a, b in zip(events, events[1:]))
        dropped, kept = int(dropped), int(kept)
        out.update(sec=time.time() - t0,
                   drop_rate=dropped / max(dropped + kept, 1))
        if out["drop_rate"] > cfg.max_drop_rate:
            logger.warning(
                "sampler dropped %.2f%% of sampled edges at edge_capacity=%d"
                " — raise --edge_capacity (the reference keeps every sampled"
                " edge; parity needs ~zero drops)", 100 * out["drop_rate"],
                cfg.edge_capacity)
        return out

    @staticmethod
    def _labels(labels: list, masks: list) -> np.ndarray:
        """The real rows' labels of a pass (int64)."""
        return np.concatenate(labels)[to_host(masks)].astype(np.int64)

    @staticmethod
    def _mcm_pass(auxes: list) -> list:
        """A pass's MCM sums on the device → ``[rmse, accuracy]``; the
        pass's one host sync."""
        return mcm_metrics(torch.stack([a["sums"] for a in auxes])
                           .sum(0).cpu().numpy())

    def evaluate(self, view, mode: str):
        """f1 (binary for two classes, else support-weighted) and, for
        binary heads, AUC over a view's real rows; under MCM ``[rmse,
        accuracy]``."""
        self.model.eval()
        auxes, masks, labels = [], [], []
        for gb, mask, y0, *_ in self._stream(view, mode):
            masks.append(mask)
            labels.append(y0)
            auxes.append(self._forward_eval(gb))
        if self.mcm_task:
            return self._mcm_pass(auxes)
        preds, scores = self._gather(auxes, masks)
        return self._metrics(self._labels(labels, masks), preds, scores)

    def predict(self, view, mode: str = "test") -> dict:
        """Batch inference over a view's rows: ``id`` (edge-table row id,
        or node id for node classification), ``pred`` (argmax class) and,
        for binary heads, ``score``, aligned on real rows (for node
        classification those not of the ``ignore_label`` class). ``mode``
        picks the sampling graph ("test" = all edges). MCM, a pretraining
        objective, raises."""
        if self.mcm_task:
            raise ValueError("predict() serves classification tasks; MCM "
                             "is a pretraining objective")
        self.model.eval()
        rows, masks, auxes = [], [], []
        for gb, mask, _, ids, *_ in self._stream(view, mode):
            rows.append(ids)
            masks.append(mask)
            auxes.append(self._forward_eval(gb))
        if not auxes:
            return {"id": np.zeros(0, np.int64), "pred": np.zeros(0, np.int64)}
        preds, scores = self._gather(auxes, masks)
        out = {"id": np.concatenate(rows)[to_host(masks)], "pred": preds}
        if scores is not None:
            out["score"] = scores
        return out

    def fit(self, run_logger=None, run_dir: Optional[str] = None,
            start_epoch: int = 0, best_m=None):
        """Epoch loop with best-val-f1 tracking (under MCM ``[rmse,
        accuracy]`` by :func:`mcm_improves`) and a checkpoint per epoch
        (``<run_dir>/<epoch>/``, the previous one pruned; ``-1`` keeps the
        best model under ``--save_model``). Returns (history, best_m)."""
        cfg = self.cfg
        tr, va, te = self.seed_table().split()
        if best_m is None:
            best_m = [1000.0, -1.0] if self.mcm_task else -1.0
        history = []
        for epoch in range(start_epoch, start_epoch + cfg.epochs):
            rec = {"epoch": epoch, **self.train_epoch(tr, epoch)}
            val_m = self.evaluate(va, "val")
            te_m = self.evaluate(te, "test")
            if self.mcm_task:
                rec.update({"val_rmse": val_m[0], "val_acc": val_m[1],
                            "test_rmse": te_m[0], "test_acc": te_m[1]})
                improved = mcm_improves(val_m, best_m)
                if improved:
                    best_m = val_m
            else:
                rec.update({"val_f1": val_m["f1"], "test_f1": te_m["f1"]})
                if "auc" in val_m:
                    rec.update({"val_auc": val_m["auc"],
                                "test_auc": te_m["auc"]})
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
