"""Serving trainer: capacities, model, device-resident tables, host-sampled
batches and batch inference (``rmm_tpu/train/trainer.py``: ``Trainer``
``__init__``, ``_batches``, ``_forward_eval``, ``predict``).

The host runs the C++ k-hop sampler and ships small id/mask arrays to the
card as pinned, non-blocking copies; the edge and node feature tables go to
the card once. The forward is only enqueued per batch: results stay on the
device until the end of ``predict``, so the host samples the next batch
while the card computes the last one. Training (loss, optimizer, ``fit``)
is not part of this slice.
"""
from __future__ import annotations

import collections
import concurrent.futures
import logging

import numpy as np
import torch

from ..frame.loader import DataLoader
from ..frame.tensor_frame import TensorFrame
from ..nn.encoders import make_stypewise_encoder
from ..utils.batch import GraphBatch
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.seeding import mix_seed
from . import task_models

logger = logging.getLogger(__name__)


def build_task_model(cfg: Config, dataset) -> task_models.TABGNNS:
    if cfg.model != "tabgnn":
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet")
    return task_models.TABGNNS(
        node_encoder=make_stypewise_encoder(dataset.nodes, cfg.n_hidden),
        edge_encoder=make_stypewise_encoder(dataset.edges, cfg.n_hidden),
        channels=cfg.n_hidden, n_gnn_layers=cfg.n_gnn_layers,
        n_classes=cfg.n_classes, dropout=cfg.dropout,
        avg_log_deg=task_models._deghist_to_avg_log(
            dataset.in_degree_histogram()),
        reverse_mp=cfg.reverse_mp, ego=cfg.ego, task=cfg.task)


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


def _features(tf: TensorFrame, device) -> TensorFrame:
    return TensorFrame(feats=tf.feats, col_names=tf.col_names).to(device)


class Trainer:
    def __init__(self, cfg: Config, dataset, device=None):
        self.device = resolve_device(cfg.device if device is None
                                     else device)
        if cfg.precision != "f32":
            raise NotImplementedError("this slice serves float32 only")
        cfg = resolve_capacities(cfg, dataset)
        self.cfg = cfg
        self.dataset = dataset
        self.model = task_models.init_parameters(
            build_task_model(cfg, dataset), cfg.seed).to(self.device).eval()
        self.edge_table = _features(dataset.edges.tensor_frame, self.device)
        self.node_table = _features(dataset.nodes.tensor_frame, self.device)

    def _batches(self, view, mode: str, epoch: int = 0):
        """GraphBatches (host numpy) for a split view, in order. The
        sampler seed of batch i is ``mix_seed(seed, epoch, i)``, so threaded
        sampling gives the same batches as sequential sampling."""
        cfg = self.cfg
        loader = DataLoader(view.tensor_frame, cfg.batch_size,
                            shuffle=(mode == "train"),
                            seed=mix_seed(cfg.seed, epoch))

        def build(item):
            i, (tf, valid) = item
            return self.dataset.get_graph_inputs(
                np.asarray(tf.y), valid, mode,
                rng_seed=mix_seed(cfg.seed, epoch, i))

        items = enumerate(loader)
        threads = int(cfg.sampler_threads)
        if threads <= 1:
            yield from map(build, items)
            return
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            pending = collections.deque()
            for item in items:
                pending.append(pool.submit(build, item))
                if len(pending) >= 2 * threads:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    @torch.inference_mode()
    def _forward_eval(self, batch: GraphBatch) -> dict:
        """Device batch → device tensors ``pred_cls`` [B] and, for binary
        heads, ``score`` [B] = P(class 1)."""
        logits = self.model(self.edge_table, self.node_table, batch)
        aux = {"pred_cls": logits.argmax(dim=-1)}
        if self.cfg.n_classes == 2:
            aux["score"] = torch.softmax(logits, dim=-1)[:, 1]
        return aux

    def predict(self, view, mode: str = "test") -> dict:
        """Batch inference over a view's rows: ``id`` (edge-table row id),
        ``pred`` (argmax class) and, for binary heads, ``score``, aligned
        on real rows. ``mode`` picks the sampling graph ("test" = all
        edges)."""
        b = self.cfg.batch_size
        rows, masks, auxes = [], [], []
        for gb in self._batches(view, mode):
            rows.append(gb.edge_gather[:b].astype(np.int64))
            masks.append(gb.seed_mask)
            auxes.append(self._forward_eval(gb.to(self.device)))
        if not auxes:
            return {"id": np.zeros(0, np.int64), "pred": np.zeros(0, np.int64)}
        m = np.concatenate(masks)
        out = {"id": np.concatenate(rows)[m]}
        out["pred"] = torch.cat([a["pred_cls"] for a in auxes]).cpu().numpy()[m]
        if "score" in auxes[0]:
            out["score"] = torch.cat([a["score"] for a in auxes]).cpu().numpy()[m]
        return out
