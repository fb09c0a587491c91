"""Self-supervised pretraining of ``TABGNNFused``: masked cell modeling
(MCM), link prediction (LP) or both (``rmm_tpu/train/pretrain.py`` without
its device-sampler, scan, prefetch and MoCo paths).

:class:`PretrainModel` is the edge encoder, the fused backbone and the two
heads as one module; its forward gives the losses of a mode on a device
batch. Node features are ones (and the ego flag under ``--ego``). The
target rows are ``[seed edges | each seed edge repeated num_neg times]``,
the negatives' rows reusing their positive's tokens. The LP view runs
first, message passing over the neighbour edges only; then the MCM view
over all edges. Both views move the BatchNorm running statistics, in that
order.

:class:`PretrainTrainer` samples on the host (the C++ k-hop sampler and
negative sampler, ``--sampler_threads`` as the supervised trainer), ships
id/mask arrays to the card and keeps the losses and predictions there until
the end of a pass: one host sync an epoch. The optimizer is AdamW whose
weight decay reaches only the parameters of two or more dimensions (the
JAX mask ``ndim >= 2``; the port's parameters have the JAX leaves' shapes,
transposed where they are kernels). A parameter that a mode does not use
keeps a zero gradient, so AdamW decays it as optax does.

``--precision bf16`` casts as ``rmm_tpu/train/pretrain.py`` does: the
parameters at the top of each step, the edge table (once, when it goes to
the device) and the node features to bf16; the heads' predictions go back
to float32 before the losses and metrics; the parameters, AdamW's state
and the BatchNorm statistics stay float32.
"""
from __future__ import annotations

import logging
import os
import statistics
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..frame.loader import DataLoader
from ..nn.decoders import LinkPredHead, MCMHead
from ..nn.dropout import set_generator
from ..nn.encoders import make_stypewise_encoder
from ..nn.gnn.conv import gather
from ..nn.models.fused import TABGNNFused
from ..utils import checkpoint
from ..utils.batch import GraphBatch
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.loss import SSLoss, lp_loss
from ..utils.metric import MCMAccumulator, mrr
from ..utils.precision import apply, compute_cast, out_f32
from ..utils.seeding import mix_seed
from .task_models import _deghist_to_avg_log, gather_rows, init_parameters
from .trainer import features, resolve_capacities, threaded_map

logger = logging.getLogger(__name__)

MODES = ("mcm", "lp", "mcm-lp")
#: what a train step gives beside its loss: the LP loss and the MCM sums
STEP_SUMS = ("lp", "loss_c", "t_c", "acc", "loss_n", "t_n")
HITS_AT = (1, 2, 5, 10)


class PretrainModel(nn.Module):
    """``edge_encoder`` + ``model`` (TABGNNFused) + ``mcm_head`` +
    ``lp_head``: the JAX pretrainer's components, by the names of its
    checkpoint."""

    def __init__(self, cfg: Config, dataset):
        super().__init__()
        edges = dataset.edges
        c = cfg.n_hidden
        self.num_neg = cfg.num_neg_samples
        self.ego = cfg.ego
        self.precision = cfg.precision
        self.edge_encoder = make_stypewise_encoder(edges, c)
        self.model = TABGNNFused(
            c, cfg.n_gnn_layers, self.edge_encoder.num_cols,
            node_dim=2 if cfg.ego else 1, nhidden=c,
            avg_log_deg=_deghist_to_avg_log(dataset.in_degree_histogram()),
            reverse_mp=cfg.reverse_mp, dropout=cfg.dropout)
        n_num = len(edges.masked_numerical_columns)
        self.mcm_head = MCMHead(c, n_num,
                                edges.masked_categorical_cardinalities(), w=3)
        self.lp_head = LinkPredHead(1, c, c, cfg.dropout)
        self.ssloss = SSLoss(n_num)

    def node_feats(self, batch: GraphBatch) -> torch.Tensor:
        """Ones ``[N_cap, 1]``; under ``ego`` a second column flags the
        endpoints of the real seed edges (a scatter-max, so a padded seed
        lane never clears a flag)."""
        n = batch.node_gather.shape[0]
        dev = batch.node_gather.device
        ones = torch.ones(n, 1, device=dev)
        if not self.ego:
            return ones
        b = batch.num_seeds
        ends = batch.edge_index[:, :b]
        vals = batch.seed_mask.float()[None, :].expand(ends.shape)
        ego = torch.zeros(n, device=dev).scatter_reduce(
            0, ends.reshape(-1), vals.reshape(-1), "amax")
        return torch.cat([ones, ego[:, None]], dim=1)

    def encode(self, edge_table, ids: torch.Tensor) -> torch.Tensor:
        return self.edge_encoder(gather_rows(edge_table, ids))

    def target_gather(self, batch: GraphBatch) -> torch.Tensor:
        """Edge-table rows of the targets: the seeds, then each seed
        ``num_neg`` times."""
        pos = batch.edge_gather[:batch.num_seeds]
        return torch.cat([pos, pos.repeat_interleave(self.num_neg)])

    def apply_fused(self, batch: GraphBatch, edge_table, lp: bool,
                    use_neigh_only: bool):
        """One TABGNNFused pass over the batch's subgraph → (x_gnn, the
        targets' embeddings, the targets' edge index)."""
        b = batch.num_seeds
        target_tok = self.encode(edge_table, self.target_gather(batch))
        target_ei = torch.cat([batch.edge_index[:, :b], batch.neg_edge_index],
                              dim=1)
        if use_neigh_only:
            ei, emask = batch.edge_index[:, b:], batch.edge_mask[b:]
            tok = self.encode(edge_table, batch.edge_gather[b:])
        else:
            ei, emask = batch.edge_index, batch.edge_mask
            tok = self.encode(edge_table, batch.edge_gather)
        x_gnn, _, target = self.model(
            compute_cast(self.node_feats(batch), self.precision), ei, tok,
            target_ei, target_tok, lp, emask, batch.node_mask)
        return x_gnn, target, target_ei

    def forward(self, batch: GraphBatch, edge_table, mode: str):
        """→ ({"lp"/"mcm": loss}, aux): device tensors, the LP view first."""
        b = batch.num_seeds
        losses, aux = {}, {}
        if "lp" in mode:
            x_gnn, target, tei = self.apply_fused(batch, edge_table, lp=True,
                                                  use_neigh_only=True)
            pos, neg = out_f32(self.lp_head(x_gnn, tei[:, :b], target[:b],
                                            tei[:, b:], target[b:]))
            losses["lp"] = lp_loss(
                pos, neg, batch.seed_mask,
                batch.seed_mask.repeat_interleave(self.num_neg))
            aux.update(pos_pred=pos, neg_pred=neg)
        if "mcm" in mode:
            x_gnn, target, _ = self.apply_fused(batch, edge_table, lp=False,
                                                use_neigh_only=False)
            pos_ei = batch.edge_index[:, :b]
            num_out, cat_out = out_f32(self.mcm_head(torch.cat(
                [gather(x_gnn, pos_ei[0]), gather(x_gnn, pos_ei[1]),
                 target[:b]], dim=-1)))
            total, (cl, tc, acc), (nl, tn) = self.ssloss.mcm_loss(
                cat_out, num_out, batch.y, batch.seed_mask)
            losses["mcm"] = total
            aux.update(loss_c=cl, t_c=tc, acc=acc, loss_n=nl, t_n=tn,
                       num_out=num_out, cat_out=cat_out)
        return losses, aux


def no_best() -> dict:
    """The best metrics before any epoch: each improves on its first
    value."""
    return {"accuracy": -1.0, "rmse": float("inf"), "mrr": -1.0}


def decays(p: torch.Tensor) -> bool:
    """AdamW's weight decay reaches parameters of two or more dimensions."""
    return p.dim() >= 2


class PretrainTrainer:
    def __init__(self, cfg: Config, dataset, mode: str = "mcm-lp"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if cfg.moo != "sum":
            raise NotImplementedError(f"--moo {cfg.moo} is not ported yet")
        self.device = resolve_device(cfg.device)
        cfg = resolve_capacities(cfg, dataset)
        self.cfg = cfg
        self.mode = mode
        self.dataset = dataset
        self.model = init_parameters(PretrainModel(cfg, dataset),
                                     cfg.seed).to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(cfg.seed)
        set_generator(self.model, self.generator)
        params = list(self.model.parameters())
        self.optimizer = torch.optim.AdamW(
            [{"params": [p for p in params if decays(p)],
              "weight_decay": cfg.weight_decay},
             {"params": [p for p in params if not decays(p)],
              "weight_decay": 0.0}],
            lr=cfg.lr, eps=cfg.adam_eps)
        for p in params:
            p.grad = torch.zeros_like(p)
        self.edge_table = compute_cast(
            features(dataset.edges.tensor_frame, self.device), cfg.precision)
        self.sample_s: list[float] = []   # host seconds of each batch built

    def _batches(self, view, mode: str, epoch: int = 0):
        """LP GraphBatches (host numpy) for a split view, in order: the
        sampler seed of batch i is ``mix_seed(seed, epoch, i, 1)`` and its
        negatives' ``mix_seed(seed, epoch, i, 2)``."""
        cfg = self.cfg
        loader = DataLoader(view.tensor_frame, cfg.batch_size,
                            shuffle=(mode == "train"),
                            seed=mix_seed(cfg.seed, epoch))

        def build(item):
            i, (tf, valid) = item
            t0 = time.perf_counter()
            gb = self.dataset.get_lp_inputs(
                np.asarray(tf.y), valid, mode,
                num_neg_samples=cfg.num_neg_samples,
                rng_seed=mix_seed(cfg.seed, epoch, i, 1),
                neg_seed=mix_seed(cfg.seed, epoch, i, 2))
            self.sample_s.append(time.perf_counter() - t0)
            return gb

        yield from threaded_map(build, enumerate(loader),
                                int(cfg.sampler_threads))

    def _step(self, batch: GraphBatch):
        """One train step on a device batch (the model in train mode): both
        views' forwards, the summed loss, the backward and the AdamW
        update. Returns the loss and its ``STEP_SUMS`` (those of the mode)
        as device tensors."""
        losses, aux = self._forward(batch)
        loss = sum(losses.values())
        self.optimizer.zero_grad(set_to_none=False)
        loss.backward()
        self.optimizer.step()
        sums = {**losses, **aux}
        return loss.detach(), {k: sums[k].detach() for k in STEP_SUMS
                               if k in sums}

    def _forward(self, batch: GraphBatch):
        """The model's losses and aux on a device batch under the
        precision of the config (float32 outputs)."""
        return apply(self.model, self.cfg.precision, batch, self.edge_table,
                     self.mode)

    def train_epoch(self, view, epoch: int) -> dict:
        """One pass over the shuffled train view: mean loss, seconds,
        sampler drop rate, the MCM train losses, the host's sampling ms a
        batch and, on the card, the median step on the device's clock."""
        t0 = time.time()
        self.model.train()
        self.sample_s = []
        rows, events = [], []
        dropped = kept = 0
        cuda = self.device.type == "cuda"
        for gb in self._batches(view, "train", epoch):
            dropped += gb.num_dropped
            kept += int(gb.edge_mask.sum())
            loss, aux = self._step(gb.to(self.device))
            rows.append(torch.stack([loss] + [aux[k].float() for k in aux]))
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        self.model.eval()
        out = {"loss": float("nan")}
        if rows:
            sums = torch.stack(rows).cpu().numpy()       # the one host sync
            out["loss"] = float(sums[:, 0].mean())
            if "mcm" in self.mode:
                tot = dict(zip(aux, sums[:, 1:].sum(axis=0)))
                out["train_loss_c"] = float(tot["loss_c"] / max(tot["t_c"], 1))
                out["train_loss_n"] = float(tot["loss_n"] / max(tot["t_n"], 1))
        if len(events) > 1:
            out["step_ms"] = statistics.median(
                a.elapsed_time(b) for a, b in zip(events, events[1:]))
        out.update(sec=time.time() - t0,
                   drop_rate=dropped / max(dropped + kept, 1),
                   sample_ms=1e3 * float(np.mean(self.sample_s))
                   if self.sample_s else float("nan"))
        if out["drop_rate"] > self.cfg.max_drop_rate:
            logger.warning(
                "sampler dropped %.2f%% of sampled edges at edge_capacity=%d"
                " — raise --edge_capacity", 100 * out["drop_rate"],
                self.cfg.edge_capacity)
        return out

    def evaluate(self, view, mode: str) -> dict:
        """MRR and Hits@1/2/5/10 (LP; each a mean over batches) and MCM
        accuracy and RMSE over a view's real rows."""
        cfg = self.cfg
        self.model.eval()
        outs = []
        with torch.inference_mode():
            for gb in self._batches(view, mode):
                _, aux = self._forward(gb.to(self.device))
                outs.append((int(gb.seed_mask.sum()), gb.y, {
                    k: aux[k] for k in ("pos_pred", "neg_pred", "num_out",
                                        "cat_out") if k in aux}))
        outs = [(valid, y, _to_numpy(aux)) for valid, y, aux in outs]
        out = {}
        if "lp" in self.mode:
            per = [mrr(aux["pos_pred"][:valid],
                       aux["neg_pred"].reshape(-1, cfg.num_neg_samples)[
                           :valid], HITS_AT, cfg.num_neg_samples)
                   for valid, _, aux in outs]
            out["mrr"] = float(np.mean([m for m, _ in per]))
            for k in HITS_AT:
                out[f"hits@{k}"] = float(np.mean([h[f"hits@{k}"]
                                                  for _, h in per]))
        if "mcm" in self.mode:
            acc = MCMAccumulator(self.model.ssloss.num_numerical)
            for valid, y, aux in outs:
                acc.update(aux["cat_out"], aux["num_out"], y, valid)
            out.update(accuracy=acc.accuracy, rmse=acc.rmse)
        return out

    # -- checkpoint / resume ----------------------------------------------
    def save(self, run_dir: str, epoch, best: dict,
             with_opt: bool = True) -> str:
        """``<run_dir>/<epoch>/``: the model (encoder, backbone, heads and
        BatchNorm statistics), the AdamW state and ``best_m.json``; a
        ``best_*`` tag holds the weights alone."""
        return checkpoint.save_epoch(
            run_dir, epoch, self.model,
            self.optimizer if with_opt else None, best,
            prune_previous=isinstance(epoch, int),
            precision=self.cfg.precision)

    def restore(self, ck_dir: str, with_opt: bool = True) -> dict:
        """Load a checkpoint of either package (the port's optimizer state
        too, when there; the JAX package's ``opt_state`` is not read, so
        AdamW starts afresh) and return its best metrics."""
        checkpoint.load_strict(ck_dir, self.model)
        if not checkpoint.is_port_checkpoint(ck_dir):
            logger.warning("%s is a JAX checkpoint: its optimizer state is "
                           "not read, AdamW starts afresh", ck_dir)
        opt = os.path.join(ck_dir, "optimizer.pt")
        if with_opt and os.path.exists(opt):
            self.optimizer.load_state_dict(torch.load(
                opt, map_location=self.device, weights_only=True))
        best = no_best()
        if os.path.exists(os.path.join(ck_dir, "best_m.json")):
            best.update(checkpoint.load_best_m(ck_dir))
        return best

    def fit(self, run_logger=None, run_dir: Optional[str] = None,
            start_epoch: int = 0, best: Optional[dict] = None):
        """Epoch loop tracking the best accuracy, RMSE and MRR; with a
        ``run_dir``, a checkpoint per epoch and a ``best_acc``/``best_rmse``
        /``best_mrr`` snapshot for each improved metric."""
        tr, va, _ = self.dataset.edges.split()
        if best is None:
            best = no_best()
        history = []
        for epoch in range(start_epoch, start_epoch + self.cfg.epochs):
            tm = self.train_epoch(tr, epoch)
            vm = self.evaluate(va, "val")
            rec = {"epoch": epoch, **tm,
                   **{f"val_{k}": v for k, v in vm.items()}}
            improved = [k for k in ("accuracy", "mrr")
                        if k in vm and vm[k] > best[k]]
            if "rmse" in vm and vm["rmse"] < best["rmse"]:
                improved.append("rmse")
            for k in improved:
                best[k] = vm[k]
            logger.info(" ".join(f"{k}={v:.4f}" if isinstance(v, float)
                                 else f"{k}={v}" for k, v in rec.items()))
            if run_logger is not None:
                run_logger.log(rec, step=epoch)
            if run_dir is not None:
                self.save(run_dir, epoch, best)
                for k in improved:
                    tag = "acc" if k == "accuracy" else k
                    self.save(run_dir, f"best_{tag}", best, with_opt=False)
            history.append(rec)
        return history, best


def _to_numpy(aux: dict) -> dict:
    return {k: [t.cpu().numpy() for t in v] if isinstance(v, list)
            else v.cpu().numpy() for k, v in aux.items()}
