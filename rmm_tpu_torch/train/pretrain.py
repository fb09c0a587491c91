"""Self-supervised pretraining of ``TABGNNFused``: masked cell modeling
(MCM), link prediction (LP) or both (``rmm_tpu/train/pretrain.py`` without
its scan and prefetch paths).

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
the end of a pass: one host sync an epoch. Under ``--sampler device`` each
batch's k-hop subgraph and negatives are drawn on the card
(``graph/device_sampler.py``) from two generators seeded from the batch's
sampler seed, one for the hops and one for the negatives, the negatives over
the sampled subgraph; a seed whose endpoint a full node buffer evicted leaves
``seed_mask`` before the negatives are drawn
(``rmm_tpu/train/pretrain.py:250-310``). The optimizer is AdamW whose
weight decay reaches only the parameters of two or more dimensions (the
JAX mask ``ndim >= 2``; the port's parameters have the JAX leaves' shapes,
transposed where they are kernels). A parameter that a mode does not use
keeps a zero gradient, so AdamW decays it as optax does.

``--moo moco`` (mcm-lp only, as in the reference; the other modes sum)
weights the two tasks' gradients by MoCo (``nn/weighting.py``): one
forward gives both losses, two ``torch.autograd.grad`` pulls (the LP loss
first) give each task's gradient over the trainable parameters (zero where
a task does not reach one), flattened in ``named_parameters`` order;
``moco_combine`` mixes them, the result goes into ``.grad`` and AdamW steps
once. The MoCo state (``y``, ``λ``, the step) is saved beside the AdamW
state as ``moco.pt``.

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
from ..graph.device_sampler import (batch_generator, cached_dgraph,
                                    negative_samples_device,
                                    sample_edges_device, use_device_sampler)
from ..nn.decoders import LinkPredHead, MCMHead
from ..nn.dropout import set_generator
from ..nn.encoders import make_stypewise_encoder
from ..nn.gnn.conv import gather
from ..nn.models.fused import TABGNNFused
from ..nn.weighting import MoCoState, init_moco, moco_combine
from ..utils import checkpoint
from ..utils.batch import GraphBatch, SeedBatch
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.loss import SSLoss, lp_loss
from ..utils.metric import MCMAccumulator, mrr
from ..utils.precision import apply, compute_cast, out_f32
from ..utils.seeding import mix_seed
from .task_models import _deghist_to_avg_log, gather_rows, init_parameters
from .trainer import (features, resolve_capacities, seed_batches,
                      threaded_map)

logger = logging.getLogger(__name__)

MODES = ("mcm", "lp", "mcm-lp")
#: what a train step gives beside its loss: the LP loss and the MCM sums
STEP_SUMS = ("lp", "loss_c", "t_c", "acc", "loss_n", "t_n")
HITS_AT = (1, 2, 5, 10)
#: the MoCo state's file in a checkpoint directory
MOCO_FILE = "moco.pt"


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


def adamw(params: list, cfg: Config) -> torch.optim.AdamW:
    """AdamW over ``params`` at the config's rate and eps, its weight decay
    on those that :func:`decays`."""
    return torch.optim.AdamW(
        [{"params": [p for p in params if decays(p)],
          "weight_decay": cfg.weight_decay},
         {"params": [p for p in params if not decays(p)],
          "weight_decay": 0.0}],
        lr=cfg.lr, eps=cfg.adam_eps)


class PretrainTrainer:
    def __init__(self, cfg: Config, dataset, mode: str = "mcm-lp"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if cfg.moo not in ("sum", "moco"):
            raise ValueError(f"moo must be 'sum' or 'moco', got {cfg.moo!r}")
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
        self.optimizer = adamw(params, cfg)
        for p in params:
            p.grad = torch.zeros_like(p)
        self.params = params
        self.moco: Optional[MoCoState] = None
        if cfg.moo == "moco" and mode == "mcm-lp":
            self.moco = init_moco(2, sum(p.numel() for p in params),
                                  self.device)
        self.edge_table = compute_cast(
            features(dataset.edges.tensor_frame, self.device), cfg.precision)
        self.sample_s: list[float] = []   # host seconds of each batch built
        self.device_sampling = use_device_sampler(cfg)
        self._dgraphs: dict = {}

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

    def _materialize_dev(self, sb: SeedBatch, dgraph):
        """The LP batch of a device ``SeedBatch``, sampled on the device:
        (GraphBatch of device tensors, dropped edges, kept edges, the
        negatives' residual), the counts 0-d device tensors."""
        cfg = self.cfg
        b = sb.num_seeds
        out = sample_edges_device(
            dgraph, sb.seeds, sb.seed_mask,
            batch_generator(mix_seed(sb.sampler_seed, 1), self.device),
            cfg.num_neighs, cfg.edge_capacity, cfg.node_capacity,
            cfg.frontier_capacity or None)
        seed_mask = sb.seed_mask & out["edge_mask"][:b]
        ei = out["edge_index"]
        neg, residual = negative_samples_device(
            ei, out["edge_mask"], ei[0, :b], ei[1, :b], seed_mask,
            cfg.num_neg_samples, cfg.node_capacity, out["node_mask"].sum(),
            batch_generator(mix_seed(sb.sampler_seed, 2), self.device))
        gb = GraphBatch(
            edge_gather=out["edge_gather"], edge_mask=out["edge_mask"],
            edge_index=ei, node_gather=out["node_gather"],
            node_mask=out["node_mask"], seed_mask=seed_mask, y=sb.y,
            neg_edge_index=neg)
        return gb, out["num_dropped"], out["edge_mask"].sum(), residual

    def _stream(self, view, mode: str, epoch: int = 0):
        """A pass's LP batches on the device, each as (device GraphBatch,
        real seed rows, host y, dropped edges, kept edges, the negatives'
        residual): host numbers under host sampling, device counts under
        device sampling."""
        if not self.device_sampling:
            for gb in self._batches(view, mode, epoch):
                yield (gb.to(self.device), int(gb.seed_mask.sum()), gb.y,
                       gb.num_dropped, int(gb.edge_mask.sum()), 0)
            return
        dgraph = cached_dgraph(self.dataset.graph, self._dgraphs, mode,
                               self.device)
        for sb in seed_batches(self.cfg, view, mode, epoch):
            gb, dropped, kept, residual = self._materialize_dev(
                sb.to(self.device), dgraph)
            yield (gb, int(sb.seed_mask.sum()), sb.y, dropped, kept,
                   residual)

    def _step(self, batch: GraphBatch):
        """One train step on a device batch (the model in train mode): both
        views' forwards, the summed loss, the backward (under MoCo the two
        tasks' pulls and their combination) and the AdamW update. Returns
        the loss and its ``STEP_SUMS`` (those of the mode) as device
        tensors."""
        losses, aux = self._forward(batch)
        loss = sum(losses.values())
        if self.moco is None:
            self.optimizer.zero_grad(set_to_none=False)
            loss.backward()
        else:
            self._moco_grads(losses["lp"], losses["mcm"])
        self.optimizer.step()
        sums = {**losses, **aux}
        return loss.detach(), {k: sums[k].detach() for k in STEP_SUMS
                               if k in sums}

    def task_grads(self, task_losses) -> list[torch.Tensor]:
        """Each loss's gradient over the trainable parameters from one
        forward, one ``torch.autograd.grad`` pull a loss in the order given
        (the graph kept for the next), flattened in ``named_parameters``
        order; zero where a loss does not reach a parameter."""
        out = []
        for i, loss in enumerate(task_losses):
            grads = torch.autograd.grad(
                loss, self.params, retain_graph=i + 1 < len(task_losses),
                allow_unused=True)
            out.append(torch.cat([
                (torch.zeros_like(p) if g is None else g).reshape(-1)
                for p, g in zip(self.params, grads)]))
        return out

    def _moco_grads(self, l_lp: torch.Tensor, l_mcm: torch.Tensor):
        """MoCo's combination of the LP and MCM gradients, written into
        ``.grad``."""
        combined, self.moco, _ = moco_combine(
            self.moco, self.task_grads([l_lp, l_mcm]),
            [l_lp.detach(), l_mcm.detach()])
        offset = 0
        for p in self.params:
            n = p.numel()
            p.grad.copy_(combined[offset:offset + n].view_as(p))
            offset += n

    def _forward(self, batch: GraphBatch):
        """The model's losses and aux on a device batch under the
        precision of the config (float32 outputs)."""
        return apply(self.model, self.cfg.precision, batch, self.edge_table,
                     self.mode)

    def train_epoch(self, view, epoch: int) -> dict:
        """One pass over the shuffled train view: mean loss, seconds,
        sampler drop rate, the negatives' residual (device sampling), the
        MCM train losses, the host's sampling ms a batch and, on the card,
        the median step on the device's clock."""
        t0 = time.time()
        self.model.train()
        self.sample_s = []
        rows, events = [], []
        dropped = kept = residual = 0
        cuda = self.device.type == "cuda"
        for gb, _, _, b_dropped, b_kept, b_residual in self._stream(
                view, "train", epoch):
            dropped, kept = dropped + b_dropped, kept + b_kept
            residual = residual + b_residual
            loss, aux = self._step(gb)
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
        dropped, kept = int(dropped), int(kept)
        out.update(sec=time.time() - t0,
                   drop_rate=dropped / max(dropped + kept, 1),
                   neg_residual=int(residual),
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
            for gb, valid, y, *_ in self._stream(view, mode):
                _, aux = self._forward(gb)
                outs.append((valid, y, {
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
        BatchNorm statistics), the AdamW state (and under MoCo its state,
        ``moco.pt``) and ``best_m.json``; a ``best_*`` tag holds the
        weights alone."""
        ck = checkpoint.save_epoch(
            run_dir, epoch, self.model,
            self.optimizer if with_opt else None, best,
            prune_previous=isinstance(epoch, int),
            precision=self.cfg.precision)
        if self.moco is not None and with_opt:
            torch.save({"y": self.moco.y, "lambd": self.moco.lambd,
                        "step": self.moco.step},
                       os.path.join(ck, MOCO_FILE))
        return ck

    def restore(self, ck_dir: str, with_opt: bool = True) -> dict:
        """Load a checkpoint of either package (the port's optimizer and
        MoCo states too, when there; the JAX package's ``opt_state`` and
        ``moco_state`` are not read, so AdamW and MoCo start afresh) and
        return its best metrics."""
        best = no_best()
        best.update(checkpoint.resume(
            ck_dir, self.model, self.optimizer if with_opt else None,
            self.device))
        if self.moco is not None and not checkpoint.is_port_checkpoint(
                ck_dir) and os.path.exists(os.path.join(ck_dir,
                                                        "moco_state")):
            logger.warning("%s: its moco_state is not read, MoCo starts "
                           "afresh", ck_dir)
        moco = os.path.join(ck_dir, MOCO_FILE)
        if with_opt and self.moco is not None and os.path.exists(moco):
            self.moco = MoCoState(**torch.load(
                moco, map_location=self.device, weights_only=True))
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
