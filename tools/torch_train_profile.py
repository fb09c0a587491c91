"""Where the PyTorch port's training time goes, on one CUDA card.

    python3 tools/torch_train_profile.py [--rows 131072] [--batches 24]
    python3 tools/torch_train_profile.py --ssl [--rows 131072] [--batches 12]
    python3 tools/torch_train_profile.py --ssl --precision bf16
    python3 tools/torch_train_profile.py --model tabgnnfused
    python3 tools/torch_train_profile.py --node [elliptic|eth|ogbn]
    python3 tools/torch_train_profile.py --model pna   # or any family
    python3 tools/torch_train_profile.py --tabular [--mask_vector]
    python3 tools/torch_train_profile.py --ssl --moo moco
    python3 tools/torch_train_profile.py [--ssl | --node] --sampler device

Builds the supervised config of record with ``rmm_tpu_torch`` (synthetic
AML, tabgnn, C = 32, 2 layers, fanouts 100/100, batch 200, dropout 0.083;
random weights from the seed) and measures, over the first ``--batches``
shuffled train batches of epoch 0:

* host sampling per batch (``Trainer._batches``, ``mode="train"``, 4
  sampler threads);
* the device train step per batch on batches already on the card (CUDA
  events around the whole run of steps), and its kernels by device time
  (``torch.profiler``), the forward and the backward apart;
* the whole train loop (``Trainer.train_epoch`` over those batches), with
  the card's busy share (sum of kernel time over the loop's wall time).

With ``--model tabgnnfused`` the same for the transfer cell's supervised
fused model (C = 128, 3 layers, 8 heads, the supervised config's data and
flags, random weights), with its forward by layer and the peak memory of
a step.

With ``--model`` one of ``fttransformer``, ``gin``, ``pna``, ``cpna``,
``cpnatab`` and ``tabgnninterleaved`` the same for that model at the
supervised launcher's flags (C = 32, 2 layers, 8 heads, fanouts 100/100,
batch 200, dropout 0.083) on the config of record's data, with its forward
by part (the encoders, each direct submodule of the backbone, the
decoder).

With ``--node`` the same for Elliptic node classification (the
``elliptic`` config: tabgnn, C = 32, 2 layers, 8 heads, fanouts 100/100,
batch 200, dropout 0.083) on the port's synthetic Elliptic (Elliptic's
203,769 transactions, 234,355 edges and 166 feature columns: node tokens
S = 167 through the split routes' long cores, edge tokens S = 2 through
the tiled kernels), with its forward by layer (each
``tab_layer`` twice a step: the node and the edge tokens) and the peak
memory of a step. ``--node eth`` profiles Ethereum phishing node
classification the same way (the ``ethereum-phishing`` overrides: lr
8e-4, dropout 0.123; the port's synthetic Ethereum phishing at
``chip_smoke.py``'s 57,521 accounts and 262,144 transactions: node tokens
S = 2, edge tokens S = 6, all tiled), ``--node ogbn`` ogbn-arxiv at
``chip_smoke.py``'s 32,768 papers, 225,669 citations and 128 features
(node tokens S = 130 through the long cores, edge tokens S = 2).

With ``--ssl`` the same for SSL pretraining at the SSL config of record
(``PretrainTrainer``, mcm-lp, C = 128, 3 layers, 8 heads, 64 negatives,
batch 200, fanouts 100/100, dropout 0.5, lr 2e-4): host sampling with the
negatives, the device step, its forward by layer (CUDA events around each
module's forward, on the device's clock), the peak memory of a step, the
kernels of the forward and of the whole step, and the train loop.

With ``--tabular`` the same for the tabular MCM trainer of
``cli/fttransformer.py`` at its defaults (C = 128, 3 layers, 8 heads,
dropout 0.5, batch 200, AdamW lr 2e-4; ``--mask_vector`` adds the
mask-vector head): no sampler, the batches gathered on the card; its
forward by part (the encoder, the backbone, the head). ``--ssl --moo
moco`` profiles the SSL step under MoCo (two gradient pulls a step).

``--sampler device`` samples on the card instead (``graph/
device_sampler.py``): the sampling line is the device's (CUDA events
around the batches' sampling, the seed ids' copies included), the staged
batches are the device-sampled ones, and the train loop samples each batch
on the card before its step, so its busy share counts the sampler's
kernels.

``--precision bf16`` measures either at ``--precision bf16`` (the steps'
forwards through the trainers' own cast of the parameters); every line
names its precision. Prints one JSON line per measurement and writes the
profiler's kernel table to ``--table`` (default ``outputs/
train_profile.txt``, ``outputs/<model>_profile.txt`` with another
``--model``, ``outputs/ssl_profile.txt`` with ``--ssl``,
``outputs/node_profile.txt`` with ``--node``, ``outputs/<family>_profile.txt``
with ``--node eth|ogbn``). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.torch_serve_profile import device_us, kernel_table  # noqa: E402
from tools.torch_serve_profile import emit as emit_line  # noqa: E402

PRECISION = "f32"
SAMPLER = "host"

#: the node datasets of ``--node``: Elliptic at its published size (Weber
#: et al. 2019), Ethereum phishing and ogbn-arxiv at ``chip_smoke.py``'s
NODE_DATA = {
    "elliptic": dict(num_nodes=203769, num_edges=234355, num_feats=166),
    "eth": dict(num_nodes=57521, num_edges=262144),
    "ogbn": dict(num_nodes=32768, num_edges=225669, num_feats=128,
                 n_classes=40)}
NODE_DIRS = {"elliptic": "elliptic", "eth": "ethereum-phishing",
             "ogbn": "ogbn-arxiv"}


def emit(obj: dict):
    emit_line({**obj, "precision": PRECISION, "sampler": SAMPLER})


def top_kernels(prof, n: int, k: int = 15) -> tuple[float, list]:
    kernels = sorted(((e.key, device_us(e), e.count)
                      for e in prof.key_averages() if device_us(e) > 0),
                     key=lambda r: -r[1])
    total = sum(r[1] for r in kernels)
    return total, [{"name": r[0][:90], "ms_per_step": r[1] / 1e3 / n,
                    "calls_per_step": r[2] / n, "share": r[1] / total}
                   for r in kernels[:k]]


FAMILIES = ("fttransformer", "gin", "pna", "cpna", "cpnatab",
            "tabgnninterleaved")


def layer_times(model, run, n: int, children: bool = False) -> dict:
    """Device ms a step of each named module's forwards (every call summed),
    from CUDA events recorded by forward hooks while ``run()`` runs ``n``
    steps; with ``children``, of the encoders, the decoder (the tabular
    model's head) and each direct submodule of the backbone (of
    ``FTTransformer``'s ``backbone``)."""
    if children:
        body = getattr(model.model, "backbone", model.model)
        prefix = "model.backbone." if body is not model.model else "model."
        return _layer_times(model, ["node_encoder", "edge_encoder",
                                    "decoder", "head"] + [
            prefix + c for c, _ in body.named_children()], run, n)
    names = ["node_encoder", "edge_encoder", "model.node_emb",
             "model.tab_conv", "model.edge_emb", "mcm_head", "lp_head",
             "decoder"]
    names += [f"model.layer_{i}{part}" for i in range(model.model.num_layers)
              for part in ("", ".tab_conv", ".gnn_conv", ".gnn_edge_update",
                           ".fuse")]
    names += [f"model.{kind}_layer_{i}" for kind in ("tab", "gnn")
              for i in range(model.model.num_layers)]
    return _layer_times(model, names, run, n)


def _layer_times(model, names, run, n: int) -> dict:
    import torch

    mods = dict(model.named_modules())
    names = [name for name in names if name in mods]
    events: dict = {name: [] for name in names}
    handles = []
    for name in names:
        def pre(_m, _a, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name].append([ev, None])

        def post(_m, _a, _o, name=name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events[name][-1][1] = ev

        handles += [mods[name].register_forward_pre_hook(pre),
                    mods[name].register_forward_hook(post)]
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {name: {"ms_per_step": sum(a.elapsed_time(b) for a, b in evs) / n,
                   "calls_per_step": len(evs) / n}
            for name, evs in events.items()}


def device_sampled(tr, view, n: int, card: str) -> list:
    """The view's train batches sampled on the card (``_stream``), timed
    by CUDA events after one warm pass (the sort kernels' first load);
    emits the sampling line."""
    import torch

    list(tr._stream(view, "train"))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    dev = [item[0] for item in tr._stream(view, "train")]
    end.record()
    enqueue = time.perf_counter() - t0
    end.synchronize()
    emit({"phase": "device_sampling", "batches": n,
          "ms_per_batch": start.elapsed_time(end) / n,
          "host_enqueue_ms_per_batch": 1e3 * enqueue / n,
          "sampled_edges_per_batch": float(sum(
              int(g.edge_mask.sum()) for g in dev) / n),
          "frontier_capacity": tr.cfg.frontier_capacity, "card": card})
    return dev


def ssl_main(args, card: str, work: str):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rmm_tpu_torch.datasets import (IBMTransactionsAML,
                                        write_synthetic_aml_csv)
    from rmm_tpu_torch.datasets.base import PretrainType
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.ops import column_attention as ca
    from rmm_tpu_torch.train.pretrain import PretrainTrainer
    from rmm_tpu_torch.utils.config import Config

    csv = os.path.join(work, "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=args.rows,
                            num_accounts=max(args.rows // 16, 64), seed=0)
    t0 = time.perf_counter()
    cfg = Config(model="tabgnnfused", data=csv, batch_size=200,
                 n_hidden=128, n_gnn_layers=3, num_neighs=(100, 100),
                 dropout=0.5, lr=2e-4, num_neg_samples=64, device="cuda",
                 sampler_threads=4, precision=args.precision, moo=args.moo,
                 sampler=args.sampler)
    ds = IBMTransactionsAML(csv, khop_neighbors=cfg.num_neighs, pretrain={
        PretrainType.MASK, PretrainType.LINK_PRED})
    tr = PretrainTrainer(cfg, ds, "mcm-lp")
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "edge_capacity": tr.cfg.edge_capacity,
          "node_capacity": tr.cfg.node_capacity,
          "parameters": sum(q.numel() for q in tr.model.parameters()),
          "card": card})
    train = ds.edges.split()[0]
    n = args.batches
    view = DatasetView(train.parent, train.indices[:n * cfg.batch_size])

    if args.sampler == "device":
        dev = device_sampled(tr, view, n, card)
    else:
        for threads in (1, 4):
            tr.cfg = tr.cfg.replace(sampler_threads=threads)
            tr.sample_s = []
            t0 = time.perf_counter()
            host = list(tr._batches(view, "train"))
            emit({"phase": "host_sampling", "threads": threads,
                  "batches": n,
                  "ms_per_batch": 1e3 * (time.perf_counter() - t0) / n,
                  "build_ms_per_batch": 1e3 * sum(tr.sample_s) / n,
                  "neg_edges_per_batch": int(
                      host[0].neg_edge_index.shape[1]),
                  "sampled_edges_per_batch": float(
                      sum(int(g.edge_mask.sum()) for g in host) / n)})
        dev = [g.to(tr.device) for g in host]
    tr.model.train()
    for g in dev[:2]:
        tr._step(g)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for g in dev:
        tr._step(g)
    end.record()
    end.synchronize()
    emit({"phase": "device_step", "ms_per_step": start.elapsed_time(end) / n,
          "host_enqueue_ms_per_step": 1e3 * (time.perf_counter() - t0) / n,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": card})

    def forwards():
        for g in dev:
            tr._forward(g)

    emit({"phase": "train_forward_layers", "card": card,
          "layers": layer_times(tr.model, forwards, n)})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forwards()
        torch.cuda.synchronize()
    fwd_total, fwd_top = top_kernels(prof, n)
    emit({"phase": "train_forward_kernels",
          "device_ms_per_step": fwd_total / 1e3 / n, "top": fwd_top})
    before = (ca.launches, ca.bwd_launches, ca.reduce_launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for g in dev:
            tr._step(g)
        torch.cuda.synchronize()
    total, top = top_kernels(prof, n, 25)
    launched = (ca.launches - before[0], ca.bwd_launches - before[1],
                ca.reduce_launches - before[2])
    emit({"phase": "train_step_kernels",
          "device_ms_per_step": total / 1e3 / n,
          "launches_per_step": sum(e.count for e in prof.key_averages()
                                   if device_us(e) > 0) / n,
          "attention_launches_per_step": {
              k: x / n for k, x in zip(("fwd", "bwd", "reduce"), launched)},
          "top": top})
    table = kernel_table(prof)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = tr.train_epoch(view, 0)
        wall = time.perf_counter() - t0
    busy = sum(device_us(e) for e in prof.key_averages()) / 1e6
    emit({"phase": "train_loop", "threads": 4, "batches": n,
          "rows": view.tensor_frame.num_rows, "wall_s": wall,
          "rows_per_s": view.tensor_frame.num_rows / wall,
          "step_ms_median": out.get("step_ms"),
          "sample_ms": out.get("sample_ms"), "device_busy_s": busy,
          "device_busy_share": busy / wall, "card": card})
    return table


def tabular_main(args, card: str, work: str):
    """The tabular MCM trainer: its staged batches' device step, the host's
    enqueue, the forward by part, the kernels and the train loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rmm_tpu_torch.cli import fttransformer
    from rmm_tpu_torch.datasets import (IBMTransactionsAML,
                                        write_synthetic_aml_csv)
    from rmm_tpu_torch.datasets.base import PretrainType
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.train.tabular import TabularMCMTrainer

    csv = write_synthetic_aml_csv(os.path.join(work, "aml.csv"),
                                  num_rows=args.rows,
                                  num_accounts=max(args.rows // 16, 64),
                                  seed=0)
    t0 = time.perf_counter()
    cfg = fttransformer.config_from_args(fttransformer.build_parser(
    ).parse_args(["--dataset", csv, "--device", "cuda"]))
    ds = IBMTransactionsAML(csv, pretrain={PretrainType.MASK})
    tr = TabularMCMTrainer(cfg, ds.edges, args.mask_vector)
    emit({"phase": "setup", "model": "tabular_mcm",
          "mask_vector": args.mask_vector,
          "seconds": time.perf_counter() - t0,
          "parameters": sum(q.numel() for q in tr.model.parameters()),
          "card": card})
    train = ds.edges.split()[0]
    n = args.batches
    view = DatasetView(train.parent, train.indices[:n * cfg.batch_size])
    staged = [(tf, mask) for tf, mask, _, _ in tr._batches(view, True)]
    tr.model.train()
    for tf, mask in staged[:2]:
        tr._step(tf, mask)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for tf, mask in staged:
        tr._step(tf, mask)
    end.record()
    end.synchronize()
    emit({"phase": "device_step", "ms_per_step": start.elapsed_time(end) / n,
          "host_enqueue_ms_per_step": 1e3 * (time.perf_counter() - t0) / n,
          "card": card})

    def forwards():
        for tf, mask in staged:
            tr._loss(tf, mask)

    emit({"phase": "train_forward_layers", "card": card,
          "layers": layer_times(tr.model, forwards, n, True)})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for tf, mask in staged:
            tr._step(tf, mask)
        torch.cuda.synchronize()
    total, top = top_kernels(prof, n, 25)
    emit({"phase": "train_step_kernels",
          "device_ms_per_step": total / 1e3 / n,
          "launches_per_step": sum(e.count for e in prof.key_averages()
                                   if device_us(e) > 0) / n,
          "top": top})
    table = kernel_table(prof)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = tr.train_epoch(view, 0)
        wall = time.perf_counter() - t0
    busy = sum(device_us(e) for e in prof.key_averages()) / 1e6
    emit({"phase": "train_loop", "batches": n,
          "rows": view.tensor_frame.num_rows, "wall_s": wall,
          "rows_per_s": view.tensor_frame.num_rows / wall,
          "step_ms_median": out.get("step_ms"), "device_busy_s": busy,
          "device_busy_share": busy / wall, "card": card})
    return table


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=131072)
    p.add_argument("--batches", type=int, default=None,
                   help="24, or 12 with --ssl")
    p.add_argument("--ssl", action="store_true")
    p.add_argument("--model", default="tabgnn",
                   choices=("tabgnn", "tabgnnfused") + FAMILIES)
    p.add_argument("--node", nargs="?", const="elliptic", default=None,
                   choices=("elliptic", "eth", "ogbn"))
    p.add_argument("--tabular", action="store_true")
    p.add_argument("--mask_vector", action="store_true")
    p.add_argument("--moo", default="sum", choices=("sum", "moco"))
    p.add_argument("--precision", default="f32", choices=("f32", "bf16"))
    p.add_argument("--sampler", default="host", choices=("host", "device"))
    p.add_argument("--table", default=None)
    args = p.parse_args(argv)
    global PRECISION, SAMPLER
    PRECISION, SAMPLER = args.precision, args.sampler
    if args.batches is None:
        args.batches = 12 if args.ssl else 48 if args.tabular else 24
    if args.table is None:
        args.table = os.path.join(ROOT, "outputs", "ssl_profile.txt"
                                  if args.ssl else "tabular_profile.txt"
                                  if args.tabular else "node_profile.txt"
                                  if args.node == "elliptic" else
                                  f"{args.node}_profile.txt" if args.node
                                  else "train_profile.txt"
                                  if args.model == "tabgnn" else
                                  f"{args.model}_profile.txt")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from rmm_tpu_torch.datasets import (IBMTransactionsAML, build_dataset,
                                        write_synthetic_aml_csv,
                                        write_synthetic_node_dataset)
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import (Config, config_from_args,
                                            create_parser)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    work = os.path.join(ROOT, "rmm_tpu_torch", "_build", "train_profile")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if args.ssl or args.tabular:
        table = (ssl_main if args.ssl else tabular_main)(args, card, work)
        os.makedirs(os.path.dirname(os.path.abspath(args.table)),
                    exist_ok=True)
        with open(args.table, "w") as f:
            f.write(card + "\n" + table + "\n")
        shutil.rmtree(work, ignore_errors=True)
        return
    if args.node:
        data = write_synthetic_node_dataset(
            os.path.join(work, NODE_DIRS[args.node]), family=args.node,
            seed=0, **NODE_DATA[args.node])
    else:
        data = write_synthetic_aml_csv(
            os.path.join(work, "aml.csv"), num_rows=args.rows,
            num_accounts=max(args.rows // 16, 64), seed=0)
    t0 = time.perf_counter()
    fused = args.model == "tabgnnfused"
    if args.node:   # the training CLI's config: the datasets' overrides
        cfg = config_from_args(create_parser().parse_args([
            "--data", data, "--model", "tabgnn", "--task",
            "node_classification", "--n_hidden", "32", "--n_gnn_layers",
            "2", "--num_neighs", "100", "100", "--batch_size", "200",
            "--sampler_threads", "4", "--device", "cuda", "--precision",
            args.precision, "--sampler", args.sampler]))
        ds = build_dataset(cfg)
        cfg = cfg.replace(n_classes=ds.n_classes)
    else:
        cfg = Config(model=args.model, data=data, batch_size=200,
                     n_hidden=128 if fused else 32,
                     n_gnn_layers=3 if fused else 2, num_neighs=(100, 100),
                     device="cuda", sampler_threads=4,
                     precision=args.precision, sampler=args.sampler)
        ds = IBMTransactionsAML(data, khop_neighbors=cfg.num_neighs)
    tr = Trainer(cfg, ds)
    emit({"phase": "setup", "model": cfg.model, "task": cfg.task,
          "data": args.node or "aml", "dropout": cfg.dropout,
          "seconds": time.perf_counter() - t0,
          "edge_capacity": tr.cfg.edge_capacity,
          "node_capacity": tr.cfg.node_capacity, "card": card})
    train = tr.seed_table().split()[0]
    n = args.batches
    view = DatasetView(train.parent, train.indices[:n * cfg.batch_size])

    if args.sampler == "device":
        dev = device_sampled(tr, view, n, card)
    else:
        t0 = time.perf_counter()
        host = list(tr._batches(view, "train"))
        emit({"phase": "host_sampling", "threads": 4, "batches": n,
              "ms_per_batch": 1e3 * (time.perf_counter() - t0) / n})
        dev = [g.to(tr.device) for g in host]
    tr.model.train()
    for g in dev[:2]:
        tr._step(g)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for g in dev:
        tr._step(g)
    end.record()
    end.synchronize()
    emit({"phase": "device_step", "ms_per_step": start.elapsed_time(end) / n,
          "host_enqueue_ms_per_step": 1e3 * (time.perf_counter() - t0) / n,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": card})
    family = args.model in FAMILIES
    if fused or args.node or family:
        def forwards():
            for g in dev:
                tr._logits(g)

        emit({"phase": "train_forward_layers", "card": card,
              "layers": layer_times(tr.model, forwards, n, family)})

    # forward alone (train mode, grad on) and the whole step, by kernel
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for g in dev:
            tr._logits(g)
        torch.cuda.synchronize()
    fwd_total, fwd_top = top_kernels(prof, n)
    emit({"phase": "train_forward_kernels",
          "device_ms_per_step": fwd_total / 1e3 / n, "top": fwd_top})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for g in dev:
            tr._step(g)
        torch.cuda.synchronize()
    total, top = top_kernels(prof, n, 25)
    emit({"phase": "train_step_kernels",
          "device_ms_per_step": total / 1e3 / n,
          "launches_per_step": sum(e.count for e in prof.key_averages()
                                   if device_us(e) > 0) / n,
          "top": top})
    table = kernel_table(prof)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = tr.train_epoch(view, 0)
        wall = time.perf_counter() - t0
    busy = sum(device_us(e) for e in prof.key_averages()) / 1e6
    emit({"phase": "train_loop", "threads": 4, "batches": n,
          "rows": view.tensor_frame.num_rows, "wall_s": wall,
          "rows_per_s": view.tensor_frame.num_rows / wall,
          "step_ms_median": out.get("step_ms"), "device_busy_s": busy,
          "device_busy_share": busy / wall, "card": card})

    os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
    with open(args.table, "w") as f:
        f.write(card + "\n" + table + "\n")
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
