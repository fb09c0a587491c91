"""Profiling CLI (the counterpart of ``rmm_tpu.cli.benchmark``): per-phase
wall-clock timers over the training loop, and a ``torch.profiler`` trace.

    python -m rmm_tpu_torch.cli.benchmark --data <csv> --model tabgnn \\
        --iters 100 --profile --trace_dir <dir> [--device cpu]

Same flags as the JAX package's (the training CLI's, plus ``--iters``,
``--profile``, ``--trace_dir`` and ``--loop``); ``--device`` is the
training CLI's (``cuda`` by default, which raises without CUDA; ``cpu``
runs the kernels' plain versions).

* The timers (``--loop supervised``, :func:`run_benchmark`): the mean, the
  median and the total of each phase of a train iteration over ``--iters``
  iterations, after one warm-up, under the reference's phase names:
  pre-processing (the host sampler's batch, or the device sampler's),
  cpu-to-device (``GraphBatch.to``), forward (``Trainer._forward_eval`` in
  eval mode: no BatchNorm statistic moves), train-step (``Trainer._step``:
  forward, backward and Adam) and copy-back (the loss and the predictions
  to the host). Each phase ends at a ``torch.cuda.synchronize()`` on the
  card, where the reference blocks until its arrays are ready.
* ``--profile``: ``min(iters, 10)`` more iterations under
  ``torch.profiler`` (CPU and CUDA activities), exported as a Chrome trace
  ``benchmark_trace.json`` under ``--trace_dir`` (the reference's
  ``jax.profiler`` trace directory); the timers leave them out (the
  reference's tables count them too, the profiler's cost in them).
* ``--loop mcm|lp|mcm-lp`` (:func:`run_pretrain_benchmark`): the SSL
  pretraining loop's pre-processing and train-step phases (``--profile``
  traces the supervised loop alone, as in the reference).

The summary (logged as JSON and returned) has the reference's keys, and
``device``: the card's name, or ``cpu``.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import time

import numpy as np
import torch

#: the reference's ``/tmp/rmm_trace``, under the caller's temporary dir
DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(), "rmm_torch_trace")
TRACE_FILE = "benchmark_trace.json"
PROFILE_ITERS = 10       # the reference's profiler hard-stop
SUPERVISED_PHASES = ("pre-processing", "cpu-to-device", "forward",
                     "train-step", "copy-back")


def _sync(device: torch.device):
    """Waits for the card (the end of a phase); nothing on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def phase_table(phases: dict) -> dict:
    return {k: {"mean_ms": float(np.mean(v) * 1e3),
                "p50_ms": float(np.median(v) * 1e3),
                "total_s": float(np.sum(v))} for k, v in phases.items()}


def _trace(device: torch.device, trace_dir: str, run):
    """``run()`` under ``torch.profiler`` (CPU, and CUDA on the card),
    exported as a Chrome trace under ``trace_dir``; returns its path."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_FILE)
    with profile(activities=activities) as prof:
        run()
    prof.export_chrome_trace(path)
    logging.info("trace exported to %s", path)
    return path


def train_batches(trainer, view):
    """The train split's batches from the start (epoch 0), each as (batch,
    on the device already): the host sampler's numpy batches, or the
    device sampler's."""
    if trainer.device_sampling:
        for gb, *_ in trainer._stream(view, "train"):
            yield gb, True
    else:
        for gb in trainer._batches(view, "train"):
            yield gb, False


def run_benchmark(cfg, iters: int = 100, profile: bool = False,
                  trace_dir: str = DEFAULT_TRACE_DIR):
    from ..datasets import build_dataset
    from ..train.trainer import Trainer

    dataset = build_dataset(cfg)
    if hasattr(dataset, "n_classes"):
        cfg = cfg.replace(n_classes=dataset.n_classes)
    return benchmark_trainer(Trainer(cfg, dataset), iters, profile,
                             trace_dir)


def benchmark_trainer(trainer, iters: int = 100, profile: bool = False,
                      trace_dir: str = DEFAULT_TRACE_DIR):
    """:func:`run_benchmark` on a built ``Trainer``: one warm-up iteration
    (a forward and a step on the train split's first batch), under
    ``profile`` ``min(iters, 10)`` traced iterations from the first batch,
    then ``iters`` timed ones from the first batch (the split starting
    over when it runs out); the traced iterations are not timed."""
    cfg = trainer.cfg
    device = trainer.device
    tr, _, _ = trainer.seed_table().split()
    phases = {k: [] for k in SUPERVISED_PHASES}

    def one_iter(batches) -> bool:
        t0 = time.perf_counter()
        try:
            gb, on_device = next(batches)
        except StopIteration:
            return False
        _sync(device)
        phases["pre-processing"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        if not on_device:
            gb = gb.to(device)
        _sync(device)
        phases["cpu-to-device"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        trainer.model.eval()
        trainer._forward_eval(gb)
        _sync(device)
        phases["forward"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        trainer.model.train()
        loss, aux = trainer._step(gb)
        trainer.model.eval()
        _sync(device)
        phases["train-step"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        float(loss.cpu())
        {k: v.cpu().numpy() for k, v in aux.items()}
        phases["copy-back"].append(time.perf_counter() - t0)
        return True

    one_iter(train_batches(trainer, tr))          # warm-up
    for v in phases.values():
        v.clear()

    def measure(n):
        it = train_batches(trainer, tr)
        done = 0
        while done < n:
            if not one_iter(it):
                it = train_batches(trainer, tr)
                continue
            done += 1

    trace = None
    if profile:
        trace = _trace(device, trace_dir,
                       lambda: measure(min(iters, PROFILE_ITERS)))
        for v in phases.values():
            v.clear()
    measure(iters)

    summary = {"iters": iters, "batch_size": cfg.batch_size,
               "train_rows_per_sec": float(
                   cfg.batch_size / np.mean(phases["train-step"])),
               "phases": phase_table(phases),
               "device": device_name(device)}
    if trace is not None:
        summary["trace"] = trace
    logging.info(json.dumps(summary, indent=2))
    return summary


def run_pretrain_benchmark(cfg, mode: str = "mcm-lp", iters: int = 100):
    """The SSL pretraining loop (``PretrainTrainer``, ``mode``) on the IBM
    AML CSV at ``cfg.data``, at the widths of ``cfg``: pre-processing (a
    batch, sampled and on the device) and train-step (both views'
    forwards, the backward and AdamW), after one warm-up step."""
    from ..datasets import IBMTransactionsAML
    from ..datasets.base import PretrainType
    from ..train.pretrain import PretrainTrainer

    pretrain = {PretrainType.LINK_PRED}
    if "mcm" in mode:
        pretrain.add(PretrainType.MASK)
    dataset = IBMTransactionsAML(
        root=cfg.data, pretrain=pretrain, khop_neighbors=cfg.num_neighs,
        edge_capacity=cfg.edge_capacity, node_capacity=cfg.node_capacity)
    trainer = PretrainTrainer(cfg, dataset, mode=mode)
    device = trainer.device
    tr, _, _ = dataset.edges.split()
    phases = {"pre-processing": [], "train-step": []}

    def steps(n: int, record: bool):
        it = trainer._stream(tr, "train")
        done = 0
        trainer.model.train()
        while done < n:
            t0 = time.perf_counter()
            try:
                gb = next(it)[0]
            except StopIteration:
                it = trainer._stream(tr, "train")
                continue
            _sync(device)
            t1 = time.perf_counter()
            trainer._step(gb)
            _sync(device)
            if record:
                phases["pre-processing"].append(t1 - t0)
                phases["train-step"].append(time.perf_counter() - t1)
            done += 1
        trainer.model.eval()

    steps(1, False)                               # warm-up
    steps(iters, True)
    table = {k: {"mean_ms": float(np.mean(v) * 1e3),
                 "p50_ms": float(np.median(v) * 1e3)}
             for k, v in phases.items()}
    summary = {"loop": f"pretrain:{mode}", "iters": iters,
               "batch_size": cfg.batch_size,
               "rows_per_sec": float(
                   cfg.batch_size / np.mean(phases["train-step"])),
               "phases": table, "device": device_name(device)}
    logging.info(json.dumps(summary, indent=2))
    return summary


def build_parser():
    from ..utils.config import create_parser

    parser = create_parser()
    parser.add_argument("--iters", default=100, type=int)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--trace_dir", default=DEFAULT_TRACE_DIR, type=str)
    parser.add_argument("--loop", default="supervised",
                        choices=["supervised", "mcm", "lp", "mcm-lp"])
    return parser


def main(argv=None):
    from ..utils.config import config_from_args
    from ..utils.logging import logger_setup

    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    logger_setup()
    if args.loop != "supervised":
        return run_pretrain_benchmark(cfg, mode=args.loop, iters=args.iters)
    return run_benchmark(cfg, iters=args.iters, profile=args.profile,
                         trace_dir=args.trace_dir)


if __name__ == "__main__":
    main()
