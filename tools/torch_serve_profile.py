"""Where the PyTorch port's serving time goes, on one CUDA card.

    python3 tools/torch_serve_profile.py [--rows 131072] [--batches 24]

Builds the supervised config of record with ``rmm_tpu_torch`` (synthetic
AML, tabgnn, C = 32, 2 layers, fanouts 100/100, batch 200; random weights
from the seed) and times, over the first ``--batches`` batches of the test
split, one layer at a time:

* host sampling per batch (the C++ engine through ``Trainer._batches``)
  with 1 and with 4 sampler threads;
* host→card copies per batch (``GraphBatch.to``, pinned, non-blocking);
* the device forward per batch on batches already on the card (CUDA
  events), and its kernels by device time (``torch.profiler``);
* the whole predict loop, with the card's busy share (sum of kernel time
  over the loop's wall time, from the profiler).

Prints one JSON line per measurement and writes the profiler's kernel table
to ``--table`` (default ``outputs/serve_profile.txt``). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def emit(obj):
    print(json.dumps(obj), flush=True)


def device_us(evt) -> float:
    """Device time of a kernel row of ``key_averages()`` (0 for the CPU-side
    operator rows, whose device time is their kernels' rows)."""
    import torch

    if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def kernel_table(prof) -> str:
    for key in ("self_device_time_total", "self_cuda_time_total"):
        try:
            return prof.key_averages().table(sort_by=key, row_limit=40)
        except (AttributeError, KeyError, ValueError):
            continue
    return prof.key_averages().table(row_limit=40)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=131072)
    p.add_argument("--batches", type=int, default=24)
    p.add_argument("--table", default=os.path.join(
        ROOT, "outputs", "serve_profile.txt"))
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from rmm_tpu_torch.datasets import (IBMTransactionsAML,
                                        write_synthetic_aml_csv)
    from rmm_tpu_torch.frame.dataset import DatasetView
    from rmm_tpu_torch.train.trainer import Trainer
    from rmm_tpu_torch.utils.config import Config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    work = os.path.join(ROOT, "rmm_tpu_torch", "_build", "profile")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    csv = os.path.join(work, "aml.csv")
    write_synthetic_aml_csv(csv, num_rows=args.rows,
                            num_accounts=max(args.rows // 16, 64), seed=0)
    t0 = time.perf_counter()
    cfg = Config(model="tabgnn", data=csv, batch_size=200, n_hidden=32,
                 n_gnn_layers=2, num_neighs=(100, 100), device="cuda")
    ds = IBMTransactionsAML(csv, khop_neighbors=cfg.num_neighs)
    tr = Trainer(cfg, ds)
    torch.cuda.synchronize()
    emit({"phase": "setup", "seconds": time.perf_counter() - t0,
          "edge_capacity": tr.cfg.edge_capacity,
          "node_capacity": tr.cfg.node_capacity, "card": card})
    test = ds.edges.split()[2]
    n = args.batches
    view = DatasetView(test.parent, test.indices[:n * cfg.batch_size])

    for threads in (1, 4):
        tr.cfg = tr.cfg.replace(sampler_threads=threads)
        t0 = time.perf_counter()
        host = list(tr._batches(view, "test"))
        dt = time.perf_counter() - t0
        emit({"phase": "host_sampling", "threads": threads, "batches": n,
              "ms_per_batch": 1e3 * dt / n,
              "edges_per_batch": float(sum(int(g.edge_mask.sum())
                                           for g in host)) / n,
              "nodes_per_batch": float(sum(int(g.node_mask.sum())
                                           for g in host)) / n})

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = [g.to(tr.device) for g in host]
    torch.cuda.synchronize()
    emit({"phase": "host_to_card", "ms_per_batch":
          1e3 * (time.perf_counter() - t0) / n,
          "bytes_per_batch": sum(a.nbytes for a in (
              host[0].edge_gather, host[0].edge_mask, host[0].edge_index,
              host[0].node_gather, host[0].node_mask, host[0].seed_mask))})

    for g in dev[:2]:
        tr._forward_eval(g)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for g in dev:
        tr._forward_eval(g)
    end.record()
    end.synchronize()
    emit({"phase": "device_forward", "ms_per_batch":
          start.elapsed_time(end) / n,
          "host_enqueue_ms_per_batch": 1e3 * (time.perf_counter() - t0) / n,
          "card": card})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for g in dev:
            tr._forward_eval(g)
        torch.cuda.synchronize()
    table = kernel_table(prof)
    kernels = sorted(((e.key, device_us(e), e.count)
                      for e in prof.key_averages() if device_us(e) > 0),
                     key=lambda k: -k[1])
    total = sum(k[1] for k in kernels)
    emit({"phase": "forward_kernels", "device_ms_per_batch":
          total / 1e3 / n, "launches_per_batch":
          sum(k[2] for k in kernels) / n,
          "top": [{"name": k[0][:80], "ms_per_batch": k[1] / 1e3 / n,
                   "share": k[1] / total} for k in kernels[:12]]})

    tr.cfg = tr.cfg.replace(sampler_threads=4)
    tr.predict(view, "test")               # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = tr.predict(view, "test")
        wall = time.perf_counter() - t0
    busy = sum(device_us(e) for e in prof.key_averages()) / 1e6
    emit({"phase": "predict_loop", "threads": 4, "batches": n,
          "rows": len(out["id"]), "wall_s": wall,
          "rows_per_s": len(out["id"]) / wall, "device_busy_s": busy,
          "device_busy_share": busy / wall, "card": card})

    os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
    with open(args.table, "w") as f:
        f.write(card + "\n" + table + "\n")
    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
