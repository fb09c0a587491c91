#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rmm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each; any failed check exits non-zero before the
last line is printed:

Every run goes through all four phases:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — compiles every kernel and the host graph engine from the
             checkout's sources, all compilers started together.
3. kernel  — each CUDA kernel against its plain PyTorch version on the
             card, at the serving path's shapes (edge tokens at the edge
             capacity, node tokens at the node capacity, both read from
             the fixture) and more (node tokens at the edge capacity,
             C = 128, a ragged batch, a numpy keep-mask): max error,
             kernel / plain / library times (CUDA events, warm, median),
             and the bound.
4. serve   — the port's predict CLI (``rmm_tpu_torch.cli.predict.main``)
             at the config of record: 131,072-row synthetic AML, tabgnn,
             C = 32, 2 layers, fanouts 100/100, batch 200, test split, on
             weights converted from the committed JAX fixture
             (``tests/fixtures/torch_port/aml_record.npz``, written by
             ``tools/make_torch_port_fixture.py``). Checks 4 kernel
             launches per batch, finite scores, and the first rows against
             the JAX results.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside it, the script fails and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port",
                       "aml_record.npz")
# Published peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12     # HBM3
PEAK_F32_FLOP_PER_S = 67e12    # float32 outside the tensor cores
KERNEL_TOL = 1e-4              # abs: f32, sums in another order
SCORE_TOL = 1e-3               # served score vs the JAX CPU fixture


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``reps`` back-to-back
    calls, by CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def attention_floor(b, s, c, h, masked) -> tuple[float, float]:
    """Least times (ms) for the work, by bytes and by operations: x read +
    o written + weights (+ the keep-mask) over HBM bandwidth, and the FMAs
    (2 flops each) of the two projections, the scores and the context over
    the f32 peak."""
    hd = c // h
    nbytes = 4 * (2 * b * s * c + 4 * c * c + 4 * c)
    if masked:
        nbytes += b * h * s * s
    flops = 2 * b * s * (3 * c * c + c * c) + 2 * 2 * b * h * s * s * hd
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return t_bytes, t_ops


def bound(t_bytes: float, t_ops: float) -> tuple[float, str]:
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def fixture_settings() -> dict:
    import numpy as np

    return json.loads(str(np.load(FIXTURE)["settings"]))


def kernel_phase(card: str) -> list[dict]:
    """Column attention on the card against its plain version; the first
    two records are the shapes the serve phase gives the kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from rmm_tpu_torch.ops import column_attention as ca

    st = fixture_settings()
    edges, nodes, c = st["edge_capacity"], st["node_capacity"], st["n_hidden"]
    shapes = [  # (B, S, C, H, masked)
        (edges, 6, c, 8, False),     # serving path: edge tokens
        (nodes, 2, c, 8, False),     # serving path: node tokens
        (edges, 2, c, 8, False),     # node tokens at the edge capacity
        (32768, 6, 128, 8, False),   # SSL width, weights via L2
        (100003, 6, 32, 8, False),   # ragged batch
        (4099, 6, 64, 4, True),      # numpy keep-mask, dropout 0.3
    ]
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    results = []
    for b, s, c, h, masked in shapes:
        def t(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).to(dev)

        x = t(b, s, c)
        wqkv, bqkv = t(c, 3 * c, scale=c ** -0.5), t(3 * c, scale=0.1)
        wout, bout = t(c, c, scale=c ** -0.5), t(c, scale=0.1)
        mask, rate = None, 0.0
        if masked:
            mask = torch.from_numpy(rng.rand(b, h, s, s) >= 0.3).to(dev)
            rate = 0.3
        args = (x, wqkv, bqkv, wout, bout, h, mask, rate)
        with torch.inference_mode():
            out = ca.fused_column_attention(*args)
            ref = ca.reference_column_attention(*args)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            check(math.isfinite(err) and err <= KERNEL_TOL,
                  f"column attention {b}x{s}x{c}/{h} mask={masked}: "
                  f"max_abs_err {err} > {KERNEL_TOL}")
            k_ms = time_ms(lambda: ca.fused_column_attention(*args))
            p_ms = time_ms(lambda: ca.reference_column_attention(*args))
            lib_ms = None
            if not masked:   # no library call takes an explicit keep-mask
                q = x.transpose(0, 1)
                w_in, w_o = wqkv.t().contiguous(), wout.t().contiguous()

                def lib():
                    return F.multi_head_attention_forward(
                        q, q, q, c, h, w_in, bqkv, None, None, False, 0.0,
                        w_o, bout, training=False, need_weights=False)[0]

                lib_err = float((lib().transpose(0, 1) - ref).abs().max())
                check(lib_err <= KERNEL_TOL,
                      f"library attention disagrees: {lib_err}")
                lib_ms = time_ms(lib)
        t_bytes, t_ops = attention_floor(b, s, c, h, masked)
        bound_ms, by = bound(t_bytes, t_ops)
        rec = {"phase": "kernel", "kernel": "column_attention_fwd",
               "B": b, "S": s, "C": c, "H": h, "masked": masked,
               "max_abs_err": err, "tol": KERNEL_TOL, "kernel_ms": k_ms,
               "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
               "bound_by": by, "bytes_ms": t_bytes, "ops_ms": t_ops,
               "card": card, "ok": True}
        emit(rec)
        results.append(rec)
        del x, out, ref, mask
        torch.cuda.empty_cache()
    return results


def serve_phase(card: str) -> dict:
    """The port's predict CLI at the config of record, on the card."""
    import numpy as np
    import torch

    from rmm_tpu_torch.cli import predict
    from rmm_tpu_torch.convert import from_jax
    from rmm_tpu_torch.datasets import write_synthetic_aml_csv
    from rmm_tpu_torch.ops import column_attention as ca
    from rmm_tpu_torch.utils.checkpoint import save_checkpoint

    fx = np.load(FIXTURE)
    st = fixture_settings()
    work = os.path.join(ROOT, "rmm_tpu_torch", "_build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        csv = os.path.join(work, "aml.csv")
        write_synthetic_aml_csv(csv, num_rows=st["rows"],
                                num_accounts=st["num_accounts"],
                                seed=st["data_seed"])
        prefix = "variables/"
        state = from_jax({k[len(prefix):]: fx[k] for k in fx.files
                          if k.startswith(prefix)})
        ckpt = save_checkpoint(os.path.join(work, "ckpt"), state,
                               {"model": st["model"]})
        argv = ["--data", csv, "--model", st["model"],
                "--n_hidden", str(st["n_hidden"]),
                "--n_gnn_layers", str(st["n_gnn_layers"]),
                "--num_neighs", *map(str, st["num_neighs"]),
                "--batch_size", str(st["batch_size"]),
                "--seed", str(st["seed"]), "--sampler_threads", "4",
                "--load_model", ckpt, "--split", "test",
                "--output", os.path.join(work, "preds.csv"),
                "--device", "cuda"]
        run: dict = {}
        ca.launches = 0
        t0 = time.perf_counter()
        out = predict.main(argv, run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ca.launches
    finally:
        shutil.rmtree(work, ignore_errors=True)

    rows = len(out["id"])
    batches = -(-rows // st["batch_size"])
    check(rows == st["test_rows"], f"served {rows} rows, test split has "
          f"{st['test_rows']}")
    check(launches == 4 * batches,
          f"{launches} kernel launches for {batches} batches (expected 4 "
          "per batch: 2 layers x node and edge tokens)")
    check((run["edge_capacity"], run["node_capacity"])
          == (st["edge_capacity"], st["node_capacity"]),
          f"capacities {run['edge_capacity']}/{run['node_capacity']} vs "
          f"the fixture's {st['edge_capacity']}/{st['node_capacity']}")
    check(np.isfinite(out["score"]).all(), "non-finite scores")
    k = len(fx["id"])
    check(np.array_equal(out["id"][:k], fx["id"]),
          "served ids differ from the JAX fixture")
    score_err = float(np.abs(out["score"][:k] - fx["score"]).max())
    check(score_err <= SCORE_TOL, f"score error {score_err} > {SCORE_TOL}")
    clear = np.abs(fx["score"] - 0.5) > SCORE_TOL
    check(np.array_equal(out["pred"][:k][clear], fx["pred"][clear]),
          "predicted classes differ from the JAX fixture")
    rec = {"phase": "serve", "rows": rows, "batches": batches,
           "launches": launches, "launches_per_batch": launches / batches,
           "edge_capacity": run["edge_capacity"],
           "node_capacity": run["node_capacity"],
           "fixture_rows": k, "max_score_err": score_err,
           "score_tol": SCORE_TOL, "wall_s": wall, "setup_s": run["setup_s"],
           "predict_s": run["predict_s"], "rows_per_s_wall": rows / wall,
           "rows_per_s_predict": rows / run["predict_s"],
           "pred_mean": float(out["pred"].mean()), "card": card, "ok": True}
    emit(rec)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        sys.path.insert(0, ROOT)
        import rmm_tpu_torch  # noqa: F401
        from rmm_tpu_torch.ops.build import build_all

        card = nvidia_smi()
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        emit({"phase": "device", "nvidia_smi": card, "kind": kind,
              "count": count, "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0]})
        t0 = time.perf_counter()
        logs = build_all()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "ptxas": [ln.strip() for log in logs.values()
                        for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]})
        edge, node = kernel_phase(card)[:2]
        serve = serve_phase(card)
        # Per served batch the path launches the kernel twice at each of
        # the two serving shapes: the times below are one such pair.
        pair_bound, pair_by = bound(edge["bytes_ms"] + node["bytes_ms"],
                                    edge["ops_ms"] + node["ops_ms"])
        emit({"kernels": [{
            "name": "column_attention_fwd", "route": "cuda",
            "source": "rmm_tpu_torch/csrc/column_attention.cu",
            "replaces": "rmm_tpu/ops/pallas/column_attention.py:165",
            "launches": serve["launches"],
            "max_abs_err": max(edge["max_abs_err"], node["max_abs_err"]),
            "ms": edge["kernel_ms"] + node["kernel_ms"],
            "plain_ms": edge["plain_ms"] + node["plain_ms"],
            "bound_ms": pair_bound, "bound_by": pair_by,
            "library_ms": edge["library_ms"] + node["library_ms"],
            "shapes": [[r[k] for k in "BSCH"] for r in (edge, node)],
            "ok": True}]})
        print(card, flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
