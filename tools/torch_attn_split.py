"""The split column-attention routes (C = 96..128, and every C that is not
a multiple of 4) on one CUDA card: the forward's three launches and the
backward's five timed against their bounds, and a sweep of the backward's
GEMM knobs.

    python3 tools/torch_attn_split.py [--direction fwd,bwd]
                                      [--shapes edge,target] [--sweep]
    python3 tools/torch_attn_split.py --shapes long40x128,long54x128 \
                                      --precision bf16

At the SSL path's shapes (edge tokens 131072×6×128/8 and target rows
13000×6×128/8), or at the narrow shapes (``--shapes narrow126,narrow30``:
32768×6×126/6 and 131072×6×30/6, the GEMMs' narrow form; ``aligned128``,
32768×6×128/8, is the first one's aligned twin), each with the 0.5
keep-mask, or past S = 16 (``--shapes long40x128,long54x128``:
4096×40×128/8 and 4096×54×128/8 without a keep-mask, the split routes'
long cores at the shapes where the library call times them), or past
``max_s`` (``--shapes direct167x256,direct600x32``: 4096×167×256/8 and
256×600×32/8 without a keep-mask, the direct form's streamed cores), the
forward (``--direction fwd``) is checked against the plain version
(absolute error) and timed:

* the whole forward (``column_attention_fwd``, its three launches and the
  scratch allocation), with CUDA events, warm, median of 5 windows;
* each launch by its device time from ``torch.profiler`` over 10 calls:
  the projection (x·Wqkv + b), the attention core and the output
  projection (ctx·Wout + b), each beside its own bound. The two GEMM
  launches run one kernel (``gemm_kernel<false, true, ...>``), so they
  are told apart by their order within a call.

The backward (``--direction bwd``) is checked against autograd of the
plain version (relative to each reference tensor's largest entry) and
timed:

* the whole backward (``column_attention_bwd``, its five launches and the
  scratch allocations), with CUDA events, warm, median of 5 windows;
* each launch by its device time from ``torch.profiler`` over 10 calls:
  the projections (``gemm_kernel<false, true, ...>``), the attention core,
  dx (``gemm_kernel<false, false, ...>``), the weight gradients
  (``gemm_kernel<true, true, ...>``) and the reduce, each beside its own
  bound (the larger of its bytes over 3.35 TB/s and its FMAs, 2 flops
  each, over 67 TFLOP/s: one H100 SXM's published peaks).

``--precision bf16`` gives both directions bf16 x, do and weights (the
bf16 build: at C % 4 = 0 its GEMM launches run the tensor-core kernel
``mma_gemm_kernel`` of ``csrc/gemm_mma.cuh``, at other widths the FMA
``gemm_kernel`` of ``csrc/gemm_f32.cuh``; float32 sums and token rows) and
checks them as ``chip_smoke.py``'s ``kernel_bf16`` phase does (out and dx
within one bf16 rounding of the plain version on the same values, the
weight gradients at ``GRAD_TOL``). Each launch names the GEMM kernel it
ran (``mma`` or ``fma``). A bf16 GEMM launch's bound counts its bf16 and
float32 bytes over 3.35 TB/s and its FLOPs over 989 TFLOP/s (a float32
operand's products twice: its hi and lo bf16 terms); the cores and the
reduce run on float32 rows as in the float32 build and keep its bounds.
Beside each GEMM launch, ``matmul_ms`` times ``torch.matmul`` of the same
products on operands of the same dtypes (a yardstick the port never
calls): bf16 × bf16 as one bf16 product (a bf16 output), a float32
operand's products in float32 (its bf16 partner cast up beforehand).

``--sweep`` builds variants of ``csrc/column_attention.cu`` with other
values of the GEMM's compile-time constants in ``csrc/gemm_f32.cuh``
(``kBK``, ``kStages``, ``kMinBlocks``: a copy of the header with those
lines replaced, beside a copy of the source, built with the port's own
nvcc flags into the git-ignored ``rmm_tpu_torch/_build/split_sweep/``)
and times each at the edge shape, in turns, at the plan's splits and at
a half and twice as many. Prints one JSON line per measurement, the card's name
and power limit in each, and the registers and spills ``ptxas`` reports.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (GRAD_TOL, KERNEL_TOL,  # noqa: E402
                        PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S,
                        PEAK_F32_FLOP_PER_S, SSL_DROPOUT, bf16_close, bound,
                        emit, nvidia_smi, time_ms)

SHAPES = {"edge": (131072, 6, 128, 8, SSL_DROPOUT),
          "target": (13000, 6, 128, 8, SSL_DROPOUT),
          "narrow126": (32768, 6, 126, 6, SSL_DROPOUT),
          "aligned128": (32768, 6, 128, 8, SSL_DROPOUT),
          "narrow30": (131072, 6, 30, 6, SSL_DROPOUT),
          "long40x128": (4096, 40, 128, 8, 0.0),
          "long54x128": (4096, 54, 128, 8, 0.0),
          "direct167x256": (4096, 167, 256, 8, 0.0),
          "direct600x32": (256, 600, 32, 8, 0.0)}
# (kBK, kStages, kMinBlocks) of each sweep variant; the checkout's values
# are the first
VARIANTS = [(16, 3, 2), (16, 2, 2), (16, 4, 2), (32, 3, 2), (32, 2, 2),
            (16, 3, 1), (16, 4, 1), (32, 3, 1), (32, 2, 1)]
OUT = os.path.join(ROOT, "rmm_tpu_torch", "_build", "split_sweep")


def one_bound(nbytes, flops, peak=PEAK_F32_FLOP_PER_S):
    """The least time (ms) for ``nbytes`` moved and ``flops`` done at
    ``peak`` FLOP/s, and what sets it."""
    return bound(nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3)


def bf16_gemm_bounds(direction, b, s, c, slices) -> dict:
    """The bf16 build's GEMM launches' least times (ms): bf16 x, do,
    weights, out and dx (2 bytes), float32 token rows and partials (4),
    each read or written once; FLOPs over the bf16 tensor-core peak, a
    float32 operand's products counted twice (hi and lo)."""
    n, total = b * s, 4 * c * c + 4 * c
    peak = PEAK_BF16_FLOP_PER_S
    if direction == "fwd":
        return {
            "projection": one_bound(2 * (n * c + 3 * c * c + 3 * c)
                                    + 4 * 3 * n * c, 2 * n * c * 3 * c,
                                    peak),
            "output": one_bound(4 * n * c + 2 * (c * c + c + n * c),
                                2 * 2 * n * c * c, peak),
        }
    return {
        "projections": one_bound(2 * (2 * n * c + 4 * c * c + 3 * c)
                                 + 4 * 4 * n * c, 2 * n * c * 4 * c, peak),
        "dx": one_bound(4 * 3 * n * c + 2 * (3 * c * c + n * c),
                        2 * 2 * n * 3 * c * c, peak),
        "weight_grads": one_bound(2 * 2 * n * c + 4 * (4 * n * c
                                                       + slices * total),
                                  2 * (2 * n * c * 4 * c) + n * 4 * c,
                                  peak),
    }


def matmul_yardsticks(direction, b, s, c) -> dict:
    """ms of ``torch.matmul`` of each GEMM launch's products on random
    operands of the launch's dtypes (bf16 x, do and weights, float32 token
    rows): bf16 × bf16 in bf16, a float32 operand's products in float32."""
    import torch

    n = b * s
    gen = torch.Generator("cuda").manual_seed(0)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    x, do = r(n, c), r(n, c)
    wqkv, wout = r(c, 3 * c), r(c, c)
    f32 = torch.float32
    if direction == "fwd":
        ctx, wout32 = r(n, c, dtype=f32), wout.float()
        calls = {"projection": lambda: torch.matmul(x, wqkv),
                 "output": lambda: torch.matmul(ctx, wout32)}
    else:
        dqkv, ctx_t = r(n, 3 * c, dtype=f32), r(c, n, dtype=f32)
        wqkv_t32, x_t32, do32 = wqkv.t().float(), x.t().float(), do.float()
        calls = {"projections": lambda: (torch.matmul(x, wqkv),
                                         torch.matmul(do, wout.t())),
                 "dx": lambda: torch.matmul(dqkv, wqkv_t32),
                 "weight_grads": lambda: (torch.matmul(x_t32, dqkv),
                                          torch.matmul(ctx_t, do32))}
    return {k: time_ms(f) for k, f in calls.items()}


def fwd_launch_bounds(b, s, c, h, masked) -> dict:
    """The split forward's launches' least times (ms) and what sets each:
    bytes each input read once and each output written once, FMAs as 2
    flops (the softmax's few operations a score not counted)."""
    n, hd = b * s, c // h
    return {
        "projection": one_bound(4 * (n * c + 3 * c * c + 3 * c + 3 * n * c),
                                2 * n * c * 3 * c),
        "core": one_bound(4 * 4 * n * c + (b * h * s * s if masked else 0),
                          2 * 2 * b * h * s * s * hd),
        "output": one_bound(4 * (2 * n * c + c * c + c), 2 * n * c * c),
    }


def launch_bounds(b, s, c, h, masked, slices) -> dict:
    """Each backward launch's least time (ms) and what sets it: bytes each
    input read once and each output written once, FMAs as 2 flops and adds
    as one."""
    n, total = b * s, 4 * c * c + 4 * c
    hd = c // h
    return {
        "projections": one_bound(
            4 * (2 * n * c + 4 * c * c + 3 * c + 4 * n * c),
            2 * n * c * 4 * c),
        "core": one_bound(4 * 8 * n * c + (b * h * s * s if masked else 0),
                          2 * 6 * b * h * s * s * hd),
        "dx": one_bound(4 * (3 * n * c + 3 * c * c + n * c),
                        2 * n * 3 * c * c),
        "weight_grads": one_bound(4 * (6 * n * c + slices * total),
                                  2 * n * 4 * c * c + n * 4 * c),
        "reduce": one_bound(4 * (slices * total + total), slices * total),
    }


def gemm_family(name: str) -> str | None:
    """``mma`` for the tensor-core GEMM (``csrc/gemm_mma.cuh``), ``fma``
    for the FMA tiles (``csrc/gemm_f32.cuh``), None for another kernel."""
    if "mma_gemm_kernel" in name:
        return "mma"
    return "fma" if "gemm_kernel" in name else None


def kernel_kind(name: str) -> str | None:
    if "bwd_core" in name:
        return "core"
    if "bwd_reduce" in name:
        return "reduce"
    if "gemm_kernel" in name:
        # [mma_]gemm_kernel<rmm_gemm::Spec<AK, BK, ...>, ...>: the first
        # Spec's layouts
        flags = name[name.index("gemm_kernel"):].replace(" ", "").replace(
            "rmm_gemm::Spec<", "")
        if flags.startswith("gemm_kernel<false,true"):
            return "projections"
        if flags.startswith("gemm_kernel<false,false"):
            return "dx"
        if flags.startswith("gemm_kernel<true,true"):
            return "weight_grads"
    return None


def inputs(b, s, c, h, rate, seed=0, precision="f32"):
    """x, do, the weights (in bf16 at ``precision`` bf16) and the keep-mask
    (None at ``rate`` 0)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).cuda()

    x, do = t(b, s, c), t(b, s, c)
    w = (t(c, 3 * c, scale=c ** -0.5), t(3 * c, scale=0.1),
         t(c, c, scale=c ** -0.5), t(c, scale=0.1))
    mask = (torch.from_numpy(rng.rand(b, h, s, s) >= rate).cuda() if rate
            else None)
    if precision == "bf16":
        x, do, w = x.bfloat16(), do.bfloat16(), [v.bfloat16() for v in w]
    return x, do, w, mask


def profiled(call, reps: int):
    """``torch.profiler`` over ``reps`` calls of ``call`` (after one
    warm-up call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return prof


def profile_fwd_launches(call, reps: int = 10) -> dict:
    """Device ms a call of each of the split forward's launches, and how
    many of each the profile saw (``reps`` of each if all were traced):
    the GEMM launches alternate, the projection first."""
    from torch.autograd import DeviceType

    prof = profiled(call, reps)
    kernels = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    ms: dict = {}
    seen: dict = {}
    family: dict = {}
    gemms = 0
    for e in kernels:
        if "fwd_core" in e.name:
            kind = "core"
        elif "gemm_kernel" in e.name:
            kind = ("projection", "output")[gemms % 2]
            gemms += 1
            family.setdefault(kind, set()).add(gemm_family(e.name))
        else:
            continue
        ms[kind] = ms.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
        seen[kind] = seen.get(kind, 0) + 1
    return {"ms": ms, "seen": seen,
            "gemm": {k: sorted(v) for k, v in family.items()}}


def profile_launches(call, reps: int = 10) -> tuple[dict, dict]:
    """Device ms a call of each of the split backward's launches, and the
    GEMM kernel (``mma`` or ``fma``) each GEMM launch ran."""
    prof = profiled(call, reps)
    out: dict = {}
    family: dict = {}
    for e in prof.key_averages():
        kind = kernel_kind(e.key)
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if kind is not None and us > 0:
            out[kind] = out.get(kind, 0.0) + us / 1e3 / reps
            if gemm_family(e.key):
                family.setdefault(kind, set()).add(gemm_family(e.key))
    return out, {k: sorted(v) for k, v in family.items()}


def fwd_shape_run(card, name, b, s, c, h, rate, precision):
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    x, _, w, mask = inputs(b, s, c, h, rate, precision=precision)
    args = (x, *w, h, mask, rate)
    with torch.inference_mode():
        out = ca.column_attention_fwd(*args)
        ref = ca.reference_column_attention(x, *(v.float() for v in w), h,
                                            mask, rate)
        err = float((out.float() - ref.float()).abs().max())
        ok = (err <= KERNEL_TOL if precision == "f32"
              else bf16_close(out, ref) <= 0)
        del out, ref
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def call():
            return ca.column_attention_fwd(*args)

        ms = time_ms(call)
        scratch = torch.cuda.max_memory_allocated() - base
        per_launch = profile_fwd_launches(call)
    bounds = fwd_launch_bounds(b, s, c, h, mask is not None)
    matmul = {}
    if precision != "f32":
        bounds.update(bf16_gemm_bounds("fwd", b, s, c, 0))
        matmul = matmul_yardsticks("fwd", b, s, c)
    emit({"tool": "torch_attn_split", "direction": "fwd", "shape": name,
          "B": b, "S": s, "C": c, "H": h, "dropout": rate,
          "precision": precision,
          "route": ca.route(c, s),
          "plan": ca.fwd_plan(b, s, c, h, dtype=x.dtype)._asdict(),
          "max_abs_err": err,
          "tol": KERNEL_TOL if precision == "f32" else "one bf16 rounding",
          "ok": ok, "ms": ms,
          "scratch_gb": scratch / 1e9,
          "launches": {k: {"ms": per_launch["ms"].get(k),
                           "seen": per_launch["seen"].get(k),
                           "gemm": per_launch["gemm"].get(k),
                           "bound_ms": v[0], "bound_by": v[1],
                           "matmul_ms": matmul.get(k)}
                       for k, v in bounds.items()},
          "launches_sum_ms": sum(per_launch["ms"].values()), "card": card})
    return ok


def shape_run(card, name, b, s, c, h, rate, precision):
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    x, do, (wqkv, bqkv, wout, bout), mask = inputs(b, s, c, h, rate,
                                                   precision=precision)
    plan = ca.bwd_plan(b, s, c, h, dtype=x.dtype)
    got = ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h, mask, rate)
    leaves = [x.detach().requires_grad_()] + [
        t.detach().float().requires_grad_() for t in (wqkv, bqkv, wout,
                                                      bout)]
    out = ca.reference_column_attention(*leaves, h, mask, rate)
    want = torch.autograd.grad(out, leaves, do)
    errs = [float((g.float() - w.float()).abs().max() / w.float().abs().max())
            for g, w in zip(got, want)]
    ok = (max(errs) <= GRAD_TOL if precision == "f32"
          else bf16_close(got[0], want[0]) <= 0 and max(errs[1:]) <= GRAD_TOL)
    del out, want, leaves, got
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()

    def call():
        return ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h, mask,
                                       rate)

    ms = time_ms(call)
    scratch = torch.cuda.max_memory_allocated() - base
    per_launch, family = profile_launches(call)
    bounds = launch_bounds(b, s, c, h, mask is not None, plan.slices)
    matmul = {}
    if precision != "f32":
        bounds.update(bf16_gemm_bounds("bwd", b, s, c, plan.slices))
        matmul = matmul_yardsticks("bwd", b, s, c)
    emit({"tool": "torch_attn_split", "direction": "bwd", "shape": name,
          "B": b, "S": s, "C": c, "H": h, "dropout": rate,
          "precision": precision, "route": ca.route(c, s),
          "plan": plan._asdict(), "max_rel_err": errs, "tol": GRAD_TOL,
          "ok": ok, "ms": ms,
          "scratch_gb": scratch / 1e9,
          "launches": {k: {"ms": per_launch.get(k), "gemm": family.get(k),
                           "bound_ms": v[0], "bound_by": v[1],
                           "matmul_ms": matmul.get(k)}
                       for k, v in bounds.items()},
          "launches_sum_ms": sum(per_launch.values()), "card": card})
    return ok


def sweep(card):
    import torch

    from rmm_tpu_torch.ops import column_attention as ca
    from rmm_tpu_torch.ops.build import KERNEL_SOURCES, start_cuda_build

    src = KERNEL_SOURCES["column_attention"]
    header = open(os.path.join(os.path.dirname(src), "gemm_f32.cuh")).read()
    builds = {}
    for bk, stages, min_blocks in VARIANTS:
        out = os.path.join(OUT, f"bk{bk}_st{stages}_mb{min_blocks}")
        os.makedirs(out, exist_ok=True)
        variant = header
        for name, value in (("kBK", bk), ("kStages", stages),
                            ("kMinBlocks", min_blocks)):
            variant, n = re.subn(rf"constexpr int {name} = \d+;",
                                 f"constexpr int {name} = {value};", variant)
            assert n == 1, name
        with open(os.path.join(out, "gemm_f32.cuh"), "w") as f:
            f.write(variant)
        shutil.copy(src, out)
        # nvcc finds the header beside the source before the package's
        builds[(bk, stages, min_blocks)] = start_cuda_build(
            os.path.join(out, os.path.basename(src)), out)
    libs = {}
    for key, bld in builds.items():
        log = bld.wait()
        libs[key] = bld.out
        emit({"tool": "torch_attn_split", "variant": key, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "gemm_kernel" in ln or "registers" in ln or "spill" in ln][-12:]})
    b, s, c, h, rate = SHAPES["edge"]
    x, do, (wqkv, bqkv, wout, _), mask = inputs(b, s, c, h, rate)
    want = None
    for rnd in range(2):
        for key, lib in libs.items():
            ca.use_library(lib)
            base = ca.bwd_plan(b, s, c, h)
            for mult in (0.5, 1, 2):
                n = b * s
                splits = max(1, int(base.slices * mult))
                tokens = -(-n // splits)
                plan = base._replace(split_tokens=tokens,
                                     slices=-(-n // tokens))
                got = ca.column_attention_bwd(x, do, wqkv, bqkv, wout, h,
                                              mask, rate, plan=plan)
                if want is None:
                    want = [g.clone() for g in got]
                diff = max(float((g - w).abs().max() / w.abs().max())
                           for g, w in zip(got, want))
                ms = time_ms(lambda: ca.column_attention_bwd(
                    x, do, wqkv, bqkv, wout, h, mask, rate, plan=plan))
                per = profile_launches(lambda: ca.column_attention_bwd(
                    x, do, wqkv, bqkv, wout, h, mask, rate, plan=plan),
                    5)[0]
                emit({"tool": "torch_attn_split", "round": rnd,
                      "variant": {"BK": key[0], "stages": key[1],
                                  "min_blocks": key[2]},
                      "slices": plan.slices, "split_tokens": tokens,
                      "ms": ms, "launches_ms": per,
                      "max_rel_diff": diff, "card": card})
        torch.cuda.empty_cache()
    ca.use_library()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--direction", default="fwd,bwd",
                    help="fwd, bwd or both, comma-separated")
    ap.add_argument("--shapes", default="edge,target")
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from rmm_tpu_torch.ops.build import build_all

    card = nvidia_smi()
    logs = build_all()
    emit({"tool": "torch_attn_split", "card": card, "ptxas": [
        ln.strip() for log in logs.values() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln]})
    runs = {"fwd": fwd_shape_run, "bwd": shape_run}
    ok = True
    for direction in args.direction.split(","):
        for name in args.shapes.split(","):
            if name:
                ok &= runs[direction](card, name, *SHAPES[name],
                                      args.precision)
    if args.sweep:
        sweep(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
