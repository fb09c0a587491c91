"""Column attention at given shapes on one CUDA card.

    python3 tools/torch_attn_shapes.py --shapes 131072x5x32/8@0.1,... \
        [--precision f32|bf16] [--timing CALLS,WINDOWS]
    python3 tools/torch_attn_shapes.py --forms \
        --shapes 128x64x128/4@0.1,4096x167x32/8@0.083 [--precision bf16]
    python3 tools/torch_attn_shapes.py --shapes 4096x167x256/8@0 \
        --variants "kStreamBwdWarps=6,kStreamBwdMinBlocks=2;kFwdQ32=1"

A shape is ``BxSxC/H@p``: B rows of S tokens at width C and H heads, with
a keep-mask at dropout p.

By default each shape is recorded as ``chip_smoke.py``'s kernel phases
record it, with the keep-mask and without it: the forward and the backward
(float32: ``fwd_record`` and ``bwd_record``; bf16: ``bf16_pair``) against
the plain version, their kernel / plain / library times and the bound,
the inputs drawn on the card, each kernel timed over ``--timing`` (the
median of WINDOWS windows of CALLS calls, warm; the plain and library
calls over at most 2 windows). One JSON line a direction and shape.

``--forms`` times each shape's split-route attention in its two core
forms, staged (the shape's own plan, which must stage it) and direct (the
same plan with ``direct=True``: a block per (row, head) streaming the
row's chunks), in turns staged, direct, direct, staged, each direction on
the same inputs, and checks both against the plain version (the
backward's error relative to each tensor's largest entry) and against
each other (``bitwise_equal``: the direct form gives the staged long
cores' bits past S = 16). The plain version runs once a shape, untimed.
One JSON line a direction, shape and turn, with the card's name and power
limit.

``--variants`` builds copies of ``csrc/column_attention.cu`` with other
values of its compile-time constants (``NAME=VALUE`` pairs, a variant's
separated by commas, variants by semicolons; each names a ``constexpr
int`` line of the source, such as the streamed cores' ``kStreamWarps``,
``kStreamBwdWarps``, ``kStreamBwdMinBlocks`` or ``kFwdQ32``) into the
git-ignored ``rmm_tpu_torch/_build/attn_variants/``, all compilers at
once, and times each shape's float32 forward and backward (the shape's
keep-mask) with the checkout's library and each variant's in turns
(checkout, variants, the variants again backwards, checkout), each held
against the plain version; one JSON line a library, direction, shape and
turn, and each library's registers and spills of the streamed cores as
``ptxas`` reports them.
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (bf16_pair, bwd_record, card_inputs,  # noqa: E402
                        emit, fwd_record, keep_mask, nvidia_smi, time_ms)

TURNS = ("staged", "direct", "direct", "staged")


def parse_shape(text: str) -> tuple:
    """``BxSxC/H@p`` → (B, S, C, H, p)."""
    dims, rate = text.split("@")
    bsc, h = dims.split("/")
    b, s, c = map(int, bsc.split("x"))
    return b, s, c, int(h), float(rate)


def forms(card, b, s, c, h, rate, dtype, timing) -> None:
    """The staged and the direct form of one shape in turns."""
    import numpy as np
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    dev = torch.device("cuda")
    rng = np.random.RandomState(b + s + c)
    x, *w = (t.to(dtype) for t in card_inputs(rng, b, s, c, dev))
    do = card_inputs(rng, b, s, c, dev)[0].to(dtype)
    mask = keep_mask(rng, b, h, s, rate, dev) if rate else None
    fplan, bplan = ca.fwd_plan(b, s, c, h, dtype=dtype), ca.bwd_plan(
        b, s, c, h, dtype=dtype)
    if fplan.direct or bplan.direct:
        raise SystemExit(f"{b}x{s}x{c}/{h}: its plan is the direct form")
    plans = {"fwd": {"staged": fplan,
                     "direct": fplan._replace(direct=True, rows=1)},
             "bwd": {"staged": bplan,
                     "direct": bplan._replace(direct=True, rows=1)}}
    leaves = [t.detach().float().requires_grad_() for t in (x, *w)]
    ref = ca.reference_column_attention(*leaves, h, mask, rate)
    want = torch.autograd.grad(ref, leaves, do.float())
    calls = {
        "fwd": lambda p: ca.column_attention_fwd(x, *w, h, mask, rate,
                                                 plan=p),
        "bwd": lambda p: ca.column_attention_bwd(x, do, *w[:3], h, mask,
                                                 rate, plan=p)}
    for direction, call in calls.items():
        with torch.inference_mode():
            got = {form: call(p) for form, p in plans[direction].items()}
        if direction == "fwd":
            errs = {form: float((g.float() - ref.detach()).abs().max())
                    for form, g in got.items()}
            equal = torch.equal(got["staged"], got["direct"])
        else:
            errs = {form: max(float((a.float() - v).abs().max()
                                    / v.abs().max()) for a, v in zip(g, want))
                    for form, g in got.items()}
            equal = all(torch.equal(a, d) for a, d in
                        zip(got["staged"], got["direct"]))
        for turn, form in enumerate(TURNS):
            plan = plans[direction][form]
            with torch.inference_mode():
                ms = time_ms(lambda: call(plan), *timing)
            emit({"tool": "torch_attn_shapes", "mode": "forms",
                  "direction": direction, "B": b, "S": s, "C": c, "H": h,
                  "dropout": rate, "dtype": str(dtype).split(".")[-1],
                  "form": form, "turn": turn, "ms": ms,
                  "blocks": ca.core_blocks(plan, h),
                  "max_err": errs[form], "bitwise_equal": equal,
                  "card": card})
    del x, do, w, mask, leaves, ref, want
    torch.cuda.empty_cache()


VARIANT_DIR = os.path.join(ROOT, "rmm_tpu_torch", "_build", "attn_variants")


def build_variants(spec: str) -> list:
    """Each variant of ``spec`` built: (its text, the library's path, the
    streamed cores' ptxas lines)."""
    from rmm_tpu_torch.ops.build import KERNEL_SOURCES, start_cuda_build

    src = open(KERNEL_SOURCES["column_attention"]).read()
    shutil.rmtree(VARIANT_DIR, ignore_errors=True)
    builds = []
    for n, text in enumerate(spec.split(";")):
        body = src
        for pair in text.split(","):
            name, value = pair.split("=")
            body, hits = re.subn(rf"^constexpr int {name} = -?\d+;",
                                 f"constexpr int {name} = {int(value)};",
                                 body, flags=re.M)
            if hits != 1:
                raise SystemExit(f"no single constexpr int {name} line")
        out = os.path.join(VARIANT_DIR, f"v{n}")
        os.makedirs(out, exist_ok=True)
        path = os.path.join(out, "column_attention.cu")
        with open(path, "w") as f:
            f.write(body)
        builds.append((text, start_cuda_build(path, out,
                                              f"column_attention_v{n}")))
    out = []
    for text, b in builds:
        log = b.wait()
        out.append((text, b.out, stream_ptxas(log)))
    return out


def stream_ptxas(log: str) -> list:
    """The registers and spills ptxas reports for the streamed cores."""
    lines, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
        elif current and "stream_kernel" in current and (
                "registers" in line or "spill" in line):
            at = current.index("stream_kernel")
            lines.append(f"{current[at - 9:at + 30]}: {line.strip()}")
    return lines


def variants(card, shapes, libs, timing) -> None:
    """Each shape's float32 directions with the checkout's library and
    each variant's, in turns."""
    import numpy as np
    import torch

    from rmm_tpu_torch.ops import column_attention as ca

    sides = [("checkout", None, [])] + libs
    order = list(range(len(sides))) + list(range(len(sides) - 1, -1, -1))
    for side, (text, _, ptxas) in enumerate(sides):
        emit({"tool": "torch_attn_shapes", "mode": "variants",
              "variant": text or "checkout", "ptxas": ptxas, "card": card})
    dev = torch.device("cuda")
    for b, s, c, h, rate in shapes:
        rng = np.random.RandomState(b + s + c)
        x, *w = card_inputs(rng, b, s, c, dev)
        do = card_inputs(rng, b, s, c, dev)[0]
        mask = keep_mask(rng, b, h, s, rate, dev) if rate else None
        leaves = [t.detach().requires_grad_() for t in (x, *w)]
        ref = ca.reference_column_attention(*leaves, h, mask, rate)
        want = torch.autograd.grad(ref, leaves, do)
        calls = {
            "fwd": lambda: ca.column_attention_fwd(x, *w, h, mask, rate),
            "bwd": lambda: ca.column_attention_bwd(x, do, *w[:3], h, mask,
                                                   rate)}
        for direction, call in calls.items():
            for turn, side in enumerate(order):
                text, path, _ = sides[side]
                ca.use_library(path)
                with torch.inference_mode():
                    got = call()
                    if direction == "fwd":
                        err = float((got - ref.detach()).abs().max())
                    else:
                        err = max(float((a - v).abs().max() / v.abs().max())
                                  for a, v in zip(got, want))
                    ms = time_ms(call, *timing)
                emit({"tool": "torch_attn_shapes", "mode": "variants",
                      "variant": text or "checkout", "turn": turn,
                      "direction": direction, "B": b, "S": s, "C": c,
                      "H": h, "dropout": rate, "ms": ms, "max_err": err,
                      "card": card})
        ca.use_library(None)
        del x, do, w, mask, leaves, ref, want
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", required=True)
    ap.add_argument("--precision", default="f32", choices=("f32", "bf16"))
    ap.add_argument("--timing", default="10,5",
                    help="calls a window, windows")
    ap.add_argument("--forms", action="store_true")
    ap.add_argument("--variants", help="NAME=VALUE,...;... (see above)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = nvidia_smi()
    timing = tuple(map(int, args.timing.split(",")))
    dev = torch.device("cuda")
    if args.variants:
        variants(card, [parse_shape(t) for t in args.shapes.split(",")],
                 build_variants(args.variants), timing)
        return 0
    for text in args.shapes.split(","):
        b, s, c, h, rate = parse_shape(text)
        if args.forms:
            forms(card, b, s, c, h, rate, torch.bfloat16
                  if args.precision == "bf16" else torch.float32, timing)
            continue
        rng = np.random.RandomState(b + s + c)
        for p in (rate, 0.0) if rate else (0.0,):
            if args.precision == "bf16":
                bf16_pair(rng, dev, b, s, c, h, p, card, False, timing,
                          "torch_attn_shapes", card_inputs)
            else:
                for record in (fwd_record, bwd_record):
                    record(rng, dev, b, s, c, h, p, card, False, timing,
                           "torch_attn_shapes", card_inputs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
