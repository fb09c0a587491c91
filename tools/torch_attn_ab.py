"""Column attention of two checkouts on one CUDA card, in turns.

    python3 tools/torch_attn_ab.py --other DIR [--cases all|direct|long]
                                   [--timing CALLS,WINDOWS]

Times the forward and the backward (+ its reduce) of this checkout's
``rmm_tpu_torch`` and of the one under ``DIR`` (another commit's package,
unpacked there by ``git archive <commit> rmm_tpu_torch | tar -x -C DIR``)
on the same seeded inputs, at ``chip_smoke.py``'s shapes:

* float32 and bf16 at the narrow shapes (``NARROW_SHAPES``, unmasked),
  where a checkout takes them (a side that refuses prints its refusal);
* float32 at the main path's tiled shape 131072×6×32/8 (the forward
  unmasked, the backward with the training keep-mask) and the SSL path's
  split shape (``SSL_SHAPES[0]``, with its keep-mask);
* bf16 at the SSL path's split shapes (``SSL_SHAPES``: 131072×6×128/8 and
  13000×6×128/8, with the 0.5 keep-mask and without it) and at
  32768×6×100/4 (bf16 rows of C % 8 = 4);
* past S = 16 (the split routes' long cores), both directions with the
  node path's keep-mask (dropout 0.083) and without it, in float32 and
  bf16: the node shape 4096×167×32/8, 4096×40×128/8, 4096×17×32/8,
  4096×65×32/8, 4096×195×32/8 and 4096×54×128/8 (``chip_smoke.py``'s
  ``kernel_long`` shapes at a node capacity of 4096);
* past ``max_s`` (the direct form), the same way: 4096×167×256/8,
  4096×130×256/8, Elliptic's 2048×167×256/8 at ``--n_hidden 256``,
  256×600×32/8 and 256×520×256/8 (``chip_smoke.py``'s ``kernel_wide``
  direct shapes). ``--cases direct`` times these alone, ``--cases long``
  the staged long cores' shapes above alone.

Each side runs in a process of its own (the two packages share a name), in
the order other, self, self, other; both sides' kernels are built first,
all compilers at once. A measurement is ``chip_smoke.time_ms``: CUDA
events, warm, the median of 5 windows of 10 calls (``--timing 3,3``: of 3
windows of 3 calls, for a side whose direct form takes ~0.4 s a call).
Each side's result is held against the plain version (the forward's
absolute error, the backward's relative to each tensor's largest entry).
The plain version's, the library call's and the bound's times at these
shapes are those of ``chip_smoke.py``'s kernel phases. One JSON line per measurement, each
with the side, its package's path and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (NARROW_SHAPES, NODE_S, SSL_SHAPES,  # noqa: E402
                        TRAIN_DROPOUT)

ORDER = ("other", "self", "self", "other")
NARROW = [sh[:4] for sh in NARROW_SHAPES if sh[4] == 0.0]
TILED = (131072, 6, 32, 8)
# past S = 16: (B, S, C, H) and the dtypes each is timed in
LONG = [((4096, s, c, 8), ("float32", "bfloat16"))
        for s, c in ((NODE_S, 32), (40, 128), (17, 32), (65, 32),
                     (195, 32), (54, 128))]
# past max_s: the direct form
DIRECT = [((b, s, c, h), ("float32", "bfloat16"))
          for b, s, c, h in ((4096, NODE_S, 256, 8), (4096, 130, 256, 8),
                             (2048, NODE_S, 256, 8), (256, 600, 32, 8),
                             (256, 520, 256, 8))]
# the bf16 split shapes at C % 4 = 0 and S <= 16 (B, S, C, H, dropout)
BF16_SPLIT = SSL_SHAPES + [(32768, 6, 100, 4, 0.0)]
# (B, S, C, H, dropout, dtype) a direction
CASES = {
    d: [(*n, 0.0, "float32") for n in NARROW]
    + [(*TILED, rate, "float32"), (*SSL_SHAPES[0], "float32")]
    + [(*n, 0.0, "bfloat16") for n in NARROW]
    + [(*sh, "bfloat16") for sh in BF16_SPLIT]
    + [(*shape, p, dtype) for shape, dtypes in LONG + DIRECT
       for dtype in dtypes for p in (TRAIN_DROPOUT, 0.0)]
    for d, rate in (("fwd", 0.0), ("bwd", TRAIN_DROPOUT))
}
PICKED = {name: {d: [(*shape, p, dtype) for shape, dtypes in shapes
                     for dtype in dtypes for p in (TRAIN_DROPOUT, 0.0)]
                 for d in ("fwd", "bwd")}
          for name, shapes in (("direct", DIRECT), ("long", LONG))}


def route_of(ca, c: int, s: int) -> str:
    """The route a side's package takes: by width and S, or, in a package
    from before rows past 16 tokens ran, by width alone."""
    try:
        return ca.route(c, s)
    except TypeError:
        return ca.route(c)


def child(root: str, label: str, cases: dict, timing: tuple) -> int:
    """One side's measurements of ``cases``, with ``root``'s package, each
    timed over ``timing`` = (calls, windows)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from chip_smoke import nvidia_smi, random_inputs, time_ms
    from rmm_tpu_torch.ops import column_attention as ca

    card = nvidia_smi()
    package = os.path.dirname(os.path.dirname(os.path.abspath(ca.__file__)))
    assert os.path.samefile(package, os.path.join(root, "rmm_tpu_torch"))
    dev = torch.device("cuda")
    for direction, shapes in cases.items():
        for b, s, c, h, rate, dtype in shapes:
            rng = np.random.RandomState(b + c)
            dt = getattr(torch, dtype)
            x, *w = [t.to(dt) for t in random_inputs(rng, b, s, c, dev)]
            do = random_inputs(rng, b, s, c, dev)[0].to(dt)
            # the keep-mask drawn on the card (the long shapes' take
            # gigabytes), from a seed both sides share
            gen = torch.Generator(dev).manual_seed(b + c)
            mask = (torch.rand(b, h, s, s, generator=gen, device=dev) >= rate
                    if rate else None)
            rec = {"tool": "torch_attn_ab", "side": label, "root": root,
                   "direction": direction, "B": b, "S": s, "C": c, "H": h,
                   "dropout": rate, "dtype": dtype,
                   "route": route_of(ca, c, s),
                   "card": card}
            leaves = [v.detach().float().requires_grad_() for v in (x, *w)]
            ref = ca.reference_column_attention(*leaves, h, mask, rate)
            try:
                ca._check_cuda_inputs(x, *w, mask)
                if direction == "fwd":
                    def call():
                        with torch.inference_mode():
                            return ca.fused_column_attention(x, *w, h, mask,
                                                             rate)
                    rec["max_abs_err"] = float(
                        (call().float() - ref.detach()).abs().max())
                else:
                    def call():
                        return ca.column_attention_bwd(x, do, *w[:3], h,
                                                       mask, rate)
                    want = torch.autograd.grad(ref, leaves, do.float())
                    rec["max_rel_err"] = max(
                        float((g.float() - v).abs().max() / v.abs().max())
                        for g, v in zip(call(), want))
                rec["ms"] = time_ms(call, *timing)
            except (NotImplementedError, RuntimeError, AttributeError) as e:
                rec["refused"] = f"{type(e).__name__}: {e}"
            print(json.dumps(rec), flush=True)
            del x, do, w, mask, leaves, ref
            torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--cases", default="all",
                    choices=("all", "direct", "long"))
    ap.add_argument("--timing", default="10,5",
                    help="calls a window, windows")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--label", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        reps, windows = map(int, args.timing.split(","))
        return child(args.child, args.label,
                     PICKED.get(args.cases, CASES),
                     (reps, windows))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    roots = {"self": ROOT, "other": os.path.abspath(args.other)}
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from rmm_tpu_torch.ops.build import build_all; build_all()")
    builds = [subprocess.Popen([sys.executable, "-c", build, r])
              for r in roots.values()]
    if any(p.wait() for p in builds):
        print("a build failed", file=sys.stderr)
        return 1
    for label in ORDER:
        if subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", roots[label], "--label", label,
                           "--cases", args.cases, "--timing",
                           args.timing]).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
