"""Sweep the tiled column-attention kernels' rows a group on one CUDA card.

    python3 tools/torch_attn_sweep.py [--directions fwd,bwd] [--source F]

At the main path's shapes (edge tokens 131072×6×32/8 and node tokens
16384×2×32/8) times each tiled kernel at the plan the wrapper picks and at
each rows-a-group that fits the card's shared memory, with CUDA events,
warm, median of 5 windows of 20 calls. Blocks have 256 threads; as many
run on an SM as the group's shared memory and the kernel's registers let
(``blocks_per_sm``, from the launch's occupancy). The forward runs without
and with the training keep-mask (dropout 0.083) at the edge shape and
without it at the node shape; the backward (+ its reduce) with the
keep-mask at both. Each run's result is held against the default plan's
(relative to each tensor's largest entry). Prints one JSON line per run;
the card's name and power limit in each. Other block sizes and launch
bounds are variants of ``tools/torch_attn_stages.py``. ``--source`` times
the kernels built from another copy of ``csrc/column_attention.cu`` (the
parent commit's, say), with the port's own nvcc flags, in place of the
checkout's.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import TRAIN_DROPOUT, emit, nvidia_smi, time_ms  # noqa: E402

# (B, S, C, H, dropout) and the rows a group to try, by direction
CASES = {
    "fwd": [((131072, 6, 32, 8, 0.0),
             [6, 8, 11, 14, 16, 18, 21, 24, 28, 40, 62]),
            ((131072, 6, 32, 8, TRAIN_DROPOUT), [11, 16, 21, 28, 40]),
            ((16384, 2, 32, 8, 0.0), [16, 24, 36, 54, 70, 90, 128, 197])],
    "bwd": [((131072, 6, 32, 8, TRAIN_DROPOUT),
             [4, 6, 8, 10, 12, 16, 20, 23]),
            ((16384, 2, 32, 8, TRAIN_DROPOUT),
             [8, 16, 24, 32, 48, 64, 82])],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--directions", default="fwd,bwd")
    ap.add_argument("--source")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from rmm_tpu_torch.ops import column_attention as ca

    card = nvidia_smi()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if args.source:
        from rmm_tpu_torch.ops.build import start_cuda_build

        build = start_cuda_build(args.source, os.path.join(
            ROOT, "rmm_tpu_torch", "_build", "sweep"))
        build.wait()
        ca.use_library(build.out)
    lib = ca._kernel()
    budget = lib.rmm_cuda_max_smem_per_block()
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    for direction in args.directions.split(","):
        for (b, s, c, h, p), rows_list in CASES[direction]:
            def t(*shape, scale=1.0):
                return torch.from_numpy(
                    (rng.randn(*shape) * scale).astype(np.float32)).to(dev)

            x, do = t(b, s, c), t(b, s, c)
            wqkv, bqkv, wout, bout = (t(c, 3 * c, scale=c ** -0.5), t(3 * c),
                                      t(c, c, scale=c ** -0.5), t(c))
            mask = (torch.from_numpy(rng.rand(b, h, s, s) >= p).to(dev)
                    if p > 0 else None)
            if direction == "fwd":
                plan_of, smem = ca.fwd_plan, (
                    lib.rmm_column_attention_fwd_tiled_smem_bytes)

                def call(plan):
                    return (ca.column_attention_fwd(
                        x, wqkv, bqkv, wout, bout, h, mask, p, plan=plan),)
            else:
                plan_of, smem = ca.bwd_plan, (
                    lib.rmm_column_attention_bwd_tiled_smem_bytes)

                def call(plan):
                    return ca.column_attention_bwd(x, do, wqkv, bqkv, wout,
                                                   h, mask, p, plan=plan)
            default = plan_of(b, s, c, h)
            want = call(default)

            def run(label, plan):
                got = call(plan)
                err = max(float((g - w).abs().max() / w.abs().max())
                          for g, w in zip(got, want))
                ms = time_ms(lambda: call(plan), reps=20)
                ngroups = -(-b // plan.rows)
                emit({"phase": f"{direction}_sweep",
                      "source": args.source or "checkout", "B": b, "S": s,
                      "C": c, "H": h, "dropout": p, "plan": label,
                      "rows": plan.rows,
                      "tokens_a_group": plan.rows * s, "groups": ngroups,
                      "blocks": plan.grid,
                      "blocks_per_sm": (plan.grid // sms
                                        if plan.grid < ngroups else None),
                      "ms": ms, "max_rel_diff": err, "card": card})

            run("default", default)
            for rows in rows_list:
                if smem(s, c, h, rows) <= budget:
                    run("sweep", plan_of(b, s, c, h, rows=rows))
            del x, do, mask, want
            torch.cuda.empty_cache()
    ca.use_library()
    return 0


if __name__ == "__main__":
    sys.exit(main())
