"""Sweep the tiled column-attention backward's rows a group on one CUDA card.

    python3 tools/torch_bwd_sweep.py

At the main path's two backward shapes (edge tokens 131072×6×32/8 and node
tokens 16384×2×32/8, both with the training keep-mask at dropout 0.083)
times the tiled kernel (+ its reduce) at the plan the wrapper picks and at
each rows-a-group that fits the card's shared memory (blocks of 256
threads; two an SM where the group leaves room for two, else one), with
CUDA events, warm, median of 5 windows of 20 calls. Each run's gradients
are held against the default plan's (relative to each tensor's largest
entry). Prints one JSON line per run; the card's name and power limit in
each. Other block sizes and launch bounds are variants of
``tools/torch_bwd_stages.py``.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import TRAIN_DROPOUT, emit, nvidia_smi, time_ms  # noqa: E402

SHAPES = [(131072, 6, 32, 8), (16384, 2, 32, 8)]
ROWS = {6: [4, 6, 8, 10, 12, 16, 20, 23], 2: [8, 16, 24, 32, 48, 64, 82]}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from rmm_tpu_torch.ops import column_attention as ca

    card = nvidia_smi()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = ca._kernel()
    budget = lib.rmm_cuda_max_smem_per_block()
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    p = TRAIN_DROPOUT
    for b, s, c, h in SHAPES:
        def t(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).to(dev)

        x, do = t(b, s, c), t(b, s, c)
        wqkv, bqkv, wout = t(c, 3 * c, scale=c ** -0.5), t(3 * c), t(
            c, c, scale=c ** -0.5)
        mask = torch.from_numpy(rng.rand(b, h, s, s) >= p).to(dev)
        args = (x, do, wqkv, bqkv, wout, h, mask, p)
        default = ca.bwd_plan(b, s, c, h)
        want = ca.column_attention_bwd(*args, plan=default)

        def run(label, plan):
            got = ca.column_attention_bwd(*args, plan=plan)
            err = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
            ms = time_ms(lambda: ca.column_attention_bwd(*args, plan=plan),
                         reps=20)
            ngroups = -(-b // plan.rows)
            emit({"phase": "bwd_sweep", "B": b, "S": s, "C": c, "H": h,
                  "dropout": p, "plan": label, "rows": plan.rows,
                  "tokens_a_group": plan.rows * s, "groups": ngroups,
                  "blocks": plan.grid,
                  "blocks_per_sm": (plan.grid // sms if plan.grid < ngroups
                                    else None),
                  "slices": plan.slices, "ms": ms, "max_rel_diff": err,
                  "card": card})

        run("default", default)
        for rows in ROWS[s]:
            if lib.rmm_column_attention_bwd_tiled_smem_bytes(
                    s, c, h, rows) <= budget:
                run("sweep", ca.bwd_plan(b, s, c, h, rows=rows))
        del x, do, mask, args, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
