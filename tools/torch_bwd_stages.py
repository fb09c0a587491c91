"""Where the tiled column-attention backward spends its time, by stage.

    python3 tools/torch_bwd_stages.py [--variants base,lb3,tok_b8,...]

Builds an instrumented copy of ``rmm_tpu_torch/csrc/column_attention.cu``
with ``nvcc`` (into the git-ignored ``rmm_tpu_torch/_build/stages/``): in
the tiled kernel, thread 0 of every block reads ``clock64()`` as it leaves
each barrier and adds the time since the last one to a per-stage counter.
A stage's count is therefore the block's time from the barrier before the
stage to the barrier after it (its slowest thread, plus the wait): A (x, do
and keep-mask loads), B (qkv, dctx), C (softmax), D (dqkv) and E+F (dx and
the weight gradients; the last group's E+F is counted after the loop).
Cycles are turned into ms at the card's maximum SM clock.

Each ``--variants`` entry is the kernel with one text substitution, built
and timed in turns with the others (two rounds):

* ``base``      — the source as it is (blocks of 256 threads, launch bounds
  for two an SM);
* ``lb3``       — ``__launch_bounds__`` for three blocks of 256 an SM (the
  smallest plan's group, 6 rows at S = 6, leaves room in shared memory for
  three);
* ``t512``      — blocks of 512 threads, launch bounds for one an SM;
* ``tok_b8``    — stage-B tiles of 8 tokens (4 in the source);
* ``tok_e4``    — stage-E tiles of 4 tokens (2 in the source);
* ``no_unroll`` — without the ``#pragma unroll 4`` of the k and token
  loops;
* ``skip_loads`` — stage A loads nothing from device memory (the stages
  run on whatever the buffers hold, so its gradients are wrong): the most
  that overlapping the next group's loads with this one's work could
  save.

Runs the main path's two backward shapes with the training keep-mask
(edge tokens 131072×6×32/8, node tokens 16384×2×32/8) at a few rows a
group (each variant's blocks an SM from the occupancy of its own build),
and prints one JSON line per run, the card's name and power limit in each,
and the registers and spills ``ptxas`` reports for the main path's
instantiations.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import TRAIN_DROPOUT, emit, nvidia_smi  # noqa: E402

SOURCE = os.path.join(ROOT, "rmm_tpu_torch", "csrc", "column_attention.cu")
OUT = os.path.join(ROOT, "rmm_tpu_torch", "_build", "stages")
STAGES = ["staging + E+F", "A", "B", "C", "D", "last E+F"]
ROWS = {6: [6, 10, 20], 2: [16, 32, 64]}   # rows a group, by S
LAUNCH_BOUNDS = "__launch_bounds__(kTiledThreads, MAXT == 1 ? 2 : 1)"
UNROLLED = ["    for (int t = split; t < T; t += splits) {",
            "        for (int c = 0; c < C; c += 4) {",
            "        for (int e = 0; e < C; e += 4) {",
            "      for (int j = 0; j < C3; j += 4) {"]


def substitute(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"variant pattern not in the source: {old!r}")
    return src.replace(old, new)


def no_unroll(src: str) -> str:
    for loop in UNROLLED:
        src = substitute(src, "#pragma unroll 4\n" + loop, loop)
    return src


def skip_loads(src: str) -> str:
    src = substitute(src, """      st4(tok + t * TS + c, __ldg(xg + i));
      st4(tok + t * TS + DO + c, __ldg(dg + i));
""", "")
    src = substitute(src, "kb4[i] = __ldg(kg4 + i);", ";")
    return substitute(src, "kb[i] = kg[i];", ";")


VARIANTS = {
    "base": lambda s: s,
    "lb3": lambda s: substitute(s, LAUNCH_BOUNDS,
                                LAUNCH_BOUNDS.replace("? 2", "? 3")),
    "t512": lambda s: substitute(
        substitute(s, "constexpr int kTiledThreads = 256;",
                   "constexpr int kTiledThreads = 512;"),
        LAUNCH_BOUNDS, "__launch_bounds__(kTiledThreads, 1)"),
    "tok_b8": lambda s: substitute(s, "constexpr int kTokB = 4;",
                                   "constexpr int kTokB = 8;"),
    "tok_e4": lambda s: substitute(s, "constexpr int kTokE = 2;",
                                   "constexpr int kTokE = 4;"),
    "no_unroll": no_unroll,
    "skip_loads": skip_loads,
}


def instrument(src: str) -> str:
    """Adds the stage counters to the tiled kernel of ``src``."""
    start = src.index("column_attention_bwd_tiled_kernel(const float*")
    end = src.index("template <int MS, int MT>", start)
    kern = src[start:end]
    count = kern.count("__syncthreads();")
    if count != 5:
        raise SystemExit(f"expected 5 barriers in the tiled kernel, got "
                         f"{count}")
    parts = kern.split("__syncthreads();")
    kern = parts[0]
    for k, rest in enumerate(parts[1:]):
        kern += ("__syncthreads();\n    if (tid == 0) { const long long now "
                 f"= clock64(); atomicAdd(&g_stage[{k}], (unsigned long "
                 "long)(now - t_prev)); t_prev = now; }\n" + rest)
    kern = substitute(kern, "  const int ngroups = (B + rows - 1) / rows;",
                      "  long long t_prev = clock64();\n"
                      "  const int ngroups = (B + rows - 1) / rows;")
    kern = substitute(
        kern, "  float* part = partials + ",
        "  __syncthreads();\n  if (tid == 0) { atomicAdd(&g_stage[5], "
        "(unsigned long long)(clock64() - t_prev)); atomicAdd(&g_stage[6], "
        "1ull); }\n  float* part = partials + ")
    src = src[:start] + kern + src[end:]
    src = substitute(src, "namespace {\n",
                     "__device__ unsigned long long g_stage[8];\n"
                     "namespace {\n")
    return substitute(src, 'extern "C" {\n', '''extern "C" {
void rmm_stage_counts(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_stage, sizeof(g_stage));
  unsigned long long zero[8] = {0};
  cudaMemcpyToSymbol(g_stage, zero, sizeof(zero));
}
''')


def build(names: list[str]) -> dict[str, str]:
    """Compiles the instrumented variants in parallel (with the port's own
    ``nvcc`` flags); returns each library's path."""
    from rmm_tpu_torch.ops.build import start_cuda_build

    base = open(SOURCE).read()
    os.makedirs(OUT, exist_ok=True)
    builds = {}
    for name in names:
        src = os.path.join(OUT, f"{name}.cu")
        with open(src, "w") as f:
            f.write(instrument(VARIANTS[name](base)))
        builds[name] = start_cuda_build(src, OUT)
    libs = {}
    for name, b in builds.items():
        lines = b.wait().splitlines()
        libs[name] = b.out
        for k, line in enumerate(lines):
            m = re.search(r"tiled_kernelILi([26])ELi1EE", line)
            if m and "Compiling entry" in line:
                near = "\n".join(lines[k + 1:k + 5])
                regs = re.search(r"Used (\d+) registers", near)
                spill = re.search(r"(\d+) bytes spill stores", near)
                emit({"phase": "ptxas", "variant": name,
                      "max_s": int(m.group(1)),
                      "registers": int(regs.group(1)) if regs else None,
                      "spill_store_bytes": int(spill.group(1)) if spill
                      else None})
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name}: {sorted(VARIANTS)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from rmm_tpu_torch.ops import column_attention as ca

    card = nvidia_smi()
    mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    libs = build(names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    cases = {}
    for b, s, c, h in [(131072, 6, 32, 8), (16384, 2, 32, 8)]:
        def t(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).to(dev)

        mask = torch.from_numpy(rng.rand(b, h, s, s) >= TRAIN_DROPOUT)
        cases[s] = (t(b, s, c), t(b, s, c), t(c, 3 * c, scale=c ** -0.5),
                    t(3 * c), t(c, c, scale=c ** -0.5), h, mask.to(dev),
                    TRAIN_DROPOUT)
    want = {}
    reps = 20
    for rnd in range(2):
        for name in names:
            lib = ca.use_library(libs[name])
            lib.rmm_stage_counts.argtypes = [ctypes.c_void_p]
            for s, case in cases.items():
                b, _, c = case[0].shape
                h = case[5]
                for rows in ROWS[s]:
                    plan = ca.bwd_plan(b, s, c, h, rows=rows)
                    got = ca.column_attention_bwd(*case, plan=plan)
                    want.setdefault(s, got)
                    diff = max(float((g - w).abs().max() / w.abs().max())
                               for g, w in zip(got, want[s]))
                    counts = (ctypes.c_ulonglong * 8)()
                    torch.cuda.synchronize()
                    lib.rmm_stage_counts(counts)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(reps):
                        ca.column_attention_bwd(*case, plan=plan)
                    end.record()
                    end.synchronize()
                    lib.rmm_stage_counts(counts)
                    blocks = counts[6] / reps
                    per_block = [counts[k] / reps / blocks for k in range(6)]
                    total = sum(per_block)
                    emit({"phase": "bwd_stages", "round": rnd,
                          "variant": name, "B": b, "S": s, "C": c, "H": h,
                          "dropout": TRAIN_DROPOUT, "rows": rows,
                          "blocks": plan.grid,
                          "blocks_per_sm": plan.grid / sms,
                          "ms": start.elapsed_time(end) / reps,
                          "max_rel_diff": diff, "max_sm_mhz": mhz,
                          "stage_ms_per_block": {
                              k: v / mhz / 1e3
                              for k, v in zip(STAGES, per_block)},
                          "stage_share": {k: v / total
                                          for k, v in zip(STAGES,
                                                          per_block)},
                          "card": card})
    ca.use_library()
    return 0


if __name__ == "__main__":
    sys.exit(main())
