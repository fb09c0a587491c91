"""Where a tiled column-attention kernel spends its time, by stage.

    python3 tools/torch_attn_stages.py --kernel fwd|bwd [--variants base,...]

Builds an instrumented copy of ``rmm_tpu_torch/csrc/column_attention.cu``
with ``nvcc`` (into the git-ignored ``rmm_tpu_torch/_build/stages/``): in
the chosen tiled kernel, thread 0 of every block reads ``clock64()`` as it
leaves each barrier and adds the time since the last one to a per-stage
counter. A stage's count is therefore the block's time from the barrier
before the stage to the barrier after it (its slowest thread, plus the
wait). The backward's stages: A (x, do and keep-mask loads), B (qkv,
dctx), C (softmax), D (dqkv) and E+F (dx and the weight gradients); the
forward's: B (qkv), A + C (the next group's loads started, then softmax
and context) and O (output projection) with the wait for the next
group's loads. The last group's E+F or O is counted after the loop, with
the block's last stores. Cycles are turned into ms at the card's maximum
SM clock.

Each ``--variants`` entry is the kernel with one text substitution, built
and timed in turns with the others (two rounds). Both kernels:

* ``base``       — the source as it is;
* ``lb3``        — ``__launch_bounds__`` for three blocks of 256 an SM;
* ``t512``       — blocks of 512 threads, launch bounds for one an SM;
* ``tok_b8``     — stage-B tiles of 8 tokens (4 in the source);
* ``skip_loads`` — stage A loads nothing from device memory (the stages
  run on whatever the buffers hold, so the results are wrong): in the
  backward the most that overlapping the next group's loads with this
  one's work could save, in the forward (which overlaps them) what they
  still cost.

The backward's: ``tok_e4`` (stage-E tiles of 4 tokens, 2 in the source) and
``no_unroll`` (without the ``#pragma unroll 4`` of the k and token loops).
The forward's: ``lb4`` (launch bounds for four blocks of 256 an SM),
``tok_o1`` and ``tok_o4`` (stage-O tiles of 1 or 4 tokens, 2 in the
source), ``runtime_s`` (S a runtime value in the S = 6 instantiation
too, where the source makes it a constant) and
``store_tok`` (stage O's items with the tokens fastest, so
that a quarter-warp stores 8 tokens' 16-byte pieces, where the source has
the column tiles fastest and stores one token's 128 contiguous bytes).

Runs the main path's shapes (edge tokens 131072×6×32/8, node tokens
16384×2×32/8; the backward with the training keep-mask, the forward
without and, at the edge shape, with it) at a few rows a group (each
variant's blocks an SM from the occupancy of its own build), and prints
one JSON line per run, the card's name and power limit in each, and the
registers and spills ``ptxas`` reports for the main path's instantiations.
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


def substitute(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"variant pattern not in the source: {old!r}")
    return src.replace(old, new)


def variants(threads: str, bounds: str, more: dict, loads: list) -> dict:
    """The variants of a kernel whose block size is the constant
    ``threads`` (``= 256;``), whose launch bounds read ``bounds`` and whose
    stage A makes its device loads with the statements ``loads``."""
    def skip_loads(s: str) -> str:
        for line in loads:
            s = substitute(s, line, ";")
        return s

    return {
        "base": lambda s: s,
        "t512": lambda s: substitute(
            substitute(s, f"{threads} = 256;", f"{threads} = 512;"), bounds,
            f"__launch_bounds__({threads.split()[-1]}, 1)"),
        "skip_loads": skip_loads,
        **more,
    }


def bwd_no_unroll(src: str) -> str:
    for loop in ["    for (int t = split; t < T; t += splits) {",
                 "  for (int c = 0; c < C; c += 4) {",
                 "        for (int e = 0; e < C; e += 4) {",
                 "      for (int j = 0; j < C3; j += 4) {"]:
        src = substitute(src, "#pragma unroll 4\n" + loop, loop)
    return src


def constant(name: str, old: int, new: int):
    return lambda s: substitute(s, f"constexpr int {name} = {old};",
                                f"constexpr int {name} = {new};")


def fwd_bounds(n: int):
    return lambda s: substitute(s, "__launch_bounds__(kFwdThreads, 2)",
                                f"__launch_bounds__(kFwdThreads, {n})")


KERNELS = {
    "bwd": {
        "signature": "column_attention_bwd_tiled_kernel(const elem_t*",
        "barriers": 5,
        "stages": ["staging + E+F", "A", "B", "C", "D", "last E+F"],
        "ptxas": r"bwd_tiled_kernelILi([26])ELi1EE",
        "rows": {6: [6, 10, 20], 2: [16, 32, 64]},
        "cases": [(131072, 6, 32, 8, TRAIN_DROPOUT),
                  (16384, 2, 32, 8, TRAIN_DROPOUT)],
        "variants": variants(
            "constexpr int kTiledThreads",
            "__launch_bounds__(kTiledThreads, MAXT == 1 ? 2 : 1)",
            {"lb3": lambda s: substitute(
                s, "__launch_bounds__(kTiledThreads, MAXT == 1 ? 2 : 1)",
                "__launch_bounds__(kTiledThreads, MAXT == 1 ? 3 : 1)"),
             "tok_b8": constant("kTokB", 4, 8),
             "tok_e4": constant("kTokE", 2, 4),
             "no_unroll": bwd_no_unroll},
            ["st4(tok + t * TS + c, E::ldg4(xg + 4 * i));",
             "st4(tok + t * TS + DO + c, E::ldg4(dg + 4 * i));",
             "kb4[i] = __ldg(kg4 + i);", "kb[i] = kg[i];"]),
    },
    "fwd": {
        "signature": "column_attention_fwd_tiled_kernel(const elem_t*",
        "barriers": 3,
        "stages": ["staging + O + wait", "B", "A + C", "last O"],
        "ptxas": r"fwd_tiled_kernelILi([26])EE",
        "rows": {6: [11, 16, 21, 42], 2: [36, 54, 70, 140]},
        "cases": [(131072, 6, 32, 8, 0.0), (131072, 6, 32, 8, TRAIN_DROPOUT),
                  (16384, 2, 32, 8, 0.0)],
        "variants": variants(
            "constexpr int kFwdThreads",
            "__launch_bounds__(kFwdThreads, 2)",
            {"lb3": fwd_bounds(3), "lb4": fwd_bounds(4),
             "tok_b8": constant("kFwdTokB", 4, 8),
             "tok_o1": constant("kFwdTokO", 2, 1),
             "tok_o4": constant("kFwdTokO", 2, 4),
             "runtime_s": lambda s: substitute(
                 s, "  if (MAXS == 6) S = 6;\n", ""),
             "store_tok": lambda s: substitute(
                 s, "      const int q = it / C4;\n"
                    "      const int ct = it - q * C4;\n",
                 "      const int ct = it / NQO;\n"
                 "      const int q = it - ct * NQO;\n")},
            ["load_x4(tok + t * TS + 4 * (i - t * C4), xg + 4 * i);",
             "cp_async16(kb + 16 * i, kg + 16 * i);", "kb[i] = kg[i];"]),
    },
}


def kernel_span(src: str, signature: str) -> tuple[int, int]:
    """Where the kernel whose parameter list starts with ``signature``
    begins, and where its closing brace is."""
    start = src.index(signature)
    depth, i = 0, src.index("{", start)
    while True:
        if src[i] == "{":
            depth += 1
        elif src[i] == "}":
            depth -= 1
            if depth == 0:
                return start, i
        i += 1


def instrument(src: str, kern: dict) -> str:
    """Adds the stage counters to the kernel ``kern`` of ``src``."""
    start, end = kernel_span(src, kern["signature"])
    body = src[start:end]
    count = body.count("__syncthreads();")
    if count != kern["barriers"]:
        raise SystemExit(f"expected {kern['barriers']} barriers in the "
                         f"kernel, got {count}")
    last, blocks = len(kern["stages"]) - 1, len(kern["stages"])
    parts = body.split("__syncthreads();")
    body = parts[0]
    for k, rest in enumerate(parts[1:]):
        body += ("__syncthreads();\n    if (tid == 0) { const long long now "
                 f"= clock64(); atomicAdd(&g_stage[{k}], (unsigned long "
                 "long)(now - t_prev)); t_prev = now; }\n" + rest)
    body = substitute(body, "  const int ngroups = (B + rows - 1) / rows;",
                      "  long long t_prev = clock64();\n"
                      "  const int ngroups = (B + rows - 1) / rows;")
    body += ("  __syncthreads();\n  if (tid == 0) { atomicAdd(&g_stage["
             f"{last}], (unsigned long long)(clock64() - t_prev)); "
             f"atomicAdd(&g_stage[{blocks}], 1ull); }}\n")
    src = src[:start] + body + src[end:]
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


def build(kernel: str, names: list[str]) -> dict[str, str]:
    """Compiles the instrumented variants in parallel (with the port's own
    ``nvcc`` flags); returns each library's path."""
    from rmm_tpu_torch.ops.build import start_cuda_build

    kern = KERNELS[kernel]
    base = open(SOURCE).read()
    os.makedirs(OUT, exist_ok=True)
    builds = {}
    for name in names:
        src = os.path.join(OUT, f"{kernel}_{name}.cu")
        with open(src, "w") as f:
            f.write(instrument(kern["variants"][name](base), kern))
        builds[name] = start_cuda_build(src, OUT)
    libs = {}
    for name, b in builds.items():
        lines = b.wait().splitlines()
        libs[name] = b.out
        for k, line in enumerate(lines):
            m = re.search(kern["ptxas"], line)
            if m and "Compiling entry" in line:
                near = "\n".join(lines[k + 1:k + 5])
                regs = re.search(r"Used (\d+) registers", near)
                spill = re.search(r"(\d+) bytes spill stores", near)
                emit({"phase": "ptxas", "kernel": kernel, "variant": name,
                      "max_s": int(m.group(1)),
                      "registers": int(regs.group(1)) if regs else None,
                      "spill_store_bytes": int(spill.group(1)) if spill
                      else None})
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="bwd")
    ap.add_argument("--variants", default="base")
    args = ap.parse_args(argv)
    kern = KERNELS[args.kernel]
    names = args.variants.split(",")
    for name in names:
        if name not in kern["variants"]:
            raise SystemExit(f"unknown variant {name}: "
                             f"{sorted(kern['variants'])}")

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
    libs = build(args.kernel, names)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    cases = []
    for b, s, c, h, p in kern["cases"]:
        def t(*shape, scale=1.0):
            return torch.from_numpy(
                (rng.randn(*shape) * scale).astype(np.float32)).to(dev)

        mask = (torch.from_numpy(rng.rand(b, h, s, s) >= p).to(dev)
                if p > 0 else None)
        x, wqkv, bqkv, wout = (t(b, s, c), t(c, 3 * c, scale=c ** -0.5),
                               t(3 * c), t(c, c, scale=c ** -0.5))
        if args.kernel == "fwd":
            cases.append(((b, s, c, h, p), ca.fwd_plan,
                          ca.column_attention_fwd,
                          (x, wqkv, bqkv, wout, t(c), h, mask, p)))
        else:
            cases.append(((b, s, c, h, p), ca.bwd_plan,
                          ca.column_attention_bwd,
                          (x, t(b, s, c), wqkv, bqkv, wout, h, mask, p)))
    want = {}
    reps = 20
    for rnd in range(2):
        for name in names:
            lib = ca.use_library(libs[name])
            lib.rmm_stage_counts.argtypes = [ctypes.c_void_p]
            for (b, s, c, h, p), plan_of, fn, case in cases:
                for rows in kern["rows"][s]:
                    plan = plan_of(b, s, c, h, rows=rows)
                    got = fn(*case, plan=plan)
                    got = got if isinstance(got, tuple) else (got,)
                    key = (b, s, p)
                    want.setdefault(key, got)
                    diff = max(float((g - w).abs().max() / w.abs().max())
                               for g, w in zip(got, want[key]))
                    counts = (ctypes.c_ulonglong * 8)()
                    torch.cuda.synchronize()
                    lib.rmm_stage_counts(counts)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(reps):
                        fn(*case, plan=plan)
                    end.record()
                    end.synchronize()
                    lib.rmm_stage_counts(counts)
                    n = len(kern["stages"])
                    blocks = counts[n] / reps
                    per_block = [counts[k] / reps / blocks for k in range(n)]
                    total = sum(per_block)
                    emit({"phase": f"{args.kernel}_stages", "round": rnd,
                          "variant": name, "B": b, "S": s, "C": c, "H": h,
                          "dropout": p, "rows": rows, "blocks": plan.grid,
                          "blocks_per_sm": plan.grid / sms,
                          "ms": start.elapsed_time(end) / reps,
                          "max_rel_diff": diff, "max_sm_mhz": mhz,
                          "stage_ms_per_block": {
                              k: v / mhz / 1e3
                              for k, v in zip(kern["stages"], per_block)},
                          "stage_share": {k: v / total for k, v in
                                          zip(kern["stages"], per_block)},
                          "card": card})
    ca.use_library()
    return 0


if __name__ == "__main__":
    sys.exit(main())
