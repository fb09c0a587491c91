"""How many shared-memory cycles a warp's float4 load costs on this card.

    python3 tools/torch_smem_probe.py

The column-attention backward's tiles read shared memory as float4s in
four patterns; this probe times each in isolation. Every warp of 528
blocks of 256 threads (4 for each of an H100's 132 SMs) runs a long
unrolled loop of float4 loads from a shared buffer at immediate offsets,
each folded into one register by two 3-input XORs (3 instructions a load,
under one issue cycle of an SM's 4 schedulers); the address pattern across
the 32 lanes is:

* ``distinct``     — 32 consecutive float4s (512 bytes; the activation
  loads of stages B and E, and the weight-gradient operand of stage F);
* ``quarter_bcast`` — one float4 per quarter-warp of 8 lanes, 4
  neighbouring ones in all (the weight loads of stages B and E, which a
  warp's lanes share but at the edge of a column tile);
* ``warp_bcast``   — one float4 for the whole warp (the x/ctx operand of
  stage F);
* ``scalar``       — a float load of 32 consecutive floats, for scale.

The time is the median of 5 launches by CUDA events. While a train of
launches of the same pattern runs (about a second), ``nvidia-smi`` samples
the SM clock every 100 ms; a warp-wide load's SM cycles are the time at
the median sampled clock, times the SMs, over the warp loads. Prints one
JSON line per pattern, with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import emit, nvidia_smi  # noqa: E402

OUT = os.path.join(ROOT, "rmm_tpu_torch", "_build", "smem_probe")
MODES = ["distinct", "quarter_bcast", "warp_bcast", "scalar"]
BLOCKS, THREADS, ITERS = 528, 256, 4096
CLOCK_S = 1.0   # seconds of launches while the SM clock is sampled
SOURCE = r"""
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256)
probe(float* out, int iters, int mode) {
  __shared__ float4 buf[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    buf[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int idx = mode == 0 ? lane : mode == 1 ? lane >> 3 : 0;
  const float* bufs = reinterpret_cast<const float*>(buf);
  unsigned a = 0;
  for (int it = 0; it < iters; it += 8) {
    const int base = (it * 5) & 511;  // warp-uniform; + 7 * 64 + 31 < 1024
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (mode == 3) {
        a ^= __float_as_uint(bufs[4 * (base + u * 64) + lane]);
      } else {
        const float4 v = buf[base + u * 64 + idx];
        a ^= __float_as_uint(v.x) ^ __float_as_uint(v.y);
        a ^= __float_as_uint(v.z) ^ __float_as_uint(v.w);
      }
    }
  }
  if (a == 0x7fc00001u) out[threadIdx.x] = 1.f;  // keeps the loads live
}

extern "C" int rmm_smem_probe(float* out, int blocks, int threads, int iters,
                              int mode) {
  probe<<<blocks, threads>>>(out, iters, mode);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from rmm_tpu_torch.ops.build import start_cuda_build

    card = nvidia_smi()
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "smem_probe.cu")
    with open(src, "w") as f:
        f.write(SOURCE)
    build = start_cuda_build(src, OUT)
    build.wait()
    lib = ctypes.CDLL(build.out)
    lib.rmm_smem_probe.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    out = torch.zeros(THREADS, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warp_loads = BLOCKS * THREADS // 32 * ITERS
    for mode, name in enumerate(MODES):
        def run():
            err = lib.rmm_smem_probe(out.data_ptr(), BLOCKS, THREADS, ITERS,
                                     mode)
            if err:
                raise RuntimeError(f"probe launch failed: {err}")

        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = sorted(times)[2]
        sampler = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        try:
            for _ in range(int(CLOCK_S * 1e3 / ms) + 1):
                run()
            torch.cuda.synchronize()
        finally:
            sampler.terminate()
        samples = [int(v) for v in sampler.communicate()[0].split()
                   if v.isdigit()]
        if not samples:
            raise RuntimeError("nvidia-smi gave no SM clock sample")
        mhz = statistics.median(samples)
        emit({"phase": "smem_probe", "pattern": name, "ms": ms,
              "warp_loads": warp_loads, "sm_mhz_sampled": mhz,
              "sm_mhz_samples": samples,
              "sm_cycles_per_warp_load": ms * 1e-3 * mhz * 1e6 * sms
              / warp_loads, "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
