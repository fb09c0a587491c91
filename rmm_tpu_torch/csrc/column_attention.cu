// Fused column attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel rmm_tpu/ops/pallas/column_attention.py::_fwd_kernel
// (math in _attention_math). For each row b of x [B, S, C]:
//   qkv = x_b · Wqkv + bqkv                      [S, 3C]
//   per head h: P = softmax(q_h k_hᵀ / √hd)      [S, S]
//               (optional dropout: P · keep / (1 − p))
//   ctx[:, h] = P · v_h                           [S, hd]
//   o_b = ctx · Wout + bout                       [S, C]
// Weights keep the JAX layout: Wqkv [C, 3C], Wout [C, C], row-major.
//
// What bounds it on an H100. The tables of this model have tiny rows
// (S = num_cols + 1 = 2 or 6 tokens) and a huge batch (up to 131,072 lanes),
// so the unfused version moves qkv, the [B, H, S, S] scores and the context
// through device memory between operators. Here one block keeps a group of
// rows' whole attention in shared memory: device memory sees one read of x
// and one write of o per row, plus the weights (from L2 after the first
// block). At the floor the call is bound by float32 FMAs (about 27k per row
// at C = 32, S = 6, against 1.5 kB moved). This simple version runs on the
// CUDA cores and is limited by shared-memory loads: each FMA of the two
// projections reads one weight (shared by all S tokens of the row, which sit
// in registers as S accumulators) and one broadcast activation. Tensor cores
// (wgmma) and TMA are later work.
//
// Design, against the TPU kernel's choices:
//  * no channel-mask trick: heads are column slices indexed directly;
//  * no multiple-of-8 batch tiling or padding: a block walks groups of
//    `rows` rows (grid-stride) and the ragged last group is masked;
//  * weights are staged in shared memory only when they fit (C <= 64);
//    above that (C = 128: 256 kB) they are read through the read-only
//    cache (__ldg), where every block finds them in L2.
// Supports S <= 16, C % nhead == 0, C <= 128, float32 only (the wrapper
// checks). Launches on the caller's stream, allocates nothing, does not
// synchronize; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int MAXS, bool W_SMEM>
__global__ void __launch_bounds__(kThreads)
column_attention_fwd_kernel(const float* __restrict__ x,
                            const float* __restrict__ wqkv,
                            const float* __restrict__ bqkv,
                            const float* __restrict__ wout,
                            const float* __restrict__ bout,
                            const uint8_t* __restrict__ keep,
                            float* __restrict__ out, int B, int S, int C,
                            int H, float scale, float inv_keep, int rows) {
  extern __shared__ float smem[];
  const int C3 = 3 * C;
  const int hd = C / H;
  const float* Wq = wqkv;
  const float* Wo = wout;
  float* buf = smem;
  if (W_SMEM) {
    float* sWq = smem;
    float* sWo = smem + C * C3;
    for (int i = threadIdx.x; i < C * C3; i += blockDim.x) sWq[i] = wqkv[i];
    for (int i = threadIdx.x; i < C * C; i += blockDim.x) sWo[i] = wout[i];
    Wq = sWq;
    Wo = sWo;
    buf = smem + C * C3 + C * C;
  }
  // Per row: x (later ctx) [S*C] and qkv [S*3C]. Row strides are padded by
  // one float so neighbouring rows start in different banks.
  const int xs = S * C + 1;
  const int qs = S * C3 + 1;
  float* xb = buf;
  float* qb = buf + rows * xs;

  const int ngroups = (B + rows - 1) / rows;
  for (int g = blockIdx.x; g < ngroups; g += gridDim.x) {
    const int r0 = g * rows;
    const int nr = min(rows, B - r0);
    __syncthreads();  // weights staged / previous group done with xb, qb

    // 1. x rows → shared (coalesced: nr*S*C contiguous floats)
    const float* xg = x + (size_t)r0 * S * C;
    for (int i = threadIdx.x; i < nr * S * C; i += blockDim.x) {
      const int r = i / (S * C);
      xb[r * xs + (i - r * S * C)] = xg[i];
    }
    __syncthreads();

    // 2. qkv[r, s, j] = bqkv[j] + Σ_c x[r, s, c] Wqkv[c, j]; one thread per
    //    (row, output column), all S tokens at once in registers.
    for (int it = threadIdx.x; it < nr * C3; it += blockDim.x) {
      const int r = it / C3;
      const int j = it - r * C3;
      const float* xr = xb + r * xs;
      float acc[MAXS];
      const float bj = __ldg(bqkv + j);
#pragma unroll
      for (int s = 0; s < MAXS; ++s) acc[s] = bj;
      for (int c = 0; c < C; ++c) {
        const float w = W_SMEM ? Wq[c * C3 + j] : __ldg(Wq + c * C3 + j);
#pragma unroll
        for (int s = 0; s < MAXS; ++s)
          if (s < S) acc[s] = fmaf(xr[s * C + c], w, acc[s]);
      }
      float* qr = qb + r * qs;
#pragma unroll
      for (int s = 0; s < MAXS; ++s)
        if (s < S) qr[s * C3 + j] = acc[s];
    }
    __syncthreads();

    // 3. one thread per (row, head, query): scores over the S keys in
    //    registers, softmax, optional keep-mask, context into xb.
    for (int it = threadIdx.x; it < nr * H * S; it += blockDim.x) {
      const int r = it / (H * S);
      const int rem = it - r * H * S;
      const int h = rem / S;
      const int i = rem - h * S;
      const float* qr = qb + r * qs;
      const float* q = qr + i * C3 + h * hd;
      float p[MAXS];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < MAXS; ++j) {
        if (j < S) {
          const float* k = qr + j * C3 + C + h * hd;
          float d = 0.f;
          for (int t = 0; t < hd; ++t) d = fmaf(q[t], k[t], d);
          p[j] = d * scale;
          m = fmaxf(m, p[j]);
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < MAXS; ++j) {
        if (j < S) {
          p[j] = expf(p[j] - m);
          sum += p[j];
        }
      }
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) p[j] = p[j] / sum;
      if (keep != nullptr) {
        const uint8_t* kp = keep + (((size_t)(r0 + r) * H + h) * S + i) * S;
#pragma unroll
        for (int j = 0; j < MAXS; ++j)
          if (j < S) p[j] = kp[j] ? p[j] * inv_keep : 0.f;
      }
      float* ctx = xb + r * xs + i * C + h * hd;
      const float* v = qr + 2 * C + h * hd;
      for (int t = 0; t < hd; ++t) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < MAXS; ++j)
          if (j < S) a = fmaf(p[j], v[j * C3 + t], a);
        ctx[t] = a;
      }
    }
    __syncthreads();

    // 4. o[r, s, j] = bout[j] + Σ_c ctx[r, s, c] Wout[c, j]; stores are
    //    coalesced over j.
    float* og = out + (size_t)r0 * S * C;
    for (int it = threadIdx.x; it < nr * C; it += blockDim.x) {
      const int r = it / C;
      const int j = it - r * C;
      const float* cr = xb + r * xs;
      float acc[MAXS];
      const float bj = __ldg(bout + j);
#pragma unroll
      for (int s = 0; s < MAXS; ++s) acc[s] = bj;
      for (int c = 0; c < C; ++c) {
        const float w = W_SMEM ? Wo[c * C + j] : __ldg(Wo + c * C + j);
#pragma unroll
        for (int s = 0; s < MAXS; ++s)
          if (s < S) acc[s] = fmaf(cr[s * C + c], w, acc[s]);
      }
#pragma unroll
      for (int s = 0; s < MAXS; ++s)
        if (s < S) og[(r * S + s) * C + j] = acc[s];
    }
  }
}

template <int MAXS, bool W_SMEM>
cudaError_t launch(const float* x, const float* wqkv, const float* bqkv,
                   const float* wout, const float* bout, const uint8_t* keep,
                   float* out, int B, int S, int C, int H, float inv_keep,
                   int rows, size_t smem, cudaStream_t stream) {
  auto kernel = column_attention_fwd_kernel<MAXS, W_SMEM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int ngroups = (B + rows - 1) / rows;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (grid > ngroups) grid = ngroups;
  const float scale = 1.0f / sqrtf((float)(C / H));
  kernel<<<grid, kThreads, smem, stream>>>(x, wqkv, bqkv, wout, bout, keep,
                                           out, B, S, C, H, scale, inv_keep,
                                           rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory layout the kernel uses for a group of `rows` rows; the
// wrapper picks `rows` and the launch checks the total against the card.
size_t rmm_column_attention_smem_bytes(int S, int C, int rows,
                                       int weights_in_smem) {
  size_t floats = (size_t)rows * ((size_t)S * C + 1 + (size_t)S * 3 * C + 1);
  if (weights_in_smem) floats += (size_t)4 * C * C;
  return floats * sizeof(float);
}

// Returns cudaGetLastError() after the launch (0 = launched).
int rmm_column_attention_fwd(const float* x, const float* wqkv,
                             const float* bqkv, const float* wout,
                             const float* bout, const uint8_t* keep,
                             float* out, int B, int S, int C, int H,
                             float inv_keep, int rows, int weights_in_smem,
                             void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > 16 || C < 1 || H < 1 || C % H != 0 || rows < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = rmm_column_attention_smem_bytes(S, C, rows,
                                                      weights_in_smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RMM_LAUNCH(MS)                                                      \
  return (int)(weights_in_smem                                              \
                   ? launch<MS, true>(x, wqkv, bqkv, wout, bout, keep, out, \
                                      B, S, C, H, inv_keep, rows, smem, st) \
                   : launch<MS, false>(x, wqkv, bqkv, wout, bout, keep, out,\
                                       B, S, C, H, inv_keep, rows, smem, st))
  if (S <= 2) RMM_LAUNCH(2);
  if (S <= 4) RMM_LAUNCH(4);
  if (S <= 8) RMM_LAUNCH(8);
  RMM_LAUNCH(16);
#undef RMM_LAUNCH
}

const char* rmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
