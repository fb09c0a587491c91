// Fused column attention for Hopper (sm_90a): the forward here, the
// backward and its reduce further down.
//
// The forward replaces the TPU kernel
// rmm_tpu/ops/pallas/column_attention.py::_fwd_kernel (math in
// _attention_math). For each row b of x [B, S, C]:
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

// ---------------------------------------------------------------------------
// Backward.
//
// Replaces the TPU kernel rmm_tpu/ops/pallas/column_attention.py::_bwd_kernel
// (math in _attention_bwd_math). Like it, the backward recomputes qkv, the
// softmax and the context from x alone: the forward saves nothing. Per row:
//   dctx = do · Woutᵀ
//   per head h and query i: P = softmax row, P_d = P · keep/(1 − p),
//     dP = (dctx_i · v_jᵀ) · keep/(1 − p),  dS = P ⊙ (dP − Σ_j P ⊙ dP) / √hd
//   dq_i = Σ_j dS_ij k_j,  dk_j = Σ_i dS_ij q_i,  dv_j = Σ_i P_d,ij dctx_i
//   dx = [dq dk dv] · Wqkvᵀ
// and over the whole batch dWqkv = Σ xᵀ·dqkv, dbqkv = Σ dqkv,
// dWout = Σ ctxᵀ·do, dbout = Σ do.
//
// The TPU kernel sums the weight gradients across its sequential grid. A
// Hopper grid runs in parallel, so each block sums the row groups it walks
// into its own slice of a [grid, 4C² + 4C] partials buffer (laid out as
// dWqkv | dbqkv | dWout | dbout), and a second kernel adds the slices in a
// fixed order: deterministic on a given card, no atomics. Where the block's
// 4C² + 4C sums fit in registers (C = 32: 17 a thread) they stay there and
// are written once; above that (C = 128: 258 a thread) each thread adds into
// its entries of the block's slice in device memory after every group.
//
// What bounds it: about 11·C² FMAs per token (the qkv recompute, dctx, dx
// and the two weight-gradient products) against x, do and dx moved once;
// float32 operations bound it. This simple version runs on the CUDA cores,
// one group of rows per block at a time with every intermediate (x, do,
// qkv, ctx, dctx, dqkv: 10·S·C floats a row, plus the S×S probabilities and
// their gradients) in shared memory, and like the forward it is limited by
// shared-memory loads. The weights are staged transposed with a padded row
// (C + 1) so that both the row-wise and the column-wise products read them
// without bank conflicts.
// ---------------------------------------------------------------------------

constexpr int kAccPerThread = 24;  // register sums when 4C² + 4C <= 24·256

// One weight or bias gradient entry k of the partials layout, summed over
// the group's rows r < nr and tokens t < S.
__device__ __forceinline__ float weight_grad_term(
    int k, int C, int S, int nr, const float* xb, const float* db,
    const float* cb, const float* hb, int xs, int qs) {
  const int C3 = 3 * C;
  const float* a = nullptr;
  const float* b;
  int ars = 0, ats = 0, brs, bts;
  if (k < C * C3) {                       // dWqkv[c, j] = Σ x[c] dqkv[j]
    const int c = k / C3;
    a = xb + c; ars = xs; ats = C;
    b = hb + (k - c * C3); brs = qs; bts = C3;
  } else if (k < C * C3 + C3) {           // dbqkv[j] = Σ dqkv[j]
    b = hb + (k - C * C3); brs = qs; bts = C3;
  } else if (k < C * C3 + C3 + C * C) {   // dWout[c, e] = Σ ctx[c] do[e]
    const int kk = k - C * C3 - C3;
    const int c = kk / C;
    a = cb + c; ars = xs; ats = C;
    b = db + (kk - c * C); brs = xs; bts = C;
  } else {                                // dbout[e] = Σ do[e]
    b = db + (k - C * C3 - C3 - C * C); brs = xs; bts = C;
  }
  float s = 0.f;
  if (a != nullptr) {
    for (int r = 0; r < nr; ++r)
      for (int t = 0; t < S; ++t)
        s = fmaf(a[r * ars + t * ats], b[r * brs + t * bts], s);
  } else {
    for (int r = 0; r < nr; ++r)
      for (int t = 0; t < S; ++t) s += b[r * brs + t * bts];
  }
  return s;
}

template <int MAXS, bool W_SMEM, bool ACC_REGS>
__global__ void __launch_bounds__(kThreads, 2)
column_attention_bwd_kernel(const float* __restrict__ x,
                            const float* __restrict__ dout,
                            const float* __restrict__ wqkv,
                            const float* __restrict__ bqkv,
                            const float* __restrict__ wout,
                            const uint8_t* __restrict__ keep,
                            float* __restrict__ dx,
                            float* __restrict__ partials, int B, int S,
                            int C, int H, float scale, float inv_keep,
                            int rows) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int C3 = 3 * C;
  const int hd = C / H;
  const int SC = S * C;
  const int CP = C + 1;
  const int total = 4 * C * C + 4 * C;
  float* part = partials + (size_t)blockIdx.x * total;

  // Weights transposed with padded rows: sWqT[j][c] = Wqkv[c][j],
  // sWoT[e][c] = Wout[c][e].
  float* sWqT = smem;
  float* sWoT = smem + C3 * CP;
  float* buf = smem;
  if (W_SMEM) {
    for (int i = tid; i < C * C3; i += nt) {
      const int c = i / C3;
      sWqT[(i - c * C3) * CP + c] = wqkv[i];
    }
    for (int i = tid; i < C * C; i += nt) {
      const int c = i / C;
      sWoT[(i - c * C) * CP + c] = wout[i];
    }
    buf = smem + 4 * C * CP;
  }
#define WQ(c, j) (W_SMEM ? sWqT[(j) * CP + (c)] : __ldg(wqkv + (c) * C3 + (j)))
#define WO(c, e) (W_SMEM ? sWoT[(e) * CP + (c)] : __ldg(wout + (c) * C + (e)))

  // Per row of the group, each buffer padded by one float.
  const int xs = SC + 1;
  const int qs = 3 * SC + 1;
  const int ps = H * S * S + 1;
  float* xb = buf;              // x       [rows][xs]
  float* db = xb + rows * xs;   // do
  float* cb = db + rows * xs;   // ctx
  float* gb = cb + rows * xs;   // dctx
  float* qb = gb + rows * xs;   // qkv     [rows][qs]
  float* hb = qb + rows * qs;   // dqkv
  float* pb = hb + rows * qs;   // P_d     [rows][ps]: [h][i][j]
  float* sb = pb + rows * ps;   // dS

  float acc[ACC_REGS ? kAccPerThread : 1];
#pragma unroll
  for (int m = 0; m < (ACC_REGS ? kAccPerThread : 1); ++m) acc[m] = 0.f;
  if (!ACC_REGS)
    for (int k = tid; k < total; k += nt) part[k] = 0.f;

  const int ngroups = (B + rows - 1) / rows;
  for (int g = blockIdx.x; g < ngroups; g += gridDim.x) {
    const int r0 = g * rows;
    const int nr = min(rows, B - r0);
    __syncthreads();  // weights staged / previous group done with buffers

    // A. x and do rows → shared (coalesced)
    const float* xg = x + (size_t)r0 * SC;
    const float* dg = dout + (size_t)r0 * SC;
    for (int i = tid; i < nr * SC; i += nt) {
      const int r = i / SC;
      const int o = r * xs + (i - r * SC);
      xb[o] = xg[i];
      db[o] = dg[i];
    }
    __syncthreads();

    // B. qkv = x·Wqkv + bqkv and dctx = do·Woutᵀ; one thread per (row,
    //    column), all S tokens in registers.
    for (int it = tid; it < nr * (C3 + C); it += nt) {
      const int r = it / (C3 + C);
      const int j = it - r * (C3 + C);
      float a[MAXS];
      if (j < C3) {
        const float* xr = xb + r * xs;
        const float bj = __ldg(bqkv + j);
#pragma unroll
        for (int s = 0; s < MAXS; ++s) a[s] = bj;
        for (int c = 0; c < C; ++c) {
          const float w = WQ(c, j);
#pragma unroll
          for (int s = 0; s < MAXS; ++s)
            if (s < S) a[s] = fmaf(xr[s * C + c], w, a[s]);
        }
        float* qr = qb + r * qs;
#pragma unroll
        for (int s = 0; s < MAXS; ++s)
          if (s < S) qr[s * C3 + j] = a[s];
      } else {
        const int c = j - C3;
        const float* dr = db + r * xs;
#pragma unroll
        for (int s = 0; s < MAXS; ++s) a[s] = 0.f;
        for (int e = 0; e < C; ++e) {
          const float w = WO(c, e);
#pragma unroll
          for (int s = 0; s < MAXS; ++s)
            if (s < S) a[s] = fmaf(dr[s * C + e], w, a[s]);
        }
        float* gr = gb + r * xs;
#pragma unroll
        for (int s = 0; s < MAXS; ++s)
          if (s < S) gr[s * C + c] = a[s];
      }
    }
    __syncthreads();

    // C. one thread per (row, head, query i): the softmax row in registers,
    //    its dropped twin, the context and the softmax VJP.
    for (int it = tid; it < nr * H * S; it += nt) {
      const int r = it / (H * S);
      const int rem = it - r * H * S;
      const int h = rem / S;
      const int i = rem - h * S;
      const float* qr = qb + r * qs;
      const float* q = qr + i * C3 + h * hd;
      const float* gi = gb + r * xs + i * C + h * hd;
      float p[MAXS], dp[MAXS];
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < MAXS; ++j) {
        if (j < S) {
          const float* k = qr + j * C3 + C + h * hd;
          const float* v = k + C;
          float d = 0.f, dv = 0.f;
          for (int t = 0; t < hd; ++t) {
            d = fmaf(q[t], k[t], d);
            dv = fmaf(gi[t], v[t], dv);
          }
          p[j] = d * scale;
          dp[j] = dv;
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
          if (j < S) dp[j] = kp[j] ? dp[j] * inv_keep : 0.f;
      }
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) dot = fmaf(p[j], dp[j], dot);
      float* dsr = sb + r * ps + (h * S + i) * S;
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) dsr[j] = p[j] * (dp[j] - dot) * scale;
      if (keep != nullptr) {
        const uint8_t* kp = keep + (((size_t)(r0 + r) * H + h) * S + i) * S;
#pragma unroll
        for (int j = 0; j < MAXS; ++j)
          if (j < S) p[j] = kp[j] ? p[j] * inv_keep : 0.f;
      }
      float* pdr = pb + r * ps + (h * S + i) * S;
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) pdr[j] = p[j];
      float* ctx = cb + r * xs + i * C + h * hd;
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

    // D. dqkv, one thread per (row, token, column of [dq dk dv]).
    for (int it = tid; it < nr * S * C3; it += nt) {
      const int r = it / (S * C3);
      const int rem = it - r * S * C3;
      const int s = rem / C3;
      const int j = rem - s * C3;
      const float* qr = qb + r * qs;
      const float* P = pb + r * ps;
      const float* D = sb + r * ps;
      float a = 0.f;
      if (j < C) {              // dq[s, j] = Σ_j' dS[h, s, j'] k[j', j]
        const float* dsr = D + ((j / hd) * S + s) * S;
#pragma unroll
        for (int jj = 0; jj < MAXS; ++jj)
          if (jj < S) a = fmaf(dsr[jj], qr[jj * C3 + C + j], a);
      } else if (j < 2 * C) {   // dk[s, c] = Σ_i dS[h, i, s] q[i, c]
        const int c = j - C;
        const float* dsc = D + (c / hd) * S * S + s;
#pragma unroll
        for (int i = 0; i < MAXS; ++i)
          if (i < S) a = fmaf(dsc[i * S], qr[i * C3 + c], a);
      } else {                  // dv[s, c] = Σ_i P_d[h, i, s] dctx[i, c]
        const int c = j - 2 * C;
        const float* pc = P + (c / hd) * S * S + s;
        const float* gr = gb + r * xs;
#pragma unroll
        for (int i = 0; i < MAXS; ++i)
          if (i < S) a = fmaf(pc[i * S], gr[i * C + c], a);
      }
      hb[r * qs + s * C3 + j] = a;
    }
    __syncthreads();

    // E. dx = dqkv·Wqkvᵀ, one thread per (row, channel), S tokens in
    //    registers; stores coalesced over the channel.
    float* dxg = dx + (size_t)r0 * SC;
    for (int it = tid; it < nr * C; it += nt) {
      const int r = it / C;
      const int c = it - r * C;
      const float* hr = hb + r * qs;
      float a[MAXS];
#pragma unroll
      for (int s = 0; s < MAXS; ++s) a[s] = 0.f;
      for (int j = 0; j < C3; ++j) {
        const float w = WQ(c, j);
#pragma unroll
        for (int s = 0; s < MAXS; ++s)
          if (s < S) a[s] = fmaf(hr[s * C3 + j], w, a[s]);
      }
#pragma unroll
      for (int s = 0; s < MAXS; ++s)
        if (s < S) dxg[(r * S + s) * C + c] = a[s];
    }

    // F. this group's weight and bias gradients into the thread's sums
    //    (reads what E reads, so no barrier between them).
    if (ACC_REGS) {
#pragma unroll
      for (int m = 0; m < kAccPerThread; ++m) {
        const int k = tid + m * nt;
        if (k < total)
          acc[m] += weight_grad_term(k, C, S, nr, xb, db, cb, hb, xs, qs);
      }
    } else {
      for (int k = tid; k < total; k += nt)
        part[k] += weight_grad_term(k, C, S, nr, xb, db, cb, hb, xs, qs);
    }
  }
#undef WQ
#undef WO
  if (ACC_REGS) {
#pragma unroll
    for (int m = 0; m < kAccPerThread; ++m) {
      const int k = tid + m * nt;
      if (k < total) part[k] = acc[m];
    }
  }
}

// grads[k] = Σ_g partials[g][k], g in order: one thread per entry.
__global__ void __launch_bounds__(kThreads)
column_attention_bwd_reduce_kernel(const float* __restrict__ partials,
                                   int nparts, int total,
                                   float* __restrict__ grads) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  float s = 0.f;
  for (int g = 0; g < nparts; ++g) s += partials[(size_t)g * total + k];
  grads[k] = s;
}

bool bwd_acc_in_regs(int C, int weights_in_smem) {
  return weights_in_smem && 4 * C * C + 4 * C <= kAccPerThread * kThreads;
}

template <int MAXS, bool W_SMEM, bool ACC_REGS>
cudaError_t bwd_blocks_per_sm(size_t smem, int* per_sm) {
  auto kernel = column_attention_bwd_kernel<MAXS, W_SMEM, ACC_REGS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, smem);
}

template <int MAXS, bool W_SMEM, bool ACC_REGS>
cudaError_t launch_bwd(const float* x, const float* dout, const float* wqkv,
                       const float* bqkv, const float* wout,
                       const uint8_t* keep, float* dx, float* partials,
                       int B, int S, int C, int H, float inv_keep, int rows,
                       int grid, size_t smem, cudaStream_t stream) {
  auto kernel = column_attention_bwd_kernel<MAXS, W_SMEM, ACC_REGS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)(C / H));
  kernel<<<grid, kThreads, smem, stream>>>(x, dout, wqkv, bqkv, wout, keep,
                                           dx, partials, B, S, C, H, scale,
                                           inv_keep, rows);
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

// Shared memory of the backward for a group of `rows` rows.
size_t rmm_column_attention_bwd_smem_bytes(int S, int C, int H, int rows,
                                           int weights_in_smem) {
  const size_t sc = (size_t)S * C;
  size_t per_row = 4 * (sc + 1) + 2 * (3 * sc + 1) +
                   2 * ((size_t)H * S * S + 1);
  size_t floats = (size_t)rows * per_row;
  if (weights_in_smem) floats += (size_t)4 * C * (C + 1);
  return floats * sizeof(float);
}

#define RMM_BWD_DISPATCH(FN, ...)                                           \
  {                                                                         \
    const bool acc = bwd_acc_in_regs(C, weights_in_smem);                   \
    if (S <= 2) {                                                           \
      if (acc) return FN<2, true, true>(__VA_ARGS__);                       \
      if (weights_in_smem) return FN<2, true, false>(__VA_ARGS__);          \
      return FN<2, false, false>(__VA_ARGS__);                              \
    }                                                                       \
    if (S <= 4) {                                                           \
      if (acc) return FN<4, true, true>(__VA_ARGS__);                       \
      if (weights_in_smem) return FN<4, true, false>(__VA_ARGS__);          \
      return FN<4, false, false>(__VA_ARGS__);                              \
    }                                                                       \
    if (S <= 8) {                                                           \
      if (acc) return FN<8, true, true>(__VA_ARGS__);                       \
      if (weights_in_smem) return FN<8, true, false>(__VA_ARGS__);          \
      return FN<8, false, false>(__VA_ARGS__);                              \
    }                                                                       \
    if (acc) return FN<16, true, true>(__VA_ARGS__);                        \
    if (weights_in_smem) return FN<16, true, false>(__VA_ARGS__);           \
    return FN<16, false, false>(__VA_ARGS__);                               \
  }

static cudaError_t bwd_occupancy(int S, int C, int weights_in_smem,
                                 size_t smem, int* per_sm) {
  RMM_BWD_DISPATCH(bwd_blocks_per_sm, smem, per_sm);
}

// Blocks the backward launches for this shape (every block owns at least
// one row group): the number of partial slices the wrapper allocates.
// Returns a negative CUDA error code on failure.
int rmm_column_attention_bwd_grid(int B, int S, int C, int H, int rows,
                                  int weights_in_smem) {
  if (B <= 0 || rows < 1 || S < 1 || S > 16 || C < 1 || H < 1 || C % H)
    return -(int)cudaErrorInvalidValue;
  const size_t smem = rmm_column_attention_bwd_smem_bytes(S, C, H, rows,
                                                          weights_in_smem);
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = bwd_occupancy(S, C, weights_in_smem, smem, &per_sm);
  if (err != cudaSuccess) return -(int)err;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ngroups = (B + rows - 1) / rows;
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  return grid < ngroups ? grid : ngroups;
}

// The backward kernel, then the reduce of its `grid` partial slices into
// grads = [dWqkv (C×3C) | dbqkv (3C) | dWout (C×C) | dbout (C)]. Returns
// cudaGetLastError() after the launches (0 = both launched).
int rmm_column_attention_bwd(const float* x, const float* dout,
                             const float* wqkv, const float* bqkv,
                             const float* wout, const uint8_t* keep,
                             float* dx, float* partials, float* grads, int B,
                             int S, int C, int H, float inv_keep, int rows,
                             int weights_in_smem, int grid, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > 16 || C < 1 || H < 1 || C % H != 0 || rows < 1 ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = rmm_column_attention_bwd_smem_bytes(S, C, H, rows,
                                                          weights_in_smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = [&]() -> cudaError_t {
    RMM_BWD_DISPATCH(launch_bwd, x, dout, wqkv, bqkv, wout, keep, dx,
                     partials, B, S, C, H, inv_keep, rows, grid, smem, st);
  }();
  if (err != cudaSuccess) return (int)err;
  const int total = 4 * C * C + 4 * C;
  column_attention_bwd_reduce_kernel<<<(total + kThreads - 1) / kThreads,
                                       kThreads, 0, st>>>(partials, grid,
                                                          total, grads);
  return (int)cudaGetLastError();
}

#undef RMM_BWD_DISPATCH

const char* rmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
