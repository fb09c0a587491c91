// Fused column attention for Hopper (sm_90a): the forward's two routes (a
// tiled kernel, and a split route of three launches), the backward's two
// routes (a tiled kernel, and a split route of four kernels) and the
// backward's reduce.
//
// The forwards replace the TPU kernel
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
// through device memory between operators. At the floor the call is bound
// by float32 FMAs (about 27k per row at C = 32, S = 6, against 1.5 kB
// moved). Tensor cores (wgmma) and TMA are later work.
//
// Two routes compute each direction, chosen by width: the register-tiled
// kernels (column_attention_fwd_tiled_kernel and
// column_attention_bwd_tiled_kernel, further down) for every C <= 64 that
// is a multiple of 4, the main path's C = 32 among them; and the split
// routes for every other C (C = 96, the SSL path's C = 128, C = 256 and
// wider, and every C that is not a multiple of 4): GEMMs (gemm_f32.cuh)
// around a per-row attention core. Against the TPU kernel's choices, the kernels
// index the heads as column slices (no channel-mask trick), and a tiled
// block walks groups of `rows` rows (grid-stride) with the ragged last
// group masked (no multiple-of-8 batch tiling or padding).
//
// The tiled forward keeps a group of rows' whole attention in shared
// memory: device memory sees one read of x and one write of o per row,
// plus the weights (from L2 after the first block). It cuts the shared
// loads with register tiles fed by float4 loads, as the tiled backward
// does:
//  * Layout. A group's tokens are token-major rows of TS = 5C + 4 floats,
//    x | ctx | q | k | v: ≡ 4 (mod 32) at C = 32, so eight tokens' float4s
//    at one column fall in eight 16-byte bank groups. The weights sit
//    row-major with rows padded by 4.
//  * A. x and the keep-mask bytes come in by cp.async: the next group's
//    are started as soon as stage B has read this group's x, and are
//    waited for at the top of the next group, so the loads run under
//    stages C and O (the mask into a second buffer).
//  * B. qkv = x·Wqkv + b as tiles of 4 tokens × 4 columns, the tokens NQ
//    apart: the 8 lanes of a quarter-warp read 8 consecutive tokens (no
//    bank conflict) and one broadcast float4 of weights, 16 FMAs a float4.
//  * C. one thread per (row, query, head), the heads of a row on
//    neighbouring lanes (no bank conflicts): float4s of the head's
//    channels, the softmax times 1/Σ, the keep-mask from shared memory.
//  * O. o = ctx·Wout + b as tiles of 2 tokens × 4 columns, the column tiles
//    on neighbouring lanes: a quarter-warp reads one broadcast ctx float4
//    and 8 consecutive weight float4s, and stores one token's 128
//    contiguous bytes straight from registers (3.5-5.5% faster than 8
//    tokens' 16-byte pieces).
//  * Groups and blocks, by measurement (tools/torch_attn_sweep.py and the
//    variants of tools/torch_attn_stages.py): two blocks of 256 threads an
//    SM, each with the most rows that leave room for the other (21 = 126
//    tokens at S = 6). Three blocks (11 rows, 80 registers) and one block
//    of 512 (42 rows) are 10-12% slower. 3 barriers a group.
//  * S = 6, the main path's edge tokens, is a constant in its
//    instantiation: 7-8% faster than the same code with a runtime S.
// What bounds it now (131072×6×32/8: about 0.35 ms, bound 0.105; H100
// 80GB HBM3, 700 W): stage
// B, about 40%, by shared loads (a distinct float4 of 4.2 cycles and a
// broadcast of 2.2 for every 16 FMAs); stage C, about a third, by issue
// and latency (a softmax, index divisions and byte loads for a few dozen
// FMAs an item). See PERF.md.
//
// The split forward does the forward's 4·C² FMAs a token as two float32
// GEMMs over all tokens (gemm_f32.cuh, the backward's), qkv = x·Wqkv + b
// before and o = ctx·Wout + b after a per-row attention core, on a scratch
// row of 3C floats a token rounded up to a multiple of 4: q | k | v, then
// ctx over q. No kernel keeps a weight, and the weights are read from L2
// once a 128×128 output tile, not once a group of rows. The scratch makes a round trip through device memory (3C floats written, 3C
// read, C written and C read again a token: 3.2 GB at that shape, ~1 ms at
// 3.35 TB/s). Bound: float32 FMAs (103 GFLOP at 131072×6×128/8, 1.54 ms at
// 67 TFLOP/s); the core by bytes. Outputs are one thread's FMA chain each:
// two calls give the same bits.
//
// Where C is not a multiple of 4, both split routes run the narrow form of
// the GEMMs (gemm_f32.cuh): every row stride of x, do, dx, out and the
// weights, and the bounds N = 3C and K = 3C, then cut 4-element chunks
// across rows, so the GEMMs copy and store one element at a time, 4
// copies for every one of the aligned form. The cores are the same: the
// forward's scratch row is padded to a multiple of 4 floats and the
// backward's (4C) is one, and a head width that is not a multiple of 4
// takes their one-float chunks. So every width that nhead divides runs
// through GEMM kernels.
//
// The tiled kernels take S <= 16; the split routes any S and any C: a row
// that fits a block's shared memory is staged there (past S = 16 through
// the long attention cores below), a longer one streams through shared
// memory in chunks, a (row, head) a block (the direct form: the streamed
// cores). All take C % nhead
// == 0 (the wrapper checks). They launch on the caller's stream, allocate
// nothing and do not synchronize; the C entry points return
// cudaGetLastError().
//
// Element types. This file builds two libraries: float32, and, with
// RMM_ATTENTION_BF16 defined, bf16 (elem_t below): x, do, out, dx, the
// weights and the biases in bf16, as the TPU kernel takes them under
// --precision bf16. Every sum stays float32, and so do the split routes'
// scratch rows, the weight-gradient partials and the reduce: the tiled
// kernels convert a bf16 row to float when they stage it in shared memory
// (4 elements at a time, 8-byte loads) and round when they store out or dx;
// the split routes' GEMMs take each operand in its own type: in the bf16
// build at every C % 4 = 0 on bf16 tensor cores (gemm_mma.cuh: mma.sync,
// float32 sums, a float32 scratch operand split into two bf16 terms, hi
// and lo, so that its products keep float32 accuracy), at the other widths
// as float32 FMAs (gemm_f32.cuh's narrow form). The weight and bias
// gradients are float32 in both builds, as the TPU kernel writes them.
// Both builds take every width.
//
// The backward's split route replaces _bwd_kernel at the split widths.
// Above C = 64 a per-row kernel fits neither the weights (256 kB at C =
// 128) in shared memory nor the 4C² + 4C weight-gradient sums in
// registers, so the split route does the backward's 11·C² FMAs a token as
// matrix products over all tokens, and no kernel keeps a weight or a
// weight-gradient sum for long:
// the projections, dx and the weight gradients are float32 GEMMs
// (gemm_f32.cuh: 128×128 tiles, cp.async rings, 8×8 register microtiles),
// and only the per-row attention, about 6·S·C FMAs a token, is a kernel of
// its own (the core, further down). The token rows q | k | v | dctx (4C
// floats a token) make a round trip through device memory between the
// launches (about 9 GB at the edge shape, ~2.9 ms at 3.35 TB/s), the price
// of keeping each launch a dense product. Bound: float32 FMAs on the CUDA
// cores (about 283 GFLOP at the edge shape, 4.2 ms at 67 TFLOP/s); TF32
// tensor cores would miss the backward's 1e-4 tolerance. The weight
// gradients sum fixed token ranges into partial slices that the reduce
// adds in a fixed order: two calls give the same bits. Measured (H100 80GB
// HBM3, 700 W): 9.34 ms at the edge shape, 2.2× its bound; the three GEMMs
// run at about half the FMA peak (stalls at 4 warps a scheduler, not a
// unit's rate), the core at two thirds of HBM's. See PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_f32.cuh"
#include "gemm_mma.cuh"

#ifdef RMM_ATTENTION_BF16
using elem_t = __nv_bfloat16;
#else
using elem_t = float;
#endif

namespace {

using rmm_gemm::Elem;
using E = Elem<elem_t>;

constexpr int kThreads = 256;

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
// Two routes compute it, chosen by width as the forward's are: the
// register-tiled kernel right below for every C <= 64 that is a multiple
// of 4 (the main path's C = 32), and the split route (the note at the top
// of this file) for every other C.
//
// The TPU kernel sums the weight gradients across its sequential grid. A
// Hopper grid runs in parallel, so both routes sum fixed parts of the
// tokens into slices of a [slices, 4C² + 4C] partials buffer (laid out as
// dWqkv | dbqkv | dWout | dbout), and a second kernel adds the slices in a
// fixed order: deterministic on a given card, no atomics.
//
// What bounds it: about 11·C² FMAs per token (the qkv recompute, dctx, dx
// and the two weight-gradient products) against x, do and dx moved once;
// float32 operations bound it.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// The register-tiled backward: every C <= 64 that is a multiple of 4 (the
// main path's C = 32 among them). Each block recomputes from x a group of
// rows at a time and sums the weight gradients of the groups it walks into
// its own partial slices.
//
// An SM issues one warp-wide shared load a clock against four warp FMAs,
// so a product that reads a 32-bit scalar from shared memory an FMA is
// bound by the loads. Here every product is a register tile fed by float4
// loads:
//  * Layout. A group's tokens are token-major rows of TS = 9C + 4 floats:
//    x | do | ctx | dctx | q | k | dq | dk | v, and dv overwrites v (no
//    stage reads v after C), so dqkv = dq | dk | dv is contiguous. TS is a
//    multiple of 4 (float4-aligned) and ≡ 4 (mod 32) at C = 32, so eight
//    consecutive tokens' float4s at one column fall in eight different
//    16-byte bank groups. The weights sit row-major with rows padded by 4.
//  * F, the weight gradients, is the product xᵀ·dqkv | ctxᵀ·do over the
//    group's tokens: each thread owns a 4×4 tile of [dWqkv | dWout] (C²/4
//    tiles, exactly 256 at C = 32) and per token reads one float4 of each
//    operand for 16 FMAs (one load per 8 FMAs, against 2 loads per FMA
//    before). The tiles of the first 4 channels also sum the bias
//    gradients from the float4 they already hold. Where there are fewer
//    tiles than threads, the threads split the tokens and each split has
//    its own partial slice; where more (C > 32), a thread owns 4 tiles.
//  * B (qkv = x·Wqkv + b, dctx = do·Woutᵀ) and E (dx = dqkv·Wqkvᵀ) are
//    tiles of 4 (B) or 2 (E) tokens × 4 output columns: per 4-deep step a
//    thread reads 4 float4s of weights, which serve every token of its tile,
//    and one float4 per token, which serves 4 columns. The tokens of a tile
//    are NQ apart, so the 8 lanes of a quarter-warp read 8 consecutive
//    tokens (no bank conflict) and the same weights (a broadcast).
//  * C, one thread per (row, query, head) with the heads of a row on
//    neighbouring lanes (no bank conflicts), reads float4s of a head's
//    channels and the keep-mask bytes that stage A staged with x and do
//    (16-byte loads), and multiplies by 1/Σ instead of dividing. D is one
//    thread per (token, 4 columns of dqkv) on float4 rows.
//  * Groups and blocks, by measurement (tools/torch_attn_sweep.py, and the
//    variants of tools/torch_attn_stages.py): two blocks of 256 threads an
//    SM (16 warps), 10 rows = 60 tokens a group at S = 6, take 3.5% less
//    time than one block of 512 threads with twice the rows, and a
//    quarter less than one block of 256 (8 warps); still 5 barriers a
//    group.
//
// What bounds it now (131072×6×32/8 with the keep-mask: 1.29 ms against
// 5.35 before, bound 0.29; H100 80GB HBM3, 700 W): no single unit. A
// warp's float4 shared load takes 4 cycles for 32 addresses, 2 for a
// broadcast, a float load 1 (tools/torch_smem_probe.py, at the 1,980 MHz
// SM clock it sampled); so counted, the stages need about 205
// shared-memory cycles and 97 of FMA issue a token, against about 430 the
// kernel takes at that clock. Shared memory is the busiest unit at about
// half its rate; the rest is latency and the waits at 5 barriers a group
// with 16 warps an SM. By stage (tools/torch_attn_stages.py): E+F 38%, B
// and D 19% each, C 17%, A 8%. Registers: 16 warps an SM leave 128 a
// thread, and stage F's 20 sums stay live through every stage. Launch
// bounds for three blocks an SM cap a thread at 80 and spill 240 bytes;
// at the 6 rows a group that leave shared memory for three blocks, three
// run no faster than two, and 14% slower than two at 10 rows. 8-token B
// tiles spill 140 bytes and run 5% slower at the same rows and blocks.
// Overlapping the next group's loads with cp.async would save at most the
// 5% that stage A's loads cost, for a second x/do/mask buffer
// of about 15 kB a block: not done.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc += a · w (one scalar times a float4)
__device__ __forceinline__ void fma4(float4& acc, float a, float4 w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One token of a qkv tile (outer form): acc += a[0..3] · W rows w0..w3.
__device__ __forceinline__ void outer4(float4& acc, float4 a, float4 w0,
                                       float4 w1, float4 w2, float4 w3) {
  fma4(acc, a.x, w0);
  fma4(acc, a.y, w1);
  fma4(acc, a.z, w2);
  fma4(acc, a.w, w3);
}

// One token of a dctx or dx tile (dot form): acc.c += a · W row c.
__device__ __forceinline__ void dots4(float4& acc, float4 a, float4 w0,
                                      float4 w1, float4 w2, float4 w3) {
  acc.x = dot4(a, w0, acc.x);
  acc.y = dot4(a, w1, acc.y);
  acc.z = dot4(a, w2, acc.z);
  acc.w = dot4(a, w3, acc.w);
}

// Stages shared by the tiled backward and the tiled forward.

// The weights into shared memory as floats, row-major with rows padded to
// WQS and WOS floats.
__device__ __forceinline__ void stage_weights(const elem_t* wqkv,
                                              const elem_t* wout, float* sWq,
                                              float* sWo, int C, int WQS,
                                              int WOS, int tid, int nt) {
  const int C3 = 3 * C;
  for (int i = tid; i < C * C3; i += nt) {
    const int c = i / C3;
    sWq[c * WQS + (i - c * C3)] = E::ldg1(wqkv + i);
  }
  for (int i = tid; i < C * C; i += nt) {
    const int c = i / C;
    sWo[c * WOS + (i - c * C)] = E::ldg1(wout + i);
  }
}

// A tile of NTOK tokens × output columns j .. j + 3 of a projection, in
// the outer form: a4[i] = bias[j..] + Σ_c t_i[c] · W[c][j..], token i's
// row at t0 + i·step, W row-major with rows WS floats apart.
template <int NTOK>
__device__ __forceinline__ void proj_tile(float4 (&a4)[NTOK], const float* t0,
                                          int step, const float* W, int WS,
                                          const elem_t* bias, int j, int C) {
  const float4 bj = make_float4(E::ldg1(bias + j), E::ldg1(bias + j + 1),
                                E::ldg1(bias + j + 2), E::ldg1(bias + j + 3));
#pragma unroll
  for (int i = 0; i < NTOK; ++i) a4[i] = bj;
#pragma unroll 4
  for (int c = 0; c < C; c += 4) {
    const float* w = W + c * WS + j;
    const float4 w0 = ld4(w), w1 = ld4(w + WS), w2 = ld4(w + 2 * WS),
                 w3 = ld4(w + 3 * WS);
#pragma unroll
    for (int i = 0; i < NTOK; ++i)
      outer4(a4[i], ld4(t0 + i * step + c), w0, w1, w2, w3);
  }
}

// The softmax of S scores, scaled first, in place (entries past S stay 0).
template <int MAXS>
__device__ __forceinline__ void softmax(float (&p)[MAXS], int S,
                                        float scale) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    if (j < S) {
      p[j] *= scale;
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
  const float inv_sum = 1.f / sum;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) p[j] *= inv_sum;
}

// p_j · keep_j / (1 − rate), from the staged keep-mask bytes kp.
template <int MAXS>
__device__ __forceinline__ void keep_scale(float (&p)[MAXS],
                                           const uint8_t* kp, int S,
                                           float inv_keep) {
#pragma unroll
  for (int j = 0; j < MAXS; ++j)
    if (j < S) p[j] = kp[j] ? p[j] * inv_keep : 0.f;
}

// ctx[t] = Σ_j p_j v_j[t] over a head's hd channels, token j's v at
// v + j·TS; float4 loads where hd is a multiple of 4.
template <int MAXS>
__device__ __forceinline__ void context(float* ctx, const float (&p)[MAXS],
                                        const float* v, int TS, int hd,
                                        int S) {
  if (hd % 4 == 0) {
    for (int t = 0; t < hd; t += 4) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) fma4(a, p[j], ld4(v + j * TS + t));
      st4(ctx + t, a);
    }
  } else {
    for (int t = 0; t < hd; ++t) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) a = fmaf(p[j], v[j * TS + t], a);
      ctx[t] = a;
    }
  }
}

constexpr int kTokB = 4;  // tokens of a stage-B tile
constexpr int kTokE = 2;  // tokens of a stage-E tile
constexpr int kTiledThreads = 256;  // two blocks an SM where MAXT == 1

// Floats of the tiled kernel's shared memory for a group of `rows` rows:
// the weights, the token rows (rounded up to whole stage-B tiles), the
// P_d and dS of each row and the rows' keep-mask bytes.
__host__ __device__ inline size_t tiled_smem_floats(int S, int C, int H,
                                                    int rows) {
  const size_t tp = ((size_t)rows * S + kTokB - 1) / kTokB * kTokB;
  const size_t hss = (size_t)rows * H * S * S;
  return (size_t)C * (3 * C + 4) + (size_t)C * (C + 4) +
         tp * (9 * C + 4) + 2 * hss + (hss + 3) / 4;
}

// Token splits of stage F: how many partial slices each block writes.
__host__ __device__ inline int tiled_splits(int C) {
  const int tiles = C * C / 4;
  return tiles >= kTiledThreads ? 1 : kTiledThreads / tiles;
}

template <int MAXS, int MAXT>
__global__ void __launch_bounds__(kTiledThreads, MAXT == 1 ? 2 : 1)
column_attention_bwd_tiled_kernel(const elem_t* __restrict__ x,
                                  const elem_t* __restrict__ dout,
                                  const elem_t* __restrict__ wqkv,
                                  const elem_t* __restrict__ bqkv,
                                  const elem_t* __restrict__ wout,
                                  const uint8_t* __restrict__ keep,
                                  elem_t* __restrict__ dx,
                                  float* __restrict__ partials, int B, int S,
                                  int C, int H, float scale, float inv_keep,
                                  int rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int NT = kTiledThreads;
  const int tid = threadIdx.x;
  const int C3 = 3 * C;
  const int C4 = C / 4;
  const int hd = C / H;
  const int SC = S * C;
  const int SS = S * S;
  const int HSS = H * SS;
  const int total = 4 * C * C + 4 * C;
  const int WQS = C3 + 4;  // padded weight rows
  const int WOS = C + 4;
  const int TS = 9 * C + 4;
  // Offsets in a token row.
  const int DO = C, CTX = 2 * C, DCTX = 3 * C, Q = 4 * C, K = 5 * C,
            DQKV = 6 * C, V = 8 * C;

  float* sWq = smem;              // Wqkv [C][WQS]
  float* sWo = sWq + C * WQS;     // Wout [C][WOS]
  float* tok = sWo + C * WOS;     // token rows [TP][TS]
  const int TP = (rows * S + kTokB - 1) / kTokB * kTokB;
  float* pb = tok + TP * TS;      // P_d [rows][H][S][S]
  float* sb = pb + rows * HSS;    // dS
  uint8_t* kb = reinterpret_cast<uint8_t*>(sb + rows * HSS);  // keep-mask
  stage_weights(wqkv, wout, sWq, sWo, C, WQS, WOS, tid, NT);

  // Stage F's tiles: tile k < 3C²/16 is dWqkv[4ct.., 4jt..] = Σ x ⊗ dqkv,
  // the rest dWout[4ct.., 4et..] = Σ ctx ⊗ do; a tile with ct = 0 also
  // sums its columns' bias gradient.
  const int tiles = C * C / 4;
  const int qtiles = 3 * C * C / 16;
  const int splits = tiled_splits(C);
  const int split = tiles >= NT ? 0 : tid / tiles;
  int aoff[MAXT], boff[MAXT], out[MAXT], ostride[MAXT], bout_at[MAXT];
  bool own[MAXT];
  float4 acc[MAXT][4], bacc[MAXT];
#pragma unroll
  for (int m = 0; m < MAXT; ++m) {
    const int k = tiles >= NT ? tid + m * NT : tid % tiles;
    own[m] = split < splits && k < tiles && (m == 0 || tiles >= NT);
    if (k < qtiles) {
      const int ct = k / (3 * C4);
      const int jt = k - ct * 3 * C4;
      aoff[m] = 4 * ct;
      boff[m] = DQKV + 4 * jt;
      out[m] = 4 * ct * C3 + 4 * jt;
      ostride[m] = C3;
      bout_at[m] = ct == 0 ? C * C3 + 4 * jt : -1;
    } else {
      const int kk = k - qtiles;
      const int ct = kk / C4;
      const int et = kk - ct * C4;
      aoff[m] = CTX + 4 * ct;
      boff[m] = DO + 4 * et;
      out[m] = C * C3 + C3 + 4 * ct * C + 4 * et;
      ostride[m] = C;
      bout_at[m] = ct == 0 ? C * C3 + C3 + C * C + 4 * et : -1;
    }
    bacc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[m][cc] = bacc[m];
  }

  const int ngroups = (B + rows - 1) / rows;
  for (int g = blockIdx.x; g < ngroups; g += gridDim.x) {
    const int r0 = g * rows;
    const int nr = min(rows, B - r0);
    const int T = nr * S;
    __syncthreads();  // weights staged / previous group done with buffers

    // A. x and do rows → token rows (4 elements a load as floats,
    //    coalesced), and the group's keep-mask bytes
    const elem_t* xg = x + (size_t)r0 * SC;
    const elem_t* dg = dout + (size_t)r0 * SC;
    for (int i = tid; i < T * C4; i += NT) {
      const int t = i / C4;
      const int c = 4 * (i - t * C4);
      st4(tok + t * TS + c, E::ldg4(xg + 4 * i));
      st4(tok + t * TS + DO + c, E::ldg4(dg + 4 * i));
    }
    if (keep != nullptr) {
      const uint8_t* kg = keep + (size_t)r0 * HSS;
      if (HSS % 16 == 0 && reinterpret_cast<uintptr_t>(keep) % 16 == 0) {
        const uint4* kg4 = reinterpret_cast<const uint4*>(kg);
        uint4* kb4 = reinterpret_cast<uint4*>(kb);
        for (int i = tid; i < nr * HSS / 16; i += NT) kb4[i] = __ldg(kg4 + i);
      } else {
        for (int i = tid; i < nr * HSS; i += NT) kb[i] = kg[i];
      }
    }
    __syncthreads();

    // B. tiles of kTokB tokens (q, q + NQ, ...) × 4 columns: column tiles
    //    jt < 3C/4 are qkv = x·Wqkv + b, the rest dctx = do·Woutᵀ. Tokens
    //    past T (the ragged tail of the last tile) compute unused values.
    const int NQ = (T + kTokB - 1) / kTokB;
    for (int it = tid; it < NQ * C; it += NT) {
      const int jt = it / NQ;
      float* t0 = tok + (it - jt * NQ) * TS;
      const int step = NQ * TS;
      float4 a4[kTokB];
      if (jt < 3 * C4) {
        const int j = 4 * jt;
        proj_tile(a4, t0, step, sWq, WQS, bqkv, j, C);
        const int dst = j < 2 * C ? Q + j : V - 2 * C + j;
#pragma unroll
        for (int i = 0; i < kTokB; ++i) st4(t0 + i * step + dst, a4[i]);
      } else {
        const int c = 4 * (jt - 3 * C4);
#pragma unroll
        for (int i = 0; i < kTokB; ++i) a4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int e = 0; e < C; e += 4) {
          const float* w = sWo + c * WOS + e;
          const float4 w0 = ld4(w), w1 = ld4(w + WOS),
                       w2 = ld4(w + 2 * WOS), w3 = ld4(w + 3 * WOS);
#pragma unroll
          for (int i = 0; i < kTokB; ++i)
            dots4(a4[i], ld4(t0 + i * step + DO + e), w0, w1, w2, w3);
        }
#pragma unroll
        for (int i = 0; i < kTokB; ++i) st4(t0 + i * step + DCTX + c, a4[i]);
      }
    }
    __syncthreads();

    // C. one thread per (row, query i, head h), h fastest so that a
    //    quarter-warp's 8 heads fall in 8 bank groups: the softmax row, its
    //    dropped twin P_d, dS and the context, over float4s of the head's
    //    channels where head_dim is a multiple of 4.
    for (int it = tid; it < nr * S * H; it += NT) {
      const int r = it / (S * H);
      const int rem = it - r * S * H;
      const int i = rem / H;
      const int h = rem - i * H;
      const float* rowp = tok + r * S * TS + h * hd;  // token j: + j * TS
      const float* q = rowp + i * TS + Q;
      const float* gi = rowp + i * TS + DCTX;
      float p[MAXS], dp[MAXS];
#pragma unroll
      for (int j = 0; j < MAXS; ++j) p[j] = dp[j] = 0.f;
      if (hd % 4 == 0) {
        for (int t = 0; t < hd; t += 4) {
          const float4 q4 = ld4(q + t), g4 = ld4(gi + t);
#pragma unroll
          for (int j = 0; j < MAXS; ++j) {
            if (j < S) {
              p[j] = dot4(q4, ld4(rowp + j * TS + K + t), p[j]);
              dp[j] = dot4(g4, ld4(rowp + j * TS + V + t), dp[j]);
            }
          }
        }
      } else {
        for (int t = 0; t < hd; ++t) {
#pragma unroll
          for (int j = 0; j < MAXS; ++j) {
            if (j < S) {
              p[j] = fmaf(q[t], rowp[j * TS + K + t], p[j]);
              dp[j] = fmaf(gi[t], rowp[j * TS + V + t], dp[j]);
            }
          }
        }
      }
      softmax(p, S, scale);
      const uint8_t* kp = kb + (r * H + h) * SS + i * S;
      if (keep != nullptr) keep_scale(dp, kp, S, inv_keep);
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) dot = fmaf(p[j], dp[j], dot);
      float* dsr = sb + r * HSS + (h * S + i) * S;
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) dsr[j] = p[j] * (dp[j] - dot) * scale;
      if (keep != nullptr) keep_scale(p, kp, S, inv_keep);
      float* pdr = pb + r * HSS + (h * S + i) * S;
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) pdr[j] = p[j];
      context(tok + (r * S + i) * TS + CTX + h * hd, p, rowp + V, TS, hd, S);
    }
    __syncthreads();

    // D. dqkv, one thread per (token, 4 columns of [dq dk dv]):
    //    dq_s = Σ_j dS[h,s,j] k_j, dk_s = Σ_i dS[h,i,s] q_i,
    //    dv_s = Σ_i P_d[h,i,s] dctx_i; dv lands on v, which C was the last
    //    to read.
    const int C34 = 3 * C4;
    for (int it = tid; it < T * C34; it += NT) {
      const int t = it / C34;
      const int j = 4 * (it - t * C34);
      const int r = t / S;
      const int s = t - r * S;
      const float* src;   // the S token rows this sum runs over
      const float* coef;  // its coefficients, head 0; step cs over the sum
      int c, cs;
      if (j < C) {
        c = j;
        src = tok + r * S * TS + K + c;
        coef = sb + r * HSS + s * S;
        cs = 1;
      } else if (j < 2 * C) {
        c = j - C;
        src = tok + r * S * TS + Q + c;
        coef = sb + r * HSS + s;
        cs = S;
      } else {
        c = j - 2 * C;
        src = tok + r * S * TS + DCTX + c;
        coef = pb + r * HSS + s;
        cs = S;
      }
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hd % 4 == 0) {  // the 4 columns lie in one head
        const float* cp = coef + (c / hd) * SS;
#pragma unroll
        for (int u = 0; u < MAXS; ++u)
          if (u < S) fma4(a, cp[u * cs], ld4(src + u * TS));
      } else {
        const float* c0 = coef + (c / hd) * SS;
        const float* c1 = coef + ((c + 1) / hd) * SS;
        const float* c2 = coef + ((c + 2) / hd) * SS;
        const float* c3 = coef + ((c + 3) / hd) * SS;
#pragma unroll
        for (int u = 0; u < MAXS; ++u) {
          if (u < S) {
            const float4 v = ld4(src + u * TS);
            a.x = fmaf(c0[u * cs], v.x, a.x);
            a.y = fmaf(c1[u * cs], v.y, a.y);
            a.z = fmaf(c2[u * cs], v.z, a.z);
            a.w = fmaf(c3[u * cs], v.w, a.w);
          }
        }
      }
      st4(tok + t * TS + DQKV + j, a);
    }
    __syncthreads();

    // E. dx = dqkv·Wqkvᵀ, tiles of kTokE tokens (q, q + NQE) × 4 channels,
    //    stored straight to device memory.
    const int NQE = (T + kTokE - 1) / kTokE;
    elem_t* dxg = dx + (size_t)r0 * SC;
    for (int it = tid; it < NQE * C4; it += NT) {
      const int ct = it / NQE;
      const int q = it - ct * NQE;
      const int c = 4 * ct;
      const float* t0 = tok + q * TS + DQKV;
      const int step = NQE * TS;
      float4 a4[kTokE];
#pragma unroll
      for (int i = 0; i < kTokE; ++i) a4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < C3; j += 4) {
        const float* w = sWq + c * WQS + j;
        const float4 w0 = ld4(w), w1 = ld4(w + WQS), w2 = ld4(w + 2 * WQS),
                     w3 = ld4(w + 3 * WQS);
#pragma unroll
        for (int i = 0; i < kTokE; ++i)
          dots4(a4[i], ld4(t0 + i * step + j), w0, w1, w2, w3);
      }
#pragma unroll
      for (int i = 0; i < kTokE; ++i)
        if (q + i * NQE < T) E::st4(dxg + (q + i * NQE) * C + c, a4[i]);
    }

    // F. the weight and bias gradients of this group into the thread's
    //    tiles (reads what E reads, so no barrier between them).
#pragma unroll 4
    for (int t = split; t < T; t += splits) {
      const float* row = tok + t * TS;
#pragma unroll
      for (int m = 0; m < MAXT; ++m) {
        if (own[m]) {
          const float4 a = ld4(row + aoff[m]);
          const float4 b = ld4(row + boff[m]);
          fma4(acc[m][0], a.x, b);
          fma4(acc[m][1], a.y, b);
          fma4(acc[m][2], a.z, b);
          fma4(acc[m][3], a.w, b);
          if (bout_at[m] >= 0) {
            bacc[m].x += b.x;
            bacc[m].y += b.y;
            bacc[m].z += b.z;
            bacc[m].w += b.w;
          }
        }
      }
    }
  }

  float* part = partials + ((size_t)blockIdx.x * splits + split) * total;
#pragma unroll
  for (int m = 0; m < MAXT; ++m) {
    if (own[m]) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        st4(part + out[m] + cc * ostride[m], acc[m][cc]);
      if (bout_at[m] >= 0) st4(part + bout_at[m], bacc[m]);
    }
  }
}

template <int MS, int MT>
struct TiledCfg {
  static constexpr int kMaxS = MS, kMaxTiles = MT;
};

// Calls f(TiledCfg<...>{}) for the instantiation that takes (S, C): the
// exact S of the main path (2 and 6), else S rounded up to 4, 8 or 16; 1
// stage-F tile a thread, or 4 where C²/4 > kTiledThreads (C > 32).
template <int MS, class F>
cudaError_t tiled_by_tiles(int C, F& f) {
  if (C * C / 4 <= kTiledThreads) return f(TiledCfg<MS, 1>{});
  return f(TiledCfg<MS, 4>{});
}

// Calls f(std::integral_constant<int, MAXS>{}) for the S a tiled kernel
// instantiates for S: the exact S of the main path (2 and 6), else S
// rounded up to 4, 8 or 16.
template <class F>
cudaError_t by_s(int S, F f) {
  if (S <= 2) return f(std::integral_constant<int, 2>{});
  if (S <= 4) return f(std::integral_constant<int, 4>{});
  if (S == 6) return f(std::integral_constant<int, 6>{});
  if (S <= 8) return f(std::integral_constant<int, 8>{});
  return f(std::integral_constant<int, 16>{});
}

template <class F>
cudaError_t tiled_dispatch(int S, int C, F f) {
  return by_s(S, [&](auto ms) {
    return tiled_by_tiles<decltype(ms)::value>(C, f);
  });
}

// ---------------------------------------------------------------------------
// The register-tiled forward: every C <= 64 that is a multiple of 4. Its
// design and what bounds it are in the note at the top of this file.
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 256;
constexpr int kFwdTokB = 4;  // tokens of a stage-B tile
constexpr int kFwdTokO = 2;  // tokens of a stage-O tile
constexpr int kFwdTokPad = kFwdTokB > kFwdTokO ? kFwdTokB : kFwdTokO;

// Floats of the tiled forward's shared memory for a group of `rows` rows:
// the weights, the token rows (rounded up to whole tiles) and two buffers
// of the rows' keep-mask bytes (16-byte aligned).
__host__ __device__ inline size_t fwd_tiled_smem_floats(int S, int C, int H,
                                                        int rows) {
  const size_t tp =
      ((size_t)rows * S + kFwdTokPad - 1) / kFwdTokPad * kFwdTokPad;
  const size_t hss = (size_t)rows * H * S * S;
  return (size_t)C * (3 * C + 4) + (size_t)C * (C + 4) + tp * (5 * C + 4) +
         2 * ((hss + 15) / 16 * 4);
}

// 16 bytes from device memory to shared memory, asynchronously (cp.async,
// not through registers or L1); they land by cp_async_wait_all().
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 8 and 4 bytes from device memory to shared memory (cp.async through L1:
// the .cg form takes only 16), and the group forms: commit the copies
// started so far as a group; wait until at most N groups are in flight.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 elements of x into a float token row: float32 by cp.async (landing by
// cp_async_wait_all()), bf16 through registers, converted (cp.async copies
// bytes as they lie).
__device__ __forceinline__ void load_x4(float* dst, const elem_t* src) {
  if constexpr (std::is_same<elem_t, float>::value)
    cp_async16(dst, src);
  else
    st4(dst, E::ldg4(src));
}

// Starts the loads of rows r0 .. r0 + nr: x into the token rows' x slots
// (TS floats apart) and the keep-mask bytes (HSS a row) into kb.
__device__ __forceinline__ void fwd_load_group(const elem_t* x,
                                               const uint8_t* keep,
                                               float* tok, uint8_t* kb,
                                               int r0, int nr, int S, int C,
                                               int HSS, int TS, int tid) {
  const int C4 = C / 4;
  const elem_t* xg = x + (size_t)r0 * S * C;
  for (int i = tid; i < nr * S * C4; i += kFwdThreads) {
    const int t = i / C4;
    load_x4(tok + t * TS + 4 * (i - t * C4), xg + 4 * i);
  }
  if (keep == nullptr) return;
  const uint8_t* kg = keep + (size_t)r0 * HSS;
  if (HSS % 16 == 0 && reinterpret_cast<uintptr_t>(keep) % 16 == 0) {
    for (int i = tid; i < nr * HSS / 16; i += kFwdThreads)
      cp_async16(kb + 16 * i, kg + 16 * i);
  } else {
    for (int i = tid; i < nr * HSS; i += kFwdThreads) kb[i] = kg[i];
  }
}

template <int MAXS>
__global__ void __launch_bounds__(kFwdThreads, 2)
column_attention_fwd_tiled_kernel(const elem_t* __restrict__ x,
                                  const elem_t* __restrict__ wqkv,
                                  const elem_t* __restrict__ bqkv,
                                  const elem_t* __restrict__ wout,
                                  const elem_t* __restrict__ bout,
                                  const uint8_t* __restrict__ keep,
                                  elem_t* __restrict__ out, int B, int S,
                                  int C, int H, float scale, float inv_keep,
                                  int rows) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int NT = kFwdThreads;
  // by_s instantiates MAXS = 6 for S = 6 alone: as a constant, S takes the
  // bounds checks out of the main path's loops over the keys.
  if (MAXS == 6) S = 6;
  const int tid = threadIdx.x;
  const int C3 = 3 * C;
  const int C4 = C / 4;
  const int hd = C / H;
  const int SC = S * C;
  const int SS = S * S;
  const int HSS = H * SS;
  const int WQS = C3 + 4;  // padded weight rows
  const int WOS = C + 4;
  const int TS = 5 * C + 4;
  const int CTX = C, Q = 2 * C, K = 3 * C, V = 4 * C;  // x at 0

  float* sWq = smem;              // Wqkv [C][WQS]
  float* sWo = sWq + C * WQS;     // Wout [C][WOS]
  float* tok = sWo + C * WOS;     // token rows [TP][TS]
  const int TP = (rows * S + kFwdTokPad - 1) / kFwdTokPad * kFwdTokPad;
  const int KBS = (rows * HSS + 15) / 16 * 16;  // bytes of a mask buffer
  uint8_t* kb = reinterpret_cast<uint8_t*>(tok + TP * TS);  // 2 buffers
  stage_weights(wqkv, wout, sWq, sWo, C, WQS, WOS, tid, NT);

  const int ngroups = (B + rows - 1) / rows;
  int g = blockIdx.x;
  if (g < ngroups)
    fwd_load_group(x, keep, tok, kb, g * rows, min(rows, B - g * rows), S,
                   C, HSS, TS, tid);
  for (int par = 0; g < ngroups; g += gridDim.x, par ^= 1) {
    const int r0 = g * rows;
    const int nr = min(rows, B - r0);
    const int T = nr * S;
    cp_async_wait_all();
    __syncthreads();  // the group's x and keep-mask landed, weights staged

    // B. qkv = x·Wqkv + b, tiles of kFwdTokB tokens (q, q + NQ, ...) × 4
    //    columns. Tokens past T (the ragged tail of the last tile) compute
    //    unused values.
    const int NQ = (T + kFwdTokB - 1) / kFwdTokB;
    for (int it = tid; it < NQ * 3 * C4; it += NT) {
      const int jt = it / NQ;
      float* t0 = tok + (it - jt * NQ) * TS;
      const int step = NQ * TS;
      float4 a4[kFwdTokB];
      proj_tile(a4, t0, step, sWq, WQS, bqkv, 4 * jt, C);
#pragma unroll
      for (int i = 0; i < kFwdTokB; ++i)
        st4(t0 + i * step + Q + 4 * jt, a4[i]);
    }
    __syncthreads();

    // A. the next group's loads, into the x slots B is done with and the
    //    other mask buffer: they run under C and O (bf16 x through
    //    registers, so its loads are waited for here).
    const int gn = g + gridDim.x;
    if (gn < ngroups)
      fwd_load_group(x, keep, tok, kb + (par ^ 1) * KBS, gn * rows,
                     min(rows, B - gn * rows), S, C, HSS, TS, tid);

    // C. one thread per (row, query i, head h), h fastest so that a
    //    quarter-warp's 8 heads fall in 8 bank groups: the scores, the
    //    softmax (with the keep-mask) and the context.
    const uint8_t* kp0 = kb + par * KBS;
    for (int it = tid; it < nr * S * H; it += NT) {
      const int r = it / (S * H);
      const int rem = it - r * S * H;
      const int i = rem / H;
      const int h = rem - i * H;
      float* rowp = tok + r * S * TS + h * hd;  // token j: + j * TS
      const float* q = rowp + i * TS + Q;
      float p[MAXS];
#pragma unroll
      for (int j = 0; j < MAXS; ++j) p[j] = 0.f;
      if (hd % 4 == 0) {
        for (int t = 0; t < hd; t += 4) {
          const float4 q4 = ld4(q + t);
#pragma unroll
          for (int j = 0; j < MAXS; ++j)
            if (j < S) p[j] = dot4(q4, ld4(rowp + j * TS + K + t), p[j]);
        }
      } else {
        for (int t = 0; t < hd; ++t) {
#pragma unroll
          for (int j = 0; j < MAXS; ++j)
            if (j < S) p[j] = fmaf(q[t], rowp[j * TS + K + t], p[j]);
        }
      }
      softmax(p, S, scale);
      if (keep != nullptr)
        keep_scale(p, kp0 + (r * H + h) * SS + i * S, S, inv_keep);
      context(rowp + i * TS + CTX, p, rowp + V, TS, hd, S);
    }
    __syncthreads();

    // O. o = ctx·Wout + b, tiles of kFwdTokO tokens (q, q + NQO) × 4
    //    columns with the columns fastest, stored straight to device
    //    memory: a quarter-warp stores one token's 128 contiguous bytes.
    const int NQO = (T + kFwdTokO - 1) / kFwdTokO;
    elem_t* og = out + (size_t)r0 * SC;
    for (int it = tid; it < NQO * C4; it += NT) {
      const int q = it / C4;
      const int ct = it - q * C4;
      float4 a4[kFwdTokO];
      proj_tile(a4, tok + q * TS + CTX, NQO * TS, sWo, WOS, bout, 4 * ct, C);
#pragma unroll
      for (int i = 0; i < kFwdTokO; ++i)
        if (q + i * NQO < T) E::st4(og + (q + i * NQO) * C + 4 * ct, a4[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// The split backward: every C that the tiled kernel does not take (64 <
// C, the SSL width among them, or C not a multiple of 4). Five
// launches, each a kernel of this file or of gemm_f32.cuh, over a scratch
// row of 4C floats a token (the design and what bounds it are in the note
// at the top of this file):
//   1. qkv = x·Wqkv + bqkv and dctx = do·Woutᵀ (one GEMM launch, two
//      problems) into the token rows q | k | v | dctx;
//   2. the attention core below, which writes dq | dk | dv over q | k | v
//      and ctx over dctx;
//   3. dx = dqkv·Wqkvᵀ (GEMM);
//   4. [dWqkv | dbqkv] = xᵀ·[dqkv | 1] and [dWout | dbout] = ctxᵀ·[do | 1]
//      over fixed token ranges, one partial slice each (GEMM, two
//      problems);
//   5. the fixed-order reduce of those slices.
//
// The attention core. A block stages `rows` rows (rows·S consecutive
// token rows of `tok`) in shared memory, then one thread per (row, head,
// query i):
//   P = softmax(q_i k_jᵀ / √hd), P_d = P · keep/(1 − p),
//   dP_j = (dctx_i · v_j) · keep/(1 − p), dS = P (dP − Σ_j P dP) / √hd,
//   ctx_i = Σ_j P_d,ij v_j, dq_i = Σ_j dS_ij k_j,
// and after a barrier one per (row, head, key t):
//   dk_t = Σ_i dS_it q_i, dv_t = Σ_i P_d,it dctx_i.
// Writing in place is safe: every read comes from the staged copy, and a
// block's rows are its own.
// ---------------------------------------------------------------------------

constexpr int kCoreThreads = 256;
// The longest S for which a core's thread keeps a query's S scores in
// registers and the backward core stages each row's S×S P_d and dS (the
// tiled kernels' bound too). Longer rows take the long cores further down.
constexpr int kShortS = 16;

// Floats of the backward core's shared memory for `rows` rows: the token
// rows, padded to 4C + 4 floats (token i's float4s at one column fall in
// neighbouring bank groups), and each row's P_d and dS; past kShortS (the
// long core) each query's log-sum-exp and D instead.
__host__ __device__ inline size_t core_smem_floats(int S, int C, int H,
                                                   int rows) {
  const size_t tokens = (size_t)rows * S * (4 * C + 4);
  if (S > kShortS) return tokens + 2 * (size_t)rows * H * S;
  return tokens + 2 * (size_t)rows * H * S * S;
}

// W consecutive floats of a head's channels: a float4 where the head
// width is a multiple of 4, else one float.
template <int W>
struct Chunk;

template <>
struct Chunk<4> {
  float4 v;
  __device__ static Chunk zero() { return {make_float4(0.f, 0.f, 0.f, 0.f)}; }
  __device__ static Chunk load(const float* p) { return {ld4(p)}; }
  __device__ void fma(float a, const Chunk& b) { fma4(v, a, b.v); }
  __device__ float dot(const Chunk& b, float acc) const {
    return dot4(v, b.v, acc);
  }
  __device__ void scale(float a) {
    v.x *= a;
    v.y *= a;
    v.z *= a;
    v.w *= a;
  }
  __device__ void store(float* p) const { st4(p, v); }
};

template <>
struct Chunk<1> {
  float v;
  __device__ static Chunk zero() { return {0.f}; }
  __device__ static Chunk load(const float* p) { return {*p}; }
  __device__ void fma(float a, const Chunk& b) { v = fmaf(a, b.v, v); }
  __device__ float dot(const Chunk& b, float acc) const {
    return fmaf(v, b.v, acc);
  }
  __device__ void scale(float a) { v *= a; }
  __device__ void store(float* p) const { *p = v; }
};

// Query i of head h of the block's row r: the softmax row and its VJP
// into sP/sD, ctx_i and dq_i into the token row `out` (global).
template <int W, int MAXS>
__device__ __forceinline__ void core_query(const float* sT, float* sP,
                                           float* sD, float* out,
                                           const uint8_t* kp, int r, int h,
                                           int i, int S, int C, int H,
                                           int TS, float scale,
                                           float inv_keep) {
  const int hd = C / H;
  const float* ti = sT + (r * S + i) * TS + h * hd;
  const float* tr = sT + r * S * TS + h * hd;  // token 0 of the row
  float p[MAXS], dp[MAXS];
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    p[j] = 0.f;
    dp[j] = 0.f;
    if (j < S) {
      const float* tj = tr + j * TS;
      float d = 0.f, e = 0.f;
      for (int c = 0; c < hd; c += W) {
        d = Chunk<W>::load(ti + c).dot(Chunk<W>::load(tj + C + c), d);
        e = Chunk<W>::load(ti + 3 * C + c)
                .dot(Chunk<W>::load(tj + 2 * C + c), e);
      }
      p[j] = d;
      dp[j] = e;
    }
  }
  softmax(p, S, scale);
  if (kp != nullptr) keep_scale(dp, kp, S, inv_keep);
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < MAXS; ++j)
    if (j < S) dot = fmaf(p[j], dp[j], dot);
  float ds[MAXS];
#pragma unroll
  for (int j = 0; j < MAXS; ++j) ds[j] = p[j] * (dp[j] - dot) * scale;
  if (kp != nullptr) keep_scale(p, kp, S, inv_keep);
  const int base = ((r * H + h) * S + i) * S;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    if (j < S) {
      sP[base + j] = p[j];
      sD[base + j] = ds[j];
    }
  }
  for (int c = 0; c < hd; c += W) {
    Chunk<W> ctx = Chunk<W>::zero(), dq = Chunk<W>::zero();
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      if (j < S) {
        const float* tj = tr + j * TS;
        ctx.fma(p[j], Chunk<W>::load(tj + 2 * C + c));
        dq.fma(ds[j], Chunk<W>::load(tj + C + c));
      }
    }
    ctx.store(out + 3 * C + c);
    dq.store(out + c);
  }
}

// Key t of head h of row r: dk_t and dv_t into the token row `out`.
template <int W, int MAXS>
__device__ __forceinline__ void core_key(const float* sT, const float* sP,
                                         const float* sD, float* out, int r,
                                         int h, int t, int S, int C, int H,
                                         int TS) {
  const int hd = C / H;
  const float* tr = sT + r * S * TS + h * hd;
  const int base = (r * H + h) * S * S + t;
  float pc[MAXS], dc[MAXS];
#pragma unroll
  for (int i = 0; i < MAXS; ++i) {
    pc[i] = i < S ? sP[base + i * S] : 0.f;
    dc[i] = i < S ? sD[base + i * S] : 0.f;
  }
  for (int c = 0; c < hd; c += W) {
    Chunk<W> dk = Chunk<W>::zero(), dv = Chunk<W>::zero();
#pragma unroll
    for (int i = 0; i < MAXS; ++i) {
      if (i < S) {
        const float* ti = tr + i * TS;
        dk.fma(dc[i], Chunk<W>::load(ti + c));
        dv.fma(pc[i], Chunk<W>::load(ti + 3 * C + c));
      }
    }
    dk.store(out + C + c);
    dv.store(out + 2 * C + c);
  }
}

template <int MAXS>
__global__ void __launch_bounds__(kCoreThreads)
column_attention_bwd_core_kernel(float* __restrict__ tok,
                                 const uint8_t* __restrict__ keep, int B,
                                 int S, int C, int H, float scale,
                                 float inv_keep, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int TT = 4 * C;      // a token row in device memory
  const int TS = TT + 4;     // in shared memory
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, B - r0);
  const int HS = H * S;
  float* sT = smem;
  float* sP = sT + (size_t)rows * S * TS;
  float* sD = sP + (size_t)rows * HS * S;
  float* tg = tok + (size_t)r0 * S * TT;

  for (int i = tid; i < nr * S * C; i += kCoreThreads) {  // C float4s a row
    const int t = i / C;
    const int q = i - t * C;
    st4(sT + t * TS + 4 * q, ld4(tg + (size_t)t * TT + 4 * q));
  }
  __syncthreads();
  const bool vec = (C / H) % 4 == 0;
  for (int it = tid; it < nr * HS; it += kCoreThreads) {
    const int r = it / HS;
    const int h = (it - r * HS) / S;
    const int i = it - r * HS - h * S;
    float* out = tg + (size_t)(r * S + i) * TT + h * (C / H);
    const uint8_t* kp =
        keep == nullptr ? nullptr
                        : keep + (((size_t)(r0 + r) * H + h) * S + i) * S;
    if (vec)
      core_query<4, MAXS>(sT, sP, sD, out, kp, r, h, i, S, C, H, TS, scale,
                          inv_keep);
    else
      core_query<1, MAXS>(sT, sP, sD, out, kp, r, h, i, S, C, H, TS, scale,
                          inv_keep);
  }
  __syncthreads();
  for (int it = tid; it < nr * HS; it += kCoreThreads) {
    const int r = it / HS;
    const int h = (it - r * HS) / S;
    const int t = it - r * HS - h * S;
    float* out = tg + (size_t)(r * S + t) * TT + h * (C / H);
    if (vec)
      core_key<4, MAXS>(sT, sP, sD, out, r, h, t, S, C, H, TS);
    else
      core_key<1, MAXS>(sT, sP, sD, out, r, h, t, S, C, H, TS);
  }
}

// The split routes' GEMM problems: x, do, the weights, out and dx in
// elem_t, the scratch rows and the weight-gradient partials in float.
// Layouts: A m-major or k-major, B k-major or n-major (the Spec's two
// flags). NARROW: the narrow form, for C not a multiple of 4 (every row
// stride, a bound of each problem, and some bases are then not multiples
// of 4 elements). The bf16 build's aligned form runs them on the tensor
// cores (gemm_mma.cuh: bf16 MMAs, a float32 operand split into hi + lo);
// the float32 build and the narrow form on the FMA tiles of gemm_f32.cuh.
template <bool NARROW>
struct SplitGemms {
  template <bool AK, bool BK, class TA, class TB, class TC>
  using S = rmm_gemm::Spec<AK, BK, TA, TB, TC, NARROW>;
  using Qkv = S<false, true, elem_t, elem_t, float>;   // x·Wqkv + b
  using Dctx = S<false, false, elem_t, elem_t, float>;  // do·Woutᵀ
  using Out = S<false, true, float, elem_t, elem_t>;   // ctx·Wout + b
  using Dx = S<false, false, float, elem_t, elem_t>;   // dqkv·Wqkvᵀ
  using Dwq = S<true, true, elem_t, float, float>;     // xᵀ·dqkv
  using Dwo = S<true, true, float, elem_t, float>;     // ctxᵀ·do
  static constexpr bool kMma =
      !NARROW && std::is_same<elem_t, __nv_bfloat16>::value;

  // One or two problems of the Specs in the template in one launch.
  template <class S0, class S1>
  static cudaError_t launch(const rmm_gemm::Gemm& g0,
                            const rmm_gemm::Gemm* g1, cudaStream_t st) {
    if constexpr (kMma)
      return rmm_mma::launch_gemm<S0, S1>(g0, g1, st);
    else
      return rmm_gemm::launch_gemm<S0, S1>(g0, g1, st);
  }

  // Blocks of the weight-gradient GEMM an SM holds.
  static cudaError_t blocks_per_sm(int* per_sm) {
    if constexpr (kMma)
      return rmm_mma::gemm_blocks_per_sm<Dwq, Dwo>(per_sm);
    else
      return rmm_gemm::gemm_blocks_per_sm<Dwq, Dwo>(per_sm);
  }
};

// ---------------------------------------------------------------------------
// The split forward: every C that the tiled kernel does not take (64 <
// C, the SSL width among them, or C not a multiple of 4). Three
// launches over a scratch row of TT = 3C floats a token, rounded up to a
// multiple of 4 (fwd_row_floats; the design and what bounds it are in the
// note at the top of this file):
//   1. tok = x·Wqkv + bqkv (GEMM): the token rows q | k | v;
//   2. the forward attention core below, which writes ctx over q;
//   3. out = ctx·Wout + bout (GEMM, A read from tok with a row stride of
//      TT).
//
// The core. A block copies `rows` rows (rows·S consecutive token rows of
// `tok`) into shared memory by 16-byte cp.async, rows padded to a stride
// of fwd_core_stride floats (≡ 4 mod 32 at C = 96 and 128 and where C is
// not a multiple of 4: token i's float4s at one column fall in distinct
// bank groups, and so do its floats where the head width is not a
// multiple of 4), then one thread per (row, head, query i):
//   P = softmax(q_i k_jᵀ / √hd) (· keep/(1 − p)), ctx_i = Σ_j P_ij v_j,
// stored over q_i's head slice. Writing in place is safe: every read
// comes from the staged copy, and a block's rows are its own. Neighbouring
// threads take neighbouring queries of one head (distinct bank groups for
// q_i, one broadcast for k_j and v_j), as the backward's core does.
// ---------------------------------------------------------------------------

// Floats of the split forward's scratch row a token: q | k | v, padded to
// a multiple of 4 so that the core stages it 16 bytes at a time whatever
// C is. (Staging a narrow row element by element would take 4 copies for
// each of these; the pad costs at most 3 floats of 3C.)
__host__ __device__ inline int fwd_row_floats(int C) {
  return (3 * C + 3) / 4 * 4;
}

// Floats between token rows in the forward core's shared memory: TT + 4
// where C % 4 == 0 (≡ 4 mod 32 at C = 96 and 128); at the other widths
// the next float ≡ 4 (mod 32) past TT, so that the one-float chunks of
// neighbouring queries fall in distinct banks too.
__host__ __device__ inline int fwd_core_stride(int C) {
  const int TT = fwd_row_floats(C);
  return C % 4 ? (TT + 31) / 32 * 32 + 4 : TT + 4;
}

// Floats of the forward core's shared memory for `rows` rows.
__host__ __device__ inline size_t fwd_core_smem_floats(int S, int C,
                                                       int rows) {
  return (size_t)rows * S * fwd_core_stride(C);
}

// Query i of head h of the block's row r: ctx_i into `out` (global, q_i's
// head slice).
template <int W, int MAXS>
__device__ __forceinline__ void fwd_core_query(const float* sT, float* out,
                                               const uint8_t* kp, int r,
                                               int h, int i, int S, int C,
                                               int H, int TS, float scale,
                                               float inv_keep) {
  const int hd = C / H;
  const float* ti = sT + (r * S + i) * TS + h * hd;
  const float* tr = sT + r * S * TS + h * hd;  // token 0 of the row
  float p[MAXS];
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    p[j] = 0.f;
    if (j < S) {
      const float* tj = tr + j * TS;
      float d = 0.f;
      for (int c = 0; c < hd; c += W)
        d = Chunk<W>::load(ti + c).dot(Chunk<W>::load(tj + C + c), d);
      p[j] = d;
    }
  }
  softmax(p, S, scale);
  if (kp != nullptr) keep_scale(p, kp, S, inv_keep);
  for (int c = 0; c < hd; c += W) {
    Chunk<W> ctx = Chunk<W>::zero();
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) ctx.fma(p[j], Chunk<W>::load(tr + j * TS + 2 * C + c));
    ctx.store(out + c);
  }
}

// NARROW: C is not a multiple of 4 (padded rows); otherwise the rows'
// sizes are computed as they always were, and the code is the same.
template <int MAXS, bool NARROW>
__global__ void __launch_bounds__(kCoreThreads)
column_attention_fwd_core_kernel(float* __restrict__ tok,
                                 const uint8_t* __restrict__ keep, int B,
                                 int S, int C, int H, float scale,
                                 float inv_keep, int rows) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  // a token row in device memory (fwd_row_floats) and in shared memory
  // (fwd_core_stride)
  const int TT = NARROW ? fwd_row_floats(C) : 3 * C;
  const int TS = NARROW ? fwd_core_stride(C) : TT + 4;
  const int Q4 = TT / 4;     // its float4s
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, B - r0);
  const int HS = H * S;
  float* tg = tok + (size_t)r0 * S * TT;

  for (int i = tid; i < nr * S * Q4; i += kCoreThreads) {
    const int t = i / Q4;
    const int q = i - t * Q4;
    cp_async16(smem + t * TS + 4 * q, tg + (size_t)t * TT + 4 * q);
  }
  cp_async_wait_all();
  __syncthreads();
  const bool vec = (C / H) % 4 == 0;
  for (int it = tid; it < nr * HS; it += kCoreThreads) {
    const int r = it / HS;
    const int h = (it - r * HS) / S;
    const int i = it - r * HS - h * S;
    float* out = tg + (size_t)(r * S + i) * TT + h * (C / H);
    const uint8_t* kp =
        keep == nullptr ? nullptr
                        : keep + (((size_t)(r0 + r) * H + h) * S + i) * S;
    if (vec)
      fwd_core_query<4, MAXS>(smem, out, kp, r, h, i, S, C, H, TS, scale,
                              inv_keep);
    else
      fwd_core_query<1, MAXS>(smem, out, kp, r, h, i, S, C, H, TS, scale,
                              inv_keep);
  }
}

// ---------------------------------------------------------------------------
// The long cores: both split routes' attention for S > kShortS (the node
// tokens of a feature-rich node table: S = 167 at C = 32 on Elliptic).
// Neither a query's S scores (registers) nor a row's S×S P_d and dS
// (892 kB at S = 167, H = 8) fit, so both cores follow the flash-attention
// scheme on CUDA cores, on the staged token rows of the short cores above
// (one row a block at these lengths) and with their in-place writes:
//  * forward, per query: one walk over the keys with an online softmax (a
//    running max m and sum l, the context rescaled when m moves), then
//    ctx = acc / l;
//  * backward, per query: the same walk gives ctx_i (stored over dctx_i),
//    the log-sum-exp L_i = m + log2 l and D_i = dctx_i · ctx_i
//    (= Σ_j P_ij dP_ij, the keep-mask included); L_i and D_i go to shared
//    memory (H·S float pairs a row); a second walk recomputes
//    P_ij = 2^(s_ij − L_i) and dS_ij = P_ij (dP_ij − D_i) / √hd into dq_i;
//  * backward, per key t after a barrier: the same recompute over the
//    queries into dk_t = Σ_i dS_it q_i and dv_t = Σ_i P_d,it dctx_i.
// What bounds them, at [4096, 167, 32/8] (0.91 G (query, key) pairs a
// walk): FP32 issue first (~13 instructions a pair forward, ~50 over the
// backward's three walks), then the exps on the MUFU units (one a pair a
// walk, 16 a clock an SM: 0.22 ms forward and 0.66 backward at 1.98 GHz),
// and, masked, the keep-mask's bytes (0.91 GB, 0.27 ms at 3.35 TB/s) and
// the instructions that turn them into bits. The design, for those:
//  * A warp per (row, head): its 8 warps are a row's 8 heads, the lanes run
//    over the queries (over the keys in the key walk), R of them a lane 32
//    apart (LongHead; one a lane up to S = 32), each with its own vector,
//    m, l or L, D and sums in registers. Every key's k_j and v_j (every
//    query's q_i, dctx_i, L_i and D_i in the key walk) is one broadcast
//    shared load that feeds R positions of every lane; rows longer than
//    32·R take more groups, each group of a row's heads one round of the
//    block's warps.
//  * The head width a compile-time constant where the paths need speed
//    (hd = 4 at C = 32/8, 16 at C = 128/8, 32 at C = 256/8): the channel
//    loops unroll, the sums hold the head's live channels and each score
//    is computed once. Any other width takes the
//    same code at a runtime width, in slices of kSlice channels (a wider
//    head walks the keys again for each), its own vector read from shared
//    memory.
//  * Exps in base 2: log2(e)/√hd is folded into each lane's own q (or k)
//    once, so a score is a dot product and 2^x one MUFU.EX2, and the
//    log-sum-exp lives in base 2. The forward walk takes 4 keys a step:
//    every slot's scores, one test whether any passes its running max by
//    kRaise (then the max is raised and the sums rescaled: a few times a
//    query), then the exps and the context, so no branch splits the
//    slots' chains and no scores are kept.
//  * The keep-mask by whole sectors: for a chunk of 32 keys each lane reads
//    its query row's bytes as the one to three aligned 16-byte granules
//    that hold them (a row is S bytes and starts anywhere), and a multiply
//    folds each 4 bytes into 4 bits: a 32-bit word a slot, one bit test a
//    pair, and ~2 instructions a pair for the reading. Two other ways were
//    measured slower: reading each row's 32 bytes across the warp, lane l
//    on byte l, gathered by __ballot_sync a row a key step (~10
//    instructions a pair: the masked forward 4.36 ms against 2.02), and
//    asking L2 for the next chunk's lines before computing this one
//    (+8.5% masked). The key walk reads a query's bytes of its keys,
//    neighbouring lanes on neighbouring bytes.
// A row's shared memory is its S token rows and, backward, the 2·H·S
// floats of L and D (98.9 kB at S = 167, C = 32, H = 8). Every output is
// one lane's chain of FMAs in a fixed order: two calls give the same bits.
// Measured at [4096, 167, 32/8] (tools/torch_attn_ab.py; H100 80GB HBM3,
// 700 W), the whole split route: forward 1.02 ms unmasked and 2.02 with
// the node keep-mask, backward + reduce 5.19 and 7.69 (bounds 0.30, 0.33
// and 0.88; exp floors 0.22 and 0.66). See PERF.md.
//
// The direct form, for a row too long for a block's shared memory (S past
// max_s, e.g. 56 tokens at C = 256, 8 heads; or, at a very wide C, a short
// row): the streamed cores (column_attention_fwd_core_stream_kernel and
// column_attention_bwd_core_stream_kernel, further down) run the same walks
// with one block per (row, head), and stage chunks of the row instead of
// the whole row:
//  * The block's warps run over the head's groups of 32·R queries (of keys
//    in the backward's key walk), in rounds where a row has more groups
//    than a block has warps (kStreamWarps forward, kStreamBwdWarps
//    backward; evened out over the rounds): S = 167 at hd = 32 gives 8
//    blocks a row of 6 warps forward, of 2 warps and 3 rounds backward.
//    A block writes
//    only its own head's columns of the scratch row, and no walk reads
//    them: the forward's row is q | k | v | ctx (4C floats), the backward's
//    q | k | v | dctx | dq | dk | dv | ctx (8C); the GEMMs after the core
//    read ctx and dqkv there. The backward's L and D (2·S floats a (row,
//    head), after the B·S token rows) are written by its query walks and
//    read by its key walk after the block's barrier.
//  * The walks' other operand streams through a ring of kStreamStages
//    chunks of up to 32 keys in shared memory (k | v of the head, 2·hd
//    floats a key; in the key walk chunks of queries, q | dctx | L, D),
//    filled by cp.async across the block: chunk n + 1's copies run under
//    chunk n's walk, each chunk is read from device memory once a walk in
//    16-byte granules that coalesce (the head's 128 contiguous bytes of k
//    and of v a key at hd = 32), and every lane of every warp reads it as
//    broadcast shared loads, as the staged cores read their staged row.
//    The ring does not grow with S (17 kB at hd = 32; fewer keys a chunk
//    past hd = 95, at least 4: 65 kB at hd = 1024), so a row of any length
//    runs several blocks an SM.
//  * The lane's own vectors (its query's q and dctx, or its key's k and v)
//    and its sums in registers at the compile-time head widths (hd = 4, 16
//    and 32: C = 32, 128 and 256 at 8 heads), each score computed once.
//    Other widths run the runtime-width code in kSlice-channel slices (the
//    ring streamed again for each), their own vectors read from the scratch.
//  * The walks are the staged cores' own code (online_chunk, dq_chunk and
//    dkdv_query on a chunk instead of the staged row): every output is one
//    lane's chain of FMAs in the walk's order, so two calls give the same
//    bits, and so do the staged and the direct form at a row that fits
//    both.
// What bounds it, at [4096, 167, 256/8] (0.91 G (query, key) pairs a walk
// and head): the FMAs on the CUDA cores, 64 a pair forward (117 GFLOP, 1.75
// ms at 67 TFLOP/s; the exps' floor 0.22 ms) and 288 over the backward's
// three walks (524 GFLOP, 7.8 ms; floor 0.66), against ~10.5 and ~30 ms of
// split GEMMs around the core at that token count. Next the shared loads:
// with one query a lane each key's k and v are 16 broadcast 16-byte loads
// for 64 FMAs, so loads share the issue limit with the FMAs; and the
// registers: at hd = 32 a thread holds its 32-float vectors and sums
// (the key walk k, v, dk and dv, 128 floats, beside the query it reads),
// 224-228 registers in the backward, 146-152 in the forward at one query
// a lane (no launch bound caps them, and nothing spills), so an SM holds
// 8 warps of the backward. The constants are measured
// (tools/torch_attn_shapes.py --variants, PERF.md): one query a lane
// forward at hd = 32 (kFwdQ32; two, each key's loads feeding both, ran
// 3.7% slower at 3 warps a block) and blocks of at most 2 warps backward
// (kStreamBwdWarps; 8 warps ran 12% slower, at one block an SM; capping
// the registers for more blocks, 4-5% slower).
// ---------------------------------------------------------------------------

constexpr int kWarps = kCoreThreads / 32;  // warps of a long core's block
constexpr float kLog2e = 1.4426950408889634f;
// A walk's running max m moves only when a score passes it by more than
// kRaise (base 2), so a term 2^(s − m) stays below 2^kRaise.
constexpr float kRaise = 8.f;
// Channels a walk sums at a runtime head width (a wider head walks the keys
// again for each slice of kSlice).
constexpr int kSlice = 16;

// 2^x: one MUFU.EX2 (a result below 2^-126 flushes to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The long cores' instantiations: a head of HD channels, 4 (C = 32, 8
// heads: the node path), 16 (C = 128, 8 heads) or 32 (C = 256, 8 heads) at
// compile time, or 0 for any other width (hd at run time, in chunks of W
// floats). kFwdQ and kBwdQ: the queries a lane of the forward's and of the
// backward's query walks owns; kK: the keys a lane of the key walk owns.
// Registers bound them: two staged blocks of 256 threads an SM leave 128 a
// thread, and the backward's query walk at hd = 16 holds q, dctx, dq, k_j
// and v_j (80 floats a query). At hd = 32 the key walk holds k, v, dk and
// dv (128 floats), so its staged core asks for one block an SM
// (kMinBlocks).
constexpr int kFwdQ32 = 1;  // the forward's queries a lane at hd = 32
template <int HD>
struct LongHead {
  static constexpr int kFwdQ =
      HD == 4 ? 6 : HD == 16 ? 2 : HD == 32 ? kFwdQ32 : 1;
  static constexpr int kBwdQ = HD == 4 ? 4 : 1;
  static constexpr int kK = HD == 4 ? 3 : 1;
  static constexpr int kMinBlocks = HD == 32 ? 1 : 2;
};

// A head's vector as a walk reads it: HD > 0, its HD channels in registers
// (times f); HD == 0, a pointer into the staged row, f applied to each dot.
template <int HD, int W>
struct Vec {
  float4 v[HD / 4];
  __device__ void set(const float* p, float f = 1.f) {
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) {
      const float4 a = ld4(p + 4 * c);
      v[c] = make_float4(a.x * f, a.y * f, a.z * f, a.w * f);
    }
  }
};

template <int W>
struct Vec<0, W> {
  const float* p;
  float f;
  __device__ void set(const float* p_, float f_ = 1.f) {
    p = p_;
    f = f_;
  }
};

// acc + a · b over the head's hd channels
template <int HD, int W>
__device__ __forceinline__ float vdot(const Vec<HD, W>& a,
                                      const Vec<HD, W>& b, int hd,
                                      float acc) {
  if constexpr (HD > 0) {
#pragma unroll
    for (int c = 0; c < HD / 4; ++c) acc = dot4(a.v[c], b.v[c], acc);
    return acc;
  } else {
    float d = 0.f;
    for (int c = 0; c < hd; c += W)
      d = Chunk<W>::load(a.p + c).dot(Chunk<W>::load(b.p + c), d);
    return fmaf(d, a.f * b.f, acc);
  }
}

// A walk's sums over a slice of a head's channels: all HD of them, or
// channels [c0, c0 + n) of a runtime width (n <= kSlice).
template <int HD, int W>
struct Sum {
  static constexpr int kN = (HD > 0 ? HD : kSlice) / W;
  Chunk<W> a[kN];
  __device__ void zero() {
#pragma unroll
    for (int w = 0; w < kN; ++w) a[w] = Chunk<W>::zero();
  }
  __device__ void scale(float f) {
#pragma unroll
    for (int w = 0; w < kN; ++w) a[w].scale(f);
  }
  // a += f · x over the slice (x's values as they lie)
  __device__ void fma(float f, const Vec<HD, W>& x, int c0, int n) {
    if constexpr (HD > 0) {
#pragma unroll
      for (int c = 0; c < HD / 4; ++c) fma4(a[c].v, f, x.v[c]);
    } else {
#pragma unroll
      for (int w = 0; w < kN; ++w)
        if (w * W < n) a[w].fma(f, Chunk<W>::load(x.p + c0 + w * W));
    }
  }
  // acc + a · x[c0 ..]
  __device__ float dot(const float* x, int c0, int n, float acc) const {
#pragma unroll
    for (int w = 0; w < kN; ++w)
      if (HD > 0 || w * W < n)
        acc = a[w].dot(Chunk<W>::load(x + c0 + w * W), acc);
    return acc;
  }
  // f · a into p[0 ..] (device memory)
  __device__ void store(float* p, float f, int n) const {
#pragma unroll
    for (int w = 0; w < kN; ++w) {
      if (HD > 0 || w * W < n) {
        Chunk<W> t = a[w];
        t.scale(f);
        t.store(p + w * W);
      }
    }
  }
};

// The keep bits of keys j .. j + nk − 1 (bit u: key j + u, nk <= 32) of a
// query's row of a head's keep-mask, from p = the row's byte of key j. A
// row is S bytes, so it starts anywhere: the lane reads the 16-byte
// granules that hold those bytes (one to three aligned loads, whole
// sectors at a time, a warp's lanes on their own rows), and a multiply
// folds each 4 bytes of 0 or 1 into 4 bits. The mask may start at any
// byte: a granule is loaded only if it holds one of the nk bytes, so it
// lies in the page that holds that byte (a page is whole granules), which
// is mapped, and the bytes it holds outside the nk (another row's, or
// none of the mask's) are shifted out or land past bit nk − 1, which no
// caller reads.
__device__ __forceinline__ unsigned keep_nibble(unsigned w, int k) {
  // bytes b0..b3 (bit 0 of each) · 0x01020408: b_i lands on bit 24 + i
  // and no other term reaches bits 24..31
  const unsigned t = ((w & 0x01010101u) * 0x01020408u) >> 24;
  return t << (4 * k);
}

__device__ __forceinline__ unsigned keep_bits(const uint8_t* p, int nk) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* g = reinterpret_cast<const uint4*>(a & ~uintptr_t(15));
  const int off = static_cast<int>(a & 15);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  const uint4 g0 = __ldg(g);
  const uint4 g1 = off + nk > 16 ? __ldg(g + 1) : z;
  const uint4 g2 = off + nk > 32 ? __ldg(g + 2) : z;
  const unsigned lo = keep_nibble(g0.x, 0) | keep_nibble(g0.y, 1) |
                      keep_nibble(g0.z, 2) | keep_nibble(g0.w, 3) |
                      keep_nibble(g1.x, 4) | keep_nibble(g1.y, 5) |
                      keep_nibble(g1.z, 6) | keep_nibble(g1.w, 7);
  const unsigned hi = keep_nibble(g2.x, 0) | keep_nibble(g2.y, 1) |
                      keep_nibble(g2.z, 2) | keep_nibble(g2.w, 3);
  return __funnelshift_r(lo, hi, off);
}

// Each slot's keep bits for the chunk of nk keys at j (queries
// g0 + 32r + lane, clamped to the row; kp: the head's S×S keep-mask).
template <int R>
__device__ __forceinline__ void keep_chunk(unsigned (&keep)[R],
                                           const uint8_t* kp, int g0,
                                           int nr, int S, int j, int nk,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < nr)
      keep[r] = keep_bits(
          kp + (size_t)min(g0 + 32 * r + lane, S - 1) * S + j, nk);
}

// A group of a query walk: the slots with a query, and each slot's query
// (clamped to the row: a lane past it computes on the last query and
// stores nothing).
__device__ __forceinline__ int group_slots(int R, int g0, int S) {
  return min(R, (S - g0 + 31) / 32);
}

__device__ __forceinline__ int slot_pos(int g0, int r, int lane, int S) {
  return min(g0 + 32 * r + lane, S - 1);
}

constexpr int kKeys = 4;  // keys of an online walk's step

// One step of an online walk: keys j .. j + kKeys − 1 (RAGGED: only nk of
// them; key i's k at kt + i·KS, its v voff floats past its k), their keep
// bits at bit 0 on of kb. Every slot's scores first, one test whether
// any passes its running max by kRaise (then raised), then the exps and
// the context: no branch between the slots' chains.
template <bool RAGGED, int HD, int W, int R, bool MASKED>
__device__ __forceinline__ void online_step(
    Sum<HD, W> (&acc)[R], float (&m)[R], float (&l)[R],
    const Vec<HD, W> (&q)[R], const unsigned (&kb)[R], const float* kt,
    int j, int KS, int voff, int nk, int nr, int hd, int c0, int n) {
  float d[R][kKeys];
#pragma unroll
  for (int t = 0; t < kKeys; ++t) {
    Vec<HD, W> k;
    k.set(kt + (j + (RAGGED ? min(t, nk - 1) : t)) * KS);
#pragma unroll
    for (int r = 0; r < R; ++r)
      d[r][t] = !RAGGED || t < nk ? vdot(q[r], k, hd, -m[r]) : -INFINITY;
  }
  bool up = false;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < kKeys; ++t) up |= r < nr && d[r][t] > kRaise;
  if (up) {  // rare: a new running max
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = d[r][0];
#pragma unroll
      for (int t = 1; t < kKeys; ++t) mx = fmaxf(mx, d[r][t]);
      if (mx > kRaise) {
        const float corr = ex2(-mx);
        l[r] *= corr;
        acc[r].scale(corr);
        m[r] += mx;
#pragma unroll
        for (int t = 0; t < kKeys; ++t) d[r][t] -= mx;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kKeys; ++t) {
    if (!RAGGED || t < nk) {
      Vec<HD, W> v;
      v.set(kt + (j + t) * KS + voff);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
          const float e = ex2(d[r][t]);
          l[r] += e;
          acc[r].fma(!MASKED || (kb[r] >> t) & 1u ? e : 0.f, v, c0, n);
        }
      }
    }
  }
}

// The start of a query walk's online softmax: no sums yet, and each slot's
// running max at its score against key 0 (its k at k0).
template <int HD, int W, int R>
__device__ __forceinline__ void online_init(Sum<HD, W> (&acc)[R],
                                            float (&m)[R], float (&l)[R],
                                            const Vec<HD, W> (&q)[R],
                                            const float* k0, int hd) {
  Vec<HD, W> k;
  k.set(k0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc[r].zero();
    l[r] = 0.f;
    m[r] = vdot(q[r], k, hd, 0.f);
  }
}

// Keys j0 .. j0 + nj − 1 of a query walk's online softmax (key j0 + u's k
// at kt + (jb + u)·KS, its v voff floats past its k), for channels
// [c0, c0 + n)
// of the context: for each slot r, acc[r] += Σ_j keep_ij · 2^(s_ij − m[r])
// · v_j, l[r] += Σ_j 2^(s_ij − m[r]), s_ij = q[r] · k_j (q scaled by
// log2(e)/√hd), m[r] within kRaise of the max so far. kp: the head's
// keep-mask or null.
template <int HD, int W, int R, bool MASKED>
__device__ __forceinline__ void online_chunk(
    Sum<HD, W> (&acc)[R], float (&m)[R], float (&l)[R],
    const Vec<HD, W> (&q)[R], const float* kt, int jb, int KS, int voff,
    const uint8_t* kp, int g0, int nr, int S, int j0, int nj, int hd, int c0,
    int n, int lane) {
  unsigned keep[R], kb[R];
  if (MASKED) keep_chunk(keep, kp, g0, nr, S, j0, nj, lane);
  for (int u = 0; u < nj; u += kKeys) {
#pragma unroll
    for (int r = 0; r < R; ++r) kb[r] = MASKED ? keep[r] >> u : 0u;
    if (u + kKeys <= nj)
      online_step<false, HD, W, R, MASKED>(acc, m, l, q, kb, kt, jb + u, KS,
                                           voff, kKeys, nr, hd, c0, n);
    else
      online_step<true, HD, W, R, MASKED>(acc, m, l, q, kb, kt, jb + u, KS,
                                          voff, nj - u, nr, hd, c0, n);
  }
}

// One query walk's online softmax over a staged row's S keys (tr: token 0
// at the head's channels, k at +C, v at +2C, rows TS floats apart), in
// chunks of 32 keys.
template <int HD, int W, int R, bool MASKED>
__device__ __forceinline__ void online_walk(Sum<HD, W> (&acc)[R],
                                            float (&m)[R], float (&l)[R],
                                            const Vec<HD, W> (&q)[R],
                                            const float* tr,
                                            const uint8_t* kp, int g0,
                                            int nr, int S, int C, int hd,
                                            int TS, int c0, int n,
                                            int lane) {
  online_init(acc, m, l, q, tr + C, hd);
  for (int j0 = 0; j0 < S; j0 += 32)
    online_chunk<HD, W, R, MASKED>(acc, m, l, q, tr + C, j0, TS, C, kp, g0,
                                   nr, S, j0, min(32, S - j0), hd, c0, n,
                                   lane);
}

// Keys j0 .. j0 + nj − 1 of the backward's second query walk (laid out as
// online_chunk's): dq[r] += Σ_j P_ij (dP_ij − D_i) k_j over
// channels [c0, c0 + n), P_ij = 2^(q_i · k_j − L_i), dP_ij = g_i · v_j
// (g = dctx) times keep/(1 − p).
template <int HD, int W, int R, bool MASKED>
__device__ __forceinline__ void dq_chunk(
    Sum<HD, W> (&dq)[R], const Vec<HD, W> (&q)[R], const Vec<HD, W> (&g)[R],
    const float (&L)[R], const float (&D)[R], const float* kt, int jb,
    int KS, int voff, const uint8_t* kp, int g0, int nr, int S, int j0,
    int nj, int hd, int c0, int n, float inv_keep, int lane) {
  unsigned keep[R];
  if (MASKED) keep_chunk(keep, kp, g0, nr, S, j0, nj, lane);
#pragma unroll 4
  for (int u = 0; u < nj; ++u) {
    const float* tj = kt + (jb + u) * KS;
    Vec<HD, W> k, v;
    k.set(tj);
    v.set(tj + voff);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        const float p = ex2(vdot(q[r], k, hd, -L[r]));
        const float e = vdot(g[r], v, hd, 0.f);
        float t = e - D[r];
        if (MASKED)
          t = (keep[r] >> u) & 1u ? fmaf(e, inv_keep, -D[r]) : -D[r];
        dq[r].fma(p * t, k, c0, n);
      }
    }
  }
}

// One query i of the backward's key walk, for each slot r with key t:
// dk[r] += P_it (dP_it − D_i) q_i, dv[r] += P_d,it dctx_i over channels
// [c0, c0 + n); kb[r]: keep byte (i, t); the query's q at qi, dctx at gi,
// (L_i, D_i) in ld.
template <int HD, int W, int R, bool MASKED>
__device__ __forceinline__ void dkdv_query(
    Sum<HD, W> (&dk)[R], Sum<HD, W> (&dv)[R], const Vec<HD, W> (&k)[R],
    const Vec<HD, W> (&v)[R], const uint8_t (&kb)[R], const float* qi_at,
    const float* gi_at, float2 ld, int nr, int hd, int c0, int n,
    float inv_keep) {
  Vec<HD, W> qi, gi;
  qi.set(qi_at);
  gi.set(gi_at);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nr) {
      const float p = ex2(vdot(k[r], qi, hd, -ld.x));
      const float e = vdot(v[r], gi, hd, 0.f);
      float pd = p, t = e - ld.y;
      if (MASKED) {
        pd = kb[r] ? p * inv_keep : 0.f;
        t = kb[r] ? fmaf(e, inv_keep, -ld.y) : -ld.y;
      }
      dk[r].fma(p * t, qi, c0, n);
      dv[r].fma(pd, gi, c0, n);
    }
  }
}

// The long forward core's queries g0 + 32r + lane (r < R) of one head of a
// staged row (token 0 at tr, at the head's channels; q | k | v at 0, C,
// 2C): ctx over q in the row's device copy at tg (rows TT floats apart).
template <int HD, int W, int R, bool MASKED>
__device__ __forceinline__ void fwd_long_group(const float* tr, float* tg,
                                               const uint8_t* kp, int g0,
                                               int S, int C, int hd, int TS,
                                               int TT, float qs,
                                               float inv_keep, int lane) {
  const int nr = group_slots(R, g0, S);
  Vec<HD, W> q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) q[r].set(tr + slot_pos(g0, r, lane, S) * TS, qs);
  for (int c0 = 0; c0 < hd; c0 += (HD > 0 ? HD : kSlice)) {
    const int n = HD > 0 ? HD : min(kSlice, hd - c0);
    Sum<HD, W> acc[R];
    float m[R], l[R];
    online_walk<HD, W, R, MASKED>(acc, m, l, q, tr, kp, g0, nr, S, C, hd,
                                  TS, c0, n, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g0 + 32 * r + lane;
      if (r < nr && i < S) acc[r].store(tg + (size_t)i * TT + c0,
                                        inv_keep / l[r], n);
    }
  }
}

// The long backward core's queries g0 + 32r + lane (r < R) of one head of
// a staged row (q | k | v | dctx at 0, C, 2C, 3C): ctx over dctx and dq
// over q in the row's device copy at tg; L and D into sLD (the head's
// pairs, query i's at 2i).
template <int HD, int W, int R, bool MASKED>
__device__ __forceinline__ void bwd_long_query_group(
    const float* tr, float* sLD, float* tg, const uint8_t* kp, int g0,
    int S, int C, int hd, int TS, int TT, float qs, float scale,
    float inv_keep, int lane) {
  const int nr = group_slots(R, g0, S);
  Vec<HD, W> q[R];
  float L[R], D[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    q[r].set(tr + slot_pos(g0, r, lane, S) * TS, qs);
    D[r] = 0.f;
  }
  // walk 1: ctx, L and D
  for (int c0 = 0; c0 < hd; c0 += (HD > 0 ? HD : kSlice)) {
    const int n = HD > 0 ? HD : min(kSlice, hd - c0);
    Sum<HD, W> acc[R];
    float m[R], l[R];
    online_walk<HD, W, R, MASKED>(acc, m, l, q, tr, kp, g0, nr, S, C, hd,
                                  TS, c0, n, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < nr) {
        const int i = g0 + 32 * r + lane;
        const float* ti = tr + slot_pos(g0, r, lane, S) * TS;
        acc[r].scale(inv_keep / l[r]);
        D[r] = acc[r].dot(ti + 3 * C, c0, n, D[r]);
        L[r] = m[r] + log2f(l[r]);
        if (i < S) acc[r].store(tg + (size_t)i * TT + 3 * C + c0, 1.f, n);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = g0 + 32 * r + lane;
    if (r < nr && i < S) {
      sLD[2 * i] = L[r];
      sLD[2 * i + 1] = D[r];
    }
  }
  // walk 2: dq_i = Σ_j P_ij (dP_ij − D_i) k_j / √hd
  Vec<HD, W> g[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    g[r].set(tr + slot_pos(g0, r, lane, S) * TS + 3 * C);
  for (int c0 = 0; c0 < hd; c0 += (HD > 0 ? HD : kSlice)) {
    const int n = HD > 0 ? HD : min(kSlice, hd - c0);
    Sum<HD, W> dq[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dq[r].zero();
    for (int j0 = 0; j0 < S; j0 += 32)
      dq_chunk<HD, W, R, MASKED>(dq, q, g, L, D, tr + C, j0, TS, C, kp, g0,
                                 nr, S, j0, min(32, S - j0), hd, c0, n,
                                 inv_keep, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = g0 + 32 * r + lane;
      if (r < nr && i < S) dq[r].store(tg + (size_t)i * TT + c0, scale, n);
    }
  }
}

// The long backward core's keys g0 + 32r + lane (r < R) of one head of a
// staged row: dk over k and dv over v in the row's device copy at tg,
// from every query's q, dctx, L and D (sLD).
template <int HD, int W, int R, bool MASKED>
__device__ __forceinline__ void bwd_long_key_group(
    const float* tr, const float* sLD, float* tg, const uint8_t* kp, int g0,
    int S, int C, int hd, int TS, int TT, float qs, float scale,
    float inv_keep, int lane) {
  const int nr = group_slots(R, g0, S);
  Vec<HD, W> k[R], v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* tt = tr + slot_pos(g0, r, lane, S) * TS;
    k[r].set(tt + C, qs);
    v[r].set(tt + 2 * C);
  }
  for (int c0 = 0; c0 < hd; c0 += (HD > 0 ? HD : kSlice)) {
    const int n = HD > 0 ? HD : min(kSlice, hd - c0);
    Sum<HD, W> dk[R], dv[R];
    uint8_t kb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dk[r].zero();
      dv[r].zero();
      const int t = g0 + 32 * r + lane;
      kb[r] = MASKED && r < nr && t < S ? __ldg(kp + t) : 0;
    }
    for (int i = 0; i < S; ++i) {
      uint8_t nb[R];  // the next query's bytes, loaded ahead
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = g0 + 32 * r + lane;
        nb[r] = MASKED && r < nr && t < S && i + 1 < S
                    ? __ldg(kp + (size_t)(i + 1) * S + t)
                    : 0;
      }
      const float* ti = tr + i * TS;
      dkdv_query<HD, W, R, MASKED>(
          dk, dv, k, v, kb, ti, ti + 3 * C,
          *reinterpret_cast<const float2*>(sLD + 2 * i), nr, hd, c0, n,
          inv_keep);
#pragma unroll
      for (int r = 0; r < R; ++r) kb[r] = nb[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = g0 + 32 * r + lane;
      if (r < nr && t < S) {
        dk[r].store(tg + (size_t)t * TT + C + c0, scale, n);
        dv[r].store(tg + (size_t)t * TT + 2 * C + c0, 1.f, n);
      }
    }
  }
}

// A long core's items: (group g, row r, head h) of `ng` groups a row, the
// group slowest, so that a round of the block's warps takes every head of
// a row in the same group.
struct LongItem {
  int g, r, h;
};

__device__ __forceinline__ LongItem long_item(int it, int nr, int H) {
  const int g = it / (nr * H), rh = it - g * nr * H;
  return {g, rh / H, rh % H};
}

// Floats of a direct-form scratch row a token: forward q | k | v | ctx,
// backward q | k | v | dctx | dq | dk | dv | ctx.
__host__ __device__ inline int direct_row_floats(int C, bool backward) {
  return (backward ? 8 : 4) * C;
}

// The long forward core (S > kShortS): staging as the short core's, then a
// warp per (group of 32·kFwdQ queries, row, head); ONE: a query a lane
// (rows of at most 32 tokens, where more would only cost registers and so
// blocks an SM). scale = 1/√hd.
template <int HD, int W, bool MASKED, bool ONE>
__global__ void __launch_bounds__(kCoreThreads, LongHead<HD>::kMinBlocks)
column_attention_fwd_core_long_kernel(float* __restrict__ tok,
                                      const uint8_t* __restrict__ keep,
                                      int B, int S, int C, int H,
                                      float scale, float inv_keep,
                                      int rows) {
  extern __shared__ __align__(16) float smem[];
  constexpr int R = ONE ? 1 : LongHead<HD>::kFwdQ;
  const int tid = threadIdx.x, lane = tid % 32;
  // a token row in device memory, and in shared memory
  const int TT = fwd_row_floats(C);
  const int TS = fwd_core_stride(C);
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, B - r0);
  float* tg = tok + (size_t)r0 * S * TT;
  const int Q4 = TT / 4;
  for (int i = tid; i < nr * S * Q4; i += kCoreThreads) {
    const int t = i / Q4;
    const int q = i - t * Q4;
    cp_async16(smem + t * TS + 4 * q, tg + (size_t)t * TT + 4 * q);
  }
  cp_async_wait_all();
  __syncthreads();
  const int hd = HD > 0 ? HD : C / H;
  const int ng = (S + 32 * R - 1) / (32 * R);
  for (int it = tid / 32; it < ng * nr * H; it += kWarps) {
    const LongItem t = long_item(it, nr, H);
    const uint8_t* kp =
        MASKED ? keep + ((size_t)(r0 + t.r) * H + t.h) * S * S : nullptr;
    fwd_long_group<HD, W, R, MASKED>(
        smem + (size_t)t.r * S * TS + t.h * hd,
        tg + (size_t)t.r * S * TT + t.h * hd, kp, t.g * 32 * R, S, C, hd,
        TS, TT, scale * kLog2e, inv_keep, lane);
  }
}

// The long backward core (S > kShortS): staging as the short core's, the
// query walks (a warp per (group of 32·kBwdQ queries, row, head)), a
// barrier, the key walk (a warp per (group of 32·kK keys, row, head)); ONE
// as the forward's.
template <int HD, int W, bool MASKED, bool ONE>
__global__ void __launch_bounds__(kCoreThreads, LongHead<HD>::kMinBlocks)
column_attention_bwd_core_long_kernel(float* __restrict__ tok,
                                      const uint8_t* __restrict__ keep,
                                      int B, int S, int C, int H,
                                      float scale, float inv_keep,
                                      int rows) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RQ = ONE ? 1 : LongHead<HD>::kBwdQ;
  constexpr int RK = ONE ? 1 : LongHead<HD>::kK;
  const int tid = threadIdx.x, lane = tid % 32;
  // a token row in device memory, and in shared memory
  const int TT = 4 * C;
  const int TS = TT + 4;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, B - r0);
  float* tg = tok + (size_t)r0 * S * TT;
  for (int i = tid; i < nr * S * C; i += kCoreThreads) {  // C float4s a row
    const int t = i / C;
    const int q = i - t * C;
    st4(smem + t * TS + 4 * q, ld4(tg + (size_t)t * TT + 4 * q));
  }
  __syncthreads();
  // (L, D) of each (row, head, query) of the block
  float* sLD = smem + (size_t)rows * S * TS;
  const int hd = HD > 0 ? HD : C / H;
  const float qs = scale * kLog2e;
  const int ngq = (S + 32 * RQ - 1) / (32 * RQ);
  for (int it = tid / 32; it < ngq * nr * H; it += kWarps) {
    const LongItem t = long_item(it, nr, H);
    const uint8_t* kp =
        MASKED ? keep + ((size_t)(r0 + t.r) * H + t.h) * S * S : nullptr;
    bwd_long_query_group<HD, W, RQ, MASKED>(
        smem + (size_t)t.r * S * TS + t.h * hd,
        sLD + 2 * (size_t)(t.r * H + t.h) * S,
        tg + (size_t)t.r * S * TT + t.h * hd, kp, t.g * 32 * RQ, S, C, hd,
        TS, TT, qs, scale, inv_keep, lane);
  }
  __syncthreads();
  const int ngk = (S + 32 * RK - 1) / (32 * RK);
  for (int it = tid / 32; it < ngk * nr * H; it += kWarps) {
    const LongItem t = long_item(it, nr, H);
    const uint8_t* kp =
        MASKED ? keep + ((size_t)(r0 + t.r) * H + t.h) * S * S : nullptr;
    bwd_long_key_group<HD, W, RK, MASKED>(
        smem + (size_t)t.r * S * TS + t.h * hd,
        sLD + 2 * (size_t)(t.r * H + t.h) * S,
        tg + (size_t)t.r * S * TT + t.h * hd, kp, t.g * 32 * RK, S, C, hd,
        TS, TT, qs, scale, inv_keep, lane);
  }
}

// ---------------------------------------------------------------------------
// The streamed cores (the direct form; the note above the long cores'
// helpers): a block per (row, head), its warps over the head's groups, the
// walks' other operand through a ring of chunks in shared memory.

// The most warps of a streamed forward and backward block, and the blocks
// an SM their launch bounds ask for (registers: 65,536 an SM).
constexpr int kStreamWarps = 8;
constexpr int kStreamMinBlocks = 1;
constexpr int kStreamBwdWarps = 2;
constexpr int kStreamBwdMinBlocks = 1;
constexpr int kStreamStages = 2;  // chunks in the ring
// Bytes of the ring beyond which its chunks take fewer than 32 keys.
constexpr int kStreamBudget = 48 * 1024;

// Floats of a ring row: k | v of a key, or q | dctx | L, D of a query (2·hd
// + 2, rounded up to 16 bytes).
__host__ __device__ inline int stream_row_floats(int hd) {
  return (2 * hd + 2 + 3) / 4 * 4;
}

// Keys (queries) a chunk of the ring: 32 where kStreamStages chunks fit
// kStreamBudget, else as many as fit, a multiple of 4 (the online walk's
// steps), at least 4.
__host__ __device__ inline int stream_keys(int hd) {
  const int k =
      kStreamBudget / (kStreamStages * 4 * stream_row_floats(hd)) / 4 * 4;
  return k < 4 ? 4 : k > 32 ? 32 : k;
}

// A streamed block's shared memory, the same whatever S is.
__host__ __device__ inline size_t stream_smem_bytes(int hd) {
  return (size_t)kStreamStages * stream_keys(hd) * stream_row_floats(hd) *
         sizeof(float);
}

// Rows u < nk of a chunk into a ring stage `dst` (KS floats a row) by
// cp.async across the block's nt threads: row u's hd floats at a + u·TT
// to 0, its hd floats at a + u·TT + boff to hd, and where ld is given the
// pair ld[2u], ld[2u + 1] to 2·hd. W = 4: 16-byte granules (hd, C and the
// rows are multiples of 4 floats), neighbouring threads on neighbouring
// granules; W = 1: single floats.
template <int W>
__device__ __forceinline__ void copy_chunk(float* dst, int KS,
                                           const float* a, int boff, int TT,
                                           const float* ld, int nk, int hd,
                                           int tid, int nt) {
  const int G = hd / W;  // copies of a row's half
  for (int i = tid; i < 2 * G * nk; i += nt) {
    const int u = i / (2 * G), e = i - u * 2 * G;
    const int half = e >= G ? 1 : 0, c = W * (e - half * G);
    const float* src = a + (size_t)u * TT + half * boff + c;
    float* to = dst + u * KS + half * hd + c;
    if constexpr (W == 4)
      cp_async16(to, src);
    else
      cp_async4(to, src);
  }
  if (ld != nullptr)
    for (int u = tid; u < nk; u += nt)
      cp_async8(dst + u * KS + 2 * hd, ld + 2 * u);
}

// One walk of a streamed block over a row's S keys (queries), in chunks of
// NK rows through the ring (kStreamStages stages of NK rows of KS floats):
// chunk c + 1's copies (copy(dst, j0, nk)) start before chunk c is walked,
// and walk(buf, j0, nk) runs on every thread once chunk c has landed and
// the block has met. Every thread of the block calls it alike.
template <class Copy, class Walk>
__device__ __forceinline__ void stream_walk(float* ring, int KS, int S,
                                            int NK, const Copy& copy,
                                            const Walk& walk) {
  const int nch = (S + NK - 1) / NK, stage = NK * KS;
  for (int c = 0; c < kStreamStages - 1; ++c) {
    if (c < nch) copy(ring + c * stage, c * NK, min(NK, S - c * NK));
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    const int ahead = c + kStreamStages - 1;
    if (ahead < nch)
      copy(ring + (ahead % kStreamStages) * stage, ahead * NK,
           min(NK, S - ahead * NK));
    cp_async_commit();
    cp_async_wait_group<kStreamStages - 1>();
    __syncthreads();
    walk(ring + (c % kStreamStages) * stage, c * NK, min(NK, S - c * NK));
    __syncthreads();
  }
}

// The direct form's forward core: block (b, h) takes head h of row b of the
// scratch `tok` ([B·S, 4C] floats, q | k | v | ctx), its warps the groups
// of 32·kFwdQ queries, ctx into the row's last C floats. scale = 1/√hd.
template <int HD, int W, bool MASKED>
__global__ void __launch_bounds__(32 * kStreamWarps, kStreamMinBlocks)
column_attention_fwd_core_stream_kernel(float* __restrict__ tok,
                                        const uint8_t* __restrict__ keep,
                                        int B, int S, int C, int H,
                                        float scale, float inv_keep) {
  extern __shared__ __align__(16) float ring[];
  constexpr int R = LongHead<HD>::kFwdQ;
  const int tid = threadIdx.x, lane = tid % 32, nt = blockDim.x;
  const int warp = tid / 32, nw = nt / 32;
  const int h = blockIdx.y;
  const int hd = HD > 0 ? HD : C / H;
  const int TT = direct_row_floats(C, false);
  // the row's token 0 at the head's q
  const float* row = tok + (size_t)blockIdx.x * S * TT + h * hd;
  float* ctx = tok + (size_t)blockIdx.x * S * TT + 3 * C + h * hd;
  const uint8_t* kp =
      MASKED ? keep + ((size_t)blockIdx.x * H + h) * S * S : nullptr;
  const int KS = stream_row_floats(hd), NK = stream_keys(hd);
  const float qs = scale * kLog2e;
  const auto copy = [&](float* dst, int j0, int nk) {
    copy_chunk<W>(dst, KS, row + (size_t)j0 * TT + C, C, TT, nullptr, nk, hd,
                  tid, nt);
  };
  const int ng = (S + 32 * R - 1) / (32 * R);
  for (int base = 0; base < ng; base += nw) {
    const int g0 = (base + warp) * 32 * R;
    const int nr = base + warp < ng ? group_slots(R, g0, S) : 0;
    Vec<HD, W> q[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      q[r].set(row + (size_t)slot_pos(g0, r, lane, S) * TT, qs);
    for (int c0 = 0; c0 < hd; c0 += (HD > 0 ? HD : kSlice)) {
      const int n = HD > 0 ? HD : min(kSlice, hd - c0);
      Sum<HD, W> acc[R];
      float m[R], l[R];
      stream_walk(ring, KS, S, NK, copy,
                  [&](const float* buf, int j0, int nj) {
                    if (nr == 0) return;
                    if (j0 == 0) online_init(acc, m, l, q, buf, hd);
                    online_chunk<HD, W, R, MASKED>(acc, m, l, q, buf, 0, KS,
                                                   hd, kp, g0, nr, S, j0, nj,
                                                   hd, c0, n, lane);
                  });
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = g0 + 32 * r + lane;
        if (r < nr && i < S)
          acc[r].store(ctx + (size_t)i * TT + c0, inv_keep / l[r], n);
      }
    }
  }
}

// The direct form's backward core: block (b, h) takes head h of row b of
// the scratch `tok` ([B·S, 8C] floats, q | k | v | dctx | dq | dk | dv |
// ctx, then 2·H·S floats a row of L and D): the query walks (its warps the
// groups of 32·kBwdQ queries) stream k | v twice, write ctx, L, D and dq;
// after the block's barrier the key walk (groups of 32·kK keys) streams
// q | dctx | L, D into dk and dv.
template <int HD, int W, bool MASKED>
__global__ void __launch_bounds__(32 * kStreamBwdWarps, kStreamBwdMinBlocks)
column_attention_bwd_core_stream_kernel(float* __restrict__ tok,
                                        const uint8_t* __restrict__ keep,
                                        int B, int S, int C, int H,
                                        float scale, float inv_keep) {
  extern __shared__ __align__(16) float ring[];
  constexpr int RQ = LongHead<HD>::kBwdQ;
  constexpr int RK = LongHead<HD>::kK;
  const int tid = threadIdx.x, lane = tid % 32, nt = blockDim.x;
  const int warp = tid / 32, nw = nt / 32;
  const int h = blockIdx.y;
  const size_t rh = (size_t)blockIdx.x * H + h;
  const int hd = HD > 0 ? HD : C / H;
  const int TT = direct_row_floats(C, true);
  // the row's token 0 at the head's q, and at its dq (dq | dk | dv | ctx)
  const float* row = tok + (size_t)blockIdx.x * S * TT + h * hd;
  float* out = tok + (size_t)blockIdx.x * S * TT + 4 * C + h * hd;
  float* LD = tok + (size_t)B * S * TT + 2 * rh * S;  // query i's at 2i
  const uint8_t* kp = MASKED ? keep + rh * S * S : nullptr;
  const int KS = stream_row_floats(hd), NK = stream_keys(hd);
  const float qs = scale * kLog2e;
  const auto copy_kv = [&](float* dst, int j0, int nk) {
    copy_chunk<W>(dst, KS, row + (size_t)j0 * TT + C, C, TT, nullptr, nk, hd,
                  tid, nt);
  };
  const auto copy_qg = [&](float* dst, int j0, int nk) {
    copy_chunk<W>(dst, KS, row + (size_t)j0 * TT, 3 * C, TT, LD + 2 * j0, nk,
                  hd, tid, nt);
  };
  const int ngq = (S + 32 * RQ - 1) / (32 * RQ);
  for (int base = 0; base < ngq; base += nw) {
    const int g0 = (base + warp) * 32 * RQ;
    const int nr = base + warp < ngq ? group_slots(RQ, g0, S) : 0;
    Vec<HD, W> q[RQ];
    float L[RQ], D[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      q[r].set(row + (size_t)slot_pos(g0, r, lane, S) * TT, qs);
      L[r] = 0.f;
      D[r] = 0.f;
    }
    // walk 1: ctx, L and D
    for (int c0 = 0; c0 < hd; c0 += (HD > 0 ? HD : kSlice)) {
      const int n = HD > 0 ? HD : min(kSlice, hd - c0);
      Sum<HD, W> acc[RQ];
      float m[RQ], l[RQ];
      stream_walk(ring, KS, S, NK, copy_kv,
                  [&](const float* buf, int j0, int nj) {
                    if (nr == 0) return;
                    if (j0 == 0) online_init(acc, m, l, q, buf, hd);
                    online_chunk<HD, W, RQ, MASKED>(acc, m, l, q, buf, 0,
                                                    KS, hd, kp, g0, nr, S,
                                                    j0, nj, hd, c0, n, lane);
                  });
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        if (r < nr) {
          const int i = g0 + 32 * r + lane;
          const float* ti = row + (size_t)slot_pos(g0, r, lane, S) * TT;
          acc[r].scale(inv_keep / l[r]);
          D[r] = acc[r].dot(ti + 3 * C, c0, n, D[r]);
          L[r] = m[r] + log2f(l[r]);
          if (i < S) acc[r].store(out + (size_t)i * TT + 3 * C + c0, 1.f, n);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int i = g0 + 32 * r + lane;
      if (r < nr && i < S) {
        LD[2 * i] = L[r];
        LD[2 * i + 1] = D[r];
      }
    }
    // walk 2: dq
    Vec<HD, W> g[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
      g[r].set(row + (size_t)slot_pos(g0, r, lane, S) * TT + 3 * C);
    for (int c0 = 0; c0 < hd; c0 += (HD > 0 ? HD : kSlice)) {
      const int n = HD > 0 ? HD : min(kSlice, hd - c0);
      Sum<HD, W> dq[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) dq[r].zero();
      stream_walk(ring, KS, S, NK, copy_kv,
                  [&](const float* buf, int j0, int nj) {
                    if (nr == 0) return;
                    dq_chunk<HD, W, RQ, MASKED>(dq, q, g, L, D, buf, 0, KS,
                                                hd, kp, g0, nr, S, j0, nj,
                                                hd, c0, n, inv_keep, lane);
                  });
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int i = g0 + 32 * r + lane;
        if (r < nr && i < S) dq[r].store(out + (size_t)i * TT + c0, scale, n);
      }
    }
  }
  // every L and D of the head written before any is copied
  __threadfence_block();
  __syncthreads();
  const int ngk = (S + 32 * RK - 1) / (32 * RK);
  for (int base = 0; base < ngk; base += nw) {
    const int g0 = (base + warp) * 32 * RK;
    const int nr = base + warp < ngk ? group_slots(RK, g0, S) : 0;
    Vec<HD, W> k[RK], v[RK];
#pragma unroll
    for (int r = 0; r < RK; ++r) {
      const float* tt = row + (size_t)slot_pos(g0, r, lane, S) * TT;
      k[r].set(tt + C, qs);
      v[r].set(tt + 2 * C);
    }
    for (int c0 = 0; c0 < hd; c0 += (HD > 0 ? HD : kSlice)) {
      const int n = HD > 0 ? HD : min(kSlice, hd - c0);
      Sum<HD, W> dk[RK], dv[RK];
      uint8_t kb[RK];
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        dk[r].zero();
        dv[r].zero();
        const int t = g0 + 32 * r + lane;
        kb[r] = MASKED && r < nr && t < S ? __ldg(kp + t) : 0;
      }
      stream_walk(ring, KS, S, NK, copy_qg,
                  [&](const float* buf, int j0, int nj) {
                    if (nr == 0) return;
                    for (int u = 0; u < nj; ++u) {
                      const int i = j0 + u;
                      uint8_t nb[RK];  // the next query's bytes, ahead
#pragma unroll
                      for (int r = 0; r < RK; ++r) {
                        const int t = g0 + 32 * r + lane;
                        nb[r] = MASKED && r < nr && t < S && i + 1 < S
                                    ? __ldg(kp + (size_t)(i + 1) * S + t)
                                    : 0;
                      }
                      const float* qi = buf + u * KS;
                      dkdv_query<HD, W, RK, MASKED>(
                          dk, dv, k, v, kb, qi, qi + hd,
                          *reinterpret_cast<const float2*>(qi + 2 * hd), nr,
                          hd, c0, n, inv_keep);
#pragma unroll
                      for (int r = 0; r < RK; ++r) kb[r] = nb[r];
                    }
                  });
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        const int t = g0 + 32 * r + lane;
        if (r < nr && t < S) {
          dk[r].store(out + (size_t)t * TT + C + c0, scale, n);
          dv[r].store(out + (size_t)t * TT + 2 * C + c0, 1.f, n);
        }
      }
    }
  }
}

using I0 = std::integral_constant<int, 0>;
using I1 = std::integral_constant<int, 1>;
using I4 = std::integral_constant<int, 4>;
using I16 = std::integral_constant<int, 16>;
using I32 = std::integral_constant<int, 32>;

// Calls f(HD, W, MASKED, ONE) (std::integral_constant values) for the
// staged long cores' instantiation that takes head width hd and rows of S
// tokens.
template <class F>
cudaError_t long_dispatch(int hd, int S, bool masked, F f) {
  auto go = [&](auto head, auto w, auto one) {
    return masked ? f(head, w, std::true_type{}, one)
                  : f(head, w, std::false_type{}, one);
  };
  using No = std::false_type;
  using Yes = std::true_type;
  if (hd == 4)
    return S <= 32 ? go(I4{}, I4{}, Yes{}) : go(I4{}, I4{}, No{});
  if (hd == 16)
    return S <= 32 ? go(I16{}, I4{}, Yes{}) : go(I16{}, I4{}, No{});
  if (hd == 32) {
    // one query (key) a lane in every walk: ONE would be the same code
    if constexpr (LongHead<32>::kFwdQ == 1) return go(I32{}, I4{}, No{});
    return S <= 32 ? go(I32{}, I4{}, Yes{}) : go(I32{}, I4{}, No{});
  }
  // a runtime width: a query (key) a lane whatever S is
  if (hd % 4 == 0) return go(I0{}, I4{}, No{});
  return go(I0{}, I1{}, No{});
}

// Calls f(HD, W, MASKED) for the streamed cores' instantiation that takes
// head width hd: the staged long cores' compiled widths, else the runtime
// width.
template <class F>
cudaError_t stream_dispatch(int hd, bool masked, F f) {
  auto go = [&](auto head, auto w) {
    return masked ? f(head, w, std::true_type{})
                  : f(head, w, std::false_type{});
  };
  if (hd == 4) return go(I4{}, I4{});
  if (hd == 16) return go(I16{}, I4{});
  if (hd == 32) return go(I32{}, I4{});
  if (hd % 4 == 0) return go(I0{}, I4{});
  return go(I0{}, I1{});
}

// Warps of a streamed block for rows of S tokens whose walks take groups
// of 32·ra and 32·rb queries (keys): as many as the larger walk's groups,
// at most `most`, evened out over its rounds.
inline int stream_warps(int S, int ra, int rb, int most) {
  const int ga = (S + 32 * ra - 1) / (32 * ra);
  const int gb = (S + 32 * rb - 1) / (32 * rb);
  const int ng = ga > gb ? ga : gb;
  const int rounds = (ng + most - 1) / most;
  return (ng + rounds - 1) / rounds;
}

// A streamed core on a grid of (B, H) blocks of `warps` warps.
template <class K>
cudaError_t launch_stream(K kernel, int warps, float* tok,
                          const uint8_t* keep, int B, int S, int C, int H,
                          float inv_keep, cudaStream_t st) {
  const int smem = (int)stream_smem_bytes(C / H);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const float scale = 1.0f / sqrtf((float)(C / H));
  kernel<<<dim3(B, H), 32 * warps, smem, st>>>(tok, keep, B, S, C, H, scale,
                                               inv_keep);
  return cudaGetLastError();
}

// The forward core on `tok` ([B·S, fwd_row_floats(C)] floats, or direct
// [B·S, 4C], 16-byte aligned): the short core up to kShortS, the long one
// past it; the direct form's streamed core at any S.
cudaError_t launch_fwd_core(float* tok, const uint8_t* keep, int B, int S,
                            int C, int H, float inv_keep, int rows,
                            bool direct, cudaStream_t st) {
  if (direct)
    return stream_dispatch(
        C / H, keep != nullptr, [&](auto hd, auto w, auto masked) {
          constexpr int HD = decltype(hd)::value;
          return launch_stream(
              &column_attention_fwd_core_stream_kernel<
                  HD, decltype(w)::value, decltype(masked)::value>,
              stream_warps(S, LongHead<HD>::kFwdQ, LongHead<HD>::kFwdQ,
                           kStreamWarps),
              tok, keep, B, S, C, H, inv_keep, st);
        });
  const size_t smem = fwd_core_smem_floats(S, C, rows) * sizeof(float);
  const float scale = 1.0f / sqrtf((float)(C / H));
  if (S > kShortS)
    return long_dispatch(
        C / H, S, keep != nullptr,
        [&](auto hd, auto w, auto masked, auto one) {
          auto kernel = &column_attention_fwd_core_long_kernel<
              decltype(hd)::value, decltype(w)::value,
              decltype(masked)::value, decltype(one)::value>;
          cudaError_t e = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              (int)smem);
          if (e != cudaSuccess) return e;
          kernel<<<(B + rows - 1) / rows, kCoreThreads, smem, st>>>(
              tok, keep, B, S, C, H, scale, inv_keep, rows);
          return cudaGetLastError();
        });
  return by_s(S, [&](auto ms) {
    constexpr int kMaxS = decltype(ms)::value;
    auto kernel = C % 4 ? &column_attention_fwd_core_kernel<kMaxS, true>
                        : &column_attention_fwd_core_kernel<kMaxS, false>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<(B + rows - 1) / rows, kCoreThreads, smem, st>>>(
        tok, keep, B, S, C, H, scale, inv_keep, rows);
    return cudaGetLastError();
  });
}

// A reduce block's entries, and the threads that share each entry.
constexpr int kReduceEntries = 32;
constexpr int kReduceParts = kThreads / kReduceEntries;

// grads[k] = Σ_g partials[g][k] in a fixed order: 8 threads sum an entry's
// slices g ≡ part (mod 8), each in order, and the 8 sums are then added in
// order. Deterministic, no atomics; 132 blocks at C = 32 (4,224 entries).
__global__ void __launch_bounds__(kThreads)
column_attention_bwd_reduce_kernel(const float* __restrict__ partials,
                                   int nparts, int total,
                                   float* __restrict__ grads) {
  __shared__ float sums[kReduceParts][kReduceEntries];
  const int e = threadIdx.x % kReduceEntries;
  const int part = threadIdx.x / kReduceEntries;
  const int k = blockIdx.x * kReduceEntries + e;
  float s = 0.f;
  if (k < total)
    for (int g = part; g < nparts; g += kReduceParts)
      s += partials[(size_t)g * total + k];
  sums[part][e] = s;
  __syncthreads();
  if (part == 0 && k < total) {
    float t = 0.f;
#pragma unroll
    for (int p = 0; p < kReduceParts; ++p) t += sums[p][e];
    grads[k] = t;
  }
}

cudaError_t launch_reduce(const float* partials, int nparts, int total,
                          float* grads, cudaStream_t stream) {
  const int blocks = (total + kReduceEntries - 1) / kReduceEntries;
  column_attention_bwd_reduce_kernel<<<blocks, kThreads, 0, stream>>>(
      partials, nparts, total, grads);
  return cudaGetLastError();
}

// The split backward's five launches (rmm_column_attention_bwd_split), in
// the aligned or the narrow GEMM form, the core staged or direct.
template <bool NARROW>
cudaError_t bwd_split(const elem_t* x, const elem_t* dout,
                      const elem_t* wqkv, const elem_t* bqkv,
                      const elem_t* wout, const uint8_t* keep, elem_t* dx,
                      float* tok, float* partials, float* grads, int B,
                      int S, int C, int H, float inv_keep, int rows,
                      int split_tokens, bool direct, cudaStream_t st) {
  using rmm_gemm::Gemm;
  using rmm_gemm::make_gemm;
  using G = SplitGemms<NARROW>;
  const int N = B * S, C3 = 3 * C;
  const int TT = direct ? direct_row_floats(C, true) : 4 * C;
  // the core's outputs dq | dk | dv | ctx: over its inputs, or beside them
  float* res = tok + (direct ? 4 * C : 0);
  const long long total = 4LL * C * C + 4 * C;
  // 1. the projections: A = x or do (tokens × channels), B = Wqkv (k-major)
  //    or Wout read as Woutᵀ (n-major).
  const Gemm qkv = make_gemm(x, C, wqkv, C3, tok, TT, bqkv, N, C3, C, C, 0,
                             0);
  const Gemm dctx = make_gemm(dout, C, wout, C, tok + C3, TT, nullptr, N, C,
                              C, C, 0, 0);
  cudaError_t err =
      G::template launch<typename G::Qkv, typename G::Dctx>(qkv, &dctx,
                                                            st);
  if (err != cudaSuccess) return err;
  // 2. the attention core (4C floats a token row: 16-byte rows at any C;
  //    direct: 8C, streamed a (row, head) at a time)
  const size_t smem = core_smem_floats(S, C, H, rows) * sizeof(float);
  const float scale = 1.0f / sqrtf((float)(C / H));
  auto run_core = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<(B + rows - 1) / rows, kCoreThreads, smem, st>>>(
        tok, keep, B, S, C, H, scale, inv_keep, rows);
    return cudaGetLastError();
  };
  if (direct)
    err = stream_dispatch(
        C / H, keep != nullptr, [&](auto hd, auto w, auto masked) {
          constexpr int HD = decltype(hd)::value;
          return launch_stream(
              &column_attention_bwd_core_stream_kernel<
                  HD, decltype(w)::value, decltype(masked)::value>,
              stream_warps(S, LongHead<HD>::kBwdQ, LongHead<HD>::kK,
                           kStreamBwdWarps),
              tok, keep, B, S, C, H, inv_keep, st);
        });
  else if (S > kShortS)
    err = long_dispatch(C / H, S, keep != nullptr,
                        [&](auto hd, auto w, auto masked, auto one) {
                          return run_core(
                              column_attention_bwd_core_long_kernel<
                                  decltype(hd)::value, decltype(w)::value,
                                  decltype(masked)::value,
                                  decltype(one)::value>);
                        });
  else
    err = by_s(S, [&](auto ms) {
      return run_core(column_attention_bwd_core_kernel<decltype(ms)::value>);
    });
  if (err != cudaSuccess) return err;
  // 3. dx = dqkv·Wqkvᵀ: B(k = j, n = c) = Wqkv[c][j] is n-major
  const Gemm gdx = make_gemm(res, TT, wqkv, C3, dx, C, nullptr, N, C, C3,
                             C3, 0, 0);
  err = G::template launch<typename G::Dx, typename G::Dx>(gdx, nullptr,
                                                          st);
  if (err != cudaSuccess) return err;
  // 4. the weight and bias gradients over token splits: A = x or ctx read
  //    as xᵀ (k-major), B = dqkv or do (k-major); the bias rows follow
  //    each weight in the partials layout.
  const Gemm gwq = make_gemm(x, C, res, TT, partials, C3, nullptr, C, C3, N,
                             split_tokens, total, 1);
  const Gemm gwo = make_gemm(res + C3, TT, dout, C,
                             partials + (size_t)C * C3 + C3, C, nullptr, C,
                             C, N, split_tokens, total, 1);
  err = G::template launch<typename G::Dwq, typename G::Dwo>(gwq, &gwo,
                                                            st);
  if (err != cudaSuccess) return err;
  // 5. the reduce
  return launch_reduce(partials, (N + split_tokens - 1) / split_tokens,
                       (int)total, grads, st);
}

// The split forward's three launches (rmm_column_attention_fwd_split), in
// the aligned or the narrow GEMM form, the core staged or direct.
template <bool NARROW>
cudaError_t fwd_split(const elem_t* x, const elem_t* wqkv,
                      const elem_t* bqkv, const elem_t* wout,
                      const elem_t* bout, const uint8_t* keep, elem_t* out,
                      float* tok, int B, int S, int C, int H, float inv_keep,
                      int rows, bool direct, cudaStream_t st) {
  using rmm_gemm::Gemm;
  using rmm_gemm::make_gemm;
  using G = SplitGemms<NARROW>;
  const int N = B * S, C3 = 3 * C;
  const int TT = direct ? direct_row_floats(C, false) : fwd_row_floats(C);
  // 1. qkv = x·Wqkv + bqkv: A = x (tokens × channels), B = Wqkv (k-major);
  //    the backward's projection instantiation, one problem.
  const Gemm qkv = make_gemm(x, C, wqkv, C3, tok, TT, bqkv, N, C3, C, C, 0,
                             0);
  cudaError_t err =
      G::template launch<typename G::Qkv, typename G::Dctx>(qkv, nullptr,
                                                            st);
  if (err != cudaSuccess) return err;
  // 2. the attention core: ctx over q (direct: beside v)
  err = launch_fwd_core(tok, keep, B, S, C, H, inv_keep, rows, direct, st);
  if (err != cudaSuccess) return err;
  // 3. out = ctx·Wout + bout: A = ctx (the first C floats of each token
  //    row; direct: the last C), B = Wout (k-major)
  const Gemm o = make_gemm(tok + (direct ? C3 : 0), TT, wout, C, out, C,
                           bout, N, C, C, C, 0, 0);
  return G::template launch<typename G::Out, typename G::Dctx>(o, nullptr,
                                                              st);
}

// Blocks a tiled kernel launches with `smem` bytes a block: as many as
// fill every SM, at most one a row group; or a negative CUDA error code.
template <class K>
int tiled_grid(K kernel, int threads, size_t smem, int B, int rows) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return -(int)e;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ngroups = (B + rows - 1) / rows;
  const int grid = sms * per_sm;
  return grid < ngroups ? grid : ngroups;
}

}  // namespace

extern "C" {

// The tiled backward (C % 4 == 0, C <= 64): its shared memory for a group
// of `rows` rows, and the partial slices each block writes (stage F's
// token splits).
size_t rmm_column_attention_bwd_tiled_smem_bytes(int S, int C, int H,
                                                 int rows) {
  return tiled_smem_floats(S, C, H, rows) * sizeof(float);
}

int rmm_column_attention_bwd_tiled_splits(int C) { return tiled_splits(C); }

static bool tiled_shape_ok(int S, int C, int H, int rows) {
  return S >= 1 && S <= 16 && C >= 4 && C <= 64 && C % 4 == 0 && H >= 1 &&
         C % H == 0 && rows >= 1;
}

// Blocks the tiled backward launches for this shape (at most one a row
// group), or a negative CUDA error code.
int rmm_column_attention_bwd_tiled_grid(int B, int S, int C, int H,
                                        int rows) {
  if (B <= 0 || !tiled_shape_ok(S, C, H, rows))
    return -(int)cudaErrorInvalidValue;
  const size_t smem = tiled_smem_floats(S, C, H, rows) * sizeof(float);
  int grid = 0;
  tiled_dispatch(S, C, [&](auto cfg) {
    using Cfg = decltype(cfg);
    grid = tiled_grid(
        column_attention_bwd_tiled_kernel<Cfg::kMaxS, Cfg::kMaxTiles>,
        kTiledThreads, smem, B, rows);
    return cudaSuccess;
  });
  return grid;
}

// The tiled backward kernel, then the reduce of its grid × splits partial
// slices into grads (layout as rmm_column_attention_bwd's). x, dout and dx
// must be 16-byte aligned. Returns cudaGetLastError() after the launches.
int rmm_column_attention_bwd_tiled(const elem_t* x, const elem_t* dout,
                                   const elem_t* wqkv, const elem_t* bqkv,
                                   const elem_t* wout, const uint8_t* keep,
                                   elem_t* dx, float* partials, float* grads,
                                   int B, int S, int C, int H,
                                   float inv_keep, int rows, int grid,
                                   void* stream) {
  if (B <= 0) return 0;
  if (!tiled_shape_ok(S, C, H, rows) || grid < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tiled_smem_floats(S, C, H, rows) * sizeof(float);
  const float scale = 1.0f / sqrtf((float)(C / H));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = tiled_dispatch(S, C, [&](auto cfg) {
    using Cfg = decltype(cfg);
    auto kernel =
        column_attention_bwd_tiled_kernel<Cfg::kMaxS, Cfg::kMaxTiles>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kTiledThreads, smem, st>>>(x, dout, wqkv, bqkv, wout, keep,
                                              dx, partials, B, S, C, H, scale,
                                              inv_keep, rows);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(partials, grid * tiled_splits(C),
                            4 * C * C + 4 * C, grads, st);
}

// The shapes both split routes take: any S and C (a staged row must fit a
// block's shared memory: the launch refuses the others).
static bool split_shape_ok(int S, int C, int H, int rows) {
  return S >= 1 && C >= 1 && H >= 1 && C % H == 0 && rows >= 1;
}

// The split backward (the wrapper routes the widths the tiled kernel does
// not take): the staged attention core's shared memory for `rows` rows,
// the floats of its scratch (staged: B·S token rows of 4C; direct: of 8C,
// then 2·H·S floats a row of L and D), and the blocks of the
// weight-gradient GEMM an SM holds (or a negative CUDA error code).
size_t rmm_column_attention_bwd_core_smem_bytes(int S, int C, int H,
                                                int rows) {
  return core_smem_floats(S, C, H, rows) * sizeof(float);
}

size_t rmm_column_attention_bwd_scratch_floats(int B, int S, int C, int H,
                                               int direct) {
  if (!direct) return (size_t)B * S * 4 * C;
  return (size_t)B * S * direct_row_floats(C, true) + 2 * (size_t)B * H * S;
}

// The shared memory of a block of either direction's direct form (a
// (row, head) of rows of S tokens at width C): its ring of chunks, which
// does not depend on S; 0 for a shape no split route takes.
size_t rmm_column_attention_direct_smem_bytes(int S, int C, int H) {
  if (!split_shape_ok(S, C, H, 1)) return 0;
  return stream_smem_bytes(C / H);
}

int rmm_column_attention_gemm_blocks_per_sm() {
  int per_sm = 0;
  const cudaError_t e = SplitGemms<false>::blocks_per_sm(&per_sm);
  return e == cudaSuccess ? per_sm : -(int)e;
}

// The split backward's five launches (see the note at the top of this
// file), on the scratch `tok` (rmm_column_attention_bwd_scratch_floats)
// and `partials` (ceil(B·S / split_tokens) slices of 4C² + 4C floats),
// into dx and the float grads (layout as the tiled backward's); the
// attention core staged, or direct (the streamed cores). Where C
// % 4 == 0, x, dout, wqkv, wout and tok must be 16-byte aligned; otherwise
// the narrow GEMMs take them as they are. Returns the first launch's
// cudaGetLastError() that is not 0, else 0.
int rmm_column_attention_bwd_split(const elem_t* x, const elem_t* dout,
                                   const elem_t* wqkv, const elem_t* bqkv,
                                   const elem_t* wout, const uint8_t* keep,
                                   elem_t* dx, float* tok, float* partials,
                                   float* grads, int B, int S, int C, int H,
                                   float inv_keep, int rows,
                                   int split_tokens, int direct,
                                   void* stream) {
  if (B <= 0) return 0;
  if (!split_shape_ok(S, C, H, rows) || split_tokens < 1)
    return (int)cudaErrorInvalidValue;
  auto run = C % 4 ? &bwd_split<true> : &bwd_split<false>;
  return (int)run(x, dout, wqkv, bqkv, wout, keep, dx, tok, partials, grads,
                  B, S, C, H, inv_keep, rows, split_tokens, direct != 0,
                  static_cast<cudaStream_t>(stream));
}

// The split forward (the wrapper routes the widths the tiled kernel does
// not take): the floats of its scratch row a token (staged: q | k | v
// padded to a multiple of 4; direct: q | k | v | ctx), and the staged
// forward core's shared memory for `rows` rows (H is not needed: the
// forward core keeps no S×S tiles).
int rmm_column_attention_fwd_row_floats(int C, int direct) {
  return direct ? direct_row_floats(C, false) : fwd_row_floats(C);
}

size_t rmm_column_attention_fwd_core_smem_bytes(int S, int C, int H,
                                                int rows) {
  (void)H;
  return fwd_core_smem_floats(S, C, rows) * sizeof(float);
}

// The forward core alone, on `tok` ([B·S, row floats] floats, q | k | v
// and the pad, 16-byte aligned), its ctx copied out of the rows (staged:
// over q; direct: at 3C, beside v) into `ctx` ([B·S, C] floats). The split
// forward's second launch, for holding it against its plain twin.
int rmm_column_attention_fwd_core(float* tok, const uint8_t* keep,
                                  float* ctx, int B, int S, int C, int H,
                                  float inv_keep, int rows, int direct,
                                  void* stream) {
  if (B <= 0) return 0;
  if (!split_shape_ok(S, C, H, rows)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_fwd_core(tok, keep, B, S, C, H, inv_keep, rows,
                                    direct != 0, st);
  if (err != cudaSuccess) return (int)err;
  const int TT = direct ? direct_row_floats(C, false) : fwd_row_floats(C);
  return (int)cudaMemcpy2DAsync(
      ctx, C * sizeof(float), tok + (direct ? 3 * C : 0), TT * sizeof(float),
      C * sizeof(float), (size_t)B * S, cudaMemcpyDeviceToDevice, st);
}

// The split forward's three launches (see the note at the top of this
// file) on the scratch `tok` ([B·S, rmm_column_attention_fwd_row_floats]
// floats, 16-byte aligned), into out; the attention core staged or direct.
// Where C % 4 == 0, x, wqkv, wout and out must be 16-byte aligned too.
// Returns the first launch's cudaGetLastError() that is not 0, else 0.
int rmm_column_attention_fwd_split(const elem_t* x, const elem_t* wqkv,
                                   const elem_t* bqkv, const elem_t* wout,
                                   const elem_t* bout, const uint8_t* keep,
                                   elem_t* out, float* tok, int B, int S,
                                   int C, int H, float inv_keep, int rows,
                                   int direct, void* stream) {
  if (B <= 0) return 0;
  if (!split_shape_ok(S, C, H, rows)) return (int)cudaErrorInvalidValue;
  auto run = C % 4 ? &fwd_split<true> : &fwd_split<false>;
  return (int)run(x, wqkv, bqkv, wout, bout, keep, out, tok, B, S, C, H,
                  inv_keep, rows, direct != 0,
                  static_cast<cudaStream_t>(stream));
}

// One problem of the narrow GEMM form alone, for holding it against a
// float64 product: C[m, n] = Σ_k A(m, k)·B(k, n) + bias[n] into float32 C
// (M rows of ldc), A m-major. layout 0: B k-major (the projections' form,
// bias of B's type or null); 1: B n-major (dctx's and dx's; bias or null);
// 2: A and B k-major, B float (the weight gradients' form), no bias, row M
// of C taking B's column sums. A and B in elem_t but B of layout 2. Returns
// cudaGetLastError() after the launch.
int rmm_gemm_narrow(const void* a, int lda, const void* b, int ldb, float* c,
                    int ldc, const void* bias, int M, int N, int K,
                    int layout, void* stream) {
  using rmm_gemm::launch_gemm;
  using rmm_gemm::make_gemm;
  using G = SplitGemms<true>;
  if (M < 1 || N < 1 || K < 1 || layout < 0 || layout > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rmm_gemm::Gemm g = make_gemm(a, lda, b, ldb, c, ldc,
                                     layout == 2 ? nullptr : bias, M, N, K,
                                     K, 0, layout == 2);
  // an empty first problem gives every block to the second
  const rmm_gemm::Gemm none = make_gemm(a, lda, b, ldb, c, ldc, nullptr, 0,
                                        N, K, K, 0, 0);
  if (layout == 0) return (int)launch_gemm<G::Qkv, G::Dctx>(g, nullptr, st);
  if (layout == 1) return (int)launch_gemm<G::Qkv, G::Dctx>(none, &g, st);
  return (int)launch_gemm<G::Dwq, G::Dwo>(g, nullptr, st);
}

#ifdef RMM_ATTENTION_BF16
// One problem of the bf16 build's tensor-core GEMM (gemm_mma.cuh) alone,
// for holding it against a float64 product, through the kernels the split
// routes launch. problem: 0 Qkv, 1 Dctx, 2 Out, 3 Dx, 4 Dwq, 5 Dwo (the
// types and layouts of SplitGemms; Dctx and Dwo as the second problem of
// their launch, as the routes run them). C[m, n] = Σ_k A(m, k)·B(k, n) +
// bias[n] (bias of B's type, or null) in the problem's output type; the K
// range in splits of split_k, split s at c + s·(M + bias_row)·ldc;
// bias_row (Dwq and Dwo) writes B's column sums over each split to its row
// M. The aligned form's contract: a, b and c 16-byte aligned, lda, ldb,
// ldc and N multiples of 4, and K (A m-major) or M (A k-major) too.
// Returns cudaGetLastError() after the launch.
int rmm_gemm_mma(const void* a, int lda, const void* b, int ldb, void* c,
                 int ldc, const void* bias, int M, int N, int K, int split_k,
                 int bias_row, int problem, void* stream) {
  using rmm_gemm::make_gemm;
  using G = SplitGemms<false>;
  const bool a_kmajor = problem >= 4;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(c);
  if (M < 1 || N < 1 || K < 1 || split_k < 1 || problem < 0 ||
      problem > 5 || (bias_row && !a_kmajor) || bases % 16 ||
      (lda | ldb | ldc | N | (a_kmajor ? M : K)) % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const rmm_gemm::Gemm g =
      make_gemm(a, lda, b, ldb, c, ldc, bias, M, N, K, split_k,
                (long long)(M + (bias_row ? 1 : 0)) * ldc, bias_row);
  // an empty first problem gives every block to the second
  const rmm_gemm::Gemm none = make_gemm(a, lda, b, ldb, c, ldc, nullptr, 0,
                                        N, K, K, 0, 0);
  // qualified: the Gemm arguments would find gemm_f32.cuh's launch_gemm too
  switch (problem) {
    case 0:
      return (int)rmm_mma::launch_gemm<G::Qkv, G::Dctx>(g, nullptr, st);
    case 1:
      return (int)rmm_mma::launch_gemm<G::Qkv, G::Dctx>(none, &g, st);
    case 2:
      return (int)rmm_mma::launch_gemm<G::Out, G::Dctx>(g, nullptr, st);
    case 3:
      return (int)rmm_mma::launch_gemm<G::Dx, G::Dx>(g, nullptr, st);
    case 4:
      return (int)rmm_mma::launch_gemm<G::Dwq, G::Dwo>(g, nullptr, st);
    default:
      return (int)rmm_mma::launch_gemm<G::Dwq, G::Dwo>(none, &g, st);
  }
}
#endif

// The tiled forward (C % 4 == 0, C <= 64): its shared memory for a group
// of `rows` rows, and the blocks it launches for this shape (or a negative
// CUDA error code).
size_t rmm_column_attention_fwd_tiled_smem_bytes(int S, int C, int H,
                                                 int rows) {
  return fwd_tiled_smem_floats(S, C, H, rows) * sizeof(float);
}

int rmm_column_attention_fwd_tiled_grid(int B, int S, int C, int H,
                                        int rows) {
  if (B <= 0 || !tiled_shape_ok(S, C, H, rows))
    return -(int)cudaErrorInvalidValue;
  const size_t smem = fwd_tiled_smem_floats(S, C, H, rows) * sizeof(float);
  int grid = 0;
  by_s(S, [&](auto ms) {
    grid = tiled_grid(column_attention_fwd_tiled_kernel<decltype(ms)::value>,
                      kFwdThreads, smem, B, rows);
    return cudaSuccess;
  });
  return grid;
}

// The tiled forward kernel. x and out must be 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 = launched).
int rmm_column_attention_fwd_tiled(const elem_t* x, const elem_t* wqkv,
                                   const elem_t* bqkv, const elem_t* wout,
                                   const elem_t* bout, const uint8_t* keep,
                                   elem_t* out, int B, int S, int C, int H,
                                   float inv_keep, int rows, int grid,
                                   void* stream) {
  if (B <= 0) return 0;
  if (!tiled_shape_ok(S, C, H, rows) || grid < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_tiled_smem_floats(S, C, H, rows) * sizeof(float);
  const float scale = 1.0f / sqrtf((float)(C / H));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_s(S, [&](auto ms) {
    auto kernel = column_attention_fwd_tiled_kernel<decltype(ms)::value>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kFwdThreads, smem, st>>>(x, wqkv, bqkv, wout, bout, keep,
                                            out, B, S, C, H, scale, inv_keep,
                                            rows);
    return cudaGetLastError();
  });
}

// The most shared memory a block may opt into on the current card, an
// SM's whole shared memory (which the blocks on it split, less 1 kB each
// that the runtime reserves), and the card's SMs.
int rmm_cuda_max_smem_per_block() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

int rmm_cuda_smem_per_sm() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                         dev);
  return bytes;
}

const char* rmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
