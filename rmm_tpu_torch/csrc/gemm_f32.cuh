// Float32 GEMM tiles for Hopper's CUDA cores: the matrix products of the
// column-attention backward's split route (csrc/column_attention.cu).
//
//   C[m, n] = Σ_k A(m, k) · B(k, n)  (+ bias[n])
//
// A and B each lie in device memory in one of two layouts, chosen per
// problem at compile time: "k-major" (A stored K×M, B stored K×N: k is the
// slow index) or "m-major" / "n-major" (A stored M×K, B stored N×K: k is
// the fast index). Both are copied into shared memory as they lie, 16 bytes
// at a time by cp.async, so no operand is transposed on the way; the
// fragment loads read each layout with float4s.
//
// Design:
//  * Block tiles of 128×128 outputs over 256 threads, each thread an 8×8
//    register microtile (64 float32 sums), summed over k in order: every
//    output is one thread's FMA chain, so two calls give the same bits.
//  * K-slices of kBK in a ring of kStages shared-memory buffers: the loads
//    of slice s + kStages − 1 are in flight while slice s is computed.
//  * Fragment loads are float4s laid out so that a warp's loads hit
//    distinct 16-byte bank groups: a warp covers 4 row groups × 8 column
//    groups of threads; a k-major tile is read along its rows (4 or 8
//    consecutive float4s), an m- or n-major one along k with rows padded
//    to kBK + 4 floats (≡ 4 mod 32 words apart at kBK = 32, a permutation
//    of the 8 bank groups at kBK = 16).
//  * A chunk of 4 k-steps holds B's fragment (8 columns × 4 k, 32 floats)
//    and half of A's (4 rows × 4 k) at a time: 256 FMAs for 16 float4
//    loads, so the FMA pipe, not shared memory, is the busier unit.
//  * Ragged edges: rows, columns and k past the problem's bounds are
//    zero-filled by cp.async (src-size 0), and the epilogue stores only in
//    range. Every row stride and base pointer must be a multiple of 4
//    floats (the caller checks: C % 4 == 0 and 16-byte aligned tensors).
//  * A K range may be cut into splits (the weight gradients' token ranges):
//    split s sums k in [s·split_k, min(K, (s + 1)·split_k)) into its own
//    output slice, c_split floats after the previous one. With bias_row
//    (taken where A is k-major, as in the weight gradients), the blocks of
//    the first row tile also write B's column sums over their K range to
//    row M of C (the bias gradients), from the B fragments they already
//    hold.
//  * One launch may run two problems (GemmPair): blocks [0, p[0].blocks)
//    take the first, the rest the second, each by its own layouts.
// What bounds it: float32 FMAs on the CUDA cores (no tensor cores: the
// backward is held to 1e-4 of float32 autograd, which TF32 would miss).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rmm_gemm {

constexpr int kBM = 128;                       // rows of a block tile
constexpr int kBN = 128;                       // columns of a block tile
constexpr int kThreads = 256;
// k-slices of 16, three stages and launch bounds for two blocks an SM (128
// registers, under 200 bytes of spills in the projections and dx): the
// fastest whole backward in tools/torch_attn_split.py --sweep's runs at
// 131072×6×128/8 (PERF.md), which builds other values of these three.
constexpr int kBK = 16;                        // k of a slice
constexpr int kStages = 3;
constexpr int kMinBlocks = 2;                  // an SM, in the launch bounds
constexpr int kPadK = kBK + 4;                 // row of an m- or n-major tile
constexpr int kTileFloats = kBM * kPadK;       // either layout fits
constexpr int kStageFloats = 2 * kTileFloats;  // A and B
constexpr size_t kSmemBytes = sizeof(float) * kStages * kStageFloats;
static_assert(kBK % 4 == 0 && kBK >= 4, "kBK is a multiple of 4");
static_assert(kBM == 128 && kBN == 128, "the thread map assumes 128x128");

// One product. Pointers are in floats; ld* are row strides of the layout
// as stored (k-major: the stride between k; otherwise between rows).
struct Gemm {
  const float* a;
  const float* b;
  float* c;
  const float* bias;   // added to every row (N floats), or null
  int M, N, K;
  int lda, ldb, ldc;
  int split_k;         // k a split (K when not split)
  long long c_split;   // floats between consecutive splits' outputs
  int bias_row;        // also write B's column sums to row M of C
  int tiles_n;         // column tiles
  int tiles;           // tiles a split
  int blocks;          // tiles × splits
};

struct GemmPair {
  Gemm p[2];
};

__host__ inline Gemm make_gemm(const float* a, int lda, const float* b,
                               int ldb, float* c, int ldc, const float* bias,
                               int M, int N, int K, int split_k,
                               long long c_split, int bias_row) {
  Gemm g;
  g.a = a; g.b = b; g.c = c; g.bias = bias;
  g.M = M; g.N = N; g.K = K;
  g.lda = lda; g.ldb = ldb; g.ldc = ldc;
  g.split_k = split_k > 0 ? split_k : (K > 0 ? K : 1);
  g.c_split = c_split;
  g.bias_row = bias_row;
  g.tiles_n = (N + kBN - 1) / kBN;
  g.tiles = ((M + kBM - 1) / kBM) * g.tiles_n;
  const int splits = (K + g.split_k - 1) / g.split_k;
  g.blocks = g.tiles * (splits > 0 ? splits : 1);
  return g;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes into shared memory by cp.async; zeros where !ok (src-size 0:
// nothing is read, so src need only be a valid pointer).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The slice of one operand at k0 .. k0 + kBK (k < klim) and rows or
// columns r0 .. r0 + 127 (< rlim) into s. K-major: g[k·ld + r] →
// s[kk·128 + rr]; otherwise g[r·ld + k] → s[rr·kPadK + kk].
template <bool KMAJOR>
__device__ __forceinline__ void load_slice(float* s, const float* g, int ld,
                                           int r0, int rlim, int k0,
                                           int klim, int tid) {
  if (KMAJOR) {
    constexpr int kChunks = kBK * kBM / 4;
#pragma unroll
    for (int c = tid; c < kChunks; c += kThreads) {
      const int kk = c / (kBM / 4), q = c % (kBM / 4);
      const int k = k0 + kk, r = r0 + 4 * q;
      const bool ok = k < klim && r < rlim;
      cp16(s + kk * kBM + 4 * q, ok ? g + (size_t)k * ld + r : g, ok);
    }
  } else {
    constexpr int kChunks = kBM * kBK / 4;
#pragma unroll
    for (int c = tid; c < kChunks; c += kThreads) {
      const int rr = c / (kBK / 4), q = c % (kBK / 4);
      const int r = r0 + rr, k = k0 + 4 * q;
      const bool ok = r < rlim && k < klim;
      cp16(s + rr * kPadK + 4 * q, ok ? g + (size_t)r * ld + k : g, ok);
    }
  }
}

// Row of the tile that a thread's sum i covers (thread row group ty),
// and column j (thread column group tx), by layout: a k-major A is read
// as float4s of 4 rows (rows 4ty .. 4ty + 3 and 64 more), an m-major one
// as float4s of 4 k (rows ty + 16i); likewise for B's columns.
template <bool AK>
__device__ __forceinline__ int tile_row(int i, int ty) {
  return AK ? 64 * (i / 4) + 4 * ty + i % 4 : ty + 16 * i;
}

template <bool BKM>
__device__ __forceinline__ int tile_col(int j, int tx) {
  return BKM ? 64 * (j / 4) + 4 * tx + j % 4 : tx + 16 * j;
}

// acc += the slice in sA, sB; cs += B's column sums where colsum.
template <bool AK, bool BKM>
__device__ __forceinline__ void mma_slice(const float* sA, const float* sB,
                                          float (&acc)[8][8], float (&cs)[8],
                                          bool colsum, int ty, int tx) {
#pragma unroll
  for (int k4 = 0; k4 < kBK; k4 += 4) {
    float b[8][4];
    if (BKM) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = lds4(sB + (k4 + kk) * kBN + 64 * h + 4 * tx);
          b[4 * h][kk] = v.x;
          b[4 * h + 1][kk] = v.y;
          b[4 * h + 2][kk] = v.z;
          b[4 * h + 3][kk] = v.w;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v = lds4(sB + (tx + 16 * j) * kPadK + k4);
        b[j][0] = v.x;
        b[j][1] = v.y;
        b[j][2] = v.z;
        b[j][3] = v.w;
      }
    }
    if (colsum) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) cs[j] += b[j][kk];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a[4][4];
      if (AK) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v = lds4(sA + (k4 + kk) * kBM + 64 * h + 4 * ty);
          a[0][kk] = v.x;
          a[1][kk] = v.y;
          a[2][kk] = v.z;
          a[3][kk] = v.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v = lds4(sA + (ty + 64 * h + 16 * r) * kPadK + k4);
          a[r][0] = v.x;
          a[r][1] = v.y;
          a[r][2] = v.z;
          a[r][3] = v.w;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[4 * h + r][j] = fmaf(a[r][kk], b[j][kk], acc[4 * h + r][j]);
    }
  }
}

// Stores 4 consecutive outputs of a k-major-B row (a float4; N and the
// column are multiples of 4), plus the bias.
__device__ __forceinline__ void store4(float* c, const float* bias, int col,
                                       float x, float y, float z, float w) {
  if (bias != nullptr) {
    x += __ldg(bias + col);
    y += __ldg(bias + col + 1);
    z += __ldg(bias + col + 2);
    w += __ldg(bias + col + 3);
  }
  *reinterpret_cast<float4*>(c) = make_float4(x, y, z, w);
}

// One block's tile of problem g (block index `bid` within the problem).
template <bool AK, bool BKM>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int bid,
                                          float* smem) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  const int split = bid / g.tiles;
  const int t = bid - split * g.tiles;
  const int tm = t / g.tiles_n;
  const int m0 = tm * kBM, n0 = (t - tm * g.tiles_n) * kBN;
  const int kb = split * g.split_k;
  const int ke = min(g.K, kb + g.split_k);
  const int slices = (ke - kb + kBK - 1) / kBK;
  float* c = g.c + split * g.c_split;
  // Only the weight gradients (A k-major) ask for bias rows: the other
  // instantiations keep no column sums.
  const bool colsum = AK && g.bias_row && tm == 0 && ty == 0;

  float acc[8][8];
  float cs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cs[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  auto load = [&](int s) {
    float* st = smem + (s % kStages) * kStageFloats;
    const int k0 = kb + s * kBK;
    load_slice<AK>(st, g.a, g.lda, m0, g.M, k0, ke, tid);
    load_slice<BKM>(st + kTileFloats, g.b, g.ldb, n0, g.N, k0, ke, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) load(s);
    cp_commit();
  }
  for (int s = 0; s < slices; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();  // slice s landed; every thread is done with s − 1
    if (s + kStages - 1 < slices) load(s + kStages - 1);
    cp_commit();
    const float* st = smem + (s % kStages) * kStageFloats;
    mma_slice<AK, BKM>(st, st + kTileFloats, acc, cs, colsum, ty, tx);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row<AK>(i, ty);
    if (row >= g.M) continue;
    float* cr = c + (size_t)row * g.ldc;
    if (BKM) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + tile_col<BKM>(4 * h, tx);
        if (col < g.N)
          store4(cr + col, g.bias, col, acc[i][4 * h], acc[i][4 * h + 1],
                 acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tile_col<BKM>(j, tx);
        if (col < g.N)
          cr[col] = acc[i][j] + (g.bias != nullptr ? __ldg(g.bias + col)
                                                   : 0.f);
      }
    }
  }
  if (colsum) {
    float* cr = c + (size_t)g.M * g.ldc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tile_col<BKM>(j, tx);
      if (col < g.N) cr[col] = cs[j];
    }
  }
}

template <bool AK0, bool BK0, bool AK1, bool BK1>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gemm_kernel(GemmPair pair) {
  extern __shared__ __align__(16) float gemm_smem[];
  const int bid = blockIdx.x;
  if (bid < pair.p[0].blocks)
    gemm_tile<AK0, BK0>(pair.p[0], bid, gemm_smem);
  else
    gemm_tile<AK1, BK1>(pair.p[1], bid - pair.p[0].blocks, gemm_smem);
}

// Launches one or two problems (count) of the layouts in the template.
template <bool AK0, bool BK0, bool AK1, bool BK1>
cudaError_t launch_gemm(const Gemm& g0, const Gemm* g1,
                        cudaStream_t stream) {
  auto kernel = gemm_kernel<AK0, BK0, AK1, BK1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  GemmPair pair;
  pair.p[0] = g0;
  pair.p[1] = g1 != nullptr ? *g1 : g0;
  const int blocks = g0.blocks + (g1 != nullptr ? g1->blocks : 0);
  if (blocks <= 0) return cudaSuccess;
  kernel<<<blocks, kThreads, kSmemBytes, stream>>>(pair);
  return cudaGetLastError();
}

// Blocks of the GEMM kernel (of the layouts in the template) an SM holds.
template <bool AK0, bool BK0, bool AK1, bool BK1>
cudaError_t gemm_blocks_per_sm(int* per_sm) {
  auto kernel = gemm_kernel<AK0, BK0, AK1, BK1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, kSmemBytes);
}

}  // namespace rmm_gemm
