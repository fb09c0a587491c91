// Float32 GEMM tiles for Hopper's CUDA cores: the matrix products of the
// column attention's split routes (csrc/column_attention.cu).
//
//   C[m, n] = Σ_k A(m, k) · B(k, n)  (+ bias[n])
//
// A, B and C each have their own element type, float or bf16
// (__nv_bfloat16; the bias has B's): bf16 tiles are staged as they lie and
// converted to float exactly when the fragments load, every sum is float32,
// and a bf16 output is rounded to nearest even once. So one template takes
// the float32 route and the bf16 one (bf16 x, do, weights, out and dx
// around float32 scratch), as the TPU kernel's products take bf16 operands
// with preferred_element_type=float32.
//
// A and B each lie in device memory in one of two layouts, chosen per
// problem at compile time: "k-major" (A stored K×M, B stored K×N: k is the
// slow index) or "m-major" / "n-major" (A stored M×K, B stored N×K: k is
// the fast index). Both are copied into shared memory as they lie, 4
// elements at a time by cp.async (16 bytes of float, 8 of bf16: a bf16 row
// of C % 8 = 4 elements is 8-byte but not 16-byte aligned), so no operand is
// transposed on the way; the fragment loads read each layout 4 elements at
// a time (a float4, or 8 bytes of bf16).
//
// The narrow form (Spec::NARROW, for widths that are not a multiple of 4)
// copies one element at a time instead, each guarded by its own bounds: a
// float by a 4-byte cp.async, a bf16 (2 bytes, below cp.async's least size)
// through a register. It stores one element at a time too, each guarded by
// its own column bound. The shared-memory layout, the fragment loads and
// the products are the aligned form's. It costs 4 copies for every one of
// the aligned form (16 a thread a slice against 4), and the bf16 copies wait
// for their loads.
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
//    range. In the aligned form a chunk of 4 is in range or out of it as a
//    whole, so every row stride and base pointer must be a multiple of 4
//    elements, and so must K of an m- or n-major operand, M or N of a
//    k-major one and N of the output (the caller checks: C % 4 == 0 and
//    16-byte aligned tensors). The narrow form takes any.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rmm_gemm {

// Element access, 4 elements (a chunk) at a time, for float and bf16.
// bf16 → float is exact (the bf16 bits are the float's top half); float →
// bf16 rounds to nearest even, as PyTorch's cast does.
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ unsigned bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <class T>
struct Elem;

template <>
struct Elem<float> {
  // 4 elements into shared memory by cp.async; zeros where !ok (src-size
  // 0: nothing is read, so src need only be a valid pointer)
  static __device__ __forceinline__ void cp4(float* dst, const float* src,
                                             bool ok) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 16 : 0));
  }
  // 1 element by cp.async (4 bytes); a zero where !ok
  static __device__ __forceinline__ void cp1(float* dst, const float* src,
                                             bool ok) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 4 : 0));
  }
  static __device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void st4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ void st1(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float ldg1(const float* p) {
    return __ldg(p);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ void cp4(T* dst, const T* src, bool ok) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src), "r"(ok ? 8 : 0));
  }
  // 1 element (2 bytes, below cp.async's least size) through a register;
  // a zero where !ok
  static __device__ __forceinline__ void cp1(T* dst, const T* src, bool ok) {
    *reinterpret_cast<unsigned short*>(dst) =
        ok ? __ldg(reinterpret_cast<const unsigned short*>(src))
           : static_cast<unsigned short>(0);
  }
  static __device__ __forceinline__ float4 ld4(const T* p) {
    return bf16x4_to_float4(*reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ float4 ldg4(const T* p) {
    return bf16x4_to_float4(__ldg(reinterpret_cast<const uint2*>(p)));
  }
  static __device__ __forceinline__ void st4(T* p, float4 v) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(bf16x2_bits(v.x, v.y), bf16x2_bits(v.z, v.w));
  }
  static __device__ __forceinline__ void st1(T* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float ldg1(const T* p) {
    return __bfloat162float(__ldg(p));
  }
};

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

// A problem's layouts (A k-major, B k-major), element types (A, B, C; the
// bias has B's type) and form: NARROW copies and stores one element at a
// time (any stride, base and bound), else 4.
template <bool AK_, bool BK_, class TA_, class TB_, class TC_,
          bool NARROW_ = false>
struct Spec {
  static constexpr bool AK = AK_, BK = BK_, NARROW = NARROW_;
  using TA = TA_;
  using TB = TB_;
  using TC = TC_;
};

// One product. Pointers are to elements of the Spec's types; ld* are row
// strides of the layout as stored, in elements (k-major: the stride between
// k; otherwise between rows).
struct Gemm {
  const void* a;
  const void* b;
  void* c;
  const void* bias;    // added to every row (N elements), or null
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

__host__ inline Gemm make_gemm(const void* a, int lda, const void* b,
                               int ldb, void* c, int ldc, const void* bias,
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

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The slice of one operand at k0 .. k0 + kBK (k < klim) and rows or
// columns r0 .. r0 + 127 (< rlim) into s. K-major: g[k·ld + r] →
// s[kk·128 + rr]; otherwise g[r·ld + k] → s[rr·kPadK + kk]. Narrow: one
// element at a time, neighbouring threads on neighbouring elements of g.
template <bool KMAJOR, bool NARROW, class T>
__device__ __forceinline__ void load_slice(T* s, const T* g, int ld, int r0,
                                           int rlim, int k0, int klim,
                                           int tid) {
  if constexpr (NARROW) {
#pragma unroll
    for (int e = tid; e < kBK * kBM; e += kThreads) {
      const int kk = KMAJOR ? e / kBM : e % kBK;
      const int rr = KMAJOR ? e % kBM : e / kBK;
      const int k = k0 + kk, r = r0 + rr;
      const bool ok = k < klim && r < rlim;
      const size_t at = KMAJOR ? (size_t)k * ld + r : (size_t)r * ld + k;
      Elem<T>::cp1(s + (KMAJOR ? kk * kBM + rr : rr * kPadK + kk),
                   ok ? g + at : g, ok);
    }
  } else if (KMAJOR) {
    constexpr int kChunks = kBK * kBM / 4;
#pragma unroll
    for (int c = tid; c < kChunks; c += kThreads) {
      const int kk = c / (kBM / 4), q = c % (kBM / 4);
      const int k = k0 + kk, r = r0 + 4 * q;
      const bool ok = k < klim && r < rlim;
      Elem<T>::cp4(s + kk * kBM + 4 * q, ok ? g + (size_t)k * ld + r : g,
                   ok);
    }
  } else {
    constexpr int kChunks = kBM * kBK / 4;
#pragma unroll
    for (int c = tid; c < kChunks; c += kThreads) {
      const int rr = c / (kBK / 4), q = c % (kBK / 4);
      const int r = r0 + rr, k = k0 + 4 * q;
      const bool ok = r < rlim && k < klim;
      Elem<T>::cp4(s + rr * kPadK + 4 * q, ok ? g + (size_t)r * ld + k : g,
                   ok);
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
template <bool AK, bool BKM, class TA, class TB>
__device__ __forceinline__ void mma_slice(const TA* sA, const TB* sB,
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
          const float4 v =
              Elem<TB>::ld4(sB + (k4 + kk) * kBN + 64 * h + 4 * tx);
          b[4 * h][kk] = v.x;
          b[4 * h + 1][kk] = v.y;
          b[4 * h + 2][kk] = v.z;
          b[4 * h + 3][kk] = v.w;
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 v = Elem<TB>::ld4(sB + (tx + 16 * j) * kPadK + k4);
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
          const float4 v =
              Elem<TA>::ld4(sA + (k4 + kk) * kBM + 64 * h + 4 * ty);
          a[0][kk] = v.x;
          a[1][kk] = v.y;
          a[2][kk] = v.z;
          a[3][kk] = v.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v =
              Elem<TA>::ld4(sA + (ty + 64 * h + 16 * r) * kPadK + k4);
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

// Stores 4 consecutive outputs of a k-major-B row (N and the column are
// multiples of 4), plus the bias.
template <class TC, class TB>
__device__ __forceinline__ void store4(TC* c, const TB* bias, int col,
                                       float x, float y, float z, float w) {
  if (bias != nullptr) {
    x += Elem<TB>::ldg1(bias + col);
    y += Elem<TB>::ldg1(bias + col + 1);
    z += Elem<TB>::ldg1(bias + col + 2);
    w += Elem<TB>::ldg1(bias + col + 3);
  }
  Elem<TC>::st4(c, make_float4(x, y, z, w));
}

// One block's tile of problem g (block index `bid` within the problem).
template <class S>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int bid,
                                          float* smem) {
  using TA = typename S::TA;
  using TB = typename S::TB;
  using TC = typename S::TC;
  constexpr bool AK = S::AK, BKM = S::BK;
  const TA* ga = static_cast<const TA*>(g.a);
  const TB* gb = static_cast<const TB*>(g.b);
  const TB* bias = static_cast<const TB*>(g.bias);
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
  TC* c = static_cast<TC*>(g.c) + split * g.c_split;
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

  // a stage holds A's tile, then B's, each in kTileFloats floats whatever
  // its element type
  auto load = [&](int s) {
    float* st = smem + (s % kStages) * kStageFloats;
    const int k0 = kb + s * kBK;
    load_slice<AK, S::NARROW>(reinterpret_cast<TA*>(st), ga, g.lda, m0,
                              g.M, k0, ke, tid);
    load_slice<BKM, S::NARROW>(reinterpret_cast<TB*>(st + kTileFloats), gb,
                               g.ldb, n0, g.N, k0, ke, tid);
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
    mma_slice<AK, BKM>(reinterpret_cast<const TA*>(st),
                       reinterpret_cast<const TB*>(st + kTileFloats), acc, cs,
                       colsum, ty, tx);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + tile_row<AK>(i, ty);
    if (row >= g.M) continue;
    TC* cr = c + (size_t)row * g.ldc;
    if (BKM) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + tile_col<BKM>(4 * h, tx);
        if constexpr (S::NARROW) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < g.N)
              Elem<TC>::st1(cr + col + j,
                            acc[i][4 * h + j] +
                                (bias != nullptr
                                     ? Elem<TB>::ldg1(bias + col + j)
                                     : 0.f));
        } else if (col < g.N) {
          store4(cr + col, bias, col, acc[i][4 * h], acc[i][4 * h + 1],
                 acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + tile_col<BKM>(j, tx);
        if (col < g.N)
          Elem<TC>::st1(cr + col,
                        acc[i][j] + (bias != nullptr
                                         ? Elem<TB>::ldg1(bias + col)
                                         : 0.f));
      }
    }
  }
  if (colsum) {
    TC* cr = c + (size_t)g.M * g.ldc;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tile_col<BKM>(j, tx);
      if (col < g.N) Elem<TC>::st1(cr + col, cs[j]);
    }
  }
}

template <class S0, class S1>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gemm_kernel(GemmPair pair) {
  extern __shared__ __align__(16) float gemm_smem[];
  const int bid = blockIdx.x;
  if (bid < pair.p[0].blocks)
    gemm_tile<S0>(pair.p[0], bid, gemm_smem);
  else
    gemm_tile<S1>(pair.p[1], bid - pair.p[0].blocks, gemm_smem);
}

// Launches one or two problems (count) of the Specs in the template.
template <class S0, class S1>
cudaError_t launch_gemm(const Gemm& g0, const Gemm* g1,
                        cudaStream_t stream) {
  auto kernel = gemm_kernel<S0, S1>;
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

// Blocks of the GEMM kernel (of the Specs in the template) an SM holds.
template <class S0, class S1>
cudaError_t gemm_blocks_per_sm(int* per_sm) {
  auto kernel = gemm_kernel<S0, S1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, kSmemBytes);
}

}  // namespace rmm_gemm
