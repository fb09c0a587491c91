// bf16 tensor-core GEMM tiles for Hopper: the matrix products of the
// column attention's split routes in the bf16 build
// (csrc/column_attention.cu built with RMM_ATTENTION_BF16), at every width
// that is a multiple of 4. The float32 build and the narrow form (C % 4 !=
// 0) keep the FMA tiles of gemm_f32.cuh.
//
//   C[m, n] = Σ_k A(m, k) · B(k, n)  (+ bias[n])
//
// The contract is gemm_f32.cuh's aligned form, and so are the problems
// (rmm_gemm::Gemm, GemmPair, Spec, make_gemm): two problems a launch, a
// K range cut into token splits that write their own output slices, a
// bias, B's column sums in row M (bias_row), A m-major or k-major and B
// k-major or n-major by the Spec, each operand and the output in its own
// element type, zero-filled ragged edges in M, N and K; every row stride
// and base pointer a multiple of 4 elements, and so K of an m- or n-major
// operand, M or N of a k-major one and N of the output.
//
// Arithmetic. Every problem of the bf16 build has one bf16 operand at
// least (x, do, the weights); the other is bf16 too, or float32 (the
// token rows' scratch: ctx, dqkv). Products are
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16 × bf16 exact,
// float32 sums, as the TPU kernel's dots take bf16 operands with
// preferred_element_type=float32. A float32 operand is not rounded to
// bf16 once (the reference takes those products in float32): as its
// fragments load, each value a is split into hi = bf16(a) and lo =
// bf16(a − hi), so that a = hi + lo to 2^-16 of a, and each k-step issues
// two MMAs against the exact bf16 operand, hi then lo. A bf16 output is
// rounded to nearest even once, after the bias.
//
// Design:
//  * Block tiles of 128×128 outputs over 8 warps, each warp a 64×32
//    sub-tile of 4×4 MMA tiles (m16 × n8): 64 float32 sums a thread.
//  * K-slices of kBK = 32 in a ring of kStages shared-memory buffers,
//    copied by cp.async as they lie in device memory (8 bytes = 4 bf16 a
//    copy, as bf16 rows of C % 8 = 4 are 8-byte but not 16-byte aligned;
//    16 bytes = 4 floats): the loads of slice s + kStages − 1 are in
//    flight while slice s is computed.
//  * bf16 fragments come by ldmatrix (.trans from the k-major tiles); a
//    float32 operand's by 8-byte (m-major) or 4-byte (k-major) shared
//    loads, split into hi and lo in registers. Rows are padded so that
//    each phase of a warp's loads hits distinct banks: bf16 m-/n-major
//    rows of kBK + 8 elements (80 bytes: the 8 rows of an 8×8 matrix in 8
//    distinct 16-byte bank groups), bf16 k-major of 136 (272 bytes: the
//    same), float m-major of kBK + 8 (40 words: the 16 float2 of a
//    half-warp on 32 distinct banks), float k-major of 132 (≡ 4 mod 32:
//    k rows 2t apart and 8 columns on 32 distinct banks).
//  * Every output is one thread's accumulator through a fixed sequence of
//    MMAs, so two calls give the same bits. The MMAs' float32 sums are
//    not rounded as an FMA's are (an exact 24-bit sum of three terms came
//    out 2^-19 short on an H100), so the drift grows with K: the split
//    routes' weight gradients sum at most 4,096 tokens a split
//    (ops/column_attention.py::MMA_SPLIT_TOKENS), the reduce adding the
//    splits in float32.
//  * Bias rows (the weight gradients: A and B k-major): the MMA fragments
//    hold no column of B whole, so the blocks of the first row tile sum
//    B's columns on the CUDA cores from the staged slices, in float32, a
//    column a thread over one half of each slice's k, the two halves
//    added last: a fixed order.
// What bounds it: the float32 scratch rows it reads or writes, not the
// MMA rate. At 4096×54×128/8 the backward's five GEMM problems move about
// 1.5 GB (~0.46 ms at 3.35 TB/s) for about 130 GFLOP with the lo passes
// (~0.13 ms at 989 TFLOP/s). mma.sync, not wgmma: the products are far
// from the tensor cores' rate.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_f32.cuh"

namespace rmm_mma {

using rmm_gemm::Elem;
using rmm_gemm::Gemm;
using rmm_gemm::GemmPair;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                   // rows of a block tile
constexpr int kBN = 128;                   // columns of a block tile
constexpr int kThreads = 256;              // 8 warps
constexpr int kWarpM = 64;                 // a warp's sub-tile: rows
constexpr int kWarpN = 32;                 // and columns
constexpr int kWarpsN = kBN / kWarpN;      // 4 warps across, 2 down
constexpr int kMi = kWarpM / 16;           // m16 MMA tiles of a warp
constexpr int kNj = kWarpN / 8;            // n8 MMA tiles of a warp
constexpr int kBK = 32;                    // k of a slice
constexpr int kStages = 3;
constexpr int kMinBlocks = 2;              // an SM, in the launch bounds
static_assert(kBM == rmm_gemm::kBM && kBN == rmm_gemm::kBN,
              "make_gemm counts tiles of gemm_f32.cuh's size");
static_assert((kBM / kWarpM) * kWarpsN * 32 == kThreads, "8 warps");
static_assert(kThreads == 2 * kBN, "two threads a column for bias rows");

template <class T>
constexpr bool kF32 = std::is_same<T, float>::value;

// The shared-memory layout of one operand's slice: k-major, kBK rows of
// 128 elements, or m-/n-major, 128 rows of kBK; rows kLd elements apart.
template <bool KMAJOR, class T>
struct Tile {
  static constexpr int kLd =
      KMAJOR ? kBM + (kF32<T> ? 4 : 8) : kBK + 8;
  static constexpr int kRows = KMAJOR ? kBK : kBM;
  static constexpr int kBytes =
      (kRows * kLd * (int)sizeof(T) + 15) / 16 * 16;
};

// Bytes of a ring stage of problem S (A's tile, then B's), and of the ring
// of a launch of two problems.
template <class S>
constexpr int kStageBytes = Tile<S::AK, typename S::TA>::kBytes +
                            Tile<S::BK, typename S::TB>::kBytes;

template <class S0, class S1>
constexpr size_t kSmemBytes =
    (size_t)kStages * ((kStageBytes<S0>) > (kStageBytes<S1>)
                           ? kStageBytes<S0>
                           : kStageBytes<S1>);

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8×8 bf16 matrices: lanes 8i .. 8i + 7 give the addresses of
// matrix i's rows; lane l gets row l/4, elements 2(l%4) and 2(l%4) + 1
// of each (.trans: column l/4, rows 2(l%4) and 2(l%4) + 1).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a·b on one m16n8k16 tile: a row-major (4 registers of 2 bf16), b
// column-major (2), d float32.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 pairs (x0 in the low half): hi = bf16(x), lo =
// bf16(x − hi), x = hi + lo to 2^-16 of x (x − hi is exact in float32).
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi,
                                       unsigned& lo) {
  hi = rmm_gemm::bf16x2_bits(x0, x1);
  lo = rmm_gemm::bf16x2_bits(x0 - __uint_as_float(hi << 16),
                             x1 - __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) {
  return __bfloat162float(v);
}

// One operand's slice at k0 .. k0 + kBK (k < klim), rows or columns r0 ..
// r0 + 127 (< rlim), into s, 4 elements a copy (zeros out of range).
// K-major: g[k·ld + r] → s[kk·kLd + rr]; otherwise g[r·ld + k] →
// s[rr·kLd + kk].
template <bool KMAJOR, class T>
__device__ __forceinline__ void load_slice(T* s, const T* g, int ld, int r0,
                                           int rlim, int k0, int klim,
                                           int tid) {
  constexpr int kLd = Tile<KMAJOR, T>::kLd;
  constexpr int kChunks = kBK * kBM / 4;
  static_assert(kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    if constexpr (KMAJOR) {
      const int kk = c / (kBM / 4), q = c % (kBM / 4);
      const int k = k0 + kk, r = r0 + 4 * q;
      const bool ok = k < klim && r < rlim;
      Elem<T>::cp4(s + kk * kLd + 4 * q, ok ? g + (size_t)k * ld + r : g,
                   ok);
    } else {
      const int rr = c / (kBK / 4), q = c % (kBK / 4);
      const int r = r0 + rr, k = k0 + 4 * q;
      const bool ok = r < rlim && k < klim;
      Elem<T>::cp4(s + rr * kLd + 4 * q, ok ? g + (size_t)r * ld + k : g,
                   ok);
    }
  }
}

// A's fragment of the m16 × k16 tile at (m, k) of the slice: a[0] rows
// g = lane/4, k 2t, 2t + 1 (t = lane%4); a[1] rows g + 8; a[2] and a[3]
// the same at k + 8. A float A gives hi and lo; a bf16 one hi alone.
template <bool AK, class TA>
__device__ __forceinline__ void load_a(const TA* s, int m, int k, int lane,
                                       unsigned (&hi)[4], unsigned (&lo)[4]) {
  constexpr int kLd = Tile<AK, TA>::kLd;
  if constexpr (!kF32<TA>) {
    if constexpr (AK) {   // matrix i: k + 8(i/2), m + 8(i%2), transposed
      const int i = lane >> 3;
      ldsm_x4_trans(hi, s + (k + (lane & 7) + (i >> 1) * 8) * kLd + m +
                            (i & 1) * 8);
    } else {              // matrix i: rows m + 8(i%2), k + 8(i/2)
      ldsm_x4(hi, s + (m + (lane & 15)) * kLd + k + (lane >> 4) * 8);
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m + g + (j & 1) * 8, kk = k + 2 * t + (j >> 1) * 8;
      if constexpr (AK) {
        split2(s[kk * kLd + r], s[(kk + 1) * kLd + r], hi[j], lo[j]);
      } else {
        const float2 v = *reinterpret_cast<const float2*>(s + r * kLd + kk);
        split2(v.x, v.y, hi[j], lo[j]);
      }
    }
  }
}

// B's fragments of the kNj n8 × k16 tiles at (n .. n + 31, k): b[j][0]
// column n + 8j + lane/4, k 2t and 2t + 1; b[j][1] the same at k + 8.
template <bool BKM, class TB>
__device__ __forceinline__ void load_b(const TB* s, int n, int k, int lane,
                                       unsigned (&hi)[kNj][2],
                                       unsigned (&lo)[kNj][2]) {
  constexpr int kLd = Tile<BKM, TB>::kLd;
  if constexpr (!kF32<TB>) {
    const int i = lane >> 3;   // matrix i: columns + 8(i/2), k + 8(i%2)
#pragma unroll
    for (int p = 0; p < kNj / 2; ++p) {
      unsigned r[4];
      const int nn = n + 16 * p + (i >> 1) * 8;
      const int kk = k + (i & 1) * 8;
      if constexpr (BKM)
        ldsm_x4_trans(r, s + (kk + (lane & 7)) * kLd + nn);
      else
        ldsm_x4(r, s + (nn + (lane & 7)) * kLd + kk);
      hi[2 * p][0] = r[0];
      hi[2 * p][1] = r[1];
      hi[2 * p + 1][0] = r[2];
      hi[2 * p + 1][1] = r[3];
    }
  } else {
    static_assert(BKM, "a float32 B is k-major in every problem");
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kNj; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = k + 2 * t + 8 * h, c = n + 8 * j + g;
        split2(s[kk * kLd + c], s[(kk + 1) * kLd + c], hi[j][h], lo[j][h]);
      }
  }
}

// acc += the slice's product for this warp's sub-tile (rows wm·64, columns
// wn·32 of the block tile).
template <class S>
__device__ __forceinline__ void mma_slice(const typename S::TA* sA,
                                          const typename S::TB* sB,
                                          float (&acc)[kMi][kNj][4], int wm,
                                          int wn, int lane) {
  constexpr bool kSplitA = kF32<typename S::TA>;
  constexpr bool kSplitB = kF32<typename S::TB>;
  static_assert(!(kSplitA && kSplitB), "one operand at least is bf16");
#pragma unroll
  for (int k = 0; k < kBK; k += 16) {
    unsigned bh[kNj][2], bl[kNj][2];
    load_b<S::BK>(sB, wn * kWarpN, k, lane, bh, bl);
#pragma unroll
    for (int i = 0; i < kMi; ++i) {
      unsigned ah[4], al[4];
      load_a<S::AK>(sA, wm * kWarpM + 16 * i, k, lane, ah, al);
#pragma unroll
      for (int j = 0; j < kNj; ++j) {
        mma(acc[i][j], ah, bh[j][0], bh[j][1]);
        if constexpr (kSplitA) mma(acc[i][j], al, bh[j][0], bh[j][1]);
        if constexpr (kSplitB) mma(acc[i][j], ah, bl[j][0], bl[j][1]);
      }
    }
  }
}

// Two consecutive outputs of a row (the column even, N a multiple of 4).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<unsigned*>(p) = rmm_gemm::bf16x2_bits(x, y);
}

// One block's tile of problem g (block index `bid` within the problem).
template <class S>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int bid,
                                          unsigned char* smem) {
  using TA = typename S::TA;
  using TB = typename S::TB;
  using TC = typename S::TC;
  constexpr bool AK = S::AK, BKM = S::BK;
  static_assert(!S::NARROW, "the narrow form keeps gemm_f32.cuh's tiles");
  constexpr int kABytes = Tile<AK, TA>::kBytes;
  constexpr int kStage = kStageBytes<S>;
  const TA* ga = static_cast<const TA*>(g.a);
  const TB* gb = static_cast<const TB*>(g.b);
  const TB* bias = static_cast<const TB*>(g.bias);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int split = bid / g.tiles;
  const int t = bid - split * g.tiles;
  const int tm = t / g.tiles_n;
  const int m0 = tm * kBM, n0 = (t - tm * g.tiles_n) * kBN;
  const int kb = split * g.split_k;
  const int ke = min(g.K, kb + g.split_k);
  const int slices = (ke - kb + kBK - 1) / kBK;
  TC* c = static_cast<TC*>(g.c) + split * g.c_split;
  // Only the weight gradients (A and B k-major) ask for bias rows; the
  // flag is the same for the whole block.
  const bool colsum = AK && BKM && g.bias_row && tm == 0;

  float acc[kMi][kNj][4];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNj; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float cs = 0.f;   // column tid % 128's sum over half tid / 128 of k

  // a stage holds A's tile, then B's
  auto load = [&](int s) {
    unsigned char* st = smem + (s % kStages) * kStage;
    const int k0 = kb + s * kBK;
    load_slice<AK>(reinterpret_cast<TA*>(st), ga, g.lda, m0, g.M, k0, ke,
                   tid);
    load_slice<BKM>(reinterpret_cast<TB*>(st + kABytes), gb, g.ldb, n0, g.N,
                    k0, ke, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) load(s);
    rmm_gemm::cp_commit();
  }
  for (int s = 0; s < slices; ++s) {
    rmm_gemm::cp_wait<kStages - 2>();
    __syncthreads();  // slice s landed; every thread is done with s − 1
    if (s + kStages - 1 < slices) load(s + kStages - 1);
    rmm_gemm::cp_commit();
    const unsigned char* st = smem + (s % kStages) * kStage;
    const TA* sA = reinterpret_cast<const TA*>(st);
    const TB* sB = reinterpret_cast<const TB*>(st + kABytes);
    if constexpr (AK && BKM) {
      if (colsum) {
        constexpr int kLdB = Tile<BKM, TB>::kLd;
        const int col = tid % kBN, k0 = (tid / kBN) * (kBK / 2);
#pragma unroll
        for (int kk = 0; kk < kBK / 2; ++kk)
          cs += to_f32(sB[(k0 + kk) * kLdB + col]);
      }
    }
    mma_slice<S>(sA, sB, acc, wm, wn, lane);
  }
  rmm_gemm::cp_wait<0>();

  const int gr = lane >> 2, gc = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kNj; ++j) {
    const int col = n0 + wn * kWarpN + 8 * j + gc;
    if (col >= g.N) continue;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      b0 = Elem<TB>::ldg1(bias + col);
      b1 = Elem<TB>::ldg1(bias + col + 1);
    }
#pragma unroll
    for (int i = 0; i < kMi; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * kWarpM + 16 * i + gr + 8 * h;
        if (row < g.M)
          store2(c + (size_t)row * g.ldc + col, acc[i][j][2 * h] + b0,
                 acc[i][j][2 * h + 1] + b1);
      }
  }
  if constexpr (AK && BKM) {
    if (colsum) {   // the halves' sums meet in the ring, now unused
      float* half = reinterpret_cast<float*>(smem);
      __syncthreads();
      if (tid >= kBN) half[tid - kBN] = cs;
      __syncthreads();
      const int col = n0 + tid;
      if (tid < kBN && col < g.N)
        Elem<TC>::st1(c + (size_t)g.M * g.ldc + col, cs + half[tid]);
    }
  }
}

template <class S0, class S1>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mma_gemm_kernel(GemmPair pair) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int bid = blockIdx.x;
  if (bid < pair.p[0].blocks)
    gemm_tile<S0>(pair.p[0], bid, mma_smem);
  else
    gemm_tile<S1>(pair.p[1], bid - pair.p[0].blocks, mma_smem);
}

// Launches one or two problems (count) of the Specs in the template.
template <class S0, class S1>
cudaError_t launch_gemm(const Gemm& g0, const Gemm* g1,
                        cudaStream_t stream) {
  auto kernel = mma_gemm_kernel<S0, S1>;
  constexpr size_t kSmem = kSmemBytes<S0, S1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  GemmPair pair;
  pair.p[0] = g0;
  pair.p[1] = g1 != nullptr ? *g1 : g0;
  const int blocks = g0.blocks + (g1 != nullptr ? g1->blocks : 0);
  if (blocks <= 0) return cudaSuccess;
  kernel<<<blocks, kThreads, kSmem, stream>>>(pair);
  return cudaGetLastError();
}

// Blocks of the GEMM kernel (of the Specs in the template) an SM holds.
template <class S0, class S1>
cudaError_t gemm_blocks_per_sm(int* per_sm) {
  auto kernel = mma_gemm_kernel<S0, S1>;
  constexpr size_t kSmem = kSmemBytes<S0, S1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, kSmem);
}

}  // namespace rmm_mma
