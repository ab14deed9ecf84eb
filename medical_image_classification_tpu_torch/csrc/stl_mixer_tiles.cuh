// The STL token mixer's tiles for Hopper (sm_90a), shared by
// stl_mixer_fwd.cu and stl_mixer_bwd.cu.
//
// Every pass of the mixer walks one axis in steps of kStep through
// mma_tiles.cuh's two-buffer cp.async pipeline: a row pass owns rows of L
// and walks P, a column pass owns columns of P and walks L.  Each step a
// warp computes score tiles of 16 of its rows (S = w u1 and, in the
// backward, dE = V dU^T; the column passes compute the transposes
// S^T = u1^T w^T and dE^T = dU V^T) over the depth C, turns them into
// E = exp(S - lse) or dS = E (dE - rowdot) in fp32 registers, and
// multiplies the rounded result into its [16, C] fp32 output tile.
//
// bf16 at C 128 (kRegs): a warp owns 16 output rows and all of C; its A
// operands (the w and V rows, or the u1 and dU columns) stay in registers
// as m16n8k16 fragments for the whole walk, and E or dS goes from the
// score accumulators straight into A fragments (acc_to_a): no score tile
// touches shared memory.  bf16 at C 256 and fp32: NW warps share 16
// output rows and each owns 128 (bf16) or 64 (fp32) of C, so that the
// output tile fits in registers; each computes its share of the step's
// score columns with A read from shared memory, and the group swaps the
// rounded E or dS tile through a 16-row exchange tile of the operand type.
// fp32 runs warp_mma's FMA overload (full fp32, no TF32).

#pragma once

#include <type_traits>

#include "mma_tiles.cuh"

namespace stl_mixer {

using namespace mma_tiles;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = kThreads / 32;
constexpr float kLog2e = 1.4426950408889634f;

// The tiles of one instantiation (operand type T, channels C).
template <typename T, int C>
struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kOut = kBf16 ? 128 : 64;  // output columns a warp owns
  static constexpr int NW = C / kOut;            // warps sharing 16 rows
  static constexpr int kGroups = kWarps / NW;
  static constexpr int kRows = 16 * kGroups;     // output rows of a block
  static constexpr int kStep = kBf16 ? 64 : 32;  // score columns a step
  static constexpr int kCols = kStep / NW;       // of them, one warp's
  static constexpr bool kRegs = kBf16 && NW == 1;
  static constexpr int kChunk = kRegs ? 32 : kCols;  // computed at a time
  static constexpr int NIs = kChunk / 8;  // n8 tiles of a score chunk
  static constexpr int NIo = kOut / 8;    // n8 tiles of a warp's output
  static constexpr int KS = C / 16;       // k-steps over the depth C
  static constexpr int ldC = ld_of<T>(C);       // [*, C] tiles
  static constexpr int ldS = ld_of<T>(kStep);   // [C, kStep], exchange
  static constexpr int ldR = ld_of<T>(kRows);   // [C, kRows]
  static_assert(C % kOut == 0 && kWarps % NW == 0, "C must be 128 or 256");
};

// shared bytes of a group's exchange tiles (none where E and dS stay in
// registers) and of the cross-warp row reduction
template <typename T, int C>
constexpr size_t xch_bytes() {
  using F = Cfg<T, C>;
  return F::kRegs ? 0 : F::kGroups * tile_bytes<T>(16, F::kStep);
}
constexpr size_t red_bytes() { return align16(2 * kWarps * 16 * sizeof(float)); }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// 2^x on the MUFU unit, results below 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// exp(x - m) with mb = m log2(e): in bf16, whose E is rounded to 8 bits,
// 2^(x log2 e - mb) as one FMA and the MUFU's 2^x; in fp32, expf of the
// difference, to the last bits as the TPU body's exp (the MUFU's 2^x of a
// rounded mb would shift every E of a row by up to 1e-6).
template <typename T>
__device__ __forceinline__ float exp_diff(float x, float m, float mb) {
  if constexpr (std::is_same<T, float>::value)
    return expf(x - m);
  else
    return ex2(fmaf(x, kLog2e, -mb));
}

// exp(d) of an exact difference d <= 0 of two maxima: exactly 1 where they
// are equal (a running sum keeps its scale while its max stays put).
template <typename T>
__device__ __forceinline__ float exp_delta(float d) {
  if constexpr (std::is_same<T, float>::value)
    return expf(d);
  else
    return ex2(d * kLog2e);
}

// Synchronises the `threads` threads of named barrier `id` (1 .. 15; the
// pipeline's __syncthreads is barrier 0).
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A warp's place: `group` of 16 output rows, `half` the share of C (and
// of each step's score columns) it owns, lane = 4 g + q.
template <class F>
struct Role {
  int group, half, g, q;
  __device__ __forceinline__ Role() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    group = warp / F::NW;
    half = warp % F::NW;
    g = lane >> 2;
    q = lane & 3;
  }
};

// Rows r0 .. r0 + rows - 1 of a row-major [*, C] array into a tile of row
// stride ld_of<T>(C), zero at rows >= rmax.
template <typename T, int C>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0,
                                           int rows, int rmax) {
  stage_as<T, 16>(dst, ld_of<T>(C), rows, C, [&](int r, int k) -> const T* {
    return r0 + r < rmax ? src + static_cast<size_t>(r0 + r) * C + k
                         : nullptr;
  });
}

// Columns c0 .. c0 + w - 1 of u1 [C, P] into a [C, w] tile of row stride
// ld, zero at columns >= P (P % 8 == 0: a 16-byte piece lies wholly inside
// or outside).
template <typename T, int C>
__device__ __forceinline__ void stage_cols(T* dst, int ld, const T* u1,
                                           int P, int c0, int w) {
  stage_as<T, 16>(dst, ld, C, w, [&](int r, int k) -> const T* {
    return c0 + k < P ? u1 + static_cast<size_t>(r) * P + c0 + k : nullptr;
  });
}

// Entries r0 .. r0 + n - 1 of a per-row fp32 statistic, zero at >= rmax.
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int r0, int n, int rmax) {
  for (int t = threadIdx.x; t < n; t += kThreads) {
    if (r0 + t < rmax)
      cp_async<4>(dst + t, src + r0 + t);
    else
      dst[t] = 0.f;
  }
}

// A warp's 16 rows (from m0) of an A operand of depth C, A(m, k) = s[k ld +
// m] when AK, else s[m ld + k]: loaded once into fragments where kRegs,
// read from shared memory at every product otherwise.
template <typename T, int C, bool AK>
struct OpA {
  using F = Cfg<T, C>;
  const T* s;
  int ld, m0;
  unsigned f[F::kRegs ? F::KS : 1][4];

  __device__ __forceinline__ void init(const T* s_, int ld_, int m0_) {
    s = s_;
    ld = ld_;
    m0 = m0_;
    if constexpr (F::kRegs) {
      const int lane = threadIdx.x & 31;
      const int r8 = lane & 7, h1 = (lane >> 3) & 1, h2 = lane >> 4;
#pragma unroll
      for (int kk = 0; kk < F::KS; ++kk) {
        const int k = 16 * kk;
        if (AK)
          ldsm4_t(f[kk], s + (k + r8 + 8 * h2) * ld + m0 + 8 * h1);
        else
          ldsm4(f[kk], s + (m0 + r8 + 8 * h1) * ld + k + 8 * h2);
      }
    }
  }

  // acc += A B(:, n0 .. n0 + 8 NI) over the depth C, B(k, n) = sB[k ldb +
  // n] when BK, else sB[n ldb + k]
  template <int NI, bool BK>
  __device__ __forceinline__ void mma(float (&acc)[1][NI][4], const T* sB,
                                      int ldb, int n0) const {
    if constexpr (F::kRegs)
      warp_mma_ra<F::KS, NI, BK>(acc, f, sB, ldb, n0, 0);
    else
      warp_mma<1, NI, AK, BK>(acc, s, ld, m0, sB, ldb, n0, 0, F::KS);
  }
};

// Writes a warp's 16 x 8 NI accumulator tile, rounded to T, at column n0
// of a tile of row stride ld.
template <typename T, int NI>
__device__ __forceinline__ void put_tile(T* x, int ld, int n0,
                                         const float (&v)[1][NI][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      st2(x + (g + 8 * r) * ld + n0 + 8 * ni + 2 * q, v[0][ni][2 * r],
          v[0][ni][2 * r + 1]);
}

// One pipeline step of a pass with an output product.  For each of the
// warp's score chunks (at step column n0), chunk(v, n0) leaves in v the
// fp32 values to multiply (E or dS, zero outside the walked axis); then
// out += X B, X the step's [16, kStep] tile of those values rounded to T,
// B(k, n) the step's tile (sB[k ldb + n] when BK, else sB[n ldb + k]) at
// the warp's share of C.  xg is the group's exchange tile (unused where
// kRegs).
template <typename T, int C, bool BK, class Chunk, class F = Cfg<T, C>>
__device__ __forceinline__ void step_product(Chunk chunk,
                                             float (&out)[1][F::NIo][4],
                                             const T* sB, int ldb, T* xg,
                                             const Role<F>& rl) {
#pragma unroll
  for (int ch = 0; ch < F::kCols / F::kChunk; ++ch) {
    const int n0 = rl.half * F::kCols + ch * F::kChunk;
    float v[1][F::NIs][4];
    chunk(v, n0);
    if constexpr (F::kRegs) {
      unsigned a[F::NIs / 2][4];
      acc_to_a(a, v);
      warp_mma_ra<F::NIs / 2, F::NIo, BK>(out, a, sB, ldb, 0, n0);
    } else {
      put_tile(xg, F::ldS, n0, v);
    }
  }
  if constexpr (!F::kRegs) {
    group_sync(1 + rl.group, 32 * F::NW);
    warp_mma<1, F::NIo, false, BK>(out, xg, F::ldS, 0, sB, ldb,
                                   rl.half * F::kOut, 0, F::kStep / 16);
  }
}

// Stores a warp's [16, kOut] output tile (F's layout) at rows r0 .. r0 +
// 15 (those below rmax) and columns c0 .. of a row-major [*, C] array of
// U, rounded to U.
template <class F, int C, typename U>
__device__ __forceinline__ void store_tile(U* dst, int r0, int rmax, int c0,
                                           const float (&o)[1][F::NIo][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= rmax) continue;
    U* p = dst + static_cast<size_t>(row) * C + c0 + 2 * q;
#pragma unroll
    for (int ni = 0; ni < F::NIo; ++ni)
      st2(p + 8 * ni, o[0][ni][2 * r], o[0][ni][2 * r + 1]);
  }
}

}  // namespace stl_mixer
