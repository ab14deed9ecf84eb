// Tile pieces shared by the ST-SSD slice's kernels (ssd_ydiag_{fwd,bwd}.cu,
// stl_mixer_{fwd,bwd}.cu, stf_zgate_{fwd,bwd}.cu): operand-type
// conversions, masked tile loads into shared memory, reductions over the
// four threads of a row, and the two block products each of them makes per
// step:
//   gemm_s       S[64][64] (fp32, shared) = (or +=) A[64][K] . B[K][64]
//   Acc<T, CW>   O[64][CW] += A[64][64] . B[64][CW], held in registers
// In bf16 both run on the tensor cores through WMMA (16x16x16 bf16
// fragments, fp32 accumulators); in fp32 on the CUDA cores, without TF32
// (the TPU bodies compute fp32 products at HIGHEST precision).  Every
// block has 256 threads (8 warps).  Operands are staged whole in shared
// memory and every step synchronises the block: simple first, no
// cp.async / TMA pipelining and no wgmma yet.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

namespace st_tiles {

constexpr int kThreads = 256;
constexpr int kT = 64;        // the square tile edge
constexpr int kLdS = kT + 4;  // leading dimension of the fp32 [64][64] tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// Leading dimension (elements) of a shared tile with `cols` columns of T:
// rows stay multiples of 16 bytes, as WMMA and the vector loads need, and
// consecutive rows start on other banks.
template <typename T>
__host__ __device__ constexpr int ld(int cols) {
  return cols + (sizeof(T) == 2 ? 8 : 4);
}

// Bytes rounded up to 128, so that every tile carved from dynamic shared
// memory starts 128-byte aligned (WMMA needs 32).
__host__ __device__ constexpr size_t round128(size_t b) {
  return (b + 127) / 128 * 128;
}

// dst[r][c] = src[r0 + r][c0 + c] for r < R, c < C, zero where the source
// row >= rmax or column >= cmax.  16-byte vectors where the shapes allow
// it (each vector then lies wholly inside or outside the range).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src,
                                          size_t lds, int r0, int c0, int R,
                                          int C, int rmax, int cmax) {
  constexpr int V = 16 / sizeof(T);
  if (C % V == 0 && lds % V == 0 && c0 % V == 0 && cmax % V == 0 &&
      ldd % V == 0) {
    const int CV = C / V;
    for (int e = threadIdx.x; e < R * CV; e += kThreads) {
      const int r = e / CV, c = (e - r * CV) * V;
      const int gr = r0 + r, gc = c0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gr < rmax && gc < cmax)
        v = *reinterpret_cast<const uint4*>(src + gr * lds + gc);
      *reinterpret_cast<uint4*>(dst + r * ldd + c) = v;
    }
    return;
  }
  for (int e = threadIdx.x; e < R * C; e += kThreads) {
    const int r = e / C, c = e - r * C;
    const int gr = r0 + r, gc = c0 + c;
    dst[r * ldd + c] = (gr < rmax && gc < cmax) ? src[gr * lds + gc]
                                                : from_f32<T>(0.f);
  }
}

// Max and sum over the four neighbouring threads that share a row.
__device__ __forceinline__ float group4_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float group4_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S[64][kLdS] = A[64][K] . B[K][64], or with kAdd S += A . B; A row-major
// (lda); B row-major [K][64] (ldb) or, with kBT, stored transposed as
// [64][K] (ldb).  K % 16 == 0.  The caller synchronises before and after.
template <bool kBT, bool kAdd = false>
__device__ __forceinline__ void gemm_s(float* S, const float* A, int lda,
                                       const float* B, int ldb, int K) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int qi = 0; qi < 4; ++qi)
#pragma unroll
    for (int qj = 0; qj < 4; ++qj)
      acc[qi][qj] = kAdd ? S[(ty * 4 + qi) * kLdS + tx + 16 * qj] : 0.f;
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = A[(ty * 4 + q) * lda + k];
      b[q] = kBT ? B[(tx + 16 * q) * ldb + k] : B[k * ldb + tx + 16 * q];
    }
#pragma unroll
    for (int qi = 0; qi < 4; ++qi)
#pragma unroll
      for (int qj = 0; qj < 4; ++qj) acc[qi][qj] += a[qi] * b[qj];
  }
#pragma unroll
  for (int qi = 0; qi < 4; ++qi)
#pragma unroll
    for (int qj = 0; qj < 4; ++qj)
      S[(ty * 4 + qi) * kLdS + tx + 16 * qj] = acc[qi][qj];
}

template <bool kBT, bool kAdd = false>
__device__ __forceinline__ void gemm_s(float* S, const bf16* A, int lda,
                                       const bf16* B, int ldb, int K) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int r = (warp & 3) * 16, c0 = (warp >> 2) * 32;
  typedef typename std::conditional<kBT, wmma::col_major,
                                    wmma::row_major>::type BLayout;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (kAdd)
      wmma::load_matrix_sync(acc[j], S + r * kLdS + c0 + 16 * j, kLdS,
                             wmma::mem_row_major);
    else
      wmma::fill_fragment(acc[j], 0.f);
  }
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + r * lda + k, lda);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + 16 * j;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
      wmma::load_matrix_sync(b, kBT ? B + c * ldb + k : B + k * ldb + c, ldb);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(S + r * kLdS + c0 + 16 * j, acc[j], kLdS,
                            wmma::mem_row_major);
}

// O[64][CW] += A[64][64] . B[64][CW] over the block, in fp32.  A is
// row-major [i][k] (lda) or, with kAT, stored transposed as [k][i]; B is
// row-major [k][c] (ldb) or, with kBT, stored transposed as [c][k].
// store(fn, stg) calls fn(row, col, value) once per element; stg is the
// calling warp's 256 floats of shared staging.
template <typename T, int CW>
struct Acc;

template <int CW>
struct Acc<float, CW> {
  static constexpr int NC = CW / 16;
  float v[4][NC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < NC; ++j) v[q][j] = 0.f;
  }

  template <bool kAT, bool kBT = false>
  __device__ __forceinline__ void mma(const float* A, int lda,
                                      const float* B, int ldb) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int k = 0; k < kT; ++k) {
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[q] = kAT ? A[k * lda + ty * 4 + q] : A[(ty * 4 + q) * lda + k];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float b =
            kBT ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q][j] += a[q] * b;
      }
    }
  }

  template <typename F>
  __device__ __forceinline__ void store(F&& fn, float*) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < NC; ++j) fn(ty * 4 + q, tx + 16 * j, v[q][j]);
  }
};

template <int CW>
struct Acc<bf16, CW> {
  // warp w owns rows (w % 4) * 16 and columns (w / 4) * CW / 2, in NF
  // 16x16 fragments
  static constexpr int NF = CW / 32;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[NF];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NF; ++j) nvcuda::wmma::fill_fragment(f[j], 0.f);
  }

  template <bool kAT, bool kBT = false>
  __device__ __forceinline__ void mma(const bf16* A, int lda, const bf16* B,
                                      int ldb) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5;
    const int r = (warp & 3) * 16, c0 = (warp >> 2) * (CW / 2);
    typedef typename std::conditional<kAT, wmma::col_major,
                                      wmma::row_major>::type ALayout;
    typedef typename std::conditional<kBT, wmma::col_major,
                                      wmma::row_major>::type BLayout;
#pragma unroll
    for (int k = 0; k < kT; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a;
      wmma::load_matrix_sync(a, kAT ? A + k * lda + r : A + r * lda + k, lda);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int c = c0 + 16 * j;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
        wmma::load_matrix_sync(b, kBT ? B + c * ldb + k : B + k * ldb + c,
                               ldb);
        wmma::mma_sync(f[j], a, b, f[j]);
      }
    }
  }

  template <typename F>
  __device__ __forceinline__ void store(F&& fn, float* stg) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r = (warp & 3) * 16, c0 = (warp >> 2) * (CW / 2);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      nvcuda::wmma::store_matrix_sync(stg, f[j], 16,
                                      nvcuda::wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        fn(r + e / 16, c0 + 16 * j + e % 16, stg[e]);
      __syncwarp();
    }
  }
};

}  // namespace st_tiles
