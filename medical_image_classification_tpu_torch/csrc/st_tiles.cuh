// fp32 tile pieces of the Y_diag backward's fp32 passes (ssd_ydiag_bwd.cu):
// masked tile loads into shared memory, a sum over the four threads of a
// row, and the two block products each pass makes per step, as 4 x 4
// register tiles of FMAs on the CUDA cores (no TF32: the TPU bodies compute
// fp32 products at HIGHEST precision):
//   gemm_s       S[64][64] (fp32, shared) = (or +=) A[64][K] . B[64][K]^T
//   Acc<CW>      O[64][CW] += A[64][64] . B[64][CW], held in registers
// Every block has 256 threads (8 warps); operands are staged whole in
// shared memory and every step synchronises the block.  These are the
// fp32 half of the Y_diag kernels as ported first: the bf16 passes moved
// to mma.sync (ssd_ydiag_strip.cuh, ssd_walk_bwd.cuh), and in fp32 the
// same passes on warp_mma's FMA fragments ran slower than these (on an
// H100 SXM at 700 W).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace st_tiles {

constexpr int kThreads = 256;
constexpr int kT = 64;        // the square tile edge
constexpr int kLdS = kT + 4;  // leading dimension of the fp32 [64][64] tile

// Leading dimension (elements) of a shared fp32 tile with `cols` columns:
// rows stay multiples of 16 bytes, as the vector loads need, and
// consecutive rows start on other banks.
__host__ __device__ constexpr int ld(int cols) { return cols + 4; }

// Bytes rounded up to 128: every tile carved from dynamic shared memory
// starts 128-byte aligned.
__host__ __device__ constexpr size_t round128(size_t b) {
  return (b + 127) / 128 * 128;
}

// dst[r][c] = src[r0 + r][c0 + c] for r < R, c < C, zero where the source
// row >= rmax or column >= cmax.  16-byte vectors where the shapes allow
// it (each vector then lies wholly inside or outside the range).
__device__ __forceinline__ void load_tile(float* dst, int ldd,
                                          const float* src, size_t lds,
                                          int r0, int c0, int R, int C,
                                          int rmax, int cmax) {
  constexpr int V = 4;
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
    dst[r * ldd + c] = (gr < rmax && gc < cmax) ? src[gr * lds + gc] : 0.f;
  }
}

// Sum over the four neighbouring threads that share a row.
__device__ __forceinline__ float group4_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// S[64][kLdS] = A[64][K] . B^T, or with kAdd S += A . B^T; A and B
// row-major [64][K] (lda, ldb).  K % 16 == 0.  The caller synchronises
// before and after.
template <bool kAdd = false>
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
      b[q] = B[(tx + 16 * q) * ldb + k];
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

// O[64][CW] += A[64][64] . B[64][CW] over the block, 4 x CW / 16 values a
// thread in registers.  A is row-major [i][k] (lda) or, with kAT, stored
// transposed as [k][i]; B is row-major [k][c] (ldb).  store(fn) calls
// fn(row, col, value) once per element.
template <int CW>
struct Acc {
  static constexpr int NC = CW / 16;
  float v[4][NC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < NC; ++j) v[q][j] = 0.f;
  }

  template <bool kAT>
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
        const float b = B[k * ldb + tx + 16 * j];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q][j] += a[q] * b;
      }
    }
  }

  template <typename F>
  __device__ __forceinline__ void store(F&& fn) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < NC; ++j) fn(ty * 4 + q, tx + 16 * j, v[q][j]);
  }
};

}  // namespace st_tiles
