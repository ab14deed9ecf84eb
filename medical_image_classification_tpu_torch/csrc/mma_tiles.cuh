// Warp-level tile code for Hopper (sm_90a) shared by the hand-written
// kernels that run their products on the tensor cores through mma.sync:
// padded shared-memory tiles, cp.async copies in 16-byte pieces, a
// two-buffer copy pipeline, ldmatrix fragment loads, the m16n8k16 bf16
// product, and warp_mma, which multiplies shared-memory tiles in the
// m16n8k16 fragment layout: on the tensor cores in bf16, as fp32 FMAs on
// the CUDA cores in fp32 (the same fragments, no TF32); warp_mma_ra, its
// bf16 form with A held in registers, and acc_to_a, which turns a warp's
// fp32 accumulator tile into such A fragments; the launch helpers
// allow_smem and pass_info.  Every block that uses stage_as or pipeline
// has kThreads threads.
//
// Included by ssd_walk_tiles.cuh (the SSD walks' passes, which the Y_diag
// backward also runs), ssd_ydiag_strip.cuh (Y_diag's strip passes) and
// stl_mixer_tiles.cuh (the STL token mixer's and STF gate's passes).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace mma_tiles {

constexpr int kThreads = 256;
constexpr int kStages = 2;   // shared-memory buffers of a pipeline

// row stride of a w-wide tile: a 16-byte pad keeps ldmatrix's eight rows
// on distinct banks
template <typename T>
__host__ __device__ constexpr int ld_of(int w) {
  return w + 16 / static_cast<int>(sizeof(T));
}
__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}
template <typename T>
__host__ __device__ constexpr size_t tile_bytes(int rows, int w) {
  return align16(static_cast<size_t>(rows) * ld_of<T>(w) * sizeof(T));
}

// Bump allocation of dynamic shared memory in the order of each kernel's
// *_smem() byte count.
struct Bump {
  char* p;
  template <typename U>
  __device__ __forceinline__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += align16(n * sizeof(U));
    return r;
  }
};

// ---------------------------------------------------------------- copies

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int BYTES>
__device__ __forceinline__ void zero_piece(void* dst) {
  if constexpr (BYTES == 16)
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
}

// Copies rows x w elements into a tile of row stride ld: src(r, k) is the
// address of element k of row r (k a multiple of the piece), or null for
// a zero piece (outside the chunk, P or N).
template <typename T, int BYTES, class Src>
__device__ __forceinline__ void stage_as(T* dst, int ld, int rows, int w,
                                         Src src) {
  constexpr int V = BYTES / static_cast<int>(sizeof(T));
  const int per_row = w / V;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, k = (e - r * per_row) * V;
    const T* s = src(r, k);
    T* d = dst + r * ld + k;
    if (s != nullptr)
      cp_async<BYTES>(d, s);
    else
      zero_piece<BYTES>(d);
  }
}


// Runs stages 0 .. n-1 through kStages shared-memory buffers: issue(s,
// buf) starts stage s's copies (and plain stores) into buffer buf, run(s,
// buf) consumes it; the copies of the next kStages - 1 stages are in
// flight while stage s runs.
template <class Issue, class Run>
__device__ __forceinline__ void pipeline(int n, Issue issue, Run run) {
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) issue(s, s);
    cp_commit();
  }
  for (int s = 0; s < n; ++s) {
    const int next = s + kStages - 1;
    if (next < n) issue(next, next % kStages);
    cp_commit();
    cp_wait<kStages - 1>();
    __syncthreads();
    run(s, s % kStages);
    __syncthreads();
  }
}

// ------------------------------------------------------------ tile math

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mi][ni] += A[m0 + 16 mi .., k] B[k, n0 + 8 ni ..] over the 16 ks
// values of k from k0, in the m16n8k16 fragment layout (lane = 4 g + q:
// acc[..][e] is row g + 8 (e >> 1), column 2 q + (e & 1)).  A(m, k) is
// sA[k lda + m] when AK (stored k-major) else sA[m lda + k]; B(k, n) is
// sB[k ldb + n] when BK else sB[n ldb + k].  bf16: ldmatrix (.trans for
// the k-major operands) and mma.sync on the tensor cores; fp32: the same
// fragments as fp32 FMAs on the CUDA cores (K4: see the fp32 overload).
template <int MI, int NI, bool AK, bool BK, bool K4 = false>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4],
                                         const __nv_bfloat16* sA, int lda,
                                         int m0, const __nv_bfloat16* sB,
                                         int ldb, int n0, int k0, int ks) {
  static_assert(NI % 2 == 0, "B fragments load two n8 tiles at a time");
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7, h1 = (lane >> 3) & 1, h2 = lane >> 4;
  for (int kk = 0; kk < ks; ++kk) {
    const int k = k0 + 16 * kk;
    unsigned a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int m = m0 + 16 * mi;
      if (AK)
        ldsm4_t(a[mi], sA + (k + r8 + 8 * h2) * lda + m + 8 * h1);
      else
        ldsm4(a[mi], sA + (m + r8 + 8 * h1) * lda + k + 8 * h2);
    }
    unsigned b[NI][2];
#pragma unroll
    for (int nj = 0; nj < NI; nj += 2) {
      const int n = n0 + 8 * nj;
      unsigned r[4];
      if (BK)
        ldsm4_t(r, sB + (k + r8 + 8 * h1) * ldb + n + 8 * h2);
      else
        ldsm4(r, sB + (n + r8 + 8 * h2) * ldb + k + 8 * h1);
      b[nj][0] = r[0];
      b[nj][1] = r[1];
      b[nj + 1][0] = r[2];
      b[nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// The fp32 instantiation's warp_mma: FMAs on the CUDA cores.  K4 (both
// operands k-contiguous, row strides and tiles 16-byte aligned, as ld_of's
// tiles are): four k a load, one float4 from each row, the FMAs in the
// same k order (the same bits).
template <int MI, int NI, bool AK, bool BK, bool K4 = false>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4],
                                         const float* sA, int lda, int m0,
                                         const float* sB, int ldb, int n0,
                                         int k0, int ks) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  if constexpr (K4) {
    static_assert(!AK && !BK, "K4 reads four k of a row at once");
    for (int k = k0; k < k0 + 16 * ks; k += 4) {
      float4 a[MI][2], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          a[mi][e] = *reinterpret_cast<const float4*>(
              sA + (m0 + 16 * mi + g + 8 * e) * lda + k);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          b[ni][e] = *reinterpret_cast<const float4*>(
              sB + (n0 + 8 * ni + 2 * q + e) * ldb + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const auto at = [kk](const float4& v) {
          return kk == 0 ? v.x : kk == 1 ? v.y : kk == 2 ? v.z : v.w;
        };
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            acc[mi][ni][0] += at(a[mi][0]) * at(b[ni][0]);
            acc[mi][ni][1] += at(a[mi][0]) * at(b[ni][1]);
            acc[mi][ni][2] += at(a[mi][1]) * at(b[ni][0]);
            acc[mi][ni][3] += at(a[mi][1]) * at(b[ni][1]);
          }
      }
    }
  } else {
    for (int k = k0; k < k0 + 16 * ks; ++k) {
      float a[MI][2], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 16 * mi + g + 8 * e;
          a[mi][e] = AK ? sA[k * lda + m] : sA[m * lda + k];
        }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * ni + 2 * q + e;
          b[ni][e] = BK ? sB[k * ldb + n] : sB[n * ldb + k];
        }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          acc[mi][ni][0] += a[mi][0] * b[ni][0];
          acc[mi][ni][1] += a[mi][0] * b[ni][1];
          acc[mi][ni][2] += a[mi][1] * b[ni][0];
          acc[mi][ni][3] += a[mi][1] * b[ni][1];
        }
    }
  }
}

template <int MI, int NI>
__device__ __forceinline__ void zero_acc(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// acc[0][ni] += A B over ks = KS k-steps from k0, as warp_mma with MI 1,
// but with A a warp's 16 rows held in registers as m16n8k16 A fragments
// a[kk] (ldmatrix's layout; acc_to_a makes them from an accumulator).
template <int KS, int NI, bool BK>
__device__ __forceinline__ void warp_mma_ra(float (&acc)[1][NI][4],
                                            const unsigned (&a)[KS][4],
                                            const __nv_bfloat16* sB, int ldb,
                                            int n0, int k0) {
  static_assert(NI % 2 == 0, "B fragments load two n8 tiles at a time");
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7, h1 = (lane >> 3) & 1, h2 = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int k = k0 + 16 * kk;
#pragma unroll
    for (int nj = 0; nj < NI; nj += 2) {
      const int n = n0 + 8 * nj;
      unsigned r[4];
      if (BK)
        ldsm4_t(r, sB + (k + r8 + 8 * h1) * ldb + n + 8 * h2);
      else
        ldsm4(r, sB + (n + r8 + 8 * h2) * ldb + k + 8 * h1);
      mma_bf16(acc[0][nj], a[kk], r[0], r[1]);
      mma_bf16(acc[0][nj + 1], a[kk], r[2], r[3]);
    }
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

// The A fragments of a warp's 16 x 8 NI fp32 accumulator tile, rounded to
// bf16: the accumulator's column pair (2 q, 2 q + 1) of n8 tiles 2 kk and
// 2 kk + 1 is the fragment's k pair of k-step kk, so the values move
// between the two layouts without leaving the thread.
template <int NI>
__device__ __forceinline__ void acc_to_a(unsigned (&a)[NI / 2][4],
                                         const float (&v)[1][NI][4]) {
#pragma unroll
  for (int kk = 0; kk < NI / 2; ++kk) {
    a[kk][0] = pack_bf16(v[0][2 * kk][0], v[0][2 * kk][1]);
    a[kk][1] = pack_bf16(v[0][2 * kk][2], v[0][2 * kk][3]);
    a[kk][2] = pack_bf16(v[0][2 * kk + 1][0], v[0][2 * kk + 1][1]);
    a[kk][3] = pack_bf16(v[0][2 * kk + 1][2], v[0][2 * kk + 1][3]);
  }
}

// element pairs (k, k + 1) of the operand type, as fp32
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------ launches

template <class Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <class Kernel>
cudaError_t pass_info(Kernel k, size_t smem, int* out) {
  cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[3] = blocks * kThreads / 32;
  return cudaSuccess;
}

}  // namespace mma_tiles
