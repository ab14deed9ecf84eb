// What the selective-scan kernels share: for the two-level pair
// (csrc/selective_scan_fwd.cu and csrc/selective_scan_bwd.cu) the chunk and
// the carry pass; for them and the v1 pair (csrc/selective_scan_v1_*.cu)
// the type conversions, the exp, softplus, the backwards' warp
// reduce-scatter of the dB/dC terms, and what the card grants a pass.
//
// Both directions of the scan are linear recurrences with the same decays:
// the state x_t = a_t x_{t-1} + b_t runs in scan order, its adjoint
// g_t = C_t dy_t + a_{t+1} g_{t+1} against it.  Over a chunk of kChunk
// steps either one is affine in what enters the chunk: what leaves is
// prod(a) * entering + (what a walk from zero leaves), and prod(a) over the
// chunk is exp(A_n * sum(dt)), one exp per (channel, state).  So each
// kernel walks every chunk from zero in parallel, a carry pass chains the
// chunks' results (chunk_carry_kernel), and a last pass walks every chunk
// again from its true entering value.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace scan2l {

// Timesteps per chunk: the unit of parallelism in time, and the chunk of
// xsave [G, ceil(L / kChunk), N, Dm] that the forward writes and the
// backward reads (kernels/selective_scan_fwd.py::CHUNK is the same value).
// The backward keeps a chunk's states in registers, kChunk x 4 per thread.
constexpr int kChunk = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 2^v on the MUFU unit, a result below 2^-126 flushed to 0 (a decay that
// small is 0 to every sum it enters).  exp2f without fast-math adds a
// rescaling around the same instruction for subnormal results; the
// kernels are bound by the latency of these chains, not by MUFU issue.
__device__ __forceinline__ float exp2_ftz(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Blocks of the one-thread-per-channel passes an SM must hold (128
// threads, N states in registers): at most 65536 / (128 x this) registers
// a thread, so ptxas keeps N <= 16 at 32 warps an SM (64 registers; the
// chunk's dt and u live in shared memory).
template <int NMAX>
__host__ __device__ constexpr int walk_min_blocks() {
  return NMAX <= 16 ? 8 : NMAX <= 32 ? 3 : 1;
}

// log(1 + e^v) as max(v, 0) + log1p(e^-|v|): never overflows, and is the
// formula of jax.nn.softplus (logaddexp(v, 0)).  On the MUFU's exp and log
// (__expf, __logf) rather than the accurate library calls, whose
// instructions made a third of a walk's: the absolute error stays below
// 5e-7, and below 2^-8 log1p(w) is w (1 - w / 2) to 2e-8 relative.
__device__ __forceinline__ float softplus_f32(float v) {
  const float w = __expf(-fabsf(v));
  return fmaxf(v, 0.f) +
         (w < 0.00390625f ? w * (1.f - 0.5f * w) : __logf(1.f + w));
}

// The carry pass, one thread per (g, n, d), consecutive threads on
// consecutive channels.  buf [G, nchunks, N, Dm] holds on entry what each
// chunk's walk from zero left, and sdt [G, nchunks, Dm] each chunk's sum of
// dt.  Walking the chunks in the order given (memory order when
// `ascending`, else from the last), the thread replaces each chunk's entry
// by the value entering that chunk, starting from `seed` [G, N, Dm] (zero
// where null), and writes what leaves the last chunk walked to `out`
// [G, N, Dm] where not null:
//   in_c = carry;  carry = exp(A_n sdt_c) * carry + buf_c.
// A null seed and a zero one give the same bits (the carry starts at 0.f).
// kAdjoint changes nothing but the name: the forward's states (false) and
// the backward's adjoint (true) show apart in a profile.
constexpr int kCarryThreads = 128;
constexpr int kCarryUnroll = 8;  // chunks whose loads are in flight at once

template <bool kAdjoint>
__global__ void __launch_bounds__(kCarryThreads)
    chunk_carry_kernel(const float* __restrict__ A, float* __restrict__ buf,
                       const float* __restrict__ sdt,
                       const float* __restrict__ seed,
                       float* __restrict__ out, int Dm, int K, int N,
                       int nchunks, bool ascending) {
  const int g = blockIdx.y;
  const int i = blockIdx.x * kCarryThreads + threadIdx.x;  // n * Dm + d
  if (i >= N * Dm) return;
  const int n = i / Dm;
  const int d = i - n * Dm;
  const float a2 =
      A[(static_cast<size_t>(g % K) * Dm + d) * N + n] * kLog2e;
  const size_t st = static_cast<size_t>(g) * N * Dm + i;
  float carry = seed != nullptr ? seed[st] : 0.f;
  const size_t bstep = static_cast<size_t>(N) * Dm;
  float* b0 = buf + static_cast<size_t>(g) * nchunks * bstep + i;
  const float* s0 = sdt + static_cast<size_t>(g) * nchunks * Dm + d;
  for (int c0 = 0; c0 < nchunks; c0 += kCarryUnroll) {
    float h[kCarryUnroll], s[kCarryUnroll];
#pragma unroll
    for (int j = 0; j < kCarryUnroll; ++j) {
      const int c = c0 + j;
      const int ci = ascending ? c : nchunks - 1 - c;
      h[j] = c < nchunks ? b0[ci * bstep] : 0.f;
      s[j] = c < nchunks ? s0[static_cast<size_t>(ci) * Dm] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kCarryUnroll; ++j) {
      const int c = c0 + j;
      if (c < nchunks) {
        const int ci = ascending ? c : nchunks - 1 - c;
        b0[ci * bstep] = carry;
        carry = exp2f(a2 * s[j]) * carry + h[j];
      }
    }
  }
  if (out != nullptr) out[st] = carry;
}

template <bool kAdjoint>
cudaError_t launch_carry(const float* A, float* buf, const float* sdt,
                                const float* seed, float* out, int G, int Dm,
                                int K, int N, int nchunks, bool ascending,
                                cudaStream_t stream) {
  const dim3 grid((N * Dm + kCarryThreads - 1) / kCarryThreads, G);
  chunk_carry_kernel<kAdjoint><<<grid, kCarryThreads, 0, stream>>>(
      A, buf, sdt, seed, out, Dm, K, N, nchunks, ascending);
  return cudaGetLastError();
}

// What the card grants one pass: registers and local-memory bytes (spills)
// a thread, and the resident warps an SM, into out[0..2].
template <typename Kernel>
cudaError_t pass_info(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = blocks * threads / 32;
  return cudaSuccess;
}

// pass_info with the shared bytes a block (the launch's dynamic bytes and
// the kernel's static ones): registers, local bytes, shared bytes, warps
// an SM into out[0..3].  The caller has allowed `smem` dynamic bytes.
template <typename Kernel>
cudaError_t pass_info_shared(Kernel kernel, int threads, size_t smem,
                             int* out) {
  int info[3];
  cudaError_t err = pass_info(kernel, threads, smem, info);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = info[0];
  out[1] = info[1];
  out[2] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[3] = info[2];
  return cudaSuccess;
}

// The 8 values of each lane summed over the warp's 32 lanes, each lane
// left with one: value lane >> 2, complete in the lanes whose low 2 bits
// are 0 (the return elsewhere is partial).  The values are halved across
// lane bits 4, 3, 2 (each lane keeps the half its bit names and adds its
// partner's), then added over bits 1 and 0: 9 shuffles, where a butterfly
// of each value would take 40.  The backwards sum their dB and dC terms
// (4 states each) over the lanes' channels so.
__device__ __forceinline__ float lane_reduce_scatter(float (&v)[8],
                                                     int lane) {
#pragma unroll
  for (int bit = 0; bit < 3; ++bit) {
    const int m = 16 >> bit;
    const int half = 8 >> (bit + 1);
    const bool hi = lane & m;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float keep = hi ? v[j + half] : v[j];
      const float send = hi ? v[j] : v[j + half];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
#pragma unroll
  for (int m = 2; m >= 1; m >>= 1) {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
  }
  return v[0];
}

}  // namespace scan2l
