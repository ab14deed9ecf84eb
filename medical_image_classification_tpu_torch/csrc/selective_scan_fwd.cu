// Mamba-1 selective-scan forward, folded layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/selective_scan_pallas_v2.py
//   ::_scan_kernel_v2 (launched by fwd_folded_v2), with its xsave output
//   and both state flags: an initial state (has_init) and the last state
//   (want_state).
//
// Computes, for every sequence g and channel d (param group k = g % K):
//   dt_t = softplus(delta_t + bias)          (softplus optional)
//   x_t  = exp(dt_t * A) * x_{t-1} + dt_t * B_t * u_t     (x: N fp32 states)
//   y_t  = C_t . x_t + D * u_t
// walking t forward, or backward when `reverse` (over unflipped memory, so
// the flipped scan directions need no flipped copies).
//
// Layout: u, delta, y [G, L, Dm]; B, C [G, L, N] (fp32 or bf16, all the same
// type); A [K, Dm, N], D, bias [K, Dm] fp32.  State and arithmetic are fp32.
//
// xsave [G, ceil(L / kChunk), N, Dm] fp32: the state entering each chunk of
// kChunk timesteps (csrc/selective_scan_common.cuh), indexed by the chunk's
// position in memory; a reverse scan enters a chunk from the right, so its
// first chunk scanned is the last in memory.  The backward
// (csrc/selective_scan_bwd.cu) reads it.  On the eval path the caller passes
// a scratch buffer of the same shape: the kernel needs it either way.
// init (optional) [G, N, Dm] fp32 seeds the state before the first step
// scanned, so it is also the xsave of the first chunk scanned; last
// (optional) [G, N, Dm] fp32 receives the state after the last step
// scanned.  The kernel walks a ragged last chunk instead of padding, so no
// pad step touches either.  sdt [G, ceil(L / kChunk), Dm] fp32 is scratch.
//
// What bounds it on this card: the exps on the MUFU units, then bytes.  The
// function needs one exp per (step, channel, state): at MedMamba stage 0
// (G 32, L 3136, Dm 96, N 16) 154 M of them, 0.037 ms at 16 a clock on each
// of 132 SMs; it moves ~64 MB of u, delta, B, C and y in bf16, 0.019 ms at
// 3.35 TB/s.  Nothing here is a matrix product (A is diagonal per (d, n)),
// so the tensor cores have no part: what matters is warps in flight, MUFU
// exps and bytes.
//
// Design: a two-level scan, parallel in time.  The one-level kernel walked
// all L steps of a channel in one thread (G * Dm threads, 3,072 at stage 0,
// under one warp an SM).  This one runs three launches:
//   (a) every chunk of every (g, channel) walks its kChunk steps from a zero
//       state, in parallel: it writes the state it leaves into xsave and
//       its sum of dt into sdt;
//   (b) the carry pass (chunk_carry_kernel) walks the chunks in scan order,
//       one thread per (g, n, d): state entering chunk c + 1 =
//       exp(A sum(dt_c)) * state entering c + what (a) left for c, seeded by
//       init; it leaves in xsave the state entering each chunk, and writes
//       last;
//   (c) every chunk walks again from its true entering state and writes y.
// (a) and (c) put one thread on each (g, channel, chunk), its N states in
// registers: 32 lanes on 32 consecutive channels of one chunk (u, delta and
// y coalesced in the [G, L, Dm] layout), four warps a block on four chunks.
// A warp stages its chunk's B (and C) rows, shared by its channels, and its
// lanes' dt and u in shared memory, so a thread holds only its states and
// their decays: 64 registers at N 16, 32 warps an SM (602,112 threads a
// pass at stage 0).  The walks are bound by the latency of their chains,
// not by MUFU issue, so occupancy is what moved them: the exp is the bare
// ex2.approx.ftz, softplus runs on __expf / __logf, and ptxas is held to
// 64 registers (scan2l::walk_min_blocks).  A decoupled look-back (one pass)
// would save (a)'s reads of u, delta and B; the three passes were kept as
// the simpler design: (a) costs about what (c) costs, and the carry pass a
// fifth of either.
//
// What is left: (a) and (c) each spend the function's exps, so the kernel
// does twice its MUFU floor; xsave and the chunk sums cross device memory
// three times (written by (a), rewritten by (b), read by (c)).  Later
// work: a one-pass look-back, and the four scan directions of an SS2D
// block in one launch.

#include "selective_scan_common.cuh"

namespace {

using scan2l::exp2_ftz;
using scan2l::from_f32;
using scan2l::kChunk;
using scan2l::kLog2e;
using scan2l::softplus_f32;
using scan2l::to_f32;

constexpr int kWarps = 4;  // chunks per block, one warp each
constexpr int kThreads = 32 * kWarps;

// shared memory of one warp's chunk: B (and C) rows [kChunk][NMAX]; dt and
// u [kChunk][32]
template <int NMAX, bool kFinal>
__host__ __device__ constexpr size_t chunk_smem_floats() {
  return (kFinal ? 2 : 1) * kChunk * NMAX + 2 * kChunk * 32;
}

// Pass (a) (kFinal false: from a zero state, writes xs and sdt) or pass (c)
// (kFinal true: from xs, the state entering the chunk, writes y).
template <typename T, int NMAX, bool kFinal>
__global__ void __launch_bounds__(kThreads, scan2l::walk_min_blocks<NMAX>())
    scan_fwd_chunk_kernel(
    const T* __restrict__ u, const T* __restrict__ delta,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dskip,
    const float* __restrict__ bias, T* __restrict__ y,
    float* __restrict__ xs, float* __restrict__ sdt, int L, int Dm, int K,
    int N, int nchunks, int ntiles, bool reverse, bool softplus) {
  extern __shared__ __align__(16) float smem[];
  const int g = blockIdx.y;
  const int tile = blockIdx.x % ntiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ci = (blockIdx.x / ntiles) * kWarps + warp;  // chunk in memory
  if (ci >= nchunks) return;  // a whole warp; nothing syncs the block
  float* sB = smem + warp * chunk_smem_floats<NMAX, kFinal>();
  float* sC = sB + kChunk * NMAX;                   // pass (c) only
  float* sDt = sB + (kFinal ? 2 : 1) * kChunk * NMAX;
  float* sU = sDt + kChunk * 32;
  const int d = tile * 32 + lane;
  const bool active = d < Dm;
  const int dp = active ? d : 0;  // in-bounds channel for parameter loads
  const int k = g % K;
  const int t0 = ci * kChunk;
  const int tl = min(kChunk, L - t0);
  const size_t row0 = static_cast<size_t>(g) * L + t0;

  // the chunk's B (and C) rows, zero past N and past the chunk's end
  for (int i = lane; i < kChunk * NMAX; i += 32) {
    const int r = i / NMAX;
    const int n = i - r * NMAX;
    const bool in = r < tl && n < N;
    const size_t off = (row0 + r) * N + n;
    sB[i] = in ? to_f32(Bm[off]) : 0.f;
    if (kFinal) sC[i] = in ? to_f32(Cm[off]) : 0.f;
  }
  // this lane's dt and u on each row of the chunk
  const float dbias = bias[k * Dm + dp];
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    float v = 0.f, uu = 0.f;
    if (r < tl && active) {
      const size_t off = (row0 + r) * Dm + d;
      v = to_f32(delta[off]);
      uu = to_f32(u[off]);
    }
    v += dbias;
    sDt[r * 32 + lane] = softplus ? softplus_f32(v) : v;
    sU[r * 32 + lane] = uu;
  }

  // A * log2(e), so that exp(dt * A) = exp2(dt * a2)
  float a2[NMAX], x[NMAX];
  const size_t xs0 = (static_cast<size_t>(g) * nchunks + ci) * N * Dm + d;
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a2[n] = n < N ? A[(static_cast<size_t>(k) * Dm + dp) * N + n] * kLog2e
                  : 0.f;
    x[n] = (kFinal && active && n < N) ? xs[xs0 + static_cast<size_t>(n) * Dm]
                                       : 0.f;
  }
  __syncwarp();

  float sum_dt = 0.f;
  for (int s = 0; s < tl; ++s) {
    const int r = reverse ? tl - 1 - s : s;
    const float dt = sDt[r * 32 + lane];
    const float uu = sU[r * 32 + lane];
    const float dtu = dt * uu;
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      // states past N stay 0: a2 = 0 and B = 0 there
      x[n] = exp2_ftz(dt * a2[n]) * x[n] + dtu * sB[r * NMAX + n];
      if (kFinal) acc += sC[r * NMAX + n] * x[n];
    }
    if (kFinal && active) {
      y[(row0 + r) * Dm + d] = from_f32<T>(acc + uu * Dskip[k * Dm + dp]);
    }
    sum_dt += dt;
  }
  if (!kFinal && active) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) xs[xs0 + static_cast<size_t>(n) * Dm] = x[n];
    }
    sdt[(static_cast<size_t>(g) * nchunks + ci) * Dm + d] = sum_dt;
  }
}

template <typename T, int NMAX, bool kFinal>
cudaError_t launch_pass(const dim3 grid, const T* u, const T* delta,
                        const float* A, const T* B, const T* C,
                        const float* D, const float* bias, T* y, float* xs,
                        float* sdt, int L, int Dm, int K, int N, int nchunks,
                        int ntiles, bool reverse, bool softplus,
                        cudaStream_t stream) {
  constexpr size_t bytes =
      sizeof(float) * kWarps * chunk_smem_floats<NMAX, kFinal>();
  // above 48 KB a block gets dynamic shared memory only on request
  cudaError_t err = cudaFuncSetAttribute(
      scan_fwd_chunk_kernel<T, NMAX, kFinal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  scan_fwd_chunk_kernel<T, NMAX, kFinal><<<grid, kThreads, bytes, stream>>>(
      u, delta, A, B, C, D, bias, y, xs, sdt, L, Dm, K, N, nchunks, ntiles,
      reverse, softplus);
  return cudaGetLastError();
}

template <typename T, int NMAX>
cudaError_t launch_n(const T* u, const T* delta, const float* A, const T* B,
                     const T* C, const float* D, const float* bias, T* y,
                     float* xs, float* sdt, const float* init, float* last,
                     int G, int L, int Dm, int K, int N, bool reverse,
                     bool softplus, cudaStream_t stream) {
  const int nchunks = (L + kChunk - 1) / kChunk;
  const int ntiles = (Dm + 31) / 32;
  const dim3 grid(ntiles * ((nchunks + kWarps - 1) / kWarps), G);
  cudaError_t err = launch_pass<T, NMAX, false>(
      grid, u, delta, A, B, C, D, bias, y, xs, sdt, L, Dm, K, N, nchunks,
      ntiles, reverse, softplus, stream);
  if (err != cudaSuccess) return err;
  err = scan2l::launch_carry<false>(A, xs, sdt, init, last, G, Dm, K, N,
                                    nchunks, !reverse, stream);
  if (err != cudaSuccess) return err;
  return launch_pass<T, NMAX, true>(grid, u, delta, A, B, C, D, bias, y, xs,
                                    sdt, L, Dm, K, N, nchunks, ntiles,
                                    reverse, softplus, stream);
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* bias, void* y, float* xs, float* sdt,
                   const float* init, float* last, int G, int L, int Dm,
                   int K, int N, bool reverse, bool softplus,
                   cudaStream_t stream) {
#define SCAN_LAUNCH(NM)                                                    \
  return launch_n<T, NM>(                                                  \
      static_cast<const T*>(u), static_cast<const T*>(delta),              \
      static_cast<const float*>(A), static_cast<const T*>(B),              \
      static_cast<const T*>(C), static_cast<const float*>(D),              \
      static_cast<const float*>(bias), static_cast<T*>(y), xs, sdt, init,  \
      last, G, L, Dm, K, N, reverse, softplus, stream)
  if (N <= 8) {
    SCAN_LAUNCH(8);
  } else if (N <= 16) {
    SCAN_LAUNCH(16);
  } else if (N <= 32) {
    SCAN_LAUNCH(32);
  } else if (N <= 64) {
    SCAN_LAUNCH(64);
  }
#undef SCAN_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T, int NMAX, bool kFinal>
cudaError_t info_pass(int* out) {
  constexpr size_t bytes =
      sizeof(float) * kWarps * chunk_smem_floats<NMAX, kFinal>();
  cudaError_t err = cudaFuncSetAttribute(
      scan_fwd_chunk_kernel<T, NMAX, kFinal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  return scan2l::pass_info(scan_fwd_chunk_kernel<T, NMAX, kFinal>, kThreads,
                           bytes, out);
}

template <typename T, int NMAX>
cudaError_t info_n(int* out) {
  cudaError_t err = info_pass<T, NMAX, false>(out);
  if (err == cudaSuccess) {
    err = scan2l::pass_info(scan2l::chunk_carry_kernel<false>,
                            scan2l::kCarryThreads, 0, out + 3);
  }
  if (err == cudaSuccess) err = info_pass<T, NMAX, true>(out + 6);
  return err;
}

template <typename T>
cudaError_t info(int N, int* out) {
  if (N <= 8) return info_n<T, 8>(out);
  if (N <= 16) return info_n<T, 16>(out);
  if (N <= 32) return info_n<T, 32>(out);
  if (N <= 64) return info_n<T, 64>(out);
  return cudaErrorInvalidValue;
}

}  // namespace

// Registers, local-memory bytes (spills) and resident warps per SM of the
// three passes (chunk, carry, final) at d_state N: out[9].
extern "C" int selective_scan_fwd_pass_info(int N, int is_bf16, int* out) {
  return static_cast<int>(is_bf16 ? info<__nv_bfloat16>(N, out)
                                  : info<float>(N, out));
}

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launches (0 on success).  is_bf16 selects the type of u, delta, B, C,
// y.  xsave [G, ceil(L / chunk), N, Dm] and sdt [G, ceil(L / chunk), Dm]
// fp32 are required (xsave is scratch on the eval path); init and last may
// each be null.  `chunk` must equal the kernel's kChunk: the caller sized
// xsave and sdt by it.
extern "C" int selective_scan_fwd(const void* u, const void* delta,
                                  const void* A, const void* B, const void* C,
                                  const void* D, const void* bias, void* y,
                                  void* xsave, const void* init, void* last,
                                  void* sdt, int G, int L, int Dm, int K,
                                  int N, int chunk, int is_bf16, int reverse,
                                  int softplus, void* stream) {
  if (chunk != kChunk || xsave == nullptr || sdt == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xs = static_cast<float*>(xsave);
  float* sd = static_cast<float*>(sdt);
  const float* in = static_cast<const float*>(init);
  float* out = static_cast<float*>(last);
  if (is_bf16) {
    return static_cast<int>(launch<__nv_bfloat16>(
        u, delta, A, B, C, D, bias, y, xs, sd, in, out, G, L, Dm, K, N,
        reverse != 0, softplus != 0, s));
  }
  return static_cast<int>(launch<float>(u, delta, A, B, C, D, bias, y, xs, sd,
                                        in, out, G, L, Dm, K, N,
                                        reverse != 0, softplus != 0, s));
}

extern "C" const char* selective_scan_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
