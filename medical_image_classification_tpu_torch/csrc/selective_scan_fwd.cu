// Mamba-1 selective-scan forward, folded layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/selective_scan_pallas_v2.py
//   ::_scan_kernel_v2 (launched by fwd_folded_v2), with want_state=False
//   and no initial state, including its xsave output.
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
// xsave (optional, for the backward, csrc/selective_scan_bwd.cu): the fp32
// state entering each chunk of kChunk timesteps, [G, ceil(L / kChunk), N, Dm],
// indexed by the chunk's position in memory.  A reverse scan enters a chunk
// from the right, so its chunks are written last to first, as the TPU
// kernel's mirrored index maps wrote them.  Null on the eval path.
//
// What bounds it on this card: bytes.  At MedMamba stage 0 (G 32, L 3136,
// Dm 96, N 16, bf16) a call moves about 64 MB (u, delta, y, B, C), about
// 20 us at 3.35 TB/s, and does ~5 fp32 operations per state per step.
//
// Design (simple first): one thread per (g, d), its N states in registers;
// one warp per block covers 32 channels of one sequence, so u, delta and y
// are read and written coalesced across d.  The block stages a chunk of
// timesteps of B and C rows (shared by all channels) and of its own u and
// delta in shared memory, so each chunk's loads are all in flight at once.
//
// What it leaves on the table: only G * Dm threads exist (3,072 at stage 0,
// under one warp per SM), and each walks all L steps in order, so the kernel
// is bound by the latency of the per-step chain, not by bytes.  Later work:
// an L-chunked two-level scan (chunk-local scans in parallel, then a carry
// pass) for more parallelism, splitting N across lanes, and fusing the four
// scan directions of an SS2D block into one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;  // channels per block: one warp
// timesteps staged per pass, and the chunk of xsave: the backward kernel and
// kernels/selective_scan_fwd.py::CHUNK use the same value
constexpr int kChunk = 32;

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

// log(1 + e^v) as max(v, 0) + log1p(e^-|v|): never overflows, and is the
// formula of jax.nn.softplus (logaddexp(v, 0)).
__device__ __forceinline__ float softplus_f32(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
    scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dskip,
                    const float* __restrict__ bias, T* __restrict__ y,
                    float* __restrict__ xsave, int L, int Dm, int K, int N,
                    bool reverse, bool softplus) {
  __shared__ float sB[kChunk][NMAX];
  __shared__ float sC[kChunk][NMAX];
  __shared__ float sU[kChunk][kThreads];
  __shared__ float sDt[kChunk][kThreads];

  const int g = blockIdx.y;
  const int lane = threadIdx.x;
  const int d = blockIdx.x * kThreads + lane;
  const int k = g % K;
  const bool active = d < Dm;
  const int dp = active ? d : 0;  // in-bounds channel for parameter loads

  // A * log2(e), so that exp(dt * A) = exp2(dt * a2)
  float a2[NMAX];
  float x[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a2[n] = n < N ? A[(static_cast<size_t>(k) * Dm + dp) * N + n] *
                        1.4426950408889634f
                  : 0.f;
    x[n] = 0.f;
  }
  const float dskip = Dskip[k * Dm + dp];
  const float dbias = bias[k * Dm + dp];
  const size_t row0 = static_cast<size_t>(g) * L;

  const int nchunks = (L + kChunk - 1) / kChunk;
  for (int c = 0; c < nchunks; ++c) {
    const int ci = reverse ? nchunks - 1 - c : c;
    const int t0 = ci * kChunk;
    const int tl = min(kChunk, L - t0);
    if (xsave != nullptr && active) {
      float* xs = xsave + (static_cast<size_t>(g) * nchunks + ci) * N * Dm + d;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) xs[static_cast<size_t>(n) * Dm] = x[n];
      }
    }
    for (int i = lane; i < tl * N; i += kThreads) {
      const int r = i / N;
      const int n = i - r * N;
      const size_t off = (row0 + t0 + r) * N + n;
      sB[r][n] = to_f32(Bm[off]);
      sC[r][n] = to_f32(Cm[off]);
    }
    if (active) {
#pragma unroll 8
      for (int r = 0; r < tl; ++r) {
        const size_t off = (row0 + t0 + r) * Dm + d;
        sU[r][lane] = to_f32(u[off]);
        sDt[r][lane] = to_f32(delta[off]);
      }
    }
    __syncthreads();
    if (active) {
      for (int s = 0; s < tl; ++s) {
        const int r = reverse ? tl - 1 - s : s;
        float dt = sDt[r][lane] + dbias;
        if (softplus) dt = softplus_f32(dt);
        const float uu = sU[r][lane];
        const float dtu = dt * uu;
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < N) {
            x[n] = exp2f(dt * a2[n]) * x[n] + dtu * sB[r][n];
            acc += sC[r][n] * x[n];
          }
        }
        y[(row0 + t0 + r) * Dm + d] = from_f32<T>(acc + uu * dskip);
      }
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* bias, void* y, float* xsave, int G, int L,
                   int Dm, int K, int N, bool reverse, bool softplus,
                   cudaStream_t stream) {
  const dim3 grid((Dm + kThreads - 1) / kThreads, G);
  const T* u_ = static_cast<const T*>(u);
  const T* dt_ = static_cast<const T*>(delta);
  const float* A_ = static_cast<const float*>(A);
  const T* B_ = static_cast<const T*>(B);
  const T* C_ = static_cast<const T*>(C);
  const float* D_ = static_cast<const float*>(D);
  const float* b_ = static_cast<const float*>(bias);
  T* y_ = static_cast<T*>(y);
#define SCAN_LAUNCH(NM)                                                    \
  scan_fwd_kernel<T, NM><<<grid, kThreads, 0, stream>>>(                   \
      u_, dt_, A_, B_, C_, D_, b_, y_, xsave, L, Dm, K, N, reverse, softplus)
  if (N <= 8) {
    SCAN_LAUNCH(8);
  } else if (N <= 16) {
    SCAN_LAUNCH(16);
  } else if (N <= 32) {
    SCAN_LAUNCH(32);
  } else if (N <= 64) {
    SCAN_LAUNCH(64);
  } else {
    return cudaErrorInvalidValue;
  }
#undef SCAN_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success).  is_bf16 selects the type of u, delta, B, C, y;
// xsave may be null.
extern "C" int selective_scan_fwd(const void* u, const void* delta,
                                  const void* A, const void* B, const void* C,
                                  const void* D, const void* bias, void* y,
                                  void* xsave, int G, int L, int Dm, int K,
                                  int N, int is_bf16, int reverse,
                                  int softplus, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xs = static_cast<float*>(xsave);
  if (is_bf16) {
    return static_cast<int>(launch<__nv_bfloat16>(
        u, delta, A, B, C, D, bias, y, xs, G, L, Dm, K, N, reverse != 0,
        softplus != 0, s));
  }
  return static_cast<int>(launch<float>(u, delta, A, B, C, D, bias, y, xs, G,
                                        L, Dm, K, N, reverse != 0,
                                        softplus != 0, s));
}

extern "C" const char* selective_scan_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
