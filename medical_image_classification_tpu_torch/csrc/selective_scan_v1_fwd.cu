// Mamba-1 selective-scan forward, v1 (chunks of T timesteps), folded
// layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/selective_scan_pallas.py
//   ::_scan_kernel (launched by _fwd_folded): a Hillis-Steele doubling scan
//   over the timesteps of each chunk, the state carried from chunk to chunk.
//
// Computes, for every sequence g and channel d (param group k = g % K):
//   dt_t = softplus(delta_t + bias)
//   x_t  = exp(dt_t * A) * x_{t-1} + dt_t * B_t * u_t     (x: N fp32 states)
//   y_t  = C_t . x_t + D * u_t
// and xsave [G, ceil(L / T), N, Dm] fp32, the state entering each chunk of T
// timesteps (null on the eval path).  No flags: forward scans only, softplus
// always, a zero initial state.  The TPU kernel pads L to a multiple of T;
// pad steps change neither y on the real steps nor any xsave entry, so this
// kernel walks a ragged last chunk instead.
//
// Layout: u, delta, y [G, L, Dm]; B, C [G, L, N] (fp32 or bf16, all the same
// type); A [K, Dm, N], D, bias [K, Dm] fp32.  State and arithmetic are fp32.
//
// What bounds it on this card: bytes.  At the kernel bench's stage 0 (G 128,
// L 3136, Dm 96, N 16, bf16, T 50) a call moves about 306 MB (u, delta, y
// 231 MB, B and C 26 MB, xsave 50 MB), 0.092 ms at 3.35 TB/s; it does ~7
// fp32 operations per state per step and one exp (617 M of them).
//
// Design: parallel in time, where csrc/selective_scan_fwd.cu walks every
// step of a channel in one thread.  A block covers 8 channels of one
// sequence, one warp each; the warp's 32 lanes are 32 consecutive
// timesteps.  For each state n, the lanes form (a_t, b_t) = (exp(dt_t A_n),
// dt_t u_t B_t[n]) and run an inclusive warp-shuffle scan of the pairs
// (five doubling steps of the combine (a1, b1) o (a2, b2) = (a1 a2,
// a2 b1 + b2)), then fold in the state entering the 32 steps; the state
// leaving them (lane 31) is broadcast back as the next carry.  A chunk of T
// steps is walked in pieces of 32 (the last one ragged), so T is any value
// >= 1.  Each lane keeps y's sum over n in its register: no reduction across
// lanes.  Lanes past the piece's end get dt = 0 (a = 1, b = 0), the scan's
// identity, so the carry is lane 31's.  The block stages each piece's u and
// dt [32][8] and B, C rows [32][N] in shared memory with coalesced loads
// (rows padded to an odd stride: no bank conflicts), and writes y through
// shared memory, coalesced.
//
// What it leaves on the table: the scan costs 10 shuffles per state per
// 32 steps and lane, and a ragged piece idles lanes (T 50: pieces of 32
// and 18, 28% of the lanes idle).  Later work: the states over lanes as
// well, longer pieces per warp with a two-level carry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;               // channels per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 32;                // timesteps per piece: one per lane
constexpr unsigned kFull = 0xffffffffu;
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

// log(1 + e^v) as max(v, 0) + log1p(e^-|v|), jax.nn.softplus's formula
__device__ __forceinline__ float softplus_f32(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads)
    scan_v1_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ Cm,
                       const float* __restrict__ Dskip,
                       const float* __restrict__ bias, T* __restrict__ y,
                       float* __restrict__ xsave, int L, int Dm, int K, int N,
                       int Tc) {
  __shared__ float sU[kSub][kWarps + 1];
  __shared__ float sDt[kSub][kWarps + 1];
  __shared__ float sY[kSub][kWarps + 1];
  __shared__ float sB[kSub][NMAX + 1];
  __shared__ float sC[kSub][NMAX + 1];
  __shared__ float sA2[kWarps][NMAX];     // A * log2(e): exp(dt A) = exp2

  const int g = blockIdx.y;
  const int k = g % K;
  const int d0 = blockIdx.x * kWarps;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int d = d0 + w;                   // this warp's channel
  const bool active = d < Dm;
  // the element this thread stages: row sr, channel sc of a piece
  const int sr = tid / kWarps;
  const int sc = tid % kWarps;
  const int sd = d0 + sc;
  const bool s_active = sd < Dm;
  const float s_bias = s_active ? bias[k * Dm + sd] : 0.f;
  for (int i = tid; i < kWarps * NMAX; i += kThreads) {
    const int ww = i / NMAX;
    const int n = i - ww * NMAX;
    const int dd = d0 + ww;
    sA2[ww][n] = (dd < Dm && n < N)
                     ? A[(static_cast<size_t>(k) * Dm + dd) * N + n] * kLog2e
                     : 0.f;
  }
  const float dskip = active ? Dskip[k * Dm + d] : 0.f;
  float carry[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) carry[n] = 0.f;
  const size_t row0 = static_cast<size_t>(g) * L;

  const int nchunks = (L + Tc - 1) / Tc;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * Tc;
    const int tl = min(Tc, L - t0);
    if (xsave != nullptr && active) {  // the state entering chunk c
      float* xs = xsave + (static_cast<size_t>(g) * nchunks + c) * N * Dm + d;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N && lane == (n & 31)) xs[static_cast<size_t>(n) * Dm] = carry[n];
      }
    }
    for (int s0 = 0; s0 < tl; s0 += kSub) {
      const int sl = min(kSub, tl - s0);
      const size_t ts = row0 + t0 + s0;   // row of the piece's first step
      __syncthreads();  // the last piece's tiles are read, its y written
      {
        float uv = 0.f, dv = 0.f;         // dt 0 past the piece: identity
        if (sr < sl && s_active) {
          const size_t off = (ts + sr) * Dm + sd;
          uv = to_f32(u[off]);
          dv = softplus_f32(to_f32(delta[off]) + s_bias);
        }
        sU[sr][sc] = uv;
        sDt[sr][sc] = dv;
      }
      for (int i = tid; i < kSub * NMAX; i += kThreads) {
        const int r = i / NMAX;
        const int n = i - r * NMAX;
        float bv = 0.f, cv = 0.f;
        if (r < sl && n < N) {
          const size_t off = (ts + r) * N + n;
          bv = to_f32(Bm[off]);
          cv = to_f32(Cm[off]);
        }
        sB[r][n] = bv;
        sC[r][n] = cv;
      }
      __syncthreads();

      const float dt = sDt[lane][w];
      const float uu = sU[lane][w];
      const float dtu = dt * uu;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          float a = exp2f(dt * sA2[w][n]);
          float b = dtu * sB[lane][n];
#pragma unroll
          for (int off = 1; off < kSub; off <<= 1) {
            const float a_up = __shfl_up_sync(kFull, a, off);
            const float b_up = __shfl_up_sync(kFull, b, off);
            if (lane >= off) {
              b = fmaf(a, b_up, b);
              a *= a_up;
            }
          }
          const float x = fmaf(a, carry[n], b);
          acc = fmaf(sC[lane][n], x, acc);
          carry[n] = __shfl_sync(kFull, x, kSub - 1);
        }
      }
      sY[lane][w] = acc + uu * dskip;
      __syncthreads();
      if (sr < sl && s_active) {
        y[(ts + sr) * Dm + sd] = from_f32<T>(sY[sr][sc]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* bias, void* y, float* xsave, int G, int L,
                   int Dm, int K, int N, int Tc, cudaStream_t stream) {
  if (Tc < 1 || L < 1 || G < 1 || G > 65535) return cudaErrorInvalidValue;
  const dim3 grid((Dm + kWarps - 1) / kWarps, G);
#define SCAN_V1_LAUNCH(NM)                                                  \
  scan_v1_fwd_kernel<T, NM><<<grid, kThreads, 0, stream>>>(                 \
      static_cast<const T*>(u), static_cast<const T*>(delta),               \
      static_cast<const float*>(A), static_cast<const T*>(B),               \
      static_cast<const T*>(C), static_cast<const float*>(D),               \
      static_cast<const float*>(bias), static_cast<T*>(y), xsave, L, Dm, K, \
      N, Tc)
  if (N <= 8) {
    SCAN_V1_LAUNCH(8);
  } else if (N <= 16) {
    SCAN_V1_LAUNCH(16);
  } else if (N <= 32) {
    SCAN_V1_LAUNCH(32);
  } else if (N <= 64) {
    SCAN_V1_LAUNCH(64);
  } else {
    return cudaErrorInvalidValue;
  }
#undef SCAN_V1_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success).  is_bf16 selects the type of u, delta, B, C, y;
// xsave may be null.
extern "C" int selective_scan_v1_fwd(const void* u, const void* delta,
                                     const void* A, const void* B,
                                     const void* C, const void* D,
                                     const void* bias, void* y, void* xsave,
                                     int G, int L, int Dm, int K, int N,
                                     int T, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xs = static_cast<float*>(xsave);
  if (is_bf16) {
    return static_cast<int>(launch<__nv_bfloat16>(
        u, delta, A, B, C, D, bias, y, xs, G, L, Dm, K, N, T, s));
  }
  return static_cast<int>(
      launch<float>(u, delta, A, B, C, D, bias, y, xs, G, L, Dm, K, N, T, s));
}

extern "C" const char* selective_scan_v1_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
