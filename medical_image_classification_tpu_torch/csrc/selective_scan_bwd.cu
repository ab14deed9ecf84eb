// Mamba-1 selective-scan backward, folded layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/selective_scan_pallas_bwd_v2.py
//   ::_bwd_kernel_v2 (launched by bwd_folded_v2), for forward and reverse
//   scans, with or without softplus, with both state flags: the cotangent
//   of the last state (dlast) and that of the initial state (want_dinit).
//
// The forward (csrc/selective_scan_fwd.cu) is, per sequence g and channel d
// (param group k = g % K), with dt_t = softplus(delta_t + bias):
//   x_t = a_t x_{t-1} + b_t,  a_t = exp(dt_t A),  b_t = dt_t B_t u_t
//   y_t = C_t . x_t + D u_t
// (x_{t+1} in place of x_{t-1} for a reverse scan; dt_t = delta_t + bias
// without softplus, and sigmoid below becomes 1).  Given dy, the adjoint
//   g_t = C_t dy_t + a_{t+1} g_{t+1}      (a_{t-1} g_{t-1} for reverse)
// runs against the scan direction, and
//   du_t     = dt_t sum_n g_t B_t + D dy_t
//   ddelta_t = sigmoid(delta_t + bias) (sum_n g_t (x_t - b_t) A + u_t sum_n g_t B_t)
//   dB_t[n]  = sum_d g_t[n] dt_t u_t        dC_t[n] = sum_d dy_t x_t[n]
//   dA[n]    = sum_t g_t[n] (x_t - b_t) dt_t
//   dD       = sum_t dy_t u_t               dbias = sum_t ddelta_t
// where x_t - b_t = a_t x_{t-1} comes straight from the recurrence.
// dlast (optional) [G, N, Dm] fp32, the cotangent of the state after the
// last step scanned, seeds the adjoint's carry: it reaches that step's g
// with factor 1.  dinit (optional) [G, N, Dm] fp32 receives the carry after
// the walk leaves the first step scanned, a_first g_first, the cotangent
// of the initial state (the forward wrote that state as the first scanned
// chunk's xsave, so the recompute needs nothing more).
//
// Layout: u, delta, dy, du, ddelta [G, L, Dm] and B, C [G, L, N] in one type
// (fp32 or bf16); A [K, Dm, N], D, bias [K, Dm] fp32; xsave [G, nT, N, Dm]
// fp32, the state entering each chunk of kChunk timesteps as the forward
// wrote it.  Outputs in fp32: dB_part, dC_part [ceil(Dm / 32), G, L, N], one
// partial sum over each block's 32 channels (the wrapper sums them: the same
// bits on every run, where atomics would add in a varying order), and per
// sequence dA_part [G, N, Dm], dD_part, dbias_part [G, Dm], which the wrapper
// sums over the batch as bwd_folded_v2 does.
//
// What bounds it on this card: like the forward, the latency of the per-step
// chain, not bytes.  Only G * Dm threads exist and each walks all L steps
// twice (state recompute, then the adjoint).
//
// Design (simple first): one thread per (g, d), one warp per block covering
// 32 channels of one sequence.  The block walks the chunks in adjoint order
// (last to first for a forward scan, first to last for a reverse one).  For
// each chunk it stages the rows of u, delta, dy, B and C in shared memory,
// recomputes the chunk's states from xsave and keeps them in shared memory
// ([S][N][32] fp32: 64 KB at N 16, S 32), then walks the adjoint.  A chunk
// is cut into sub-chunks of S timesteps when N is above 16 (S 16 at N 32, 8
// at N 64), each recomputed from the chunk's incoming state, so that the
// states always fit.  The sums over channels (dB, dC) go through the same
// shared buffer: each lane sums one (t, n) pair over the 32 lanes, reading
// the lanes in a rotated order so that no two lanes hit one bank.
//
// Later work: the forward's, plus keeping the four directions' adjoints in
// one launch and splitting N across lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;  // channels per block: one warp
// timesteps per chunk of xsave; equal to the forward kernel's kChunk
constexpr int kChunk = 32;

// timesteps whose states shared memory holds at once
template <int NMAX>
__host__ __device__ constexpr int sub_chunk() {
  return NMAX <= 16 ? kChunk : 512 / NMAX;
}

template <int NMAX>
__host__ __device__ constexpr size_t smem_bytes() {
  // sB, sC [kChunk][NMAX]; sU, sDt, sSig, sDy [kChunk][32]; sX [S][NMAX][32]
  return sizeof(float) * (2 * kChunk * NMAX + 4 * kChunk * kThreads +
                          sub_chunk<NMAX>() * NMAX * kThreads);
}

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

// the forward kernel's softplus (jax.nn.softplus's formula)
__device__ __forceinline__ float softplus_f32(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads) scan_bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ delta,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dskip,
    const float* __restrict__ bias, const float* __restrict__ xsave,
    const T* __restrict__ dy, const float* __restrict__ dlast,
    T* __restrict__ du, T* __restrict__ ddelta,
    float* __restrict__ dB_part, float* __restrict__ dC_part,
    float* __restrict__ dA_part, float* __restrict__ dD_part,
    float* __restrict__ dbias_part, float* __restrict__ dinit, int G, int L,
    int Dm, int K, int N, bool reverse, bool softplus) {
  constexpr int S = sub_chunk<NMAX>();
  extern __shared__ float smem[];
  float* sB = smem;                        // [kChunk][NMAX]
  float* sC = sB + kChunk * NMAX;          // [kChunk][NMAX]
  float* sU = sC + kChunk * NMAX;          // [kChunk][32]
  float* sDt = sU + kChunk * kThreads;     // softplus(delta + bias)
  float* sSig = sDt + kChunk * kThreads;   // its derivative, sigmoid
  float* sDy = sSig + kChunk * kThreads;   // [kChunk][32]
  float* sX = sDy + kChunk * kThreads;     // [S][NMAX][32]

  const int g = blockIdx.y;
  const int lane = threadIdx.x;
  const int d = blockIdx.x * kThreads + lane;
  const int k = g % K;
  const bool active = d < Dm;
  const int dp = active ? d : 0;  // in-bounds channel for parameter loads

  // A, and A * log2(e) so that exp(dt * A) = exp2(dt * a2) as in the forward
  float Av[NMAX], a2[NMAX], gc[NMAX], dA[NMAX];
  // this thread's column of dlast and dinit: [G, N, Dm], step Dm per state
  const size_t st0 = static_cast<size_t>(g) * N * Dm + d;
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    Av[n] = n < N ? A[(static_cast<size_t>(k) * Dm + dp) * N + n] : 0.f;
    a2[n] = Av[n] * 1.4426950408889634f;
    // a_t g_t of the step walked last: the adjoint's carry, seeded with the
    // last state's cotangent
    gc[n] = (dlast != nullptr && active && n < N)
                ? dlast[st0 + static_cast<size_t>(n) * Dm]
                : 0.f;
    dA[n] = 0.f;
  }
  const float dskip = Dskip[k * Dm + dp];
  const float dbias = bias[k * Dm + dp];
  float dD = 0.f, dbias_acc = 0.f;
  const size_t row0 = static_cast<size_t>(g) * L;
  const size_t part0 = (static_cast<size_t>(blockIdx.x) * G + g) * L;

  const int nchunks = (L + kChunk - 1) / kChunk;
  for (int c = 0; c < nchunks; ++c) {
    const int ci = reverse ? c : nchunks - 1 - c;  // adjoint order
    const int t0 = ci * kChunk;
    const int tl = min(kChunk, L - t0);
    for (int i = lane; i < tl * N; i += kThreads) {
      const int r = i / N;
      const int n = i - r * N;
      const size_t off = (row0 + t0 + r) * N + n;
      sB[r * NMAX + n] = to_f32(Bm[off]);
      sC[r * NMAX + n] = to_f32(Cm[off]);
    }
    // idle lanes (d >= Dm) hold u = dy = 0 and a zero state, so every sum
    // over the block's channels takes exact zeros from them
    for (int r = 0; r < tl; ++r) {
      const size_t off = (row0 + t0 + r) * Dm + d;
      const float v = (active ? to_f32(delta[off]) : 0.f) + dbias;
      sDt[r * kThreads + lane] = softplus ? softplus_f32(v) : v;
      sSig[r * kThreads + lane] = softplus ? 1.f / (1.f + expf(-v)) : 1.f;
      sU[r * kThreads + lane] = active ? to_f32(u[off]) : 0.f;
      sDy[r * kThreads + lane] = active ? to_f32(dy[off]) : 0.f;
    }
    __syncthreads();

    // scan position i (0 = first step of the chunk in scan order) -> row
    const int nsub = (tl + S - 1) / S;
    for (int j = nsub - 1; j >= 0; --j) {
      const int i0 = j * S;
      const int il = min(S, tl - i0);

      // recompute the states of scan positions [i0, i0 + il)
      float x[NMAX];
      const float* xs =
          xsave + (static_cast<size_t>(g) * nchunks + ci) * N * Dm + dp;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        x[n] = (n < N && active) ? xs[static_cast<size_t>(n) * Dm] : 0.f;
      }
      for (int i = 0; i < i0 + il; ++i) {
        const int r = reverse ? tl - 1 - i : i;
        const float dt = sDt[r * kThreads + lane];
        const float dtu = dt * sU[r * kThreads + lane];
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < N) {
            x[n] = exp2f(dt * a2[n]) * x[n] + dtu * sB[r * NMAX + n];
            if (i >= i0) sX[((i - i0) * NMAX + n) * kThreads + lane] = x[n];
          }
        }
      }
      __syncthreads();

      // dC: sum over the block's channels of dy_t x_t[n]
      for (int p = lane; p < il * N; p += kThreads) {
        const int ii = p / N;
        const int n = p - ii * N;
        const int r = reverse ? tl - 1 - (i0 + ii) : i0 + ii;
        const float* xr = sX + (ii * NMAX + n) * kThreads;
        const float* dyr = sDy + r * kThreads;
        float s = 0.f;
        for (int l = 0; l < kThreads; ++l) {
          const int ll = (lane + l) & (kThreads - 1);  // rotated: no bank clash
          s += dyr[ll] * xr[ll];
        }
        dC_part[(part0 + t0 + r) * N + n] = s;
      }
      __syncthreads();

      // the adjoint, scan positions descending
      for (int i = i0 + il - 1; i >= i0; --i) {
        const int r = reverse ? tl - 1 - i : i;
        const float dt = sDt[r * kThreads + lane];
        const float uu = sU[r * kThreads + lane];
        const float dyv = sDy[r * kThreads + lane];
        const float dtu = dt * uu;
        float gB = 0.f, gxA = 0.f;
#pragma unroll
        for (int n = 0; n < NMAX; ++n) {
          if (n < N) {
            const float bn = sB[r * NMAX + n];
            const float gn = sC[r * NMAX + n] * dyv + gc[n];
            float* slot = sX + ((i - i0) * NMAX + n) * kThreads + lane;
            const float xa = *slot - dtu * bn;  // a_t x_prev
            gB += gn * bn;
            gxA += gn * xa * Av[n];
            dA[n] += gn * xa * dt;
            *slot = gn * dtu;  // the state's slot now holds the dB term
            gc[n] = exp2f(dt * a2[n]) * gn;
          }
        }
        const float dd = sSig[r * kThreads + lane] * (gxA + uu * gB);
        dbias_acc += dd;
        dD += dyv * uu;
        if (active) {
          const size_t off = (row0 + t0 + r) * Dm + d;
          du[off] = from_f32<T>(dt * gB + dskip * dyv);
          ddelta[off] = from_f32<T>(dd);
        }
      }
      __syncthreads();

      // dB: sum over the block's channels of g_t[n] dt_t u_t
      for (int p = lane; p < il * N; p += kThreads) {
        const int ii = p / N;
        const int n = p - ii * N;
        const int r = reverse ? tl - 1 - (i0 + ii) : i0 + ii;
        const float* br = sX + (ii * NMAX + n) * kThreads;
        float s = 0.f;
        for (int l = 0; l < kThreads; ++l) {
          s += br[(lane + l) & (kThreads - 1)];
        }
        dB_part[(part0 + t0 + r) * N + n] = s;
      }
      __syncthreads();  // the next sub-chunk or chunk overwrites sX and rows
    }
  }

  if (active) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) dA_part[(static_cast<size_t>(g) * N + n) * Dm + d] = dA[n];
    }
    dD_part[static_cast<size_t>(g) * Dm + d] = dD;
    dbias_part[static_cast<size_t>(g) * Dm + d] = dbias_acc;
    if (dinit != nullptr) {
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) dinit[st0 + static_cast<size_t>(n) * Dm] = gc[n];
      }
    }
  }
}

template <typename T, int NMAX>
cudaError_t launch_n(const dim3 grid, const T* u, const T* delta,
                     const float* A, const T* B, const T* C, const float* D,
                     const float* bias, const float* xsave, const T* dy,
                     const float* dlast, T* du, T* ddelta, float* dB_part,
                     float* dC_part, float* dA_part, float* dD_part,
                     float* dbias_part, float* dinit, int G, int L, int Dm,
                     int K, int N, bool reverse, bool softplus,
                     cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<NMAX>();
  // above 48 KB a block gets dynamic shared memory only on request
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<T, NMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  scan_bwd_kernel<T, NMAX><<<grid, kThreads, bytes, stream>>>(
      u, delta, A, B, C, D, bias, xsave, dy, dlast, du, ddelta, dB_part,
      dC_part, dA_part, dD_part, dbias_part, dinit, G, L, Dm, K, N, reverse,
      softplus);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* bias, const void* xsave, const void* dy,
                   const void* dlast, void* du, void* ddelta, void* dB_part,
                   void* dC_part, void* dA_part, void* dD_part,
                   void* dbias_part, void* dinit, int G, int L, int Dm, int K,
                   int N, bool reverse, bool softplus, cudaStream_t stream) {
  const dim3 grid((Dm + kThreads - 1) / kThreads, G);
#define SCAN_BWD_LAUNCH(NM)                                                  \
  return launch_n<T, NM>(                                                    \
      grid, static_cast<const T*>(u), static_cast<const T*>(delta),          \
      static_cast<const float*>(A), static_cast<const T*>(B),                \
      static_cast<const T*>(C), static_cast<const float*>(D),                \
      static_cast<const float*>(bias), static_cast<const float*>(xsave),     \
      static_cast<const T*>(dy), static_cast<const float*>(dlast),           \
      static_cast<T*>(du), static_cast<T*>(ddelta),                          \
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),            \
      static_cast<float*>(dA_part), static_cast<float*>(dD_part),            \
      static_cast<float*>(dbias_part), static_cast<float*>(dinit), G, L, Dm, \
      K, N, reverse, softplus, stream)
  if (N <= 8) {
    SCAN_BWD_LAUNCH(8);
  } else if (N <= 16) {
    SCAN_BWD_LAUNCH(16);
  } else if (N <= 32) {
    SCAN_BWD_LAUNCH(32);
  } else if (N <= 64) {
    SCAN_BWD_LAUNCH(64);
  }
#undef SCAN_BWD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success).  is_bf16 selects the type of u, delta, B, C, dy,
// du and ddelta; dlast and dinit may each be null.
extern "C" int selective_scan_bwd(const void* u, const void* delta,
                                  const void* A, const void* B, const void* C,
                                  const void* D, const void* bias,
                                  const void* xsave, const void* dy,
                                  const void* dlast, void* du, void* ddelta,
                                  void* dB_part, void* dC_part, void* dA_part,
                                  void* dD_part, void* dbias_part,
                                  void* dinit, int G, int L, int Dm, int K,
                                  int N, int is_bf16, int reverse,
                                  int softplus, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return static_cast<int>(launch<__nv_bfloat16>(
        u, delta, A, B, C, D, bias, xsave, dy, dlast, du, ddelta, dB_part,
        dC_part, dA_part, dD_part, dbias_part, dinit, G, L, Dm, K, N,
        reverse != 0, softplus != 0, s));
  }
  return static_cast<int>(launch<float>(
      u, delta, A, B, C, D, bias, xsave, dy, dlast, du, ddelta, dB_part,
      dC_part, dA_part, dD_part, dbias_part, dinit, G, L, Dm, K, N,
      reverse != 0, softplus != 0, s));
}

extern "C" const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
