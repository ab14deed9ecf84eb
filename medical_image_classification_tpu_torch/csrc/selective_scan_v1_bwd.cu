// Mamba-1 selective-scan backward, v1 (chunks of T timesteps), folded
// layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/selective_scan_pallas_bwd.py
//   ::_bwd_kernel (launched by bwd_folded): the chunks walked in reverse,
//   each chunk's states recomputed from xsave by the doubling scan, a suffix
//   doubling scan for the adjoint, per-sequence parameter partials.
//
// The forward (csrc/selective_scan_v1_fwd.cu) is, per sequence g and
// channel d (param group k = g % K), with dt_t = softplus(delta_t + bias):
//   x_t = a_t x_{t-1} + b_t,  a_t = exp(dt_t A),  b_t = dt_t B_t u_t
//   y_t = C_t . x_t + D u_t
// Given dy, the adjoint g_t = C_t dy_t + a_{t+1} g_{t+1} runs backward, and
//   du_t     = dt_t sum_n g_t B_t + D dy_t
//   ddelta_t = sigmoid(delta_t + bias) (sum_n g_t a_t x_{t-1} A
//                                       + u_t sum_n g_t B_t)
//   dB_t[n]  = sum_d g_t[n] dt_t u_t        dC_t[n] = sum_d dy_t x_t[n]
//   dA[n]    = sum_t g_t[n] a_t x_{t-1} dt_t
//   dD       = sum_t dy_t u_t               dbias = sum_t ddelta_t
//
// Layout: u, delta, dy [G, L, Dm] and B, C [G, L, N] in one type (fp32 or
// bf16); A [K, Dm, N], D, bias [K, Dm] fp32; xsave [G, ceil(L / T), N, Dm]
// fp32, the state entering each chunk as the forward wrote it.  Outputs, all
// fp32 as bwd_folded returns them: du, ddelta [G, L, Dm]; dB_part, dC_part
// [ceil(Dm / 8), G, L, N], each block's sum over its 8 channels (the wrapper
// sums them: the same bits on every run, where atomics would add in a
// varying order); per sequence dA_part [G, N, Dm], dD_part, dbias_part
// [G, Dm], which the wrapper sums over the batch as bwd_folded does.
//
// What bounds it on this card: bytes.  At the kernel bench's stage 0 (G 128,
// L 3136, Dm 96, N 16, bf16, T 50) the function moves about 665 MB (u,
// delta, dy, B, C and xsave in; du, ddelta, dB, dC out in fp32), 0.20 ms
// at 3.35 TB/s, against ~20 fp32 operations per state per step, 0.18 ms.
//
// Design: the forward's, parallel in time.  A block covers 8 channels of
// one sequence, one warp each, lanes = 32 consecutive timesteps, and walks
// the chunks last to first.  Entering a chunk it takes the chunk's incoming
// state from xsave and scans the chunk's 32-step pieces forward once to
// keep the state entering each piece in shared memory (ceil(T / 32) states
// of N per channel, so T is any value the shared memory holds).  It then
// walks the pieces last to first: it recomputes the piece's states with the
// warp-shuffle prefix scan of (a_t, b_t), takes x_{t-1} from the lane below,
// and runs the adjoint as a suffix scan of (a_{t+1}, C_t dy_t) with
// shuffles down, seeded with the carry a_first g_first of the piece after
// it.  du and ddelta are per lane; dA, dD and dbias sum per lane in
// registers and across the lanes by a butterfly at the end; dB and dC are
// sums over channels, so each warp writes its terms to shared memory and
// the block adds its 8 channels in a fixed order.  Steps past the piece's
// end are staged with dt = u = dy = 0 and B = C = 0: the scans' identity,
// and no term.
//
// What it leaves on the table: the forward's (10 shuffles per state per
// 32 steps for each scan, idle lanes in a ragged piece), the pieces of a
// chunk scanned twice, and dB/dC partials for every 8 channels (12 at
// stage 0, written and summed in fp32, more bytes than the outputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;               // channels per block, one warp each
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 32;                // timesteps per piece: one per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRow = kWarps + 1;        // padded row of a [32][8] tile

// shared memory of a block (kernels/selective_scan_v1.py::bwd_smem_bytes
// computes the same): u, dt, sigmoid, dy, du, ddelta tiles [32][9]; B, C
// rows [32][NMAX + 1]; A [8][NMAX]; the dB and dC terms [8][32][NMAX + 1];
// the states entering the pieces [nsub][8][NMAX]
template <int NMAX>
__host__ __device__ constexpr size_t smem_fixed() {
  return sizeof(float) * (6 * kSub * kRow + 2 * kSub * (NMAX + 1) +
                          kWarps * NMAX + 2 * kWarps * kSub * (NMAX + 1));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the forward kernel's softplus (jax.nn.softplus's formula)
__device__ __forceinline__ float softplus_f32(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads) scan_v1_bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ delta,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dskip,
    const float* __restrict__ bias, const float* __restrict__ xsave,
    const T* __restrict__ dy, float* __restrict__ du,
    float* __restrict__ ddelta, float* __restrict__ dB_part,
    float* __restrict__ dC_part, float* __restrict__ dA_part,
    float* __restrict__ dD_part, float* __restrict__ dbias_part, int G,
    int L, int Dm, int K, int N, int Tc) {
  extern __shared__ float smem[];
  float* sU = smem;                        // [32][kRow]
  float* sDt = sU + kSub * kRow;           // softplus(delta + bias)
  float* sSig = sDt + kSub * kRow;         // its derivative, sigmoid
  float* sDy = sSig + kSub * kRow;
  float* sDu = sDy + kSub * kRow;          // outputs on their way out
  float* sDd = sDu + kSub * kRow;
  float* sB = sDd + kSub * kRow;           // [32][NMAX + 1]
  float* sC = sB + kSub * (NMAX + 1);
  float* sA = sC + kSub * (NMAX + 1);      // [8][NMAX]; exp(dt A) is
                                           // exp2(dt (A log2 e)) as in the
                                           // forward
  float* sPB = sA + kWarps * NMAX;         // [8][32][NMAX + 1]: g dt u
  float* sPC = sPB + kWarps * kSub * (NMAX + 1);  // dy x
  float* sXb = sPC + kWarps * kSub * (NMAX + 1);  // [nsub][8][NMAX]

  const int g = blockIdx.y;
  const int k = g % K;
  const int d0 = blockIdx.x * kWarps;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int d = d0 + w;                   // this warp's channel
  const bool active = d < Dm;
  const int sr = tid / kWarps;            // the element this thread stages
  const int sc = tid % kWarps;
  const int sd = d0 + sc;
  const bool s_active = sd < Dm;
  const float s_bias = s_active ? bias[k * Dm + sd] : 0.f;
  for (int i = tid; i < kWarps * NMAX; i += kThreads) {
    const int ww = i / NMAX;
    const int n = i - ww * NMAX;
    const int dd = d0 + ww;
    sA[i] = (dd < Dm && n < N)
                ? A[(static_cast<size_t>(k) * Dm + dd) * N + n]
                : 0.f;
  }
  const float dskip = active ? Dskip[k * Dm + d] : 0.f;
  const size_t row0 = static_cast<size_t>(g) * L;
  const size_t part0 = (static_cast<size_t>(blockIdx.x) * G + g) * L;

  // stage the piece of sl steps at row ts: u and dt, and with `full` also
  // sigmoid, dy and C; zeros past the piece and the channels
  auto stage = [&](size_t ts, int sl, bool full) {
    float uv = 0.f, dv = 0.f, sg = 0.f, dyv = 0.f;
    if (sr < sl && s_active) {
      const size_t off = (ts + sr) * Dm + sd;
      const float raw = to_f32(delta[off]) + s_bias;
      uv = to_f32(u[off]);
      dv = softplus_f32(raw);
      if (full) {
        sg = 1.f / (1.f + expf(-raw));
        dyv = to_f32(dy[off]);
      }
    }
    sU[sr * kRow + sc] = uv;
    sDt[sr * kRow + sc] = dv;
    sSig[sr * kRow + sc] = sg;
    sDy[sr * kRow + sc] = dyv;
    for (int i = tid; i < kSub * NMAX; i += kThreads) {
      const int r = i / NMAX;
      const int n = i - r * NMAX;
      float bv = 0.f, cv = 0.f;
      if (r < sl && n < N) {
        const size_t off = (ts + r) * N + n;
        bv = to_f32(Bm[off]);
        if (full) cv = to_f32(Cm[off]);
      }
      sB[r * (NMAX + 1) + n] = bv;
      sC[r * (NMAX + 1) + n] = cv;
    }
  };

  float gc[NMAX], dA[NMAX];  // the adjoint's carry a_t g_t; dA over t
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    gc[n] = 0.f;
    dA[n] = 0.f;
  }
  float dD = 0.f, dbias_acc = 0.f;
  const float* sAw = sA + w * NMAX;

  const int nchunks = (L + Tc - 1) / Tc;
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * Tc;
    const int tl = min(Tc, L - t0);
    const int nsub = (tl + kSub - 1) / kSub;
    __syncthreads();  // the last chunk is done with sXb
    for (int i = tid; i < kWarps * NMAX; i += kThreads) {
      const int ww = i / NMAX;
      const int n = i - ww * NMAX;
      const int dd = d0 + ww;
      sXb[i] = (dd < Dm && n < N)
                   ? xsave[((static_cast<size_t>(g) * nchunks + c) * N + n) *
                               Dm + dd]
                   : 0.f;
    }
    // the state entering each later piece of the chunk (all but the last
    // piece are whole)
    for (int j = 0; j + 1 < nsub; ++j) {
      __syncthreads();
      stage(row0 + t0 + j * kSub, kSub, false);
      __syncthreads();
      const float dt = sDt[lane * kRow + w];
      const float dtu = dt * sU[lane * kRow + w];
      const float* xin = sXb + (j * kWarps + w) * NMAX;
      float* xout = sXb + ((j + 1) * kWarps + w) * NMAX;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          float a = exp2f(dt * (sAw[n] * kLog2e));
          float b = dtu * sB[lane * (NMAX + 1) + n];
#pragma unroll
          for (int off = 1; off < kSub; off <<= 1) {
            const float a_up = __shfl_up_sync(kFull, a, off);
            const float b_up = __shfl_up_sync(kFull, b, off);
            if (lane >= off) {
              b = fmaf(a, b_up, b);
              a *= a_up;
            }
          }
          const float xe = __shfl_sync(kFull, fmaf(a, xin[n], b), kSub - 1);
          if (lane == 0) xout[n] = xe;
        }
      }
    }

    // the pieces last to first
    for (int j = nsub - 1; j >= 0; --j) {
      const int sl = min(kSub, tl - j * kSub);
      const size_t ts = row0 + t0 + j * kSub;
      __syncthreads();
      stage(ts, sl, true);
      __syncthreads();
      const float dt = sDt[lane * kRow + w];
      const float uu = sU[lane * kRow + w];
      const float dyv = sDy[lane * kRow + w];
      const float dtu = dt * uu;
      const float* xin = sXb + (j * kWarps + w) * NMAX;
      float* pb = sPB + (w * kSub + lane) * (NMAX + 1);
      float* pc = sPC + (w * kSub + lane) * (NMAX + 1);
      float gB = 0.f, gxA = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          const float An = sAw[n];
          const float bn = sB[lane * (NMAX + 1) + n];
          const float a = exp2f(dt * (An * kLog2e));
          // the states: prefix scan, the incoming state folded in
          float as = a, bs = dtu * bn;
#pragma unroll
          for (int off = 1; off < kSub; off <<= 1) {
            const float a_up = __shfl_up_sync(kFull, as, off);
            const float b_up = __shfl_up_sync(kFull, bs, off);
            if (lane >= off) {
              bs = fmaf(as, b_up, bs);
              as *= a_up;
            }
          }
          const float x = fmaf(as, xin[n], bs);
          float xp = __shfl_up_sync(kFull, x, 1);
          if (lane == 0) xp = xin[n];
          // the adjoint: suffix scan of (a_{t+1}, C_t dy_t), a_{t+1} of
          // the piece's last step 1 (the carry holds the next piece's)
          float ah = __shfl_down_sync(kFull, a, 1);
          if (lane == kSub - 1) ah = 1.f;
          float dd = sC[lane * (NMAX + 1) + n] * dyv;
#pragma unroll
          for (int off = 1; off < kSub; off <<= 1) {
            const float a_dn = __shfl_down_sync(kFull, ah, off);
            const float d_dn = __shfl_down_sync(kFull, dd, off);
            if (lane + off < kSub) {
              dd = fmaf(ah, d_dn, dd);
              ah *= a_dn;
            }
          }
          const float gn = fmaf(ah, gc[n], dd);
          gc[n] = __shfl_sync(kFull, a * gn, 0);
          const float gax = gn * a * xp;
          gB = fmaf(gn, bn, gB);
          gxA = fmaf(gax, An, gxA);
          dA[n] = fmaf(gax, dt, dA[n]);
          pb[n] = gn * dtu;
          pc[n] = dyv * x;
        }
      }
      const float ddv = sSig[lane * kRow + w] * (gxA + uu * gB);
      dbias_acc += ddv;              // 0 past the piece (sigmoid staged 0)
      dD = fmaf(dyv, uu, dD);
      sDu[lane * kRow + w] = fmaf(dt, gB, dskip * dyv);
      sDd[lane * kRow + w] = ddv;
      __syncthreads();
      if (sr < sl && s_active) {
        const size_t off = (ts + sr) * Dm + sd;
        du[off] = sDu[sr * kRow + sc];
        ddelta[off] = sDd[sr * kRow + sc];
      }
      // dB, dC: the block's 8 channels, added in order
      for (int i = tid; i < sl * N; i += kThreads) {
        const int r = i / N;
        const int n = i - r * N;
        float sb = 0.f, scv = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) {
          sb += sPB[(ww * kSub + r) * (NMAX + 1) + n];
          scv += sPC[(ww * kSub + r) * (NMAX + 1) + n];
        }
        const size_t off = (part0 + t0 + j * kSub + r) * N + n;
        dB_part[off] = sb;
        dC_part[off] = scv;
      }
    }
  }

  // per-sequence partials: each lane's sums over its steps, then over lanes
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    if (n < N) {
      float v = dA[n];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(kFull, v, off);
      }
      if (lane == 0 && active) {
        dA_part[(static_cast<size_t>(g) * N + n) * Dm + d] = v;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dD += __shfl_xor_sync(kFull, dD, off);
    dbias_acc += __shfl_xor_sync(kFull, dbias_acc, off);
  }
  if (lane == 0 && active) {
    dD_part[static_cast<size_t>(g) * Dm + d] = dD;
    dbias_part[static_cast<size_t>(g) * Dm + d] = dbias_acc;
  }
}

template <typename T, int NMAX>
cudaError_t launch_n(const dim3 grid, const void* u, const void* delta,
                     const void* A, const void* B, const void* C,
                     const void* D, const void* bias, const void* xsave,
                     const void* dy, void* du, void* ddelta, void* dB_part,
                     void* dC_part, void* dA_part, void* dD_part,
                     void* dbias_part, int G, int L, int Dm, int K, int N,
                     int Tc, cudaStream_t stream) {
  const int nsub = (Tc + kSub - 1) / kSub;
  const size_t bytes =
      smem_fixed<NMAX>() + sizeof(float) * nsub * kWarps * NMAX;
  // above 48 KB a block gets dynamic shared memory only on request
  cudaError_t err = cudaFuncSetAttribute(
      scan_v1_bwd_kernel<T, NMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  scan_v1_bwd_kernel<T, NMAX><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(bias), static_cast<const float*>(xsave),
      static_cast<const T*>(dy), static_cast<float*>(du),
      static_cast<float*>(ddelta), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), static_cast<float*>(dA_part),
      static_cast<float*>(dD_part), static_cast<float*>(dbias_part), G, L, Dm,
      K, N, Tc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* bias, const void* xsave, const void* dy,
                   void* du, void* ddelta, void* dB_part, void* dC_part,
                   void* dA_part, void* dD_part, void* dbias_part, int G,
                   int L, int Dm, int K, int N, int Tc, cudaStream_t stream) {
  if (Tc < 1 || L < 1 || G < 1 || G > 65535) return cudaErrorInvalidValue;
  const dim3 grid((Dm + kWarps - 1) / kWarps, G);
#define SCAN_V1_BWD_LAUNCH(NM)                                               \
  return launch_n<T, NM>(grid, u, delta, A, B, C, D, bias, xsave, dy, du,    \
                         ddelta, dB_part, dC_part, dA_part, dD_part,         \
                         dbias_part, G, L, Dm, K, N, Tc, stream)
  if (N <= 8) {
    SCAN_V1_BWD_LAUNCH(8);
  } else if (N <= 16) {
    SCAN_V1_BWD_LAUNCH(16);
  } else if (N <= 32) {
    SCAN_V1_BWD_LAUNCH(32);
  } else if (N <= 64) {
    SCAN_V1_BWD_LAUNCH(64);
  }
#undef SCAN_V1_BWD_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success).  is_bf16 selects the type of u, delta, B, C and
// dy; every output is fp32.
extern "C" int selective_scan_v1_bwd(const void* u, const void* delta,
                                     const void* A, const void* B,
                                     const void* C, const void* D,
                                     const void* bias, const void* xsave,
                                     const void* dy, void* du, void* ddelta,
                                     void* dB_part, void* dC_part,
                                     void* dA_part, void* dD_part,
                                     void* dbias_part, int G, int L, int Dm,
                                     int K, int N, int T, int is_bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return static_cast<int>(launch<__nv_bfloat16>(
        u, delta, A, B, C, D, bias, xsave, dy, du, ddelta, dB_part, dC_part,
        dA_part, dD_part, dbias_part, G, L, Dm, K, N, T, s));
  }
  return static_cast<int>(launch<float>(
      u, delta, A, B, C, D, bias, xsave, dy, du, ddelta, dB_part, dC_part,
      dA_part, dD_part, dbias_part, G, L, Dm, K, N, T, s));
}

extern "C" const char* selective_scan_v1_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
