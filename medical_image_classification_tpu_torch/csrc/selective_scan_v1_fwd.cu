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
// What bounds it on this card: the exps on the MUFU units.  The function
// needs one exp(dt A) per (step, channel, state): at the kernel bench's
// stage 0 (G 128, L 3136, Dm 96, N 16, bf16, T 50) 617 M of them, 0.147 ms
// at 16 a clock on 132 SMs, against 306 MB moved (u, delta, y 231 MB, B and
// C 26 MB, xsave 50 MB; 0.092 ms at 3.35 TB/s) and ~7 fp32 operations per
// state and step.
//
// Design: one walk in time per state.  The recurrence has one FMA on its
// chain, so the parallelism comes from the G Dm N independent recurrences
// (196,608 at stage 0), not from time: the TPU body's doubling scan over
// the lanes spent 10 shuffles per state and 32 steps and ~5x the FMAs of a
// walk, and idled the lanes past a ragged piece.  A block covers 32
// channels of one sequence, one per lane, and all N states: warp w holds
// states [4 w, 4 w + 4) of its lane's channel in registers (one float4 of
// B and of C a step), so a block has N / 4 warps (4 at N 16: 384 blocks of
// 128 threads at stage 0, one wave).  Each thread walks its four states
// through all L steps: one ex2.approx.ftz, one multiply and two FMAs a
// state and step, and y's sum over its four states in a register; the
// warps' sums go to shared memory, and the block adds them in warp order
// when it writes a tile of y (32 consecutive channels a row, coalesced).
// Time goes in tiles of kTile steps, two buffers deep: while the block
// walks tile i from shared memory, each thread's loads of tile i + 1 (u,
// delta, B, C in their own type) are in flight in registers, and after the
// walk it stores them converted (dt = softplus(delta + bias) once per step
// and channel, u, B, C in fp32) into the other buffer: one barrier a tile.
// (cp.async would land the raw tiles and still need a converting pass, and
// rows of any Dm are not 16-byte aligned.)  A whole tile's steps are
// unrolled without a branch, each step's operands loaded a step ahead; a
// chunk boundary inside a tile is kept by a select and stored after it,
// the thread's four states, one float a lane on 32 consecutive channels,
// 128 bytes a warp store.
//
// What is left: on an H100 80GB HBM3 (700 W) the bench's stage 0 takes
// ~0.46 ms, 3x the MUFU time: taking the exps out, or the softplus,
// saved little, so the walk is bound by the latency of each step's chain
// at 12 warps an SM (the grid's 1,536 warps over 132 SMs).  Two states a
// thread (24 warps an SM) measured slower: each step's loads and y's
// store then serve half the states.

#include "selective_scan_common.cuh"

namespace {

using scan2l::exp2_ftz;
using scan2l::from_f32;
using scan2l::kLog2e;
using scan2l::softplus_f32;
using scan2l::to_f32;

constexpr int kStates = 4;   // states a thread: one float4 of B and of C
constexpr int kTile = 16;    // timesteps a staged tile

template <int NMAX>
__host__ __device__ constexpr int fwd_threads() {
  return NMAX / kStates * 32;
}

// blocks an SM must hold: 24 warps, so ptxas keeps a thread within 85
// registers
template <int NMAX>
__host__ __device__ constexpr int fwd_min_blocks() {
  return 768 / fwd_threads<NMAX>() > 0 ? 768 / fwd_threads<NMAX>() : 1;
}

// one buffer of a tile: dt, u [kTile][32]; B, C [kTile][NMAX] (fp32)
template <int NMAX>
__host__ __device__ constexpr int tile_floats() {
  return 2 * kTile * 32 + 2 * kTile * NMAX;
}

// dynamic shared memory: two tile buffers, then y's per-warp sums over
// their states [2][NMAX / states][kTile][32]
template <int NMAX>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) *
         (2 * tile_floats<NMAX>() + 2 * (NMAX / kStates) * kTile * 32);
}

// A step's operands from the staged tile: dt and u of the lane's channel,
// B and C of the thread's four states.
struct StepIn {
  float dt, u;
  float4 b, c;
};

template <int NMAX>
__device__ __forceinline__ StepIn load_step(int s, const float* sDt,
                                            const float* sU, const float* sB,
                                            const float* sC, int lane,
                                            int n0) {
  return {sDt[s * 32 + lane], sU[s * 32 + lane],
          *reinterpret_cast<const float4*>(sB + s * NMAX + n0),
          *reinterpret_cast<const float4*>(sC + s * NMAX + n0)};
}

// one step of the walk: the thread's four states through step s, and their
// share of y (D u in warp 0's) into yp
__device__ __forceinline__ void walk_step(int s, const StepIn& in, int lane,
                                          const float (&a2)[kStates],
                                          float dskip, float (&x)[kStates],
                                          float* yp) {
  const float dtu = in.dt * in.u;
  const float b[kStates] = {in.b.x, in.b.y, in.b.z, in.b.w};
  const float c[kStates] = {in.c.x, in.c.y, in.c.z, in.c.w};
  float acc = dskip * in.u;
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    x[j] = fmaf(exp2_ftz(in.dt * a2[j]), x[j], dtu * b[j]);
    acc = fmaf(c[j], x[j], acc);
  }
  yp[s * 32 + lane] = acc;
}

// the thread's states v as the state entering chunk c: 32 consecutive
// channels a warp store
__device__ __forceinline__ void save_state(float* xsave, int g, int nchunks,
                                           int c, int N, int n0, int Dm,
                                           int d, const float (&v)[kStates]) {
  float* xc = xsave + (static_cast<size_t>(g * nchunks + c) * N + n0) * Dm + d;
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    if (n0 + j < N) xc[static_cast<size_t>(j) * Dm] = v[j];
  }
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(fwd_threads<NMAX>(), fwd_min_blocks<NMAX>())
    scan_v1_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                       const float* __restrict__ A, const T* __restrict__ Bm,
                       const T* __restrict__ Cm,
                       const float* __restrict__ Dskip,
                       const float* __restrict__ bias, T* __restrict__ y,
                       float* __restrict__ xsave, int L, int Dm, int K, int N,
                       int Tc) {
  constexpr int NG = NMAX / kStates;
  constexpr int NT = NG * 32;
  constexpr int kUV = kTile * 32 / NT;    // u and delta values a thread stages
  constexpr int kBC = kTile * NMAX / NT;  // B and C values a thread stages
  constexpr int kBuf = tile_floats<NMAX>();
  static_assert(kUV >= 1 && kTile * 32 % NT == 0 && kTile * NMAX % NT == 0,
                "a tile is staged in whole rounds of the block");
  extern __shared__ __align__(16) float smem[];
  float* sYp = smem + 2 * kBuf;           // [2][NG][kTile][32]

  const int g = blockIdx.y;
  const int k = g % K;
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int d = blockIdx.x * 32 + lane;
  const bool active = d < Dm;
  const int dp = active ? d : 0;          // in-bounds channel for parameters
  const int n0 = w * kStates;
  const size_t row0 = static_cast<size_t>(g) * L;

  // A * log2(e), so that exp(dt * A) = exp2(dt * a2); states past N keep
  // a2 = 0 and B = 0, so they stay 0
  float a2[kStates], x[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    const int n = n0 + j;
    a2[j] = n < N ? A[(static_cast<size_t>(k) * Dm + dp) * N + n] * kLog2e
                  : 0.f;
    x[j] = 0.f;
  }
  const float dbias = bias[k * Dm + dp];
  const float dskip = w == 0 ? Dskip[k * Dm + dp] : 0.f;  // D u once a step

  const int ntiles = (L + kTile - 1) / kTile;
  const int nchunks = (L + Tc - 1) / Tc;
  int next_save = xsave != nullptr ? 0 : L;  // the next chunk's first step

  // the values of a tile this thread stages: u and delta on rows
  // w + e NG of its lane's channel; B and C at i = tid + e NT of [kTile][NMAX]
  T ru[kUV], rd[kUV], rb[kBC], rc[kBC];
  for (int i = -1; i < ntiles; ++i) {
    if (i + 1 < ntiles) {  // tile i + 1's loads, in flight through the walk
      const int t0 = (i + 1) * kTile;
#pragma unroll
      for (int e = 0; e < kUV; ++e) {
        const int t = t0 + w + e * NG;
        const bool ok = t < L && active;
        const size_t off = (row0 + t) * Dm + d;
        ru[e] = ok ? u[off] : from_f32<T>(0.f);
        rd[e] = ok ? delta[off] : from_f32<T>(0.f);
      }
#pragma unroll
      for (int e = 0; e < kBC; ++e) {
        const int idx = tid + e * NT;
        const int t = t0 + idx / NMAX;
        const int n = idx % NMAX;
        const bool ok = t < L && n < N;
        const size_t off = (row0 + t) * N + n;
        rb[e] = ok ? Bm[off] : from_f32<T>(0.f);
        rc[e] = ok ? Cm[off] : from_f32<T>(0.f);
      }
    }
    if (i >= 0) {
      __syncthreads();  // tile i is stored; y's sums of tile i - 2 written
      const float* sDt = smem + (i & 1) * kBuf;
      const float* sU = sDt + kTile * 32;
      const float* sB = sU + kTile * 32;
      const float* sC = sB + kTile * NMAX;
      float* yp = sYp + ((i & 1) * NG + w) * kTile * 32;
      const int t0 = i * kTile;
      const int tl = min(kTile, L - t0);
      // The whole-tile paths load step s + 1's operands before step s
      // stores its share of y: the compiler keeps a load after a store to
      // shared memory it cannot tell apart, and would wait out each step's
      // loads otherwise.
      if (tl == kTile && next_save >= t0 + kTile) {
        // no chunk begins in the tile: the steps unrolled, no branch
        StepIn in = load_step<NMAX>(0, sDt, sU, sB, sC, lane, n0);
#pragma unroll
        for (int s = 0; s < kTile; ++s) {
          const StepIn cur = in;
          if (s + 1 < kTile) {
            in = load_step<NMAX>(s + 1, sDt, sU, sB, sC, lane, n0);
          }
          walk_step(s, cur, lane, a2, dskip, x, yp);
        }
      } else if (tl == kTile && Tc >= kTile) {
        // one chunk begins in the tile, at step sb: its entering state is
        // kept by a select a step, and stored after the tile
        const int sb = next_save - t0;
        float xb[kStates] = {};
        StepIn in = load_step<NMAX>(0, sDt, sU, sB, sC, lane, n0);
#pragma unroll
        for (int s = 0; s < kTile; ++s) {
          const StepIn cur = in;
          if (s + 1 < kTile) {
            in = load_step<NMAX>(s + 1, sDt, sU, sB, sC, lane, n0);
          }
#pragma unroll
          for (int j = 0; j < kStates; ++j) xb[j] = s == sb ? x[j] : xb[j];
          walk_step(s, cur, lane, a2, dskip, x, yp);
        }
        if (active) {
          save_state(xsave, g, nchunks, next_save / Tc, N, n0, Dm, d, xb);
        }
        next_save += Tc;
      } else {
        // the last tile, or chunks shorter than a tile: a step at a time
        for (int s = 0; s < tl; ++s) {
          if (t0 + s == next_save) {  // the state entering the chunk
            if (active) {
              save_state(xsave, g, nchunks, next_save / Tc, N, n0, Dm, d, x);
            }
            next_save += Tc;
          }
          walk_step(s, load_step<NMAX>(s, sDt, sU, sB, sC, lane, n0), lane,
                    a2, dskip, x, yp);
        }
      }
      if (i > 0) {  // y of tile i - 1: the warps' sums in warp order
        const float* yq = sYp + ((i - 1) & 1) * NG * kTile * 32;
        const int tp = (i - 1) * kTile;
        for (int idx = tid; idx < kTile * 32; idx += NT) {
          const int s = idx >> 5;            // idx & 31 is the lane
          float v = 0.f;
#pragma unroll
          for (int ww = 0; ww < NG; ++ww) {
            v += yq[(ww * kTile + s) * 32 + lane];
          }
          if (active) y[(row0 + tp + s) * Dm + d] = from_f32<T>(v);
        }
      }
    }
    if (i + 1 < ntiles) {  // tile i + 1 converted into the other buffer
      float* sDt = smem + ((i + 1) & 1) * kBuf;
      float* sU = sDt + kTile * 32;
      float* sB = sU + kTile * 32;
      float* sC = sB + kTile * NMAX;
#pragma unroll
      for (int e = 0; e < kUV; ++e) {
        const int r = w + e * NG;
        sDt[r * 32 + lane] = softplus_f32(to_f32(rd[e]) + dbias);
        sU[r * 32 + lane] = to_f32(ru[e]);
      }
#pragma unroll
      for (int e = 0; e < kBC; ++e) {
        sB[tid + e * NT] = to_f32(rb[e]);
        sC[tid + e * NT] = to_f32(rc[e]);
      }
    }
  }
  __syncthreads();
  {  // y of the last tile
    const float* yq = sYp + ((ntiles - 1) & 1) * NG * kTile * 32;
    const int tp = (ntiles - 1) * kTile;
    const int tl = L - tp;
    for (int idx = tid; idx < tl * 32; idx += NT) {
      const int s = idx >> 5;
      float v = 0.f;
#pragma unroll
      for (int ww = 0; ww < NG; ++ww) v += yq[(ww * kTile + s) * 32 + lane];
      if (active) y[(row0 + tp + s) * Dm + d] = from_f32<T>(v);
    }
  }
}

template <typename T, int NMAX>
cudaError_t allow_smem() {
  // above 48 KB a block gets dynamic shared memory only on request
  return cudaFuncSetAttribute(scan_v1_fwd_kernel<T, NMAX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(fwd_smem_bytes<NMAX>()));
}

template <typename T, int NMAX>
cudaError_t launch_n(const dim3 grid, const void* u, const void* delta,
                     const void* A, const void* B, const void* C,
                     const void* D, const void* bias, void* y, float* xsave,
                     int L, int Dm, int K, int N, int Tc,
                     cudaStream_t stream) {
  cudaError_t err = allow_smem<T, NMAX>();
  if (err != cudaSuccess) return err;
  scan_v1_fwd_kernel<T, NMAX>
      <<<grid, fwd_threads<NMAX>(), fwd_smem_bytes<NMAX>(), stream>>>(
          static_cast<const T*>(u), static_cast<const T*>(delta),
          static_cast<const float*>(A), static_cast<const T*>(B),
          static_cast<const T*>(C), static_cast<const float*>(D),
          static_cast<const float*>(bias), static_cast<T*>(y), xsave, L, Dm,
          K, N, Tc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* bias, void* y, float* xsave, int G, int L,
                   int Dm, int K, int N, int Tc, cudaStream_t stream) {
  if (Tc < 1 || L < 1 || Dm < 1 || N < 1 || K < 1 || G < 1 || G > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((Dm + 31) / 32, G);
#define SCAN_V1_LAUNCH(NM)                                                  \
  return launch_n<T, NM>(grid, u, delta, A, B, C, D, bias, y, xsave, L, Dm, \
                         K, N, Tc, stream)
  if (N <= 8) {
    SCAN_V1_LAUNCH(8);
  } else if (N <= 16) {
    SCAN_V1_LAUNCH(16);
  } else if (N <= 32) {
    SCAN_V1_LAUNCH(32);
  } else if (N <= 64) {
    SCAN_V1_LAUNCH(64);
  }
#undef SCAN_V1_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename T, int NMAX>
cudaError_t info_n(int* out) {
  cudaError_t err = allow_smem<T, NMAX>();
  if (err != cudaSuccess) return err;
  return scan2l::pass_info_shared(scan_v1_fwd_kernel<T, NMAX>,
                                  fwd_threads<NMAX>(), fwd_smem_bytes<NMAX>(),
                                  out);
}

template <typename T>
cudaError_t info(int N, int* out) {
  if (N < 1) return cudaErrorInvalidValue;
  if (N <= 8) return info_n<T, 8>(out);
  if (N <= 16) return info_n<T, 16>(out);
  if (N <= 32) return info_n<T, 32>(out);
  if (N <= 64) return info_n<T, 64>(out);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success).  is_bf16 selects the type of u, delta, B, C, y;
// xsave may be null.  Refuses (cudaErrorInvalidValue) T, L, Dm, N, K or G
// below 1, G above 65535 and N above 64.
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

// What the card grants the one pass (walk) at d_state N: out[0..3] =
// registers a thread, local (spill) bytes a thread, shared bytes a block,
// resident warps per SM.
extern "C" int selective_scan_v1_fwd_pass_info(int N, int is_bf16,
                                               int* out) {
  return static_cast<int>(is_bf16 ? info<__nv_bfloat16>(N, out)
                                  : info<float>(N, out));
}

extern "C" const char* selective_scan_v1_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
