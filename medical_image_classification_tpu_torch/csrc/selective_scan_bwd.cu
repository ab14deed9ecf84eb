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
// sums over the batch as bwd_folded_v2 does.  `scratch` holds the adjoint's
// chunk carries [G, nT, N, Dm], the chunk sums of dt [G, nT, Dm] and the
// per-block parameter partials [G, ceil(nT / kGroup), N + 2, Dm], fp32.
//
// What bounds it on this card: the exps on the MUFU units and the CUDA-core
// arithmetic.  The function needs one exp per (step, channel, state) for
// the adjoint's decay (154 M at MedMamba stage 0: G 32, L 3136, Dm 96,
// N 16; 0.037 ms at 16 a clock on 132 SMs) and ~20 fp32 operations per
// (step, channel, state); it moves ~150 MB in bf16 with xsave.  Nothing is
// a matrix product (A is diagonal per (d, n)): the tensor cores have no
// part; what matters is warps in flight, MUFU exps and bytes.
//
// Design: the two-level scan of the forward, in adjoint order.  Over a
// chunk the adjoint is affine in the carry entering it from the later side
// q_c: g_i = g0_i + (prod_{j > i} a_j) q_c, and what leaves the chunk is
// a_first g_first = h_c + exp(A sum(dt_c)) q_c, with h_c the chunk's walk
// from q = 0.  So four launches:
//   (a) bwd_local_kernel: every chunk walks its adjoint from zero in
//       parallel (no state needed: g0 uses only C, dy and the decays), one
//       thread per (g, channel, chunk) with its N states in registers, and
//       writes h_c and the chunk's sum of dt;
//   (b) the carry pass (chunk_carry_kernel) in adjoint order, seeded by
//       dlast: the carry entering each chunk; its end is dinit;
//   (c) bwd_final_kernel: every chunk recomputes its states from xsave and
//       walks its adjoint from the true carry, emitting du, ddelta, the dB
//       and dC partials and the per-block dA, dD and dbias partials;
//   (d) bwd_sum_kernel adds the per-block partials of (c) in a fixed order.
// Residency, the design target of (c): the one-level kernel kept a chunk's
// states in shared memory (T x N x 32 channels x 4 B, 84 KB a one-warp
// block, 2 warps an SM).  Here N is split across warps: a block covers 32
// channels (the lanes) of one sequence, each warp 4 of the states, so a
// thread keeps its chunk's states in registers (kChunk x 4 = 64 floats,
// fully unrolled walks), and the block walks kGroup chunks in turn.
// ptxas holds it to 128 registers (__launch_bounds__), 16 warps an SM; (a)
// stages dt and dy in shared memory and runs at 64 registers, 32 warps.
// The sums over the states (du, ddelta) go through shared memory, one
// partial per warp, added in warp order; the sums over the block's
// channels (dB, dC) by a warp-shuffle reduce-scatter of the 8 values per
// lane and step (9 shuffles, scan2l::lane_reduce_scatter), so no block
// barrier sits inside a walk.  Two states a thread (32 registers of
// states, 24 warps an SM) measured slower: the reduce-scatter and the
// staged rows cost more per state.
//
// What is left: (c) is bound by the latency of each step's chain (the
// shuffles and the exps), at 16 warps an SM; it spends two exps per (step,
// channel, state) where the function needs one (the recompute's and the
// adjoint's decay), (a) a third; the chunk carries and partials cross
// device memory.  Later work: fewer instructions per step in (c), and the
// four directions' adjoints in one launch.

#include "selective_scan_common.cuh"

namespace {

using scan2l::exp2_ftz;
using scan2l::from_f32;
using scan2l::kChunk;
using scan2l::kLog2e;
using scan2l::softplus_f32;
using scan2l::to_f32;

constexpr int kWarps = 4;    // chunks per block of the local pass
constexpr int kStates = 4;   // states per thread in the last pass (a float4)
constexpr int kFinalWarps = 16;  // resident warps an SM the last pass needs
constexpr int kGroup = 4;    // chunks per block of the last pass
constexpr int kSumThreads = 256;
// values per lane and step that the dB/dC reduce-scatter spreads over the
// lanes (dB then dC for the thread's states), and the lane bits it splits
constexpr int kVals = 2 * kStates;
constexpr int kSplit = 3;  // log2(kVals)

// the thread's kStates consecutive floats from shared memory, one load
__device__ __forceinline__ void load_states(const float* p,
                                            float (&v)[kStates]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// (a): the adjoint of each chunk from a zero carry, written into q (the
// carry pass turns it into the carry entering each chunk), and the chunk's
// sum of dt.
template <typename T, int NMAX>
__global__ void __launch_bounds__(32 * kWarps, scan2l::walk_min_blocks<NMAX>())
    bwd_local_kernel(
    const T* __restrict__ delta, const float* __restrict__ A,
    const T* __restrict__ Cm, const float* __restrict__ bias,
    const T* __restrict__ dy, float* __restrict__ q, float* __restrict__ sdt,
    int L, int Dm, int K, int N, int nchunks, int ntiles, bool reverse,
    bool softplus) {
  __shared__ __align__(16) float sC[kWarps][kChunk][NMAX];
  __shared__ float sDt[kWarps][kChunk][32];
  __shared__ float sDy[kWarps][kChunk][32];

  const int g = blockIdx.y;
  const int tile = blockIdx.x % ntiles;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ci = (blockIdx.x / ntiles) * kWarps + warp;
  if (ci >= nchunks) return;  // a whole warp; nothing syncs the block
  const int d = tile * 32 + lane;
  const bool active = d < Dm;
  const int dp = active ? d : 0;
  const int k = g % K;
  const int t0 = ci * kChunk;
  const int tl = min(kChunk, L - t0);
  const size_t row0 = static_cast<size_t>(g) * L + t0;

  for (int i = lane; i < kChunk * NMAX; i += 32) {
    const int r = i / NMAX;
    const int n = i - r * NMAX;
    sC[warp][r][n] = (r < tl && n < N) ? to_f32(Cm[(row0 + r) * N + n]) : 0.f;
  }
  const float dbias = bias[k * Dm + dp];
#pragma unroll
  for (int r = 0; r < kChunk; ++r) {
    float v = 0.f, dd = 0.f;
    if (r < tl && active) {
      const size_t off = (row0 + r) * Dm + d;
      v = to_f32(delta[off]);
      dd = to_f32(dy[off]);
    }
    v += dbias;
    sDt[warp][r][lane] = softplus ? softplus_f32(v) : v;
    sDy[warp][r][lane] = dd;
  }
  float a2[NMAX], gc[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a2[n] = n < N ? A[(static_cast<size_t>(k) * Dm + dp) * N + n] * kLog2e
                  : 0.f;
    gc[n] = 0.f;
  }
  __syncwarp();

  float sum_dt = 0.f;
  for (int s = tl - 1; s >= 0; --s) {
    const int r = reverse ? tl - 1 - s : s;
    const float dt = sDt[warp][r][lane];
    const float dyv = sDy[warp][r][lane];
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      gc[n] = exp2_ftz(dt * a2[n]) * (sC[warp][r][n] * dyv + gc[n]);
    }
    sum_dt += dt;
  }
  if (active) {
    const size_t q0 = (static_cast<size_t>(g) * nchunks + ci) * N * Dm + d;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) q[q0 + static_cast<size_t>(n) * Dm] = gc[n];
    }
    sdt[(static_cast<size_t>(g) * nchunks + ci) * Dm + d] = sum_dt;
  }
}

// dynamic shared memory of the last pass: B, C rows [kChunk][NMAX]; dt,
// sigmoid, u, dy [kChunk][32]; the per-warp sums over states [NG][kChunk][32]
// of g.B and g.(x - b).A
template <int NMAX>
constexpr size_t final_smem_bytes() {
  return sizeof(float) * (2 * kChunk * NMAX + 4 * kChunk * 32 +
                          2 * (NMAX / kStates) * kChunk * 32);
}

template <int NMAX>
__host__ __device__ constexpr int final_threads() {
  return NMAX / kStates * 32;
}

// blocks of the last pass an SM must hold for kFinalWarps warps; ptxas caps
// the registers a thread to fit them
template <int NMAX>
__host__ __device__ constexpr int final_min_blocks() {
  return kFinalWarps * 32 / final_threads<NMAX>();
}

// (c): per block 32 channels of one sequence and kGroup chunks; warp w
// holds states [kStates w, kStates (w + 1)) of the lane's channel.
template <typename T, int NMAX>
__global__ void __launch_bounds__(final_threads<NMAX>(),
                                  final_min_blocks<NMAX>())
    bwd_final_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ Dskip,
                     const float* __restrict__ bias,
                     const float* __restrict__ xsave, const T* __restrict__ dy,
                     const float* __restrict__ q, T* __restrict__ du,
                     T* __restrict__ ddelta, float* __restrict__ dB_part,
                     float* __restrict__ dC_part, float* __restrict__ part,
                     int G, int L, int Dm, int K, int N, int nchunks,
                     int ntiles, bool reverse, bool softplus) {
  constexpr int NG = NMAX / kStates;
  constexpr int NT = NG * 32;
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;                    // [kChunk][NMAX]
  float* sC = sB + kChunk * NMAX;      // [kChunk][NMAX]
  float* sDt = sC + kChunk * NMAX;     // [kChunk][32]
  float* sSig = sDt + kChunk * 32;     // sigmoid(delta + bias), or 1
  float* sU = sSig + kChunk * 32;
  float* sDy = sU + kChunk * 32;
  float* sGB = sDy + kChunk * 32;      // [NG][kChunk][32]
  float* sGX = sGB + NG * kChunk * 32;

  const int g = blockIdx.y;
  const int tile = blockIdx.x % ntiles;
  const int grp = blockIdx.x / ntiles;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int d = tile * 32 + lane;
  const bool active = d < Dm;
  const int dp = active ? d : 0;
  const int k = g % K;
  const int n0 = w * kStates;

  // A, and A * log2(e) so that exp(dt * A) = exp2(dt * a2) as in the forward
  float Av[kStates], a2[kStates], dA[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    const int n = n0 + j;
    Av[j] = n < N ? A[(static_cast<size_t>(k) * Dm + dp) * N + n] : 0.f;
    a2[j] = Av[j] * kLog2e;
    dA[j] = 0.f;
  }
  const float dskip = Dskip[k * Dm + dp];
  const float dbias = bias[k * Dm + dp];
  float dD_acc = 0.f, dbias_acc = 0.f;
  const size_t part0 = (static_cast<size_t>(tile) * G + g) * L;
  // this lane's reduce-scatter slot: value lane >> (5 - kSplit) of the
  // kVals (dB for the thread's states, then dC), summed over the warp's 32
  // channels
  const int red_i = lane >> (5 - kSplit);
  const int red_n = n0 + red_i % kStates;
  float* red_out = red_i < kStates ? dB_part : dC_part;
  const bool red_writes =
      (lane & ((1 << (5 - kSplit)) - 1)) == 0 && red_n < N;

  const int c_end = min(grp * kGroup + kGroup, nchunks);
  for (int ci = grp * kGroup; ci < c_end; ++ci) {
    const int t0 = ci * kChunk;
    const int tl = min(kChunk, L - t0);
    const size_t row0 = static_cast<size_t>(g) * L + t0;
    for (int i = threadIdx.x; i < kChunk * NMAX; i += NT) {
      const int r = i / NMAX;
      const int n = i - r * NMAX;
      const bool in = r < tl && n < N;
      const size_t off = (row0 + r) * N + n;
      sB[i] = in ? to_f32(Bm[off]) : 0.f;
      sC[i] = in ? to_f32(Cm[off]) : 0.f;
    }
    // rows of the lane's own channel (NT is a multiple of 32); idle lanes
    // (d >= Dm) hold u = dy = 0 and a zero state and carry, so every sum
    // over the block's channels takes exact zeros from them
    for (int i = threadIdx.x; i < kChunk * 32; i += NT) {
      const int r = i >> 5;
      float v = 0.f, uu = 0.f, dyv = 0.f;
      if (r < tl && active) {
        const size_t off = (row0 + r) * Dm + d;
        v = to_f32(delta[off]);
        uu = to_f32(u[off]);
        dyv = to_f32(dy[off]);
      }
      v += dbias;
      sDt[i] = softplus ? softplus_f32(v) : v;
      sSig[i] = softplus ? 1.f / (1.f + expf(-v)) : 1.f;
      sU[i] = uu;
      sDy[i] = dyv;
    }
    __syncthreads();

    // the chunk's states at each scan position, from the state entering it
    const size_t st0 =
        (static_cast<size_t>(g) * nchunks + ci) * N * Dm + dp;
    float x[kStates], gc[kStates];
#pragma unroll
    for (int j = 0; j < kStates; ++j) {
      const bool ok = active && n0 + j < N;
      x[j] = ok ? xsave[st0 + static_cast<size_t>(n0 + j) * Dm] : 0.f;
      gc[j] = ok ? q[st0 + static_cast<size_t>(n0 + j) * Dm] : 0.f;
    }
    // this lane's slot of the chunk's dB or dC rows
    float* red_row = red_out + (part0 + t0) * N + red_n;
    float xs[kChunk][kStates];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      if (s < tl) {
        const int r = reverse ? tl - 1 - s : s;
        const float dt = sDt[r * 32 + lane];
        const float dtu = dt * sU[r * 32 + lane];
        float bv[kStates];
        load_states(sB + r * NMAX + n0, bv);
#pragma unroll
        for (int j = 0; j < kStates; ++j) {
          x[j] = exp2_ftz(dt * a2[j]) * x[j] + dtu * bv[j];
          xs[s][j] = x[j];
        }
      }
    }

    // the adjoint, scan positions descending, from the carry entering the
    // chunk
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      if (s < tl) {
        const int r = reverse ? tl - 1 - s : s;
        const float dt = sDt[r * 32 + lane];
        const float uu = sU[r * 32 + lane];
        const float dyv = sDy[r * 32 + lane];
        const float dtu = dt * uu;
        float bv[kStates], cv[kStates];
        load_states(sB + r * NMAX + n0, bv);
        load_states(sC + r * NMAX + n0, cv);
        float gB = 0.f, gxA = 0.f, v[kVals];  // dB terms, then dC terms
#pragma unroll
        for (int j = 0; j < kStates; ++j) {
          const float gn = cv[j] * dyv + gc[j];
          const float gxa = gn * (xs[s][j] - dtu * bv[j]);  // g a_t x_prev
          gB += gn * bv[j];
          gxA += gxa * Av[j];
          dA[j] += gxa * dt;
          v[j] = gn * dtu;
          v[kStates + j] = dyv * xs[s][j];
          gc[j] = exp2_ftz(dt * a2[j]) * gn;
        }
        sGB[(w * kChunk + r) * 32 + lane] = gB;
        sGX[(w * kChunk + r) * 32 + lane] = gxA;
        // dB and dC: the kVals values summed over the 32 lanes, each lane
        // left with one
        const float red = scan2l::lane_reduce_scatter(v, lane);
        if (red_writes) red_row[r * N] = red;
      }
    }
    __syncthreads();

    // du and ddelta from the warps' sums over their states, in warp order;
    // this thread's rows r = w, w + NG, ... of its lane's channel
    for (int i = threadIdx.x; i < tl * 32; i += NT) {
      const int r = i >> 5;
      float gB = 0.f, gx = 0.f;
#pragma unroll
      for (int ww = 0; ww < NG; ++ww) {
        gB += sGB[(ww * kChunk + r) * 32 + lane];
        gx += sGX[(ww * kChunk + r) * 32 + lane];
      }
      const float dyv = sDy[i];
      const float uu = sU[i];
      const float dd = sSig[i] * (gx + uu * gB);
      if (active) {
        const size_t off = (row0 + r) * Dm + d;
        du[off] = from_f32<T>(sDt[i] * gB + dskip * dyv);
        ddelta[off] = from_f32<T>(dd);
      }
      dbias_acc += dd;
      dD_acc += dyv * uu;
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }

  // the block's partials: dA per thread, dD and dbias over the warps
  sGB[w * 32 + lane] = dD_acc;
  sGX[w * 32 + lane] = dbias_acc;
  __syncthreads();
  if (active) {
    const int ngroups = (nchunks + kGroup - 1) / kGroup;
    const size_t p0 = (static_cast<size_t>(g) * ngroups + grp) * (N + 2) * Dm;
#pragma unroll
    for (int j = 0; j < kStates; ++j) {
      if (n0 + j < N) part[p0 + static_cast<size_t>(n0 + j) * Dm + d] = dA[j];
    }
    if (w == 0) {
      float sD = 0.f, sb = 0.f;
#pragma unroll
      for (int ww = 0; ww < NG; ++ww) {
        sD += sGB[ww * 32 + lane];
        sb += sGX[ww * 32 + lane];
      }
      part[p0 + static_cast<size_t>(N) * Dm + d] = sD;
      part[p0 + static_cast<size_t>(N + 1) * Dm + d] = sb;
    }
  }
}

// (d): the per-block partials [G, ngroups, N + 2, Dm] summed over the
// blocks in order into dA_part [G, N, Dm], dD_part and dbias_part [G, Dm]
__global__ void __launch_bounds__(kSumThreads)
    bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ dA_part,
                   float* __restrict__ dD_part,
                   float* __restrict__ dbias_part, int Dm, int N,
                   int ngroups) {
  const int g = blockIdx.y;
  const int i = blockIdx.x * kSumThreads + threadIdx.x;  // j * Dm + d
  const int width = (N + 2) * Dm;
  if (i >= width) return;
  const float* p = part + static_cast<size_t>(g) * ngroups * width + i;
  float s = 0.f;
  for (int grp = 0; grp < ngroups; ++grp) {
    s += p[static_cast<size_t>(grp) * width];
  }
  const int j = i / Dm;
  if (j < N) {
    dA_part[static_cast<size_t>(g) * N * Dm + i] = s;
  } else {
    float* out = j == N ? dD_part : dbias_part;
    out[static_cast<size_t>(g) * Dm + (i - j * Dm)] = s;
  }
}

template <typename T, int NMAX>
cudaError_t launch_n(const T* u, const T* delta, const float* A, const T* B,
                     const T* C, const float* D, const float* bias,
                     const float* xsave, const T* dy, const float* dlast,
                     T* du, T* ddelta, float* dB_part, float* dC_part,
                     float* dA_part, float* dD_part, float* dbias_part,
                     float* dinit, float* scratch, long long scratch_floats,
                     int G, int L, int Dm, int K, int N, bool reverse,
                     bool softplus, cudaStream_t stream) {
  const int nchunks = (L + kChunk - 1) / kChunk;
  const int ntiles = (Dm + 31) / 32;
  const int ngroups = (nchunks + kGroup - 1) / kGroup;
  const size_t nq = static_cast<size_t>(G) * nchunks * N * Dm;
  const size_t nsdt = static_cast<size_t>(G) * nchunks * Dm;
  const size_t npart = static_cast<size_t>(G) * ngroups * (N + 2) * Dm;
  if (scratch_floats < 0 ||
      static_cast<size_t>(scratch_floats) < nq + nsdt + npart) {
    return cudaErrorInvalidValue;
  }
  float* q = scratch;
  float* sdt = q + nq;
  float* part = sdt + nsdt;

  const dim3 grid_local(ntiles * ((nchunks + kWarps - 1) / kWarps), G);
  bwd_local_kernel<T, NMAX><<<grid_local, 32 * kWarps, 0, stream>>>(
      delta, A, C, bias, dy, q, sdt, L, Dm, K, N, nchunks, ntiles, reverse,
      softplus);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = scan2l::launch_carry<true>(A, q, sdt, dlast, dinit, G, Dm, K, N,
                                   nchunks, reverse, stream);
  if (err != cudaSuccess) return err;

  constexpr size_t bytes = final_smem_bytes<NMAX>();
  // above 48 KB a block gets dynamic shared memory only on request
  err = cudaFuncSetAttribute(bwd_final_kernel<T, NMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid_final(ntiles * ngroups, G);
  bwd_final_kernel<T, NMAX><<<grid_final, final_threads<NMAX>(), bytes,
                              stream>>>(
      u, delta, A, B, C, D, bias, xsave, dy, q, du, ddelta, dB_part, dC_part,
      part, G, L, Dm, K, N, nchunks, ntiles, reverse, softplus);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_sum(((N + 2) * Dm + kSumThreads - 1) / kSumThreads, G);
  bwd_sum_kernel<<<grid_sum, kSumThreads, 0, stream>>>(
      part, dA_part, dD_part, dbias_part, Dm, N, ngroups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* bias, const void* xsave, const void* dy,
                   const void* dlast, void* du, void* ddelta, void* dB_part,
                   void* dC_part, void* dA_part, void* dD_part,
                   void* dbias_part, void* dinit, void* scratch,
                   long long scratch_floats, int G, int L, int Dm, int K,
                   int N, bool reverse, bool softplus, cudaStream_t stream) {
#define SCAN_BWD_LAUNCH(NM)                                                  \
  return launch_n<T, NM>(                                                    \
      static_cast<const T*>(u), static_cast<const T*>(delta),                \
      static_cast<const float*>(A), static_cast<const T*>(B),                \
      static_cast<const T*>(C), static_cast<const float*>(D),                \
      static_cast<const float*>(bias), static_cast<const float*>(xsave),     \
      static_cast<const T*>(dy), static_cast<const float*>(dlast),           \
      static_cast<T*>(du), static_cast<T*>(ddelta),                          \
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),            \
      static_cast<float*>(dA_part), static_cast<float*>(dD_part),            \
      static_cast<float*>(dbias_part), static_cast<float*>(dinit),           \
      static_cast<float*>(scratch), scratch_floats, G, L, Dm, K, N, reverse, \
      softplus, stream)
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

template <typename T, int NMAX>
cudaError_t info_n(int* out) {
  constexpr size_t bytes = final_smem_bytes<NMAX>();
  cudaError_t err = scan2l::pass_info(bwd_local_kernel<T, NMAX>, 32 * kWarps,
                                      0, out);
  if (err == cudaSuccess) {
    err = scan2l::pass_info(scan2l::chunk_carry_kernel<true>,
                            scan2l::kCarryThreads, 0, out + 3);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bwd_final_kernel<T, NMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  }
  if (err == cudaSuccess) {
    err = scan2l::pass_info(bwd_final_kernel<T, NMAX>,
                            final_threads<NMAX>(), bytes, out + 6);
  }
  if (err == cudaSuccess) {
    err = scan2l::pass_info(bwd_sum_kernel, kSumThreads, 0, out + 9);
  }
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
// four passes (local, carry, final, sum) at d_state N: out[12].
extern "C" int selective_scan_bwd_pass_info(int N, int is_bf16, int* out) {
  return static_cast<int>(is_bf16 ? info<__nv_bfloat16>(N, out)
                                  : info<float>(N, out));
}

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launches (0 on success).  is_bf16 selects the type of u, delta, B, C,
// dy, du and ddelta; dlast and dinit may each be null.  `scratch` holds
// scratch_floats fp32 values, at least
//   G nT (N + 1) Dm + G ceil(nT / 4) (N + 2) Dm,   nT = ceil(L / chunk);
// `chunk` must equal the kernel's kChunk (xsave was sized by it).
extern "C" int selective_scan_bwd(const void* u, const void* delta,
                                  const void* A, const void* B, const void* C,
                                  const void* D, const void* bias,
                                  const void* xsave, const void* dy,
                                  const void* dlast, void* du, void* ddelta,
                                  void* dB_part, void* dC_part, void* dA_part,
                                  void* dD_part, void* dbias_part,
                                  void* dinit, void* scratch,
                                  long long scratch_floats, int G, int L,
                                  int Dm, int K, int N, int chunk,
                                  int is_bf16, int reverse, int softplus,
                                  void* stream) {
  if (chunk != kChunk || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return static_cast<int>(launch<__nv_bfloat16>(
        u, delta, A, B, C, D, bias, xsave, dy, dlast, du, ddelta, dB_part,
        dC_part, dA_part, dD_part, dbias_part, dinit, scratch, scratch_floats,
        G, L, Dm, K, N, reverse != 0, softplus != 0, s));
  }
  return static_cast<int>(launch<float>(
      u, delta, A, B, C, D, bias, xsave, dy, dlast, du, ddelta, dB_part,
      dC_part, dA_part, dD_part, dbias_part, dinit, scratch, scratch_floats,
      G, L, Dm, K, N, reverse != 0, softplus != 0, s));
}

extern "C" const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
