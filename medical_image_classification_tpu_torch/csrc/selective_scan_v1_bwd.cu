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
// where a_t x_{t-1} = x_t - b_t comes straight from the recurrence.
//
// Layout: u, delta, dy [G, L, Dm] and B, C [G, L, N] in one type (fp32 or
// bf16); A [K, Dm, N], D, bias [K, Dm] fp32; xsave [G, ceil(L / T), N, Dm]
// fp32, the state entering each chunk as the forward wrote it (each chunk's
// states are recomputed from it, whatever it holds).  Outputs, all fp32 as
// bwd_folded returns them: du, ddelta [G, L, Dm]; dB, dC [P, G, L, N], one
// sum over each cluster's channels (P clusters a sequence, see below; the
// wrapper adds the P in order where P > 1); per sequence dA_part [G, N,
// Dm], dD_part, dbias_part [G, Dm], which the wrapper sums over the batch
// as bwd_folded does.  No atomics: a second launch gives the same bits.
//
// What bounds it on this card: bytes.  At the kernel bench's stage 0 (G
// 128, L 3136, Dm 96, N 16, bf16, T 50) the function moves about 665 MB (u,
// delta, dy, B, C and xsave in; du, ddelta, dB, dC out in fp32), 0.199 ms
// at 3.35 TB/s; its 617 M exps take 0.147 ms at the MUFU rate, the two this
// kernel spends per state and step 0.295 ms, and its ~20 fp32 operations
// per state and step 0.18 ms.
//
// Design: one sequential walk per state, as the forward's.  A block
// covers 32 groups<NMAX>() channels of one sequence and all N states: warp
// w of channel group q holds states [4 w, 4 w + 4) of channel 32 q + lane.
// At N <= 16 a block has three groups (96 channels, 12 warps at N 16), so
// the bench's Dm 96 is one block a sequence and its 128 sequences one
// wave.  The block walks the chunks last to first, each seeded from the
// xsave it is given:
//   1. the checkpoint walk: from xsave[c], forward over the chunk's pieces
//      of kPiece steps but the last, keeping the state entering each piece
//      in a global scratch slot of its own (written and read back by the
//      same thread; L2 holds them: 5.5 MB at stage 0);
//   2. the pieces last to first: the piece's states recomputed from its
//      checkpoint (loaded a piece ahead), x_t and a_t kept in registers
//      (kPiece x 4 of each), then the adjoint as a sequential sweep against
//      time, g_t = C_t dy_t + a_{t+1} g_{t+1} with the kept a: two exps per
//      state and step in all.
// du and ddelta need sums over the states: each warp's sum over its four
// goes to shared memory, added in warp order once a piece is swept (the
// sigmoid of delta + bias is 1 - exp(-dt) there).  dB and dC need sums
// over the channels: each step's 8 terms of a lane (4 states, dB and dC)
// are summed over the warp's 32 channels by the warp reduce-scatter
// (scan2l::lane_reduce_scatter, 9 shuffles) into a row a step and channel
// group in shared memory; once a window is swept the block adds its
// groups' rows, and the blocks of a thread-block cluster (up to 8) theirs
// in rank order through distributed shared memory, so each sequence's dB
// and dC are written once up to 768 channels at N <= 16 (256 above) and
// in ceil(Dm / 768) sums beyond (the first port wrote ceil(Dm / 8) fp32
// partials, more bytes than the outputs).  A chunk of up to kWinCap steps
// is one staged window: its raw rows (u, delta, dy, B, C in their own
// type) come in by cp.async while the chunk before it is walked, and are
// converted once (dt = softplus(delta + bias), fp32) when its turn comes;
// longer chunks stage each window while the block waits.  No chunk is too
// long: T sets only the scratch's size.
//
// What is left: on an H100 80GB HBM3 (700 W) the bench's stage 0 takes
// ~1.4 ms, 7x its bytes' time: the block issues about 30 instructions a
// state and step (the reduce-scatter a large share) at 12 warps an SM,
// bound by the latency of each step's chain; pieces of 4 steps measured
// no faster.  The first build, 32-channel blocks in clusters of 3, lost a
// wave to cluster placement (fewer clusters of 3 fit the card at once
// than the bench's 128) and waited out each window's loads.

#include <cooperative_groups.h>

#include <cstdint>

#include "selective_scan_common.cuh"

namespace {

namespace cg = cooperative_groups;
using scan2l::exp2_ftz;
using scan2l::from_f32;
using scan2l::kLog2e;
using scan2l::softplus_f32;
using scan2l::to_f32;

constexpr int kStates = 4;       // states a thread: one float4 of B and of C
constexpr int kVals = 2 * kStates;  // dB and dC terms a lane and step
constexpr int kPiece = 8;        // steps a piece: x and a in registers
constexpr int kWinCap = 56;      // steps a staged window at most
constexpr int kMaxCluster = 8;   // blocks a cluster
constexpr size_t kSmemLimit = 232448;  // bytes a block may have on sm_90

// channel groups of 32 a block: three at N <= 16 (a block of 96 channels,
// 12 warps at N 16: the bench's Dm 96 in one block, one wave of 128), one
// above (16 warps of 4 states at N 64)
template <int NMAX>
__host__ __device__ constexpr int groups() {
  return NMAX <= 16 ? 3 : 1;
}

template <int NMAX>
__host__ __device__ constexpr int bwd_threads() {
  return groups<NMAX>() * NMAX / kStates * 32;
}

// the steps a window stages: the chunk in whole pieces, at most kWinCap
__host__ __device__ constexpr int window_rows(int Tc) {
  const int whole = kPiece * ((Tc + kPiece - 1) / kPiece);
  return whole < kWinCap ? whole : kWinCap;
}

// dynamic shared memory of a block at chunk Tc: the staged window in fp32,
// dt, u, dy [rows][32 groups] and B, C [rows][NMAX]; the raw window in T
// (the next chunk's, in flight); the groups' dB and dC rows [groups][rows]
// [2 NMAX]; the warps' sums g.B and g.(x - b).A [2][2][groups NMAX / 4]
// [kPiece][32].  Tc sets only the rows, at most kWinCap: every chunk fits
// (209 KiB at most, at N 16 in fp32; launch_n asserts it)
template <typename T, int NMAX>
__host__ __device__ constexpr size_t bwd_smem_bytes(int Tc) {
  return static_cast<size_t>(window_rows(Tc)) *
             (3 * 32 * groups<NMAX>() + 2 * NMAX) *
             (sizeof(float) + sizeof(T)) +
         sizeof(float) * (static_cast<size_t>(window_rows(Tc)) *
                              groups<NMAX>() * 2 * NMAX +
                          4 * static_cast<size_t>(bwd_threads<NMAX>() / 32) *
                              kPiece * 32);
}

// the cluster barrier in two halves: arrive releases this thread's shared
// memory writes, wait acquires every other block's
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes (or the first `bytes` of them, the rest zero) from global to
// shared memory, in flight until cp_wait
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned sdst = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sdst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A sweep step's operands from the staged window: dt, u and dy of the
// thread's channel, B and C of its four states.
struct StepIn {
  float dt, u, dy;
  float4 b, c;
};

template <int NMAX>
__device__ __forceinline__ StepIn load_step(int r, const float* sDt,
                                            const float* sU, const float* sDy,
                                            const float* sB, const float* sC,
                                            int ch, int n0) {
  constexpr int CB = 32 * groups<NMAX>();
  return {sDt[r * CB + ch], sU[r * CB + ch], sDy[r * CB + ch],
          *reinterpret_cast<const float4*>(sB + r * NMAX + n0),
          *reinterpret_cast<const float4*>(sC + r * NMAX + n0)};
}

// One piece of the sweep, rows [r0, r0 + pl) of the staged window: its
// states and decays recomputed from its checkpoint ck, then the adjoint
// steps descending, carrying gc back and adding into dA; each step's warp
// sums g.B and g.(x - b).A into gbw, gxw and its group's dB/dC row into
// sPart.  kFull: pl is kPiece, so no step is guarded.  Each step's
// operands are loaded a step ahead: the compiler keeps a load after a
// store to shared memory it cannot tell apart.
template <bool kFull, int NMAX>
__device__ __forceinline__ void sweep_piece(
    float4 ck, int r0, int pl, const float* sDt, const float* sU,
    const float* sDy, const float* sB, const float* sC, float* gbw,
    float* gxw, float* sPart, int ch, int lane, int n0, int red_col,
    bool red_writes, const float (&a2)[kStates], const float (&Av)[kStates],
    float (&gc)[kStates], float (&dA)[kStates]) {
  constexpr int CB = 32 * groups<NMAX>();
  float xs[kPiece][kStates], as[kPiece][kStates];
  float xr[kStates] = {ck.x, ck.y, ck.z, ck.w};
#pragma unroll
  for (int s = 0; s < kPiece; ++s) {
    if (kFull || s < pl) {
      const int r = r0 + s;
      const float dt = sDt[r * CB + ch];
      const float dtu = dt * sU[r * CB + ch];
      const float4 bv = *reinterpret_cast<const float4*>(sB + r * NMAX + n0);
      const float bb[kStates] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < kStates; ++j) {
        as[s][j] = exp2_ftz(dt * a2[j]);
        xr[j] = fmaf(as[s][j], xr[j], dtu * bb[j]);
        xs[s][j] = xr[j];
      }
    }
  }
  const int s_last = kFull ? kPiece - 1 : pl - 1;
  StepIn in = load_step<NMAX>(r0 + s_last, sDt, sU, sDy, sB, sC, ch, n0);
#pragma unroll
  for (int s = kPiece - 1; s >= 0; --s) {
    if (kFull || s < pl) {
      const int r = r0 + s;
      const StepIn cur = in;
      if (s > 0) {
        in = load_step<NMAX>(r - 1, sDt, sU, sDy, sB, sC, ch, n0);
      }
      const float dt = cur.dt;
      const float dyv = cur.dy;
      const float dtu = dt * cur.u;
      const float bb[kStates] = {cur.b.x, cur.b.y, cur.b.z, cur.b.w};
      const float cc[kStates] = {cur.c.x, cur.c.y, cur.c.z, cur.c.w};
      float gB = 0.f, gxA = 0.f, v[kVals];
#pragma unroll
      for (int j = 0; j < kStates; ++j) {
        const float gn = fmaf(cc[j], dyv, gc[j]);
        const float gxa = gn * fmaf(-dtu, bb[j], xs[s][j]);  // g a_t x_{t-1}
        gB = fmaf(gn, bb[j], gB);
        gxA = fmaf(gxa, Av[j], gxA);
        dA[j] = fmaf(gxa, dt, dA[j]);
        v[j] = gn * dtu;
        v[kStates + j] = dyv * xs[s][j];
        gc[j] = as[s][j] * gn;
      }
      gbw[s * 32 + lane] = gB;
      gxw[s * 32 + lane] = gxA;
      const float red = scan2l::lane_reduce_scatter(v, lane);
      if (red_writes) sPart[r * 2 * NMAX + red_col] = red;
    }
  }
}

template <typename T, int NMAX>
__global__ void __launch_bounds__(bwd_threads<NMAX>(), 1)
    scan_v1_bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ delta,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dskip,
    const float* __restrict__ bias, const float* __restrict__ xsave,
    const T* __restrict__ dy, float* __restrict__ du,
    float* __restrict__ ddelta, float* __restrict__ dB,
    float* __restrict__ dC, float* __restrict__ dA_part,
    float* __restrict__ dD_part, float* __restrict__ dbias_part,
    float4* __restrict__ ckpt, int G, int L, int Dm, int K, int N, int Tc,
    bool aligned) {
  constexpr int NG = NMAX / kStates;      // state warps a channel group
  constexpr int NT = bwd_threads<NMAX>();
  constexpr int CB = 32 * groups<NMAX>();  // channels a block
  constexpr int kRow = 2 * NMAX;          // a dB/dC row: dB, then dC
  constexpr int kRaw = 3 * CB + 2 * NMAX;  // a raw window row, in T
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // T a 16-byte piece
  static_assert(NT % CB == 0, "a thread stages and flushes one channel");
  extern __shared__ __align__(16) float smem[];
  const int wr = window_rows(Tc);
  float* sDt = smem;                      // [wr][CB]
  float* sU = sDt + wr * CB;
  float* sDy = sU + wr * CB;
  float* sB = sDy + wr * CB;              // [wr][NMAX]
  float* sC = sB + wr * NMAX;
  T* rU = reinterpret_cast<T*>(sC + wr * NMAX);  // the raw window, in T
  T* rD = rU + wr * CB;
  T* rDy = rD + wr * CB;
  T* rB = rDy + wr * CB;
  T* rC = rB + wr * NMAX;
  // [groups][wr][kRow]
  float* sPart = reinterpret_cast<float*>(rU + wr * kRaw);
  float* sGB = sPart + groups<NMAX>() * wr * kRow;  // [2][NT / 32][kPiece][32]
  float* sGX = sGB + 2 * (NT / 32) * kPiece * 32;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.y;
  const int k = g % K;
  const int tid = threadIdx.x;
  const int wg = tid >> 5;                 // warp of the block
  const int grp = wg / NG;                 // its channel group
  const int w = wg - grp * NG;             // its states
  const int lane = tid & 31;
  const int ch = grp * 32 + lane;          // its channel in the block
  const int d0 = blockIdx.x * CB;
  const int d = d0 + ch;
  const bool active = d < Dm;
  const int dp = active ? d : 0;
  const int n0 = w * kStates;
  const size_t row0 = static_cast<size_t>(g) * L;
  const int nchunks = (L + Tc - 1) / Tc;
  const int npc = (Tc + kPiece - 1) / kPiece;
  float4* ck_blk = ckpt + (static_cast<size_t>(g) * gridDim.x + blockIdx.x) *
                              npc * NT + tid;
  // this cluster's dB and dC
  const size_t part = static_cast<size_t>(blockIdx.x / cs) * G * L * N;
  float* dBo = dB + part;
  float* dCo = dC + part;
  // the channel this thread stages and flushes (NT is a multiple of CB)
  const int fch = tid % CB;
  const int fd = d0 + fch;
  const bool factive = fd < Dm;
  const float fbias = bias[k * Dm + (factive ? fd : 0)];
  const float fskip = Dskip[k * Dm + (factive ? fd : 0)];

  float Av[kStates], a2[kStates], dA[kStates], gc[kStates];
#pragma unroll
  for (int j = 0; j < kStates; ++j) {
    const int n = n0 + j;
    Av[j] = n < N ? A[(static_cast<size_t>(k) * Dm + dp) * N + n] : 0.f;
    a2[j] = Av[j] * kLog2e;      // exp(dt A) = exp2(dt a2)
    dA[j] = 0.f;
    gc[j] = 0.f;                 // a_{t+1} g_{t+1}, carried back
  }
  float dD_acc = 0.f, dbias_acc = 0.f;  // of channel fch
  // this lane's slot of the reduce-scatter: value lane >> 2 of the 8 (dB
  // for the warp's states, then dC), complete where lane % 4 == 0
  const int red_i = lane >> 2;
  const int red_n = n0 + red_i % kStates;
  const int red_col = (red_i < kStates ? 0 : NMAX) + red_n;
  const bool red_writes = (lane & 3) == 0 && red_n < N;

  // the raw rows of a window of `rows` steps from step ts into rU ... rC:
  // cp.async pieces of 16 bytes where every row starts 16-byte aligned,
  // else plain copies; zeros past the rows, Dm and N
  auto issue_raw = [&](int ts, int rows) {
    if (aligned) {
      for (int e = tid; e < wr * (CB / V); e += NT) {
        const int r = e / (CB / V);
        const int c = (e - r * (CB / V)) * V;
        const int n_ok = r < rows ? min(max(Dm - d0 - c, 0), V) : 0;
        const size_t off = n_ok > 0 ? (row0 + ts + r) * Dm + d0 + c : 0;
        cp_async16(rU + r * CB + c, u + off, n_ok * sizeof(T));
        cp_async16(rD + r * CB + c, delta + off, n_ok * sizeof(T));
        cp_async16(rDy + r * CB + c, dy + off, n_ok * sizeof(T));
      }
      for (int e = tid; e < wr * (NMAX / V); e += NT) {
        const int r = e / (NMAX / V);
        const int c = (e - r * (NMAX / V)) * V;
        const int n_ok = r < rows ? min(max(N - c, 0), V) : 0;
        const size_t off = n_ok > 0 ? (row0 + ts + r) * N + c : 0;
        cp_async16(rB + r * NMAX + c, Bm + off, n_ok * sizeof(T));
        cp_async16(rC + r * NMAX + c, Cm + off, n_ok * sizeof(T));
      }
    } else {
      const T zero = from_f32<T>(0.f);
      for (int e = tid; e < wr * CB; e += NT) {
        const int r = e / CB;
        const int c = e - r * CB;
        const bool ok = r < rows && d0 + c < Dm;
        const size_t off = (row0 + ts + r) * Dm + d0 + c;
        rU[e] = ok ? u[off] : zero;
        rD[e] = ok ? delta[off] : zero;
        rDy[e] = ok ? dy[off] : zero;
      }
      for (int e = tid; e < wr * NMAX; e += NT) {
        const int r = e / NMAX;
        const int n = e - r * NMAX;
        const bool ok = r < rows && n < N;
        const size_t off = (row0 + ts + r) * N + n;
        rB[e] = ok ? Bm[off] : zero;
        rC[e] = ok ? Cm[off] : zero;
      }
    }
    cp_commit();
  };
  // the raw window into the staged one: dt = softplus(delta + bias) once
  // per step and channel, u, dy, B and C in fp32 (each thread its channel
  // fch on rows tid / CB, + NT / CB, ...)
  auto convert = [&]() {
    for (int e = tid; e < wr * CB; e += NT) {
      sDt[e] = softplus_f32(to_f32(rD[e]) + fbias);
      sU[e] = to_f32(rU[e]);
      sDy[e] = to_f32(rDy[e]);
    }
    for (int e = tid; e < wr * NMAX; e += NT) {
      sB[e] = to_f32(rB[e]);
      sC[e] = to_f32(rC[e]);
    }
  };
  // a window staged while the block waits (chunks longer than kWinCap)
  auto stage = [&](int ts, int rows) {
    __syncthreads();  // the last window's readers are done
    issue_raw(ts, rows);
    cp_wait_all();
    __syncthreads();
    convert();
    __syncthreads();
  };

  // chunks of at most kWinCap steps are one window: the next chunk's raw
  // rows are in flight while this one is walked
  const bool prefetch = Tc <= kWinCap;
  if (prefetch) issue_raw((nchunks - 1) * Tc, L - (nchunks - 1) * Tc);
  bool waiting = false;  // a cluster arrive whose wait is still due
  int swept = 0;         // pieces swept so far: the parity of sGB, sGX
  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * Tc;
    const int tl = min(Tc, L - t0);
    const int np = (tl + kPiece - 1) / kPiece;
    const int nwin = (tl + wr - 1) / wr;
    const int walk_end = (np - 1) * kPiece;  // the last piece's first step

    // the state entering the chunk: piece 0's checkpoint
    float xin[kStates];
    {
      const size_t st0 =
          (static_cast<size_t>(g * nchunks + c) * N + n0) * Dm + dp;
#pragma unroll
      for (int j = 0; j < kStates; ++j) {
        xin[j] = active && n0 + j < N
                     ? xsave[st0 + static_cast<size_t>(j) * Dm]
                     : 0.f;
      }
    }
    int staged = -1;
    if (prefetch) {
      cp_wait_all();
      __syncthreads();  // the chunk's raw rows are in; the last chunk is done
      convert();
      __syncthreads();
      if (c > 0) issue_raw((c - 1) * Tc, Tc);
      staged = 0;
    }

    // 1. the checkpoint walk: the state entering each later piece, into
    // the block's checkpoint slots (each thread its own; L2 keeps them)
    float x[kStates] = {xin[0], xin[1], xin[2], xin[3]};
    for (int wi = 0; wi * wr < walk_end; ++wi) {
      if (staged != wi) {
        stage(t0 + wi * wr, min(wr, tl - wi * wr));
        staged = wi;
      }
      const int pieces = min(wr, walk_end - wi * wr) / kPiece;
      for (int q = 0; q < pieces; ++q) {
#pragma unroll
        for (int i = 0; i < kPiece; ++i) {
          const int s = q * kPiece + i;
          const float dt = sDt[s * CB + ch];
          const float dtu = dt * sU[s * CB + ch];
          const float4 bv =
              *reinterpret_cast<const float4*>(sB + s * NMAX + n0);
          x[0] = fmaf(exp2_ftz(dt * a2[0]), x[0], dtu * bv.x);
          x[1] = fmaf(exp2_ftz(dt * a2[1]), x[1], dtu * bv.y);
          x[2] = fmaf(exp2_ftz(dt * a2[2]), x[2], dtu * bv.z);
          x[3] = fmaf(exp2_ftz(dt * a2[3]), x[3], dtu * bv.w);
        }
        ck_blk[static_cast<size_t>(wi * wr / kPiece + q + 1) * NT] =
            make_float4(x[0], x[1], x[2], x[3]);
      }
    }

    // 2. windows last to first, their pieces last to first
    for (int wi = nwin - 1; wi >= 0; --wi) {
      const int wt = wi * wr;
      const int wl = min(wr, tl - wt);
      if (staged != wi) {
        stage(t0 + wt, wl);
        staged = wi;
      }
      if (waiting) {  // every block of the cluster has read its dB/dC rows
        cluster_wait();
        waiting = false;
      }
      // each piece's checkpoint, loaded a piece ahead
      auto checkpoint = [&](int p) {
        return p == 0 ? make_float4(xin[0], xin[1], xin[2], xin[3])
                      : ck_blk[static_cast<size_t>(p) * NT];
      };
      const int p_hi = (wt + wl - 1) / kPiece;
      float4 ck_next = checkpoint(p_hi);
      for (int p = p_hi; p * kPiece >= wt; --p) {
        const int r0 = p * kPiece - wt;   // the piece's first row
        const int pl = min(kPiece, tl - p * kPiece);
        const float4 ck = ck_next;
        if ((p - 1) * kPiece >= wt) ck_next = checkpoint(p - 1);
        const int buf = swept & 1;
        ++swept;
        float* gbw = sGB + (buf * (NT / 32) + wg) * kPiece * 32;
        float* gxw = sGX + (buf * (NT / 32) + wg) * kPiece * 32;
        float* part = sPart + grp * wr * kRow;
        if (pl == kPiece) {
          sweep_piece<true, NMAX>(ck, r0, pl, sDt, sU, sDy, sB, sC, gbw, gxw,
                                  part, ch, lane, n0, red_col, red_writes, a2,
                                  Av, gc, dA);
        } else {
          sweep_piece<false, NMAX>(ck, r0, pl, sDt, sU, sDy, sB, sC, gbw,
                                   gxw, part, ch, lane, n0, red_col,
                                   red_writes, a2, Av, gc, dA);
        }
        __syncthreads();
        // du and ddelta of the piece: the state warps' sums in warp order
        // (thread tid: channel fch, rows tid / CB, + NT / CB, ...); the
        // sigmoid of delta + bias is 1 - exp(-dt)
        const int fgrp = fch >> 5;
        const int flane = fch & 31;
        for (int e = tid; e < pl * CB; e += NT) {
          const int s = e / CB;
          const int r = r0 + s;
          float gB = 0.f, gx = 0.f;
#pragma unroll
          for (int ww = 0; ww < NG; ++ww) {
            const int at = ((buf * (NT / 32) + fgrp * NG + ww) * kPiece + s) *
                               32 + flane;
            gB += sGB[at];
            gx += sGX[at];
          }
          const float dt = sDt[r * CB + fch];
          const float dyv = sDy[r * CB + fch];
          const float uu = sU[r * CB + fch];
          const float sig = 1.f - exp2_ftz(-dt * kLog2e);
          const float dd = sig * fmaf(uu, gB, gx);
          if (factive) {
            const size_t off = (row0 + t0 + wt + r) * Dm + fd;
            du[off] = fmaf(dt, gB, fskip * dyv);
            ddelta[off] = dd;
          }
          dbias_acc += dd;
          dD_acc = fmaf(dyv, uu, dD_acc);
        }
      }
      // dB and dC of the window: the groups' rows of every block of the
      // cluster, added in rank order, then group order
      if (cs > 1) {
        cluster_arrive();
        cluster_wait();
      } else {
        __syncthreads();
      }
      for (int e = rank * NT + tid; e < wl * 2 * N; e += cs * NT) {
        const int r = e / (2 * N);
        const int q = e - r * 2 * N;
        const int col = q < N ? q : NMAX + q - N;
        float sum = 0.f;
        for (int b = 0; b < cs; ++b) {
          const float* pb = cluster.map_shared_rank(sPart, b);
#pragma unroll
          for (int gi = 0; gi < groups<NMAX>(); ++gi) {
            sum += pb[(gi * wr + r) * kRow + col];
          }
        }
        const size_t off = (row0 + t0 + wt + r) * N + (q < N ? q : q - N);
        (q < N ? dBo : dCo)[off] = sum;
      }
      if (cs > 1) {
        cluster_arrive();
        waiting = true;
      }
    }
  }
  if (waiting) cluster_wait();  // no block leaves while its rows are read

  // per-sequence partials: dA a thread, dD and dbias over the threads that
  // flushed each channel
  if (active) {
#pragma unroll
    for (int j = 0; j < kStates; ++j) {
      if (n0 + j < N) {
        dA_part[(static_cast<size_t>(g) * N + n0 + j) * Dm + d] = dA[j];
      }
    }
  }
  __syncthreads();
  sGB[tid] = dD_acc;
  sGX[tid] = dbias_acc;
  __syncthreads();
  if (tid < CB && factive) {
    float sD = 0.f, sb = 0.f;
    for (int m = 0; m < NT / CB; ++m) {
      sD += sGB[m * CB + tid];
      sb += sGX[m * CB + tid];
    }
    dD_part[static_cast<size_t>(g) * Dm + fd] = sD;
    dbias_part[static_cast<size_t>(g) * Dm + fd] = sb;
  }
}

// blocks of 32 groups<NMAX>() channels a cluster and clusters a sequence:
// as few clusters of at most kMaxCluster blocks as cover Dm, the blocks
// spread evenly (selective_scan_v1.py::bwd_grid computes the same)
template <int NMAX>
void cluster_shape(int Dm, int* cs, int* nclusters) {
  const int nblocks = (Dm + 32 * groups<NMAX>() - 1) / (32 * groups<NMAX>());
  *nclusters = (nblocks + kMaxCluster - 1) / kMaxCluster;
  *cs = (nblocks + *nclusters - 1) / *nclusters;
}

template <typename T, int NMAX>
cudaError_t allow_smem(size_t bytes) {
  // above 48 KB a block gets dynamic shared memory only on request
  return cudaFuncSetAttribute(scan_v1_bwd_kernel<T, NMAX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int NMAX>
cudaError_t launch_n(const void* u, const void* delta, const void* A,
                     const void* B, const void* C, const void* D,
                     const void* bias, const void* xsave, const void* dy,
                     void* du, void* ddelta, void* dB, void* dC,
                     void* dA_part, void* dD_part, void* dbias_part,
                     void* ckpt, long long ckpt_floats, int G, int L,
                     int Dm, int K, int N, int Tc, cudaStream_t stream) {
  static_assert(bwd_smem_bytes<T, NMAX>(kWinCap) <= kSmemLimit,
                "a block's shared memory fits sm_90 at every chunk");
  const size_t bytes = bwd_smem_bytes<T, NMAX>(Tc);
  int cs = 0, nclusters = 0;
  cluster_shape<NMAX>(Dm, &cs, &nclusters);
  const size_t need = static_cast<size_t>(G) * nclusters * cs *
                      ((Tc + kPiece - 1) / kPiece) * bwd_threads<NMAX>() *
                      kStates;
  if (ckpt == nullptr || ckpt_floats < 0 ||
      static_cast<size_t>(ckpt_floats) < need) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_smem<T, NMAX>(bytes);
  if (err != cudaSuccess) return err;
  // cp.async takes 16-byte pieces: every row of u, delta, dy, B and C must
  // start on a 16-byte boundary
  const uintptr_t bases = reinterpret_cast<uintptr_t>(u) |
                          reinterpret_cast<uintptr_t>(delta) |
                          reinterpret_cast<uintptr_t>(dy) |
                          reinterpret_cast<uintptr_t>(B) |
                          reinterpret_cast<uintptr_t>(C);
  const bool aligned = bases % 16 == 0 && (Dm * sizeof(T)) % 16 == 0 &&
                       (N * sizeof(T)) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nclusters * cs, G);
  cfg.blockDim = dim3(bwd_threads<NMAX>());
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, scan_v1_bwd_kernel<T, NMAX>, static_cast<const T*>(u),
      static_cast<const T*>(delta), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(D), static_cast<const float*>(bias),
      static_cast<const float*>(xsave), static_cast<const T*>(dy),
      static_cast<float*>(du), static_cast<float*>(ddelta),
      static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA_part), static_cast<float*>(dD_part),
      static_cast<float*>(dbias_part), static_cast<float4*>(ckpt), G, L, Dm,
      K, N, Tc, aligned);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* A,
                   const void* B, const void* C, const void* D,
                   const void* bias, const void* xsave, const void* dy,
                   void* du, void* ddelta, void* dB, void* dC, void* dA_part,
                   void* dD_part, void* dbias_part, void* ckpt,
                   long long ckpt_floats, int G, int L, int Dm, int K, int N,
                   int Tc, cudaStream_t stream) {
  if (Tc < 1 || L < 1 || Dm < 1 || N < 1 || K < 1 || G < 1 || G > 65535) {
    return cudaErrorInvalidValue;
  }
#define SCAN_V1_BWD_LAUNCH(NM)                                              \
  return launch_n<T, NM>(u, delta, A, B, C, D, bias, xsave, dy, du, ddelta, \
                         dB, dC, dA_part, dD_part, dbias_part, ckpt,        \
                         ckpt_floats, G, L, Dm, K, N, Tc, stream)
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

template <typename T, int NMAX>
cudaError_t info_n(int Tc, int* out) {
  const size_t bytes = bwd_smem_bytes<T, NMAX>(Tc);
  cudaError_t err = allow_smem<T, NMAX>(bytes);
  if (err != cudaSuccess) return err;
  return scan2l::pass_info_shared(scan_v1_bwd_kernel<T, NMAX>,
                                  bwd_threads<NMAX>(), bytes, out);
}

template <typename T>
cudaError_t info(int N, int Tc, int* out) {
  if (Tc < 1 || N < 1) return cudaErrorInvalidValue;
  if (N <= 8) return info_n<T, 8>(Tc, out);
  if (N <= 16) return info_n<T, 16>(Tc, out);
  if (N <= 32) return info_n<T, 32>(Tc, out);
  if (N <= 64) return info_n<T, 64>(Tc, out);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the launch's error (0 on
// success).  is_bf16 selects the type of u, delta, B, C and dy; every
// output is fp32.  dB and dC hold one sum [G, L, N] per cluster of the
// sequence, one after the other (see above).  ckpt is scratch for the
// checkpoints, at least G x blocks x ceil(T / 8) x threads x 4 fp32 values
// (selective_scan_v1.py::bwd_grid gives blocks and threads).  Refuses
// (cudaErrorInvalidValue) T, L, Dm, N, K or G below 1, G above 65535, N
// above 64 and a missing or short ckpt.
extern "C" int selective_scan_v1_bwd(const void* u, const void* delta,
                                     const void* A, const void* B,
                                     const void* C, const void* D,
                                     const void* bias, const void* xsave,
                                     const void* dy, void* du, void* ddelta,
                                     void* dB, void* dC, void* dA_part,
                                     void* dD_part, void* dbias_part,
                                     void* ckpt, long long ckpt_floats, int G,
                                     int L, int Dm, int K, int N, int T,
                                     int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return static_cast<int>(launch<__nv_bfloat16>(
        u, delta, A, B, C, D, bias, xsave, dy, du, ddelta, dB, dC, dA_part,
        dD_part, dbias_part, ckpt, ckpt_floats, G, L, Dm, K, N, T, s));
  }
  return static_cast<int>(launch<float>(
      u, delta, A, B, C, D, bias, xsave, dy, du, ddelta, dB, dC, dA_part,
      dD_part, dbias_part, ckpt, ckpt_floats, G, L, Dm, K, N, T, s));
}

// What the card grants the one pass (walk) at d_state N and chunk T:
// out[0..3] = registers a thread, local (spill) bytes a thread, shared
// bytes a block, resident warps per SM (blocks counted alone, not by
// cluster).
extern "C" int selective_scan_v1_bwd_pass_info(int N, int T, int is_bf16,
                                               int* out) {
  return static_cast<int>(is_bf16 ? info<__nv_bfloat16>(N, T, out)
                                  : info<float>(N, T, out));
}

extern "C" const char* selective_scan_v1_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
