// ST-SSD semantic-token mixer, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/stl_mixer_pallas.py
//   ::_fwd_kernel (launched by _run_fwd).
//
// Computes, for every bb of the batch (the four scan directions folded in):
//   S = w[bb] . u1                   [L, P], fp32 sums of operand-type values
//   E = rnd(softmax over P of S)     fp32, rounded to the operand type
//   U[bb] = E^T . V[bb]              [P, C], fp32 sums, written rounded
// with w, V [BB, L, C] and u1 [C, P].  No [L, P] tensor goes to device
// memory.
//
// What bounds it on this card: at ST-SSD stage 0 (BB 128, L = P = 3136,
// C 128, bf16) the two products are 4 BB L P C ~ 0.64 TFLOP against
// ~0.3 GB moved: operations, by a wide margin.
//
// Design (simple and right first).  The softmax runs over P, the axis the
// output keeps, and U sums over L; the TPU body held all of P (u1 and a
// [P, C] fp32 accumulator, 3 MB at stage 0) in VMEM, which does not fit a
// block's 227 KB.  So two kernels, no atomics, the same bits on every run:
//  1. stats_kernel, per (64 rows of L, bb): walks P in 64-column tiles,
//     recomputing S, and keeps each row's running max m and sum n of
//     exp(S - m) (online rescaling); writes m and n ([2, BB, L] fp32).
//  2. mix_kernel, per (64 columns of P, bb): holds u1's 64 columns and a
//     [64, C] fp32 accumulator, walks L in 64-row tiles, recomputes S,
//     forms E = rnd(exp(S - m) / n) and accumulates E^T . V.
// S is computed twice (6 L P C operations for the 4 L P C the bound
// counts).  P 3136 and 784 are multiples of 64 only at stage 0: every
// tile edge is masked.  bf16 on the tensor cores (WMMA), fp32 on the CUDA
// cores (st_tiles.cuh); C is a template parameter (128 or 256).

#include "st_tiles.cuh"

namespace {

using namespace st_tiles;

// shared memory of a block, byte offsets: the w rows [64][C], u1's columns
// [C][64], the V rows [64][C] (mix only), the fp32 S tile, the rounded E
// tile (bf16 only: fp32 rounds in place) and the 64 rows' m and n
template <typename T, int C>
struct StlSmem {
  size_t w, u1, v, s, e, m, n, total;
  __host__ __device__ StlSmem() {
    const size_t rows = round128(kT * ld<T>(C) * sizeof(T));
    w = 0;
    u1 = w + rows;
    v = u1 + round128(C * ld<T>(kT) * sizeof(T));
    s = v + rows;
    e = s + round128(kT * kLdS * sizeof(float));
    m = e + (std::is_same<T, float>::value
                 ? 0
                 : round128(kT * ld<T>(kT) * sizeof(T)));
    n = m + round128(kT * sizeof(float));
    total = n + round128(kT * sizeof(float));
  }
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    stats_kernel(const T* __restrict__ w, const T* __restrict__ u1,
                 float* __restrict__ stats, int BB, int L, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StlSmem<T, C> S;
  T* sW = reinterpret_cast<T*>(smem + S.w);
  T* sU1 = reinterpret_cast<T*>(smem + S.u1);
  float* sS = reinterpret_cast<float*>(smem + S.s);
  const int ldC = ld<T>(C), ld64 = ld<T>(kT);
  const int bb = blockIdx.y, l0 = blockIdx.x * kT;
  // four threads per row, 16 columns each
  const int r = threadIdx.x / 4, c0 = (threadIdx.x % 4) * 16;

  load_tile(sW, ldC, w + static_cast<size_t>(bb) * L * C, C, l0, 0, kT, C,
            L, C);
  float m = __int_as_float(0xff800000), n = 0.f;     // -inf, 0
  for (int q0 = 0; q0 < P; q0 += kT) {
    load_tile(sU1, ld64, u1, P, 0, q0, C, kT, C, P);
    __syncthreads();
    gemm_s<false>(sS, sW, ldC, sU1, ld64, C);
    __syncthreads();
    const float* row = sS + r * kLdS;
    float tm = __int_as_float(0xff800000);
    for (int c = c0; c < c0 + 16; ++c)
      if (q0 + c < P) tm = fmaxf(tm, row[c]);
    const float nm = fmaxf(m, group4_max(tm));
    float ts = 0.f;
    for (int c = c0; c < c0 + 16; ++c)
      if (q0 + c < P) ts += expf(row[c] - nm);
    n = n * expf(m - nm) + group4_sum(ts);
    m = nm;
  }
  if (threadIdx.x % 4 == 0 && l0 + r < L) {
    const size_t o = static_cast<size_t>(bb) * L + l0 + r;
    stats[o] = m;
    stats[static_cast<size_t>(BB) * L + o] = n;
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    mix_kernel(const T* __restrict__ w, const T* __restrict__ u1,
               const T* __restrict__ V, const float* __restrict__ stats,
               T* __restrict__ U, int BB, int L, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StlSmem<T, C> S;
  constexpr bool kF32 = std::is_same<T, float>::value;
  T* sW = reinterpret_cast<T*>(smem + S.w);
  T* sU1 = reinterpret_cast<T*>(smem + S.u1);
  T* sV = reinterpret_cast<T*>(smem + S.v);
  float* sS = reinterpret_cast<float*>(smem + S.s);
  T* sE = reinterpret_cast<T*>(smem + (kF32 ? S.s : S.e));
  float* sm = reinterpret_cast<float*>(smem + S.m);
  float* sn = reinterpret_cast<float*>(smem + S.n);
  const int ldC = ld<T>(C), ld64 = ld<T>(kT);
  const int ldE = kF32 ? kLdS : ld64;
  const int bb = blockIdx.y, p0 = blockIdx.x * kT;
  const size_t base = static_cast<size_t>(bb) * L * C;
  const float* mrow = stats + static_cast<size_t>(bb) * L;
  const float* nrow = mrow + static_cast<size_t>(BB) * L;

  load_tile(sU1, ld64, u1, P, 0, p0, C, kT, C, P);
  Acc<T, C> acc;
  acc.zero();
  for (int l0 = 0; l0 < L; l0 += kT) {
    load_tile(sW, ldC, w + base, C, l0, 0, kT, C, L, C);
    load_tile(sV, ldC, V + base, C, l0, 0, kT, C, L, C);
    for (int t = threadIdx.x; t < kT; t += kThreads) {
      const bool in = l0 + t < L;
      sm[t] = in ? mrow[l0 + t] : 0.f;
      sn[t] = in ? nrow[l0 + t] : 1.f;
    }
    __syncthreads();
    gemm_s<false>(sS, sW, ldC, sU1, ld64, C);        // S = w u1
    __syncthreads();
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e - r * kT;
      float v = 0.f;
      if (l0 + r < L && p0 + c < P)
        v = expf(sS[r * kLdS + c] - sm[r]) / sn[r];
      sE[r * ldE + c] = from_f32<T>(v);
    }
    __syncthreads();
    acc.template mma<true>(sE, ldE, sV, ldC);        // U += E^T V
    __syncthreads();
  }
  T* Ub = U + static_cast<size_t>(bb) * P * C;
  acc.store(
      [&](int r, int c, float v) {
        if (p0 + r < P)
          Ub[static_cast<size_t>(p0 + r) * C + c] = from_f32<T>(v);
      },
      sS + (threadIdx.x >> 5) * 256);
}

template <typename T, int C>
cudaError_t launch(const void* w, const void* u1, const void* V, void* U,
                   float* stats, int BB, int L, int P, cudaStream_t stream) {
  const size_t smem = StlSmem<T, C>().total;
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mix_kernel<T, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const T* wt = static_cast<const T*>(w);
  const T* ut = static_cast<const T*>(u1);
  stats_kernel<T, C><<<dim3((L + kT - 1) / kT, BB), kThreads, smem, stream>>>(
      wt, ut, stats, BB, L, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mix_kernel<T, C><<<dim3((P + kT - 1) / kT, BB), kThreads, smem, stream>>>(
      wt, ut, static_cast<const T*>(V), stats, static_cast<T*>(U), BB, L, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(const void* w, const void* u1, const void* V, void* U,
                     float* stats, int BB, int L, int P, int C,
                     cudaStream_t stream) {
  if (C == 128) return launch<T, 128>(w, u1, V, U, stats, BB, L, P, stream);
  if (C == 256) return launch<T, 256>(w, u1, V, U, stats, BB, L, P, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the two launches (0 on success).  is_bf16 selects the type of w, u1, V
// and U; stats is a [2, BB, L] fp32 workspace (the rows' max, then sum).
// The caller checks the shapes: C 128 or 256, P % 8 == 0, BB <= 65535.
extern "C" int stl_mixer_fwd(const void* w, const void* u1, const void* V,
                             void* U, void* stats, int BB, int L, int P,
                             int C, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (is_bf16)
    return static_cast<int>(launch_c<bf16>(w, u1, V, U, st, BB, L, P, C, s));
  return static_cast<int>(launch_c<float>(w, u1, V, U, st, BB, L, P, C, s));
}

extern "C" const char* stl_mixer_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
