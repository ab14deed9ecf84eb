// ST-SSD semantic-token mixer, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/stl_mixer_pallas.py
//   ::_bwd_kernel (launched by _run_bwd).
//
// Computes, for every bb of the batch, with S = w[bb] . u1 and E its fp32
// softmax over P (w, V, dU of the operand type; rnd() rounds to it):
//   dV[bb]  = rnd(E) . dU[bb]                           [L, C]
//   dE      = V[bb] . dU[bb]^T,  rowdot = rowsums(E * dE)
//   dS      = rnd(E * (dE - rowdot))                    [L, P]
//   dw[bb]  = dS . u1^T                                 [L, C]
//   du1p[bb] = dS^T . w[bb]                             [P, C], fp32
// every product summed in fp32, dV and dw written rounded; the caller sums
// the per-batch du1 partials over bb and transposes them (the TPU body's
// rounding points: E fp32 for rowdot and dS, E and dS rounded before the
// products).  No [L, P] tensor goes to device memory.
//
// What bounds it on this card: at ST-SSD stage 0 (BB 128, L = P = 3136,
// C 128, bf16) the TPU body's five products are 10 BB L P C ~ 1.6 TFLOP
// against ~0.4 GB moved: operations, by a wide margin.
//
// Design (simple and right first).  The softmax runs over P, so a row's dS
// needs a full pass over P (rowdot) before it exists; dV and dw sum over P
// per row of L, du1 sums over L per column of P.  The TPU body walked L
// sequentially with a [P, C] fp32 accumulator in VMEM; a block has 227 KB
// and blocks run in no order.  So two kernels, no atomics, the same bits on
// every run:
//  1. mix_rows_bwd_kernel, per (64 rows of L, bb): walks P in 64-column
//     tiles twice.  The first walk recomputes S and dE and keeps each row's
//     running max m, sum n of exp(S - m) and sum t of exp(S - m) dE
//     (online rescaling), so rowdot = t / n; it writes m, n and rowdot to a
//     [3, BB, L] fp32 workspace.  The second walk recomputes S and dE,
//     forms E and dS and accumulates dV and dw in registers.
//  2. mix_cols_bwd_kernel, per (64 columns of P, bb): walks L, recomputes
//     S and dE, forms dS from the workspace's rows and accumulates the du1
//     partial.
// The softmax statistics are recomputed rather than saved by the forward:
// the first walk is needed for rowdot anyway.  That makes 9 products where
// the bound counts 5.  Each block stages its operands through two shared
// buffers, reloading w or u1's columns where a product needs them again,
// so that fp32 at C 256 fits.  P 3136 and 784 are multiples of 64 only at
// stage 0: every tile edge is masked.  bf16 on the tensor cores (WMMA),
// fp32 on the CUDA cores (st_tiles.cuh); C is a template parameter (128 or
// 256).

#include "st_tiles.cuh"

namespace {

using namespace st_tiles;

// shared memory of a block, byte offsets: two staging buffers, each a
// [64][C] row tile or a [C][64] column tile of T; the fp32 S and dE tiles;
// the rounded E and dS tiles (bf16 only: fp32 rounds in place); the 64
// rows' m, n and rowdot
template <typename T, int C>
struct MixBwdSmem {
  size_t x, z, s, de, e, ds, st, total;
  __host__ __device__ MixBwdSmem() {
    const size_t rows = kT * ld<T>(C) * sizeof(T);
    const size_t cols = C * ld<T>(kT) * sizeof(T);
    const size_t buf = round128(rows > cols ? rows : cols);
    const size_t f32 = round128(kT * kLdS * sizeof(float));
    const size_t rnd = std::is_same<T, float>::value
                           ? 0
                           : round128(kT * ld<T>(kT) * sizeof(T));
    x = 0;
    z = x + buf;
    s = z + buf;
    de = s + f32;
    e = de + f32;
    ds = e + rnd;
    st = ds + rnd;
    total = st + round128(3 * kT * sizeof(float));
  }
};

// The block's pointers into shared memory.
template <typename T, int C>
struct MixTiles {
  T *x, *z, *e, *ds;
  float *s, *de, *m, *n, *rd;
  int ldR;  // leading dimension of the rounded E and dS tiles
  __device__ explicit MixTiles(unsigned char* smem) {
    const MixBwdSmem<T, C> L;
    constexpr bool kF32 = std::is_same<T, float>::value;
    x = reinterpret_cast<T*>(smem + L.x);
    z = reinterpret_cast<T*>(smem + L.z);
    s = reinterpret_cast<float*>(smem + L.s);
    de = reinterpret_cast<float*>(smem + L.de);
    e = reinterpret_cast<T*>(smem + (kF32 ? L.s : L.e));
    ds = reinterpret_cast<T*>(smem + (kF32 ? L.de : L.ds));
    m = reinterpret_cast<float*>(smem + L.st);
    n = m + kT;
    rd = n + kT;
    ldR = kF32 ? kLdS : ld<T>(kT);
  }
};

// S = w[l0:] . u1[:, q0:] and dE = V[l0:] . dU[q0:]^T into the fp32 tiles.
// Starts by overwriting both staging buffers and ends synchronised.
template <typename T, int C>
__device__ __forceinline__ void scores_and_de(const MixTiles<T, C>& t,
                                              const T* wb, const T* u1,
                                              const T* Vb, const T* dUb,
                                              int l0, int q0, int L, int P) {
  const int ldC = ld<T>(C), ld64 = ld<T>(kT);
  load_tile(t.x, ldC, wb, C, l0, 0, kT, C, L, C);
  load_tile(t.z, ld64, u1, P, 0, q0, C, kT, C, P);
  __syncthreads();
  gemm_s<false>(t.s, t.x, ldC, t.z, ld64, C);        // S = w u1
  __syncthreads();
  load_tile(t.x, ldC, Vb, C, l0, 0, kT, C, L, C);
  load_tile(t.z, ldC, dUb, C, q0, 0, kT, C, P, C);
  __syncthreads();
  gemm_s<true>(t.de, t.x, ldC, t.z, ldC, C);         // dE = V dU^T
  __syncthreads();
}

// E = exp(S - m) / n and dS = E (dE - rowdot) of the tile, rounded into the
// E and dS tiles (in place in fp32); zero outside L and P.
template <typename T, int C>
__device__ __forceinline__ void softmax_grad(const MixTiles<T, C>& t, int l0,
                                             int q0, int L, int P) {
  for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
    const int r = i / kT, c = i - r * kT;
    float e = 0.f, ds = 0.f;
    if (l0 + r < L && q0 + c < P) {
      e = expf(t.s[r * kLdS + c] - t.m[r]) / t.n[r];
      ds = e * (t.de[r * kLdS + c] - t.rd[r]);
    }
    t.e[r * t.ldR + c] = from_f32<T>(e);
    t.ds[r * t.ldR + c] = from_f32<T>(ds);
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    mix_rows_bwd_kernel(const T* __restrict__ w, const T* __restrict__ u1,
                        const T* __restrict__ V, const T* __restrict__ dU,
                        T* __restrict__ dw, T* __restrict__ dV,
                        float* __restrict__ rows, int BB, int L, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MixTiles<T, C> t(smem);
  const int ld64 = ld<T>(kT), ldC = ld<T>(C);
  const int bb = blockIdx.y, l0 = blockIdx.x * kT;
  const size_t base = static_cast<size_t>(bb) * L * C;
  const T* dUb = dU + static_cast<size_t>(bb) * P * C;
  // four threads per row, 16 columns each
  const int r = threadIdx.x / 4, c0 = (threadIdx.x % 4) * 16;

  // walk 1: each row's max, sum and rowdot, online over the column tiles
  float m = __int_as_float(0xff800000), n = 0.f, td = 0.f;   // -inf, 0, 0
  for (int q0 = 0; q0 < P; q0 += kT) {
    scores_and_de(t, w + base, u1, V + base, dUb, l0, q0, L, P);
    const float* srow = t.s + r * kLdS;
    const float* drow = t.de + r * kLdS;
    float tm = __int_as_float(0xff800000);
    for (int c = c0; c < c0 + 16; ++c)
      if (q0 + c < P) tm = fmaxf(tm, srow[c]);
    const float nm = fmaxf(m, group4_max(tm));
    float ts = 0.f, tt = 0.f;
    for (int c = c0; c < c0 + 16; ++c)
      if (q0 + c < P) {
        const float e = expf(srow[c] - nm);
        ts += e;
        tt += e * drow[c];
      }
    const float scale = expf(m - nm);
    n = n * scale + group4_sum(ts);
    td = td * scale + group4_sum(tt);
    m = nm;
  }
  if (threadIdx.x % 4 == 0) {
    t.m[r] = m;
    t.n[r] = n;
    t.rd[r] = td / n;
    if (l0 + r < L) {
      const size_t o = static_cast<size_t>(bb) * L + l0 + r;
      const size_t plane = static_cast<size_t>(BB) * L;
      rows[o] = m;
      rows[plane + o] = n;
      rows[2 * plane + o] = td / n;
    }
  }
  __syncthreads();

  // walk 2: dV += rnd(E) dU and dw += dS u1^T
  Acc<T, C> accV, accW;
  accV.zero();
  accW.zero();
  for (int q0 = 0; q0 < P; q0 += kT) {
    scores_and_de(t, w + base, u1, V + base, dUb, l0, q0, L, P);
    softmax_grad(t, l0, q0, L, P);
    __syncthreads();
    accV.template mma<false>(t.e, t.ldR, t.z, ldC);   // z holds dU's rows
    load_tile(t.x, ld64, u1, P, 0, q0, C, kT, C, P);  // u1's columns
    __syncthreads();
    accW.template mma<false, true>(t.ds, t.ldR, t.x, ld64);
    __syncthreads();
  }
  float* stg = t.s + (threadIdx.x >> 5) * 256;
  accV.store(
      [&](int rr, int c, float v) {
        if (l0 + rr < L)
          dV[base + static_cast<size_t>(l0 + rr) * C + c] = from_f32<T>(v);
      },
      stg);
  accW.store(
      [&](int rr, int c, float v) {
        if (l0 + rr < L)
          dw[base + static_cast<size_t>(l0 + rr) * C + c] = from_f32<T>(v);
      },
      stg);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    mix_cols_bwd_kernel(const T* __restrict__ w, const T* __restrict__ u1,
                        const T* __restrict__ V, const T* __restrict__ dU,
                        const float* __restrict__ rows,
                        float* __restrict__ du1p, int BB, int L, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MixTiles<T, C> t(smem);
  const int ldC = ld<T>(C);
  const int bb = blockIdx.y, p0 = blockIdx.x * kT;
  const size_t base = static_cast<size_t>(bb) * L * C;
  const size_t plane = static_cast<size_t>(BB) * L;
  const float* mrow = rows + static_cast<size_t>(bb) * L;

  Acc<T, C> acc;
  acc.zero();
  for (int l0 = 0; l0 < L; l0 += kT) {
    for (int i = threadIdx.x; i < kT; i += kThreads) {
      const bool in = l0 + i < L;
      t.m[i] = in ? mrow[l0 + i] : 0.f;
      t.n[i] = in ? mrow[plane + l0 + i] : 1.f;
      t.rd[i] = in ? mrow[2 * plane + l0 + i] : 0.f;
    }
    scores_and_de(t, w + base, u1, V + base,
                  dU + static_cast<size_t>(bb) * P * C, l0, p0, L, P);
    softmax_grad(t, l0, p0, L, P);
    load_tile(t.x, ldC, w + base, C, l0, 0, kT, C, L, C);   // w's rows
    __syncthreads();
    acc.template mma<true>(t.ds, t.ldR, t.x, ldC);          // += dS^T w
    __syncthreads();
  }
  float* out = du1p + static_cast<size_t>(bb) * P * C;
  acc.store(
      [&](int r, int c, float v) {
        if (p0 + r < P) out[static_cast<size_t>(p0 + r) * C + c] = v;
      },
      t.s + (threadIdx.x >> 5) * 256);
}

template <typename T, int C>
cudaError_t launch(const void* w, const void* u1, const void* V,
                   const void* dU, void* dw, void* dV, float* rows,
                   float* du1p, int BB, int L, int P, cudaStream_t stream) {
  const int smem = static_cast<int>(MixBwdSmem<T, C>().total);
  cudaError_t err = cudaFuncSetAttribute(
      mix_rows_bwd_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mix_cols_bwd_kernel<T, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const T* wt = static_cast<const T*>(w);
  const T* ut = static_cast<const T*>(u1);
  const T* vt = static_cast<const T*>(V);
  const T* dut = static_cast<const T*>(dU);
  mix_rows_bwd_kernel<T, C>
      <<<dim3((L + kT - 1) / kT, BB), kThreads, smem, stream>>>(
          wt, ut, vt, dut, static_cast<T*>(dw), static_cast<T*>(dV), rows, BB,
          L, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mix_cols_bwd_kernel<T, C>
      <<<dim3((P + kT - 1) / kT, BB), kThreads, smem, stream>>>(
          wt, ut, vt, dut, rows, du1p, BB, L, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(const void* w, const void* u1, const void* V,
                     const void* dU, void* dw, void* dV, float* rows,
                     float* du1p, int BB, int L, int P, int C,
                     cudaStream_t stream) {
  if (C == 128)
    return launch<T, 128>(w, u1, V, dU, dw, dV, rows, du1p, BB, L, P, stream);
  if (C == 256)
    return launch<T, 256>(w, u1, V, dU, dw, dV, rows, du1p, BB, L, P, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the two launches (0 on success).  is_bf16 selects the type of w, u1, V,
// dU, dw and dV; rows is a [3, BB, L] fp32 workspace (each row's max, sum
// and rowdot) and du1p the [BB, P, C] fp32 per-batch du1 partials.  The
// caller checks the shapes: C 128 or 256, P % 8 == 0, BB <= 65535.
extern "C" int stl_mixer_bwd(const void* w, const void* u1, const void* V,
                             const void* dU, void* dw, void* dV, void* rows,
                             void* du1p, int BB, int L, int P, int C,
                             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rows);
  float* p = static_cast<float*>(du1p);
  if (is_bf16)
    return static_cast<int>(
        launch_c<bf16>(w, u1, V, dU, dw, dV, r, p, BB, L, P, C, s));
  return static_cast<int>(
      launch_c<float>(w, u1, V, dU, dw, dV, r, p, BB, L, P, C, s));
}

extern "C" const char* stl_mixer_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
