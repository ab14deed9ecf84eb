// ST-SSD fusion gate, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/stf_zgate_pallas.py
//   ::_bwd_kernel (launched by _run_bwd).
//
// Computes, for every bb of the batch, with Z = sigmoid(pooledT[bb] . lz)
// in fp32 (pooledT, lz, U, dY of the operand type; rnd() rounds to it):
//   dU[bb]       = rnd(Z)^T . dY[bb]                  [P, C]
//   dS           = rnd((dY[bb] . U[bb]^T) * Z * (1 - Z))   [P, P]
//   dpooledT[bb] = dS . lz^T                           [P, C]
//   dlzp[bb]     = dS^T . pooledT[bb]                  [P, C], fp32
// every product summed in fp32, dU and dpooledT written rounded; the caller
// sums the per-batch dlz partials over bb and transposes them (the TPU
// body's rounding points).  No [P, P] tensor goes to device memory.
//
// What bounds it on this card: at ST-SSD stage 0 (BB 32, P 3136, C 128,
// bf16) the TPU body's five products are 10 BB P^2 C ~ 0.40 TFLOP against
// ~0.13 GB moved: operations.
//
// Design (simple and right first).  The rows of Z are independent, but dU
// and dlz sum over them, and the TPU body carried those sums in VMEM over
// its sequential row axis; Hopper blocks run in no order.  So two kernels,
// no atomics, the same bits on every run:
//  1. gate_rows_bwd_kernel, per (64 rows of P, bb): walks the columns q of
//     Z in 64-wide tiles, recomputes S = pooledT_rows . lz[:, q] and
//     dZ = dY_rows . U[q]^T, forms dS and accumulates dpooledT.
//  2. gate_cols_bwd_kernel, per (64 columns q of Z, bb): walks the rows,
//     recomputes S and dZ, forms rnd(Z) and dS and accumulates dU and the
//     dlz partial.
// That makes 7 products where the bound counts 5.  Each block stages its
// operands through two shared buffers, reloading lz's columns or pooledT's
// rows where a product needs them again, so that fp32 at C 256 fits.  P 784
// is not a multiple of 64: every tile edge is masked, and a masked row or
// column of Z contributes nothing to dU, dlz or dpooledT.  bf16 on the
// tensor cores (WMMA), fp32 on the CUDA cores (st_tiles.cuh); C is a
// template parameter (128 or 256).

#include "st_tiles.cuh"

namespace {

using namespace st_tiles;

// shared memory of a block, byte offsets: two staging buffers, each a
// [64][C] row tile or a [C][64] column tile of T; the fp32 S and dZ tiles;
// the rounded Z and dS tiles (bf16 only: fp32 rounds in place)
template <typename T, int C>
struct GateBwdSmem {
  size_t x, y, s, dz, z, ds, total;
  __host__ __device__ GateBwdSmem() {
    const size_t rows = kT * ld<T>(C) * sizeof(T);
    const size_t cols = C * ld<T>(kT) * sizeof(T);
    const size_t buf = round128(rows > cols ? rows : cols);
    const size_t f32 = round128(kT * kLdS * sizeof(float));
    const size_t rnd = std::is_same<T, float>::value
                           ? 0
                           : round128(kT * ld<T>(kT) * sizeof(T));
    x = 0;
    y = x + buf;
    s = y + buf;
    dz = s + f32;
    z = dz + f32;
    ds = z + rnd;
    total = ds + rnd;
  }
};

template <typename T, int C>
struct GateTiles {
  T *x, *y, *z, *ds;
  float *s, *dz;
  int ldR;  // leading dimension of the rounded Z and dS tiles
  __device__ explicit GateTiles(unsigned char* smem) {
    const GateBwdSmem<T, C> L;
    constexpr bool kF32 = std::is_same<T, float>::value;
    x = reinterpret_cast<T*>(smem + L.x);
    y = reinterpret_cast<T*>(smem + L.y);
    s = reinterpret_cast<float*>(smem + L.s);
    dz = reinterpret_cast<float*>(smem + L.dz);
    z = reinterpret_cast<T*>(smem + (kF32 ? L.s : L.z));
    ds = reinterpret_cast<T*>(smem + (kF32 ? L.dz : L.ds));
    ldR = kF32 ? kLdS : ld<T>(kT);
  }
};

// For the tile (rows i0.., columns q0..): S = pooledT[i0:] . lz[:, q0:],
// dZ = dY[i0:] . U[q0:]^T, then rnd(Z) and dS = rnd(dZ Z (1 - Z)), zero
// outside P.  Starts by overwriting both staging buffers; ends synchronised
// with dY's rows in x and U's rows in y.
template <typename T, int C>
__device__ __forceinline__ void gate_grad(const GateTiles<T, C>& t,
                                          const T* pb, const T* lz,
                                          const T* Ub, const T* dYb, int i0,
                                          int q0, int P) {
  const int ldC = ld<T>(C), ld64 = ld<T>(kT);
  load_tile(t.x, ldC, pb, C, i0, 0, kT, C, P, C);
  load_tile(t.y, ld64, lz, P, 0, q0, C, kT, C, P);
  __syncthreads();
  gemm_s<false>(t.s, t.x, ldC, t.y, ld64, C);        // S = pooledT lz
  __syncthreads();
  load_tile(t.x, ldC, dYb, C, i0, 0, kT, C, P, C);
  load_tile(t.y, ldC, Ub, C, q0, 0, kT, C, P, C);
  __syncthreads();
  gemm_s<true>(t.dz, t.x, ldC, t.y, ldC, C);         // dZ = dY U^T
  __syncthreads();
  for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
    const int r = i / kT, c = i - r * kT;
    float z = 0.f, ds = 0.f;
    if (i0 + r < P && q0 + c < P) {
      z = 1.f / (1.f + expf(-t.s[r * kLdS + c]));
      ds = t.dz[r * kLdS + c] * z * (1.f - z);
    }
    t.z[r * t.ldR + c] = from_f32<T>(z);
    t.ds[r * t.ldR + c] = from_f32<T>(ds);
  }
  __syncthreads();
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    gate_rows_bwd_kernel(const T* __restrict__ pooledT,
                         const T* __restrict__ lz, const T* __restrict__ U,
                         const T* __restrict__ dY, T* __restrict__ dpT,
                         int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GateTiles<T, C> t(smem);
  const int ld64 = ld<T>(kT);
  const int bb = blockIdx.y, i0 = blockIdx.x * kT;
  const size_t base = static_cast<size_t>(bb) * P * C;

  Acc<T, C> acc;
  acc.zero();
  for (int q0 = 0; q0 < P; q0 += kT) {
    gate_grad(t, pooledT + base, lz, U + base, dY + base, i0, q0, P);
    load_tile(t.y, ld64, lz, P, 0, q0, C, kT, C, P);  // lz's columns again
    __syncthreads();
    acc.template mma<false, true>(t.ds, t.ldR, t.y, ld64);   // += dS lz^T
    __syncthreads();
  }
  acc.store(
      [&](int r, int c, float v) {
        if (i0 + r < P)
          dpT[base + static_cast<size_t>(i0 + r) * C + c] = from_f32<T>(v);
      },
      t.s + (threadIdx.x >> 5) * 256);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    gate_cols_bwd_kernel(const T* __restrict__ pooledT,
                         const T* __restrict__ lz, const T* __restrict__ U,
                         const T* __restrict__ dY, T* __restrict__ dU,
                         float* __restrict__ dlzp, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GateTiles<T, C> t(smem);
  const int ldC = ld<T>(C);
  const int bb = blockIdx.y, q0 = blockIdx.x * kT;
  const size_t base = static_cast<size_t>(bb) * P * C;

  Acc<T, C> accU, accL;
  accU.zero();
  accL.zero();
  for (int i0 = 0; i0 < P; i0 += kT) {
    gate_grad(t, pooledT + base, lz, U + base, dY + base, i0, q0, P);
    accU.template mma<true>(t.z, t.ldR, t.x, ldC);    // += rnd(Z)^T dY
    __syncthreads();
    load_tile(t.x, ldC, pooledT + base, C, i0, 0, kT, C, P, C);
    __syncthreads();
    accL.template mma<true>(t.ds, t.ldR, t.x, ldC);   // += dS^T pooledT
    __syncthreads();
  }
  float* stg = t.s + (threadIdx.x >> 5) * 256;
  accU.store(
      [&](int r, int c, float v) {
        if (q0 + r < P)
          dU[base + static_cast<size_t>(q0 + r) * C + c] = from_f32<T>(v);
      },
      stg);
  accL.store(
      [&](int r, int c, float v) {
        if (q0 + r < P) dlzp[base + static_cast<size_t>(q0 + r) * C + c] = v;
      },
      stg);
}

template <typename T, int C>
cudaError_t launch(const void* pooledT, const void* lz, const void* U,
                   const void* dY, void* dpT, void* dU, float* dlzp, int BB,
                   int P, cudaStream_t stream) {
  const int smem = static_cast<int>(GateBwdSmem<T, C>().total);
  cudaError_t err = cudaFuncSetAttribute(
      gate_rows_bwd_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gate_cols_bwd_kernel<T, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + kT - 1) / kT, BB);
  const T* pt = static_cast<const T*>(pooledT);
  const T* lt = static_cast<const T*>(lz);
  const T* ut = static_cast<const T*>(U);
  const T* dyt = static_cast<const T*>(dY);
  gate_rows_bwd_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      pt, lt, ut, dyt, static_cast<T*>(dpT), P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gate_cols_bwd_kernel<T, C><<<grid, kThreads, smem, stream>>>(
      pt, lt, ut, dyt, static_cast<T*>(dU), dlzp, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(const void* pooledT, const void* lz, const void* U,
                     const void* dY, void* dpT, void* dU, float* dlzp, int BB,
                     int P, int C, cudaStream_t stream) {
  if (C == 128)
    return launch<T, 128>(pooledT, lz, U, dY, dpT, dU, dlzp, BB, P, stream);
  if (C == 256)
    return launch<T, 256>(pooledT, lz, U, dY, dpT, dU, dlzp, BB, P, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the two launches (0 on success).  is_bf16 selects the type of pooledT,
// lz, U, dY, dpT and dU; dlzp is the [BB, P, C] fp32 per-batch dlz
// partials.  The caller checks the shapes: C 128 or 256, P % 8 == 0,
// BB <= 65535.
extern "C" int stf_zgate_bwd(const void* pooledT, const void* lz,
                             const void* U, const void* dY, void* dpT,
                             void* dU, void* dlzp, int BB, int P, int C,
                             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(dlzp);
  if (is_bf16)
    return static_cast<int>(
        launch_c<bf16>(pooledT, lz, U, dY, dpT, dU, p, BB, P, C, s));
  return static_cast<int>(
      launch_c<float>(pooledT, lz, U, dY, dpT, dU, p, BB, P, C, s));
}

extern "C" const char* stf_zgate_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
