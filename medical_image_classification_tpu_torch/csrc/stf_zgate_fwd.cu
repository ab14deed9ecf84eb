// ST-SSD fusion gate, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/stf_zgate_pallas.py
//   ::_fwd_kernel (launched by _run_fwd).
//
// Computes, for every bb of the batch,
//   Z = rnd(sigmoid(pooledT[bb] . lz))   [P, P], fp32 sums and gate, rounded
//                                        to the operand type
//   Y[bb] = Z . U[bb]                    [P, C], fp32 sums, written rounded
// with pooledT, U [BB, P, C] and lz [C, P].  No [P, P] tensor goes to
// device memory.
//
// What bounds it on this card: at ST-SSD stage 0 (BB 32, P 3136, C 128,
// bf16) the two products are 4 BB P^2 C ~ 0.16 TFLOP against ~0.08 GB
// moved: operations.
//
// Design (simple and right first): the rows of Z are independent, so one
// block per (64 rows of P, bb) keeps its pooledT rows and a [64, C] fp32
// accumulator (32 KB at stage 0's C 128, 64 KB at stage 1's 256) and walks
// the columns of Z in 64-wide tiles: S = pooledT_rows . lz[:, q], Z =
// rnd(sigmoid(S)), Y += Z . U[q].  P 784 is not a multiple of 64: the tile
// edges are masked (a masked column gets Z = 0, not sigmoid(0)).  bf16 on
// the tensor cores (WMMA), fp32 on the CUDA cores (st_tiles.cuh); C is a
// template parameter (128 or 256).

#include "st_tiles.cuh"

namespace {

using namespace st_tiles;

// shared memory of a block, byte offsets: the pooledT rows [64][C], lz's
// columns [C][64], the U rows [64][C], the fp32 S tile and the rounded Z
// tile (bf16 only: fp32 gates in place)
template <typename T, int C>
struct StfSmem {
  size_t a, lz, u, s, z, total;
  __host__ __device__ StfSmem() {
    const size_t rows = round128(kT * ld<T>(C) * sizeof(T));
    a = 0;
    lz = a + rows;
    u = lz + round128(C * ld<T>(kT) * sizeof(T));
    s = u + rows;
    z = s + round128(kT * kLdS * sizeof(float));
    total = z + (std::is_same<T, float>::value
                     ? 0
                     : round128(kT * ld<T>(kT) * sizeof(T)));
  }
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    zgate_kernel(const T* __restrict__ pooledT, const T* __restrict__ lz,
                 const T* __restrict__ U, T* __restrict__ Y, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StfSmem<T, C> S;
  constexpr bool kF32 = std::is_same<T, float>::value;
  T* sA = reinterpret_cast<T*>(smem + S.a);
  T* sLz = reinterpret_cast<T*>(smem + S.lz);
  T* sU = reinterpret_cast<T*>(smem + S.u);
  float* sS = reinterpret_cast<float*>(smem + S.s);
  T* sZ = reinterpret_cast<T*>(smem + (kF32 ? S.s : S.z));
  const int ldC = ld<T>(C), ld64 = ld<T>(kT);
  const int ldZ = kF32 ? kLdS : ld64;
  const int bb = blockIdx.y, p0 = blockIdx.x * kT;
  const size_t base = static_cast<size_t>(bb) * P * C;

  load_tile(sA, ldC, pooledT + base, C, p0, 0, kT, C, P, C);
  Acc<T, C> acc;
  acc.zero();
  for (int q0 = 0; q0 < P; q0 += kT) {
    load_tile(sLz, ld64, lz, P, 0, q0, C, kT, C, P);
    load_tile(sU, ldC, U + base, C, q0, 0, kT, C, P, C);
    __syncthreads();
    gemm_s<false>(sS, sA, ldC, sLz, ld64, C);        // S = pooledT lz
    __syncthreads();
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e - r * kT;
      const float z =
          q0 + c < P ? 1.f / (1.f + expf(-sS[r * kLdS + c])) : 0.f;
      sZ[r * ldZ + c] = from_f32<T>(z);
    }
    __syncthreads();
    acc.template mma<false>(sZ, ldZ, sU, ldC);       // Y += Z U
    __syncthreads();
  }
  T* Yb = Y + base;
  acc.store(
      [&](int r, int c, float v) {
        if (p0 + r < P)
          Yb[static_cast<size_t>(p0 + r) * C + c] = from_f32<T>(v);
      },
      sS + (threadIdx.x >> 5) * 256);
}

template <typename T, int C>
cudaError_t launch(const void* pooledT, const void* lz, const void* U,
                   void* Y, int BB, int P, cudaStream_t stream) {
  const size_t smem = StfSmem<T, C>().total;
  const cudaError_t err = cudaFuncSetAttribute(
      zgate_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  zgate_kernel<T, C><<<dim3((P + kT - 1) / kT, BB), kThreads, smem, stream>>>(
      static_cast<const T*>(pooledT), static_cast<const T*>(lz),
      static_cast<const T*>(U), static_cast<T*>(Y), P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_c(const void* pooledT, const void* lz, const void* U,
                     void* Y, int BB, int P, int C, cudaStream_t stream) {
  if (C == 128) return launch<T, 128>(pooledT, lz, U, Y, BB, P, stream);
  if (C == 256) return launch<T, 256>(pooledT, lz, U, Y, BB, P, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the CUDA error of the
// launch (0 on success).  is_bf16 selects the type of every operand.  The
// caller checks the shapes: C 128 or 256, P % 8 == 0, BB <= 65535.
extern "C" int stf_zgate_fwd(const void* pooledT, const void* lz,
                             const void* U, void* Y, int BB, int P, int C,
                             int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(launch_c<bf16>(pooledT, lz, U, Y, BB, P, C, s));
  return static_cast<int>(launch_c<float>(pooledT, lz, U, Y, BB, P, C, s));
}

extern "C" const char* stf_zgate_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
