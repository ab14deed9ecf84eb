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
// moved: operations (the BB P^2 sigmoids on the MUFU unit come close).
//
// Design.  Rows of Z are independent, so one pass (stf_zgate_tiles.cuh):
// per 128 rows of P (64 at C 256 or fp32) and bb, the block walks the
// columns q of Z in steps of kStep, lz's columns [C, kStep] (the same for
// every bb, L2-resident) and U's rows [kStep, C] coming through two
// cp.async buffers.  Each step a warp computes S = pooledT_rows . lz_q into
// fp32 accumulators, Z = sigmoid(S) in registers (0 at q >= P, not
// sigmoid(0)), rounds Z at the TPU body's rounding point and adds Z . U_q
// into its [16, C] fp32 output.  bf16 products run on the tensor cores
// (mma.sync m16n8k16); at C 128 the pooledT rows and Z never leave
// registers.

#include "stf_zgate_tiles.cuh"

namespace stf_zgate {

template <typename T, int C>
constexpr size_t fwd_smem() {
  using F = Cfg<T, C>;
  return tile_bytes<T>(F::kRows, C) +
         kStages * (tile_bytes<T>(C, F::kStep) + tile_bytes<T>(F::kStep, C)) +
         xch_bytes<T, C>();
}

// Y[bb] = rnd(sigmoid(pooledT[bb] lz)) U[bb] over kRows rows of P.  Grid
// (ceil(P / kRows), BB).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
    zgate_fwd_rows_kernel(const T* __restrict__ pooledT,
                          const T* __restrict__ lz, const T* __restrict__ U,
                          T* __restrict__ Y, int P) {
  using F = Cfg<T, C>;
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  T* sA = bump.take<T>(F::kRows * F::ldC);
  T* sL[kStages];
  T* sU[kStages];
  for (int i = 0; i < kStages; ++i) {
    sL[i] = bump.take<T>(C * F::ldS);
    sU[i] = bump.take<T>(F::kStep * F::ldC);
  }
  const Role<F> rl;
  T* xg = F::kRegs ? nullptr
                   : bump.take<T>(F::kGroups * 16 * F::ldS) +
                         rl.group * 16 * F::ldS;
  const int bb = blockIdx.y, i0 = blockIdx.x * F::kRows;
  const size_t base = static_cast<size_t>(bb) * P * C;

  stage_rows<T, C>(sA, pooledT + base, i0, F::kRows, P);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  OpA<T, C, false> A;  // pooledT rows
  A.init(sA, F::ldC, 16 * rl.group);

  float o[1][F::NIo][4];
  zero_acc(o);
  pipeline(
      (P + F::kStep - 1) / F::kStep,
      [&](int s, int buf) {
        stage_cols<T, C>(sL[buf], F::ldS, lz, P, s * F::kStep, F::kStep);
        stage_rows<T, C>(sU[buf], U + base, s * F::kStep, F::kStep, P);
      },
      [&](int s, int buf) {
        step_product<T, C, true>(
            [&](float(&v)[1][F::NIs][4], int n0) {
              zero_acc(v);
              A.template mma<F::NIs, true>(v, sL[buf], F::ldS, n0);  // S
              gate<T>(v, s * F::kStep + n0 + 2 * rl.q, P);
            },
            o, sU[buf], F::ldC, xg, rl);
      });
  store_tile<F, C>(Y + base, i0 + 16 * rl.group, P, rl.half * F::kOut, o);
}

template <typename T, int C>
cudaError_t launch(const void* pooledT, const void* lz, const void* U,
                   void* Y, int BB, int P, cudaStream_t stream) {
  using F = Cfg<T, C>;
  constexpr size_t smem = fwd_smem<T, C>();
  static_assert(smem <= 232448, "a block's shared memory");
  const cudaError_t err = allow_smem(zgate_fwd_rows_kernel<T, C>, smem);
  if (err != cudaSuccess) return err;
  zgate_fwd_rows_kernel<T, C>
      <<<dim3((P + F::kRows - 1) / F::kRows, BB), kThreads, smem, stream>>>(
          static_cast<const T*>(pooledT), static_cast<const T*>(lz),
          static_cast<const T*>(U), static_cast<T*>(Y), P);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t info(int* out) {
  return pass_info(zgate_fwd_rows_kernel<T, C>, fwd_smem<T, C>(), out);
}

}  // namespace stf_zgate

// Plain C interface, loaded with ctypes.  Returns the CUDA error of the
// launch (0 on success).  is_bf16 selects the type of every operand.  The
// caller checks the shapes: C 128 or 256, P % 8 == 0, BB <= 65535.
extern "C" int stf_zgate_fwd(const void* pooledT, const void* lz,
                             const void* U, void* Y, int BB, int P, int C,
                             int is_bf16, void* stream) {
  using namespace stf_zgate;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && C == 128)
    err = launch<bf16, 128>(pooledT, lz, U, Y, BB, P, s);
  else if (is_bf16 && C == 256)
    err = launch<bf16, 256>(pooledT, lz, U, Y, BB, P, s);
  else if (!is_bf16 && C == 128)
    err = launch<float, 128>(pooledT, lz, U, Y, BB, P, s);
  else if (!is_bf16 && C == 256)
    err = launch<float, 256>(pooledT, lz, U, Y, BB, P, s);
  return static_cast<int>(err);
}

// What the card grants the one pass (rows) at (C, is_bf16): out[0 .. 3] =
// registers a thread, local (spill) bytes a thread, shared bytes a block,
// resident warps per SM.
extern "C" int stf_zgate_fwd_pass_info(int C, int is_bf16, int* out) {
  using namespace stf_zgate;
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && C == 128) err = info<bf16, 128>(out);
  else if (is_bf16 && C == 256) err = info<bf16, 256>(out);
  else if (!is_bf16 && C == 128) err = info<float, 128>(out);
  else if (!is_bf16 && C == 256) err = info<float, 256>(out);
  return static_cast<int>(err);
}

extern "C" const char* stf_zgate_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
