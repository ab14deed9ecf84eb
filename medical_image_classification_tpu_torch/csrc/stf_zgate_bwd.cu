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
// Design.  dpooledT sums over the columns q of Z per row, dU and dlz over
// the rows i per column, and blocks run in no order; one pass with a
// dpooledT atomic sum would change the bits from run to run.  So two
// passes (stf_zgate_tiles.cuh), no atomics, the same bits on every run:
//  1. rows: per 128 rows i of P (64 at C 256 or fp32) and bb, walks q with
//     the pooledT and dY rows as A operands: S = pT_i . lz_q,
//     dZ = dY_i . U_q^T, dS = rnd(dZ Z (1 - Z)) from the fp32 Z, and
//     dpooledT += dS . lz_q^T; the one lz_q tile serves both S and the
//     output product.  Three products.
//  2. cols: per 128 columns q (64 at C 256 or fp32) and bb, walks i
//     computing the transposes S^T = lz_q^T . pT_i^T and
//     dZ^T = U_q . dY_i^T directly, so that rnd(Z)^T and dS^T are already
//     the A operands of dU_q += Z^T . dY_i and dlzp_q += dS^T . pT_i.  Four
//     products, with chunks of 16 score columns where the operands stay in
//     registers.
// Seven products where the TPU body makes five: S and dZ are computed by
// each pass.  bf16 products run on the tensor cores (mma.sync m16n8k16,
// fp32 accumulators); at C 128 the A operands and the Z and dS tiles
// never leave registers.

#include "stf_zgate_tiles.cuh"

namespace stf_zgate {

template <typename T, int C>
constexpr size_t bwd_rows_smem() {
  using F = Cfg<T, C>;
  return 2 * tile_bytes<T>(F::kRows, C) +
         kStages * (tile_bytes<T>(C, F::kStep) + tile_bytes<T>(F::kStep, C)) +
         xch_bytes<T, C>();
}

template <typename T, int C>
constexpr size_t bwd_cols_smem() {
  using F = Cfg<T, C>;
  return tile_bytes<T>(C, F::kRows) + tile_bytes<T>(F::kRows, C) +
         kStages * 2 * tile_bytes<T>(F::kStep, C) + 2 * xch_bytes<T, C>();
}

// dpooledT[bb] = dS lz^T over kRows rows of P.  Grid (ceil(P / kRows),
// BB).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
    zgate_bwd_rows_kernel(const T* __restrict__ pooledT,
                          const T* __restrict__ lz, const T* __restrict__ U,
                          const T* __restrict__ dY, T* __restrict__ dpT,
                          int P) {
  using F = Cfg<T, C>;
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  T* sA = bump.take<T>(F::kRows * F::ldC);
  T* sD = bump.take<T>(F::kRows * F::ldC);
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
  stage_rows<T, C>(sD, dY + base, i0, F::kRows, P);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  OpA<T, C, false> Ap, Ad;  // pooledT rows, dY rows
  Ap.init(sA, F::ldC, 16 * rl.group);
  Ad.init(sD, F::ldC, 16 * rl.group);

  float o[1][F::NIo][4];
  zero_acc(o);
  pipeline(
      (P + F::kStep - 1) / F::kStep,
      [&](int s, int buf) {
        stage_cols<T, C>(sL[buf], F::ldS, lz, P, s * F::kStep, F::kStep);
        stage_rows<T, C>(sU[buf], U + base, s * F::kStep, F::kStep, P);
      },
      [&](int s, int buf) {
        step_product<T, C, false>(
            [&](float(&v)[1][F::NIs][4], int n0) {
              float D[1][F::NIs][4];
              zero_acc(v);
              zero_acc(D);
              Ap.template mma<F::NIs, true>(v, sL[buf], F::ldS, n0);   // S
              Ad.template mma<F::NIs, false>(D, sU[buf], F::ldC, n0);  // dZ
              gate<T>(v, s * F::kStep + n0 + 2 * rl.q, P, D);
#pragma unroll
              for (int ni = 0; ni < F::NIs; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) v[0][ni][e] = D[0][ni][e];
            },
            o, sL[buf], F::ldS, xg, rl);  // dpooledT += dS lz^T
      });
  store_tile<F, C>(dpT + base, i0 + 16 * rl.group, P, rl.half * F::kOut, o);
}

// dU[bb] = rnd(Z)^T dY[bb] and dlzp[bb] = dS^T pooledT[bb] over kRows
// columns of P.  Grid (ceil(P / kRows), BB).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
    zgate_bwd_cols_kernel(const T* __restrict__ pooledT,
                          const T* __restrict__ lz, const T* __restrict__ U,
                          const T* __restrict__ dY, T* __restrict__ dU,
                          float* __restrict__ dlzp, int P) {
  using F = ColsCfg<T, C>;
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  T* sL = bump.take<T>(C * F::ldR);
  T* sUq = bump.take<T>(F::kRows * F::ldC);
  T* sP[kStages];
  T* sD[kStages];
  for (int i = 0; i < kStages; ++i) {
    sP[i] = bump.take<T>(F::kStep * F::ldC);
    sD[i] = bump.take<T>(F::kStep * F::ldC);
  }
  const Role<F> rl;
  // the group's exchange tiles of rnd(Z)^T and dS^T (none where kRegs)
  T* xz = nullptr;
  T* xs = nullptr;
  if constexpr (!F::kRegs) {
    xz = bump.take<T>(F::kGroups * 16 * F::ldS) + rl.group * 16 * F::ldS;
    xs = bump.take<T>(F::kGroups * 16 * F::ldS) + rl.group * 16 * F::ldS;
  }
  const int bb = blockIdx.y, q0 = blockIdx.x * F::kRows;
  const size_t base = static_cast<size_t>(bb) * P * C;

  stage_cols<T, C>(sL, F::ldR, lz, P, q0, F::kRows);
  stage_rows<T, C>(sUq, U + base, q0, F::kRows, P);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  OpA<T, C, true> Al;   // lz^T: A(q, c) = lz[c, q]
  Al.init(sL, F::ldR, 16 * rl.group);
  OpA<T, C, false> Au;  // U rows
  Au.init(sUq, F::ldC, 16 * rl.group);

  float oU[1][F::NIo][4], oL[1][F::NIo][4];
  zero_acc(oU);
  zero_acc(oL);
  pipeline(
      (P + F::kStep - 1) / F::kStep,
      [&](int s, int buf) {
        stage_rows<T, C>(sP[buf], pooledT + base, s * F::kStep, F::kStep, P);
        stage_rows<T, C>(sD[buf], dY + base, s * F::kStep, F::kStep, P);
      },
      [&](int s, int buf) {
#pragma unroll
        for (int ch = 0; ch < F::kCols / F::kChunk; ++ch) {
          const int n0 = rl.half * F::kCols + ch * F::kChunk;
          float v[1][F::NIs][4], D[1][F::NIs][4];
          zero_acc(v);
          zero_acc(D);
          Al.template mma<F::NIs, false>(v, sP[buf], F::ldC, n0);  // S^T
          Au.template mma<F::NIs, false>(D, sD[buf], F::ldC, n0);  // dZ^T
          gate<T>(v, s * F::kStep + n0 + 2 * rl.q, P, D);
          if constexpr (F::kRegs) {
            unsigned a[F::NIs / 2][4];
            acc_to_a(a, v);
            warp_mma_ra<F::NIs / 2, F::NIo, true>(oU, a, sD[buf], F::ldC, 0,
                                                   n0);
            acc_to_a(a, D);
            warp_mma_ra<F::NIs / 2, F::NIo, true>(oL, a, sP[buf], F::ldC, 0,
                                                   n0);
          } else {
            put_tile(xz, F::ldS, n0, v);
            put_tile(xs, F::ldS, n0, D);
          }
        }
        if constexpr (!F::kRegs) {
          group_sync(1 + rl.group, 32 * F::NW);
          warp_mma<1, F::NIo, false, true>(oU, xz, F::ldS, 0, sD[buf], F::ldC,
                                           rl.half * F::kOut, 0,
                                           F::kStep / 16);
          warp_mma<1, F::NIo, false, true>(oL, xs, F::ldS, 0, sP[buf], F::ldC,
                                           rl.half * F::kOut, 0,
                                           F::kStep / 16);
        }
      });
  store_tile<F, C>(dU + base, q0 + 16 * rl.group, P, rl.half * F::kOut, oU);
  store_tile<F, C>(dlzp + base, q0 + 16 * rl.group, P, rl.half * F::kOut, oL);
}

template <typename T, int C>
cudaError_t launch(const void* pooledT, const void* lz, const void* U,
                   const void* dY, void* dpT, void* dU, float* dlzp, int BB,
                   int P, cudaStream_t stream) {
  using F = Cfg<T, C>;
  constexpr size_t rows_smem = bwd_rows_smem<T, C>();
  constexpr size_t cols_smem = bwd_cols_smem<T, C>();
  static_assert(rows_smem <= 232448 && cols_smem <= 232448,
                "a block's shared memory");
  cudaError_t err = allow_smem(zgate_bwd_rows_kernel<T, C>, rows_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(zgate_bwd_cols_kernel<T, C>, cols_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((P + F::kRows - 1) / F::kRows, BB);
  const T* pt = static_cast<const T*>(pooledT);
  const T* lt = static_cast<const T*>(lz);
  const T* ut = static_cast<const T*>(U);
  const T* dyt = static_cast<const T*>(dY);
  zgate_bwd_rows_kernel<T, C><<<grid, kThreads, rows_smem, stream>>>(
      pt, lt, ut, dyt, static_cast<T*>(dpT), P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  zgate_bwd_cols_kernel<T, C><<<grid, kThreads, cols_smem, stream>>>(
      pt, lt, ut, dyt, static_cast<T*>(dU), dlzp, P);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t info(int* out) {
  cudaError_t err =
      pass_info(zgate_bwd_rows_kernel<T, C>, bwd_rows_smem<T, C>(), out);
  if (err != cudaSuccess) return err;
  return pass_info(zgate_bwd_cols_kernel<T, C>, bwd_cols_smem<T, C>(),
                   out + 4);
}

}  // namespace stf_zgate

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the two launches (0 on success).  is_bf16 selects the type of pooledT,
// lz, U, dY, dpT and dU; dlzp is the [BB, P, C] fp32 per-batch dlz
// partials.  The caller checks the shapes: C 128 or 256, P % 8 == 0,
// BB <= 65535.
extern "C" int stf_zgate_bwd(const void* pooledT, const void* lz,
                             const void* U, const void* dY, void* dpT,
                             void* dU, void* dlzp, int BB, int P, int C,
                             int is_bf16, void* stream) {
  using namespace stf_zgate;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(dlzp);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && C == 128)
    err = launch<bf16, 128>(pooledT, lz, U, dY, dpT, dU, p, BB, P, s);
  else if (is_bf16 && C == 256)
    err = launch<bf16, 256>(pooledT, lz, U, dY, dpT, dU, p, BB, P, s);
  else if (!is_bf16 && C == 128)
    err = launch<float, 128>(pooledT, lz, U, dY, dpT, dU, p, BB, P, s);
  else if (!is_bf16 && C == 256)
    err = launch<float, 256>(pooledT, lz, U, dY, dpT, dU, p, BB, P, s);
  return static_cast<int>(err);
}

// What the card grants the two passes (rows, cols) at (C, is_bf16):
// out[4 * pass ..] = registers a thread, local (spill) bytes a thread,
// shared bytes a block, resident warps per SM.
extern "C" int stf_zgate_bwd_pass_info(int C, int is_bf16, int* out) {
  using namespace stf_zgate;
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && C == 128) err = info<bf16, 128>(out);
  else if (is_bf16 && C == 256) err = info<bf16, 256>(out);
  else if (!is_bf16 && C == 128) err = info<float, 128>(out);
  else if (!is_bf16 && C == 256) err = info<float, 256>(out);
  return static_cast<int>(err);
}

extern "C" const char* stf_zgate_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
