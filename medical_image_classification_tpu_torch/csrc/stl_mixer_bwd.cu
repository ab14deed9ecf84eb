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
// products).  E = exp(S - lse) comes from the forward's row log-sum-exp
// lse [BB, L].  No [L, P] tensor goes to device memory.
//
// What bounds it on this card: at ST-SSD stage 0 (BB 128, L = P = 3136,
// C 128, bf16) the TPU body's five products are 10 BB L P C ~ 1.6 TFLOP
// against ~0.4 GB moved: operations, by a wide margin.
//
// Design.  A row's dS needs its rowdot, a sum over all of P, before it
// exists; dV and dw sum over P per row of L, du1 sums over L per column
// of P, and blocks run in no order.  So two passes (stl_mixer_tiles.cuh),
// no atomics, the same bits on every run:
//  1. rows: per 128 rows of L (64 at C 256 or fp32), walks P twice with
//     the w and V rows as A operands.  Walk 1 computes S and dE, E from
//     lse, the rows' rowdot and dV += rnd(E) dU; rowdot goes to a [BB, L]
//     fp32 workspace.  Walk 2 computes S and dE again, dS and
//     dw += dS u1^T.  Six products.
//  2. cols: per 128 columns of P (64 at C 256 or fp32), walks L computing
//     the transposed tiles S^T = u1^T w^T and dE^T = dU V^T, so that
//     dS^T = rnd(E^T (dE^T - rowdot)) is already the A operand of
//     du1 += dS^T w.  Three products.
// Nine products where the TPU body makes five: S and dE are recomputed by
// each walk, since rowdot must be whole before any dS.  bf16 products run
// on the tensor cores (mma.sync m16n8k16, fp32 accumulators); at C 128 the
// A operands and the E and dS tiles never leave registers.

#include "stl_mixer_tiles.cuh"

namespace stl_mixer {

template <typename T, int C>
constexpr size_t bwd_rows_smem() {
  using F = Cfg<T, C>;
  return 2 * tile_bytes<T>(F::kRows, C) +
         kStages * (tile_bytes<T>(C, F::kStep) + tile_bytes<T>(F::kStep, C)) +
         xch_bytes<T, C>() + red_bytes();
}

template <typename T, int C>
constexpr size_t bwd_cols_smem() {
  using F = Cfg<T, C>;
  return tile_bytes<T>(C, F::kRows) + tile_bytes<T>(F::kRows, C) +
         kStages * (2 * tile_bytes<T>(F::kStep, C) +
                    2 * align16(F::kStep * sizeof(float))) +
         xch_bytes<T, C>();
}

// dV, dw and rowdot of kRows rows of L.  Grid (ceil(L / kRows), BB).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
    mixer_bwd_rows_kernel(const T* __restrict__ w, const T* __restrict__ u1,
                          const T* __restrict__ V, const T* __restrict__ dU,
                          const float* __restrict__ lse, T* __restrict__ dw,
                          T* __restrict__ dV, float* __restrict__ rowdot,
                          int L, int P) {
  using F = Cfg<T, C>;
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  T* sW = bump.take<T>(F::kRows * F::ldC);
  T* sVr = bump.take<T>(F::kRows * F::ldC);
  T* sU[kStages];
  T* sD[kStages];
  for (int i = 0; i < kStages; ++i) {
    sU[i] = bump.take<T>(C * F::ldS);
    sD[i] = bump.take<T>(F::kStep * F::ldC);
  }
  const Role<F> rl;
  T* xg = F::kRegs ? nullptr
                   : bump.take<T>(F::kGroups * 16 * F::ldS) +
                         rl.group * 16 * F::ldS;
  float* sRed = bump.take<float>(2 * kWarps * 16);
  const int bb = blockIdx.y, l0 = blockIdx.x * F::kRows;
  const size_t base = static_cast<size_t>(bb) * L * C;
  const T* dUb = dU + static_cast<size_t>(bb) * P * C;
  const int lr = l0 + 16 * rl.group + rl.g;  // this thread's rows lr, lr + 8

  stage_rows<T, C>(sW, w + base, l0, F::kRows, L);
  stage_rows<T, C>(sVr, V + base, l0, F::kRows, L);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  OpA<T, C, false> Aw, Av;
  Aw.init(sW, F::ldC, 16 * rl.group);
  Av.init(sVr, F::ldC, 16 * rl.group);
  float ls[2], lb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ls[r] = lr + 8 * r < L ? lse[static_cast<size_t>(bb) * L + lr + 8 * r]
                           : 0.f;
    lb[r] = ls[r] * kLog2e;
  }

  const int steps = (P + F::kStep - 1) / F::kStep;
  auto issue = [&](int s, int buf) {
    stage_cols<T, C>(sU[buf], F::ldS, u1, P, s * F::kStep, F::kStep);
    stage_rows<T, C>(sD[buf], dUb, s * F::kStep, F::kStep, P);
  };
  // the chunk at step column n0: E = exp(S - lse) (zero beyond P) in S,
  // dE = V dU^T in D
  auto scores = [&](float(&S)[1][F::NIs][4], float(&D)[1][F::NIs][4],
                    int buf, int pc, int n0) {
    zero_acc(S);
    zero_acc(D);
    Aw.template mma<F::NIs, true>(S, sU[buf], F::ldS, n0);
    Av.template mma<F::NIs, false>(D, sD[buf], F::ldC, n0);
#pragma unroll
    for (int ni = 0; ni < F::NIs; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = pc + 8 * ni + e < P;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = S[0][ni][2 * r + e];
          x = in ? exp_diff<T>(x, ls[r], lb[r]) : 0.f;
        }
      }
  };

  // walk 1: rowdot and dV += rnd(E) dU
  float rd[2] = {0.f, 0.f};
  {
    float o[1][F::NIo][4];
    zero_acc(o);
    pipeline(steps, issue, [&](int s, int buf) {
      step_product<T, C, true>(
          [&](float(&v)[1][F::NIs][4], int n0) {
            float D[1][F::NIs][4];
            scores(v, D, buf, s * F::kStep + n0 + 2 * rl.q, n0);
#pragma unroll
            for (int ni = 0; ni < F::NIs; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                rd[e >> 1] = fmaf(v[0][ni][e], D[0][ni][e], rd[e >> 1]);
          },
          o, sD[buf], F::ldC, xg, rl);
    });
    store_tile<F, C>(dV + base, l0 + 16 * rl.group, L, rl.half * F::kOut, o);
  }

  // rowdot: summed over the four lanes of a row, then over the NW warps of
  // a group in a fixed order (every warp of the group gets the same bits)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rd[r] += __shfl_xor_sync(0xffffffffu, rd[r], 1);
    rd[r] += __shfl_xor_sync(0xffffffffu, rd[r], 2);
  }
  if constexpr (F::NW > 1) {
    const int warp = threadIdx.x >> 5;
    if (rl.q == 0)
      for (int r = 0; r < 2; ++r) sRed[warp * 16 + rl.g + 8 * r] = rd[r];
    __syncthreads();
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
      for (int h = 0; h < F::NW; ++h)
        sum += sRed[(rl.group * F::NW + h) * 16 + rl.g + 8 * r];
      rd[r] = sum;
    }
  }
  if (rl.half == 0 && rl.q == 0)
    for (int r = 0; r < 2; ++r)
      if (lr + 8 * r < L)
        rowdot[static_cast<size_t>(bb) * L + lr + 8 * r] = rd[r];

  // walk 2: dw += rnd(E (dE - rowdot)) u1^T
  {
    float o[1][F::NIo][4];
    zero_acc(o);
    pipeline(steps, issue, [&](int s, int buf) {
      step_product<T, C, false>(
          [&](float(&v)[1][F::NIs][4], int n0) {
            float D[1][F::NIs][4];
            scores(v, D, buf, s * F::kStep + n0 + 2 * rl.q, n0);
#pragma unroll
            for (int ni = 0; ni < F::NIs; ++ni)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                v[0][ni][e] *= D[0][ni][e] - rd[e >> 1];
          },
          o, sU[buf], F::ldS, xg, rl);
    });
    store_tile<F, C>(dw + base, l0 + 16 * rl.group, L, rl.half * F::kOut, o);
  }
}

// du1p[bb] = dS^T w[bb] over kRows columns of P.  Grid (ceil(P / kRows),
// BB).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
    mixer_bwd_cols_kernel(const T* __restrict__ w, const T* __restrict__ u1,
                          const T* __restrict__ V, const T* __restrict__ dU,
                          const float* __restrict__ lse,
                          const float* __restrict__ rowdot,
                          float* __restrict__ du1p, int L, int P) {
  using F = Cfg<T, C>;
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  T* sU1 = bump.take<T>(C * F::ldR);
  T* sDr = bump.take<T>(F::kRows * F::ldC);
  T* sW[kStages];
  T* sV[kStages];
  float* sL[kStages];
  float* sR[kStages];
  for (int i = 0; i < kStages; ++i) {
    sW[i] = bump.take<T>(F::kStep * F::ldC);
    sV[i] = bump.take<T>(F::kStep * F::ldC);
    sL[i] = bump.take<float>(F::kStep);
    sR[i] = bump.take<float>(F::kStep);
  }
  const Role<F> rl;
  T* xg = F::kRegs ? nullptr
                   : bump.take<T>(F::kGroups * 16 * F::ldS) +
                         rl.group * 16 * F::ldS;
  const int bb = blockIdx.y, p0 = blockIdx.x * F::kRows;
  const size_t base = static_cast<size_t>(bb) * L * C;
  const float* lrow = lse + static_cast<size_t>(bb) * L;
  const float* rrow = rowdot + static_cast<size_t>(bb) * L;

  stage_cols<T, C>(sU1, F::ldR, u1, P, p0, F::kRows);
  stage_rows<T, C>(sDr, dU + static_cast<size_t>(bb) * P * C, p0, F::kRows,
                   P);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  OpA<T, C, true> Au;  // u1^T: A(p, c) = u1[c, p]
  Au.init(sU1, F::ldR, 16 * rl.group);
  OpA<T, C, false> Ad;  // dU rows
  Ad.init(sDr, F::ldC, 16 * rl.group);

  float o[1][F::NIo][4];
  zero_acc(o);
  pipeline(
      (L + F::kStep - 1) / F::kStep,
      [&](int s, int buf) {
        const int r0 = s * F::kStep;
        stage_rows<T, C>(sW[buf], w + base, r0, F::kStep, L);
        stage_rows<T, C>(sV[buf], V + base, r0, F::kStep, L);
        stage_vec(sL[buf], lrow, r0, F::kStep, L);
        stage_vec(sR[buf], rrow, r0, F::kStep, L);
      },
      [&](int s, int buf) {
        const int r0 = s * F::kStep;
        step_product<T, C, true>(
            [&](float(&v)[1][F::NIs][4], int n0) {
              float D[1][F::NIs][4];
              zero_acc(v);
              zero_acc(D);
              Au.template mma<F::NIs, false>(v, sW[buf], F::ldC, n0);  // S^T
              Ad.template mma<F::NIs, false>(D, sV[buf], F::ldC, n0);  // dE^T
#pragma unroll
              for (int ni = 0; ni < F::NIs; ++ni)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int j = n0 + 8 * ni + 2 * rl.q + e;
                  const bool in = r0 + j < L;
                  const float ls = sL[buf][j], lb = ls * kLog2e;
                  const float rdj = sR[buf][j];
#pragma unroll
                  for (int r = 0; r < 2; ++r) {
                    float& x = v[0][ni][2 * r + e];
                    const float E = in ? exp_diff<T>(x, ls, lb) : 0.f;
                    x = E * (D[0][ni][2 * r + e] - rdj);
                  }
                }
            },
            o, sW[buf], F::ldC, xg, rl);
      });
  store_tile<F, C>(du1p + static_cast<size_t>(bb) * P * C,
                   p0 + 16 * rl.group, P, rl.half * F::kOut, o);
}

template <typename T, int C>
cudaError_t launch(const void* w, const void* u1, const void* V,
                   const void* dU, const float* lse, void* dw, void* dV,
                   float* rowdot, float* du1p, int BB, int L, int P,
                   cudaStream_t stream) {
  using F = Cfg<T, C>;
  constexpr size_t rows_smem = bwd_rows_smem<T, C>();
  constexpr size_t cols_smem = bwd_cols_smem<T, C>();
  static_assert(rows_smem <= 232448 && cols_smem <= 232448,
                "a block's shared memory");
  cudaError_t err = allow_smem(mixer_bwd_rows_kernel<T, C>, rows_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(mixer_bwd_cols_kernel<T, C>, cols_smem);
  if (err != cudaSuccess) return err;
  const T* wt = static_cast<const T*>(w);
  const T* ut = static_cast<const T*>(u1);
  const T* vt = static_cast<const T*>(V);
  const T* dut = static_cast<const T*>(dU);
  mixer_bwd_rows_kernel<T, C>
      <<<dim3((L + F::kRows - 1) / F::kRows, BB), kThreads, rows_smem,
         stream>>>(wt, ut, vt, dut, lse, static_cast<T*>(dw),
                   static_cast<T*>(dV), rowdot, L, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mixer_bwd_cols_kernel<T, C>
      <<<dim3((P + F::kRows - 1) / F::kRows, BB), kThreads, cols_smem,
         stream>>>(wt, ut, vt, dut, lse, rowdot, du1p, L, P);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t info(int* out) {
  cudaError_t err =
      pass_info(mixer_bwd_rows_kernel<T, C>, bwd_rows_smem<T, C>(), out);
  if (err != cudaSuccess) return err;
  return pass_info(mixer_bwd_cols_kernel<T, C>, bwd_cols_smem<T, C>(),
                   out + 4);
}

}  // namespace stl_mixer

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the two launches (0 on success).  is_bf16 selects the type of w, u1, V,
// dU, dw and dV; lse is the forward's [BB, L] fp32 row log-sum-exp,
// rowdot a [BB, L] fp32 workspace and du1p the [BB, P, C] fp32 per-batch
// du1 partials.  The caller checks the shapes: C 128 or 256, P % 8 == 0,
// BB <= 65535.
extern "C" int stl_mixer_bwd(const void* w, const void* u1, const void* V,
                             const void* dU, const void* lse, void* dw,
                             void* dV, void* rowdot, void* du1p, int BB,
                             int L, int P, int C, int is_bf16, void* stream) {
  using namespace stl_mixer;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* rd = static_cast<float*>(rowdot);
  float* p = static_cast<float*>(du1p);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && C == 128)
    err = launch<bf16, 128>(w, u1, V, dU, ls, dw, dV, rd, p, BB, L, P, s);
  else if (is_bf16 && C == 256)
    err = launch<bf16, 256>(w, u1, V, dU, ls, dw, dV, rd, p, BB, L, P, s);
  else if (!is_bf16 && C == 128)
    err = launch<float, 128>(w, u1, V, dU, ls, dw, dV, rd, p, BB, L, P, s);
  else if (!is_bf16 && C == 256)
    err = launch<float, 256>(w, u1, V, dU, ls, dw, dV, rd, p, BB, L, P, s);
  return static_cast<int>(err);
}

// What the card grants the two passes (rows, cols) at (C, is_bf16):
// out[4 * pass ..] = registers a thread, local (spill) bytes a thread,
// shared bytes a block, resident warps per SM.
extern "C" int stl_mixer_bwd_pass_info(int C, int is_bf16, int* out) {
  using namespace stl_mixer;
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && C == 128) err = info<bf16, 128>(out);
  else if (is_bf16 && C == 256) err = info<bf16, 256>(out);
  else if (!is_bf16 && C == 128) err = info<float, 128>(out);
  else if (!is_bf16 && C == 256) err = info<float, 256>(out);
  return static_cast<int>(err);
}

extern "C" const char* stl_mixer_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
