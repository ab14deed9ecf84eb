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
// with w, V [BB, L, C] and u1 [C, P], and each row's log-sum-exp
// lse = log(sum over P of exp(S)) [BB, L] fp32, which the backward reads
// instead of walking P again.  No [L, P] tensor goes to device memory.
//
// What bounds it on this card: at ST-SSD stage 0 (BB 128, L = P = 3136,
// C 128, bf16) the two products are 4 BB L P C ~ 0.64 TFLOP against
// ~0.3 GB moved: operations, by a wide margin.
//
// Design.  The softmax runs over P, the axis the output keeps, and U sums
// over L; a row's E exists only once its whole row of S has been seen, and
// the TPU body's [P, C] fp32 accumulator does not fit a block.  So two
// passes (stl_mixer_tiles.cuh), no atomics, the same bits on every run:
//  1. rows: per 128 rows of L (64 at C 256 or fp32), walks P and keeps,
//     per thread and row, the running max and sum of exp(S - max) of the
//     columns it holds; the lanes and warps of a row merge theirs at the
//     end, lse = max + log(sum).  One product.
//  2. cols: per 128 columns of P (64 at C 256 or fp32), walks L computing
//     the transposed tile S^T = u1^T w^T directly, so that
//     E^T = rnd(exp(S^T - lse)) is already the A operand of U += E^T V.
//     Two products.
// Three products where the bound counts two: the second S is the price of
// a softmax over the kept axis.  bf16 products run on the tensor cores
// (mma.sync m16n8k16, fp32 accumulators); at C 128 the u1 / w operand and
// the E tile never leave registers.

#include "stl_mixer_tiles.cuh"

namespace stl_mixer {

template <typename T, int C>
constexpr size_t fwd_rows_smem() {
  using F = Cfg<T, C>;
  return tile_bytes<T>(F::kRows, C) + kStages * tile_bytes<T>(C, F::kStep) +
         red_bytes();
}

template <typename T, int C>
constexpr size_t fwd_cols_smem() {
  using F = Cfg<T, C>;
  return tile_bytes<T>(C, F::kRows) +
         kStages * (2 * tile_bytes<T>(F::kStep, C) +
                    align16(F::kStep * sizeof(float))) +
         xch_bytes<T, C>();
}

// (m, n) <- the max and sum of exp(. - max) over both sets of columns.
// A sum is rescaled by exp(m - mx) of the difference, exactly 1 for the
// set that holds the max: a factor 2^(m log2e - round(mx log2e)) would
// miss 1 by the rounding of mx log2e, and a row whose max stays put would
// drift by it at every step (2e-5 in lse over P 3136).
template <typename T>
__device__ __forceinline__ void merge_stats(float& m, float& n, float mo,
                                            float no) {
  const float mx = fmaxf(m, mo);
  if (mx == neg_inf()) return;  // neither has seen a column
  n = n * exp_delta<T>(m - mx) + no * exp_delta<T>(mo - mx);
  m = mx;
}

// lse[bb, l] = log(sum over P of exp(S[l, :])).  Grid (ceil(L / kRows),
// BB).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 2)
    mixer_fwd_rows_kernel(const T* __restrict__ w, const T* __restrict__ u1,
                          float* __restrict__ lse, int L, int P) {
  using F = Cfg<T, C>;
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  T* sW = bump.take<T>(F::kRows * F::ldC);
  T* sU[kStages];
  for (int i = 0; i < kStages; ++i) sU[i] = bump.take<T>(C * F::ldS);
  float* sRed = bump.take<float>(2 * kWarps * 16);
  const Role<F> rl;
  const int bb = blockIdx.y, l0 = blockIdx.x * F::kRows;

  stage_rows<T, C>(sW, w + static_cast<size_t>(bb) * L * C, l0, F::kRows,
                   L);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  OpA<T, C, false> A;
  A.init(sW, F::ldC, 16 * rl.group);

  // this thread's rows g and g + 8: the max and sum over its columns
  float m[2] = {neg_inf(), neg_inf()}, n[2] = {0.f, 0.f};
  pipeline(
      (P + F::kStep - 1) / F::kStep,
      [&](int s, int buf) {
        stage_cols<T, C>(sU[buf], F::ldS, u1, P, s * F::kStep, F::kStep);
      },
      [&](int s, int buf) {
#pragma unroll
        for (int ch = 0; ch < F::kCols / F::kChunk; ++ch) {
          const int n0 = rl.half * F::kCols + ch * F::kChunk;
          const int pc = s * F::kStep + n0 + 2 * rl.q;
          float v[1][F::NIs][4];
          zero_acc(v);
          A.template mma<F::NIs, true>(v, sU[buf], F::ldS, n0);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float tm = neg_inf();
#pragma unroll
            for (int ni = 0; ni < F::NIs; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (pc + 8 * ni + e < P) tm = fmaxf(tm, v[0][ni][2 * r + e]);
            const float mx = fmaxf(m[r], tm);
            if (mx == neg_inf()) continue;
            const float mb = mx * kLog2e;
            float sum = n[r] * exp_delta<T>(m[r] - mx);  // see merge_stats
#pragma unroll
            for (int ni = 0; ni < F::NIs; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (pc + 8 * ni + e < P)
                  sum += exp_diff<T>(v[0][ni][2 * r + e], mx, mb);
            m[r] = mx;
            n[r] = sum;
          }
        }
      });

  // merge over the four lanes of a row, then over the NW warps of a group
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float no = __shfl_xor_sync(0xffffffffu, n[r], off);
      merge_stats<T>(m[r], n[r], mo, no);
    }
  const int warp = threadIdx.x >> 5;
  if constexpr (F::NW > 1) {
    if (rl.q == 0)
      for (int r = 0; r < 2; ++r) {
        sRed[warp * 16 + rl.g + 8 * r] = m[r];
        sRed[(kWarps + warp) * 16 + rl.g + 8 * r] = n[r];
      }
    __syncthreads();
    if (rl.half == 0)
      for (int h = 1; h < F::NW; ++h)
        for (int r = 0; r < 2; ++r) {
          const int o = (warp + h) * 16 + rl.g + 8 * r;
          merge_stats<T>(m[r], n[r], sRed[o], sRed[kWarps * 16 + o]);
        }
  }
  if (rl.half == 0 && rl.q == 0)
    for (int r = 0; r < 2; ++r) {
      const int l = l0 + 16 * rl.group + rl.g + 8 * r;
      if (l < L) lse[static_cast<size_t>(bb) * L + l] = m[r] + logf(n[r]);
    }
}

// U[bb] = rnd(exp(S - lse))^T V[bb].  Grid (ceil(P / kRows), BB).
template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1)
    mixer_fwd_cols_kernel(const T* __restrict__ w, const T* __restrict__ u1,
                          const T* __restrict__ V,
                          const float* __restrict__ lse, T* __restrict__ U,
                          int L, int P) {
  using F = Cfg<T, C>;
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  T* sU1 = bump.take<T>(C * F::ldR);
  T* sW[kStages];
  T* sV[kStages];
  float* sL[kStages];
  for (int i = 0; i < kStages; ++i) {
    sW[i] = bump.take<T>(F::kStep * F::ldC);
    sV[i] = bump.take<T>(F::kStep * F::ldC);
    sL[i] = bump.take<float>(F::kStep);
  }
  const Role<F> rl;
  T* xg = F::kRegs ? nullptr
                   : bump.take<T>(F::kGroups * 16 * F::ldS) +
                         rl.group * 16 * F::ldS;
  const int bb = blockIdx.y, p0 = blockIdx.x * F::kRows;
  const size_t base = static_cast<size_t>(bb) * L * C;
  const float* lrow = lse + static_cast<size_t>(bb) * L;

  stage_cols<T, C>(sU1, F::ldR, u1, P, p0, F::kRows);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  OpA<T, C, true> A;  // u1^T: A(p, c) = u1[c, p]
  A.init(sU1, F::ldR, 16 * rl.group);

  float o[1][F::NIo][4];
  zero_acc(o);
  pipeline(
      (L + F::kStep - 1) / F::kStep,
      [&](int s, int buf) {
        const int r0 = s * F::kStep;
        stage_rows<T, C>(sW[buf], w + base, r0, F::kStep, L);
        stage_rows<T, C>(sV[buf], V + base, r0, F::kStep, L);
        stage_vec(sL[buf], lrow, r0, F::kStep, L);
      },
      [&](int s, int buf) {
        const int r0 = s * F::kStep;
        step_product<T, C, true>(
            [&](float(&v)[1][F::NIs][4], int n0) {
              zero_acc(v);
              A.template mma<F::NIs, false>(v, sW[buf], F::ldC, n0);  // S^T
#pragma unroll
              for (int ni = 0; ni < F::NIs; ++ni)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int j = n0 + 8 * ni + 2 * rl.q + e;
                  const bool in = r0 + j < L;
                  const float ls = sL[buf][j], lb = ls * kLog2e;
#pragma unroll
                  for (int r = 0; r < 2; ++r) {
                    float& x = v[0][ni][2 * r + e];
                    x = in ? exp_diff<T>(x, ls, lb) : 0.f;
                  }
                }
            },
            o, sV[buf], F::ldC, xg, rl);
      });
  store_tile<F, C>(U + static_cast<size_t>(bb) * P * C, p0 + 16 * rl.group,
                   P, rl.half * F::kOut, o);
}

template <typename T, int C>
cudaError_t launch(const void* w, const void* u1, const void* V, void* U,
                   float* lse, int BB, int L, int P, cudaStream_t stream) {
  using F = Cfg<T, C>;
  constexpr size_t rows_smem = fwd_rows_smem<T, C>();
  constexpr size_t cols_smem = fwd_cols_smem<T, C>();
  static_assert(rows_smem <= 232448 && cols_smem <= 232448,
                "a block's shared memory");
  cudaError_t err = allow_smem(mixer_fwd_rows_kernel<T, C>, rows_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(mixer_fwd_cols_kernel<T, C>, cols_smem);
  if (err != cudaSuccess) return err;
  const T* wt = static_cast<const T*>(w);
  const T* ut = static_cast<const T*>(u1);
  mixer_fwd_rows_kernel<T, C>
      <<<dim3((L + F::kRows - 1) / F::kRows, BB), kThreads, rows_smem,
         stream>>>(wt, ut, lse, L, P);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mixer_fwd_cols_kernel<T, C>
      <<<dim3((P + F::kRows - 1) / F::kRows, BB), kThreads, cols_smem,
         stream>>>(wt, ut, static_cast<const T*>(V), lse, static_cast<T*>(U),
                   L, P);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t info(int* out) {
  cudaError_t err =
      pass_info(mixer_fwd_rows_kernel<T, C>, fwd_rows_smem<T, C>(), out);
  if (err != cudaSuccess) return err;
  return pass_info(mixer_fwd_cols_kernel<T, C>, fwd_cols_smem<T, C>(),
                   out + 4);
}

}  // namespace stl_mixer

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the two launches (0 on success).  is_bf16 selects the type of w, u1, V
// and U; lse is the [BB, L] fp32 output of each row's log-sum-exp.  The
// caller checks the shapes: C 128 or 256, P % 8 == 0, BB <= 65535.
extern "C" int stl_mixer_fwd(const void* w, const void* u1, const void* V,
                             void* U, void* lse, int BB, int L, int P, int C,
                             int is_bf16, void* stream) {
  using namespace stl_mixer;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(lse);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && C == 128)
    err = launch<bf16, 128>(w, u1, V, U, st, BB, L, P, s);
  else if (is_bf16 && C == 256)
    err = launch<bf16, 256>(w, u1, V, U, st, BB, L, P, s);
  else if (!is_bf16 && C == 128)
    err = launch<float, 128>(w, u1, V, U, st, BB, L, P, s);
  else if (!is_bf16 && C == 256)
    err = launch<float, 256>(w, u1, V, U, st, BB, L, P, s);
  return static_cast<int>(err);
}

// What the card grants the two passes (rows, cols) at (C, is_bf16):
// out[4 * pass ..] = registers a thread, local (spill) bytes a thread,
// shared bytes a block, resident warps per SM.
extern "C" int stl_mixer_fwd_pass_info(int C, int is_bf16, int* out) {
  using namespace stl_mixer;
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16 && C == 128) err = info<bf16, 128>(out);
  else if (is_bf16 && C == 256) err = info<bf16, 256>(out);
  else if (!is_bf16 && C == 128) err = info<float, 128>(out);
  else if (!is_bf16 && C == 256) err = info<float, 256>(out);
  return static_cast<int>(err);
}

extern "C" const char* stl_mixer_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
