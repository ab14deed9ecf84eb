// The fused SSD forward chunk walk, for either operand layout
// (ssd_walk_common.cuh).  Instantiated by ssd_fused_fwd.cu (the single
// layout) and ssd_fused_dirs_fwd.cu (the four-direction stack).
//
// Computes, for every batch b, head h and chunk c in order, with
// a = acum[b, c, h] and E[i, j] = exp(a_i - a_j) for i >= j (else 0):
//   M     = rnd(scores[b, c] * E)                  scores = C B^T
//   dtx   = rnd(x * dtp)                           x: [l, P]
//   y     = rnd(M dtx + (C rnd(S)^T) * exp(a) + x * D[h])
//   Ssave[b, c, h] = rnd(S)                        (the state entering c)
//   S     = cdec[b, c, h] * S + rnd(dtx * dte)^T B
// where rnd() rounds to the operand type (bf16 or fp32) as the TPU body's
// .astype(mm_dtype) does, every product sums in fp32, and D is 0 in the
// single layout.
//
// Design (simple and right first): two passes.
//  1. scores_kernel (ssd_walk_common.cuh) writes C B^T per (b, c) to a
//     [B, nc, l, l] fp32 workspace, once for all heads: the TPU body kept
//     it in VMEM across its head grid axis.
//  2. fwd_walk_kernel: one block per (b, head, 32 columns of P) walks the
//     chunks in order with its [32, N] fp32 state in shared memory (64 KB at
//     N 512), so Y_off = C S^T and the state update stay local; the head's
//     x, dtx, cumsum rows and a staging tile are in shared memory too.
// All products run on the CUDA cores in fp32 (FMA over operand-type values)
// from shared-memory tiles; tensor cores (mma/wgmma) are later work.

#pragma once

#include "ssd_walk_common.cuh"

namespace ssd_walk {

// Shared memory of the walking block, in floats.
struct FwdSmem {
  int LP, N;
  __host__ __device__ FwdSmem(int l, int N_) : LP((l + 31) / 32 * 32),
                                               N(N_) {}
  __host__ __device__ int S() const { return 0; }                 // [32][N+1]
  __host__ __device__ int x() const { return kPT * (N + 1); }     // [LP][32]
  __host__ __device__ int dtx() const { return x() + LP * kPT; }  // [LP][32]
  __host__ __device__ int a() const { return dtx() + LP * kPT; }  // [LP]
  __host__ __device__ int dtp() const { return a() + LP; }        // [LP]
  __host__ __device__ int dte() const { return dtp() + LP; }      // [LP]
  __host__ __device__ int stage() const { return dte() + LP; }    // 32 x 128
  __host__ __device__ int total() const { return stage() + 32 * 128; }
};

// Its shared memory allows one block per SM at N 512, so ptxas may spend
// registers freely (left to itself it chose 64 and spilled).
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_walk_kernel(Lay lay, const float* __restrict__ acum,
                    const float* __restrict__ dte,
                    const float* __restrict__ cdec,
                    const float* __restrict__ dtp,
                    const float* __restrict__ scores, T* __restrict__ y,
                    T* __restrict__ ssave, Dims d) {
  extern __shared__ float smem[];
  const FwdSmem L(d.l, d.N);
  const int N = d.N, NP = d.N + 1, l = d.l, LP = L.LP;
  float* sS = smem + L.S();
  float* sx = smem + L.x();
  float* sdtx = smem + L.dtx();
  float* sa = smem + L.a();
  float* sdtp = smem + L.dtp();
  float* sdte = smem + L.dte();
  float* stg = smem + L.stage();

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float Dh = lay.D(h);

  for (int e = tid; e < kPT * NP; e += kThreads) sS[e] = 0.f;
  __syncthreads();

  for (int c = 0; c < d.nc; ++c) {
    const size_t rowoff = d.bch(b, c, h) * l;
    for (int t = tid; t < LP; t += kThreads) {
      const bool in = t < l;
      sa[t] = in ? acum[rowoff + t] : 0.f;
      sdtp[t] = in ? dtp[rowoff + t] : 0.f;
      sdte[t] = in ? dte[rowoff + t] : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < LP * kPT; e += kThreads) {
      const int t = e / kPT, p = e % kPT;
      const float xv = t < l ? lay.load_x(d, b, h, c, t, p0 + p) : 0.f;
      sx[e] = xv;
      sdtx[e] = rnd<T>(xv * sdtp[t]);
    }
    if (ssave != nullptr) {
      T* dst = ssave + (d.bch(b, c, h) * d.P + p0) * N;
      for (int e = tid; e < kPT * N; e += kThreads) {
        const int p = e / N, n = e - p * N;
        dst[static_cast<size_t>(p) * N + n] = from_f32<T>(sS[p * NP + n]);
      }
    }
    __syncthreads();

    // y, 32 rows at a time: lane = column p, warp = 4 rows
    const float* sc = scores + (static_cast<size_t>(b) * d.nc + c) * l * l;
    for (int i0 = 0; i0 < l; i0 += 32) {
      float accD[4] = {0.f, 0.f, 0.f, 0.f};
      float accO[4] = {0.f, 0.f, 0.f, 0.f};
      // Y_diag = M dtx over j <= i
      for (int j0 = 0; j0 < i0 + 32 && j0 < l; j0 += 32) {
        for (int e = tid; e < 32 * 32; e += kThreads) {
          const int ii = e / 32, jj = e % 32;
          const int i = i0 + ii, j = j0 + jj;
          float m = 0.f;
          if (i < l && j <= i)
            m = rnd<T>(sc[static_cast<size_t>(i) * l + j] *
                       expf(sa[i] - sa[j]));
          stg[ii * 33 + jj] = m;
        }
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < 32; ++jj) {
          const float dv = sdtx[(j0 + jj) * kPT + lane];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            accD[q] += stg[(warp * 4 + q) * 33 + jj] * dv;
        }
        __syncthreads();
      }
      // Y_off = C rnd(S)^T
      for (int n0 = 0; n0 < N; n0 += 32) {
        for (int e = tid; e < 32 * 32; e += kThreads) {
          const int ii = e / 32, nn = e % 32;
          const int i = i0 + ii;
          stg[ii * 33 + nn] = i < l ? lay.load_C(d, b, c, i, n0 + nn) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int nn = 0; nn < 32; ++nn) {
          const float sv = rnd<T>(sS[lane * NP + n0 + nn]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            accO[q] += stg[(warp * 4 + q) * 33 + nn] * sv;
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + warp * 4 + q;
        if (i < l) {
          float v = accD[q] + accO[q] * expf(sa[i]);
          if (Lay::kHasD) v += sx[i * kPT + lane] * Dh;
          y[lay.yrow(d, b, h, c, i) + p0 + lane] = from_f32<T>(v);
        }
      }
    }

    // the state update: S = cdec S + rnd(dtx * dte)^T B
    for (int e = tid; e < LP * kPT; e += kThreads) {
      const int t = e / kPT;
      sdtx[e] = rnd<T>(sdtx[e] * sdte[t]);
    }
    __syncthreads();
    const float dec = cdec[d.bch(b, c, h)];
    for (int n0 = 0; n0 < N; n0 += 128) {
      float acc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = 0.f;
      for (int t0 = 0; t0 < l; t0 += 32) {
        for (int e = tid; e < 32 * 128; e += kThreads) {
          const int tt = e / 128, nn = e % 128;
          const int t = t0 + tt, n = n0 + nn;
          stg[e] = (t < l && n < N) ? lay.load_B(d, b, c, t, n) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int tt = 0; tt < 32; ++tt) {
          const float dd = sdtx[(t0 + tt) * kPT + lane];
#pragma unroll
          for (int k = 0; k < 16; ++k)
            acc[k] += dd * stg[tt * 128 + warp + 8 * k];
        }
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int n = n0 + warp + 8 * k;
        if (n < N) sS[lane * NP + n] = dec * sS[lane * NP + n] + acc[k];
      }
    }
    __syncthreads();
  }
}

// The two launches of the forward on `stream`; the first CUDA error, or
// cudaSuccess.  ssave may be null (no saved states); scores is a
// [B, nc, l, l] fp32 workspace.  The caller checks the shapes: P % 32 == 0,
// l <= 256, N <= 512 and a multiple of 32.
template <typename T, class Lay>
cudaError_t launch_fwd(const Lay& lay, const float* acum, const float* dte,
                       const float* cdec, const float* dtp, void* y,
                       void* ssave, float* scores, const Dims& d,
                       cudaStream_t stream) {
  const int nt = (d.l + kTile - 1) / kTile;
  scores_kernel<T, Lay><<<dim3(nt, nt, d.B * d.nc), kThreads, 0, stream>>>(
      lay, scores, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = FwdSmem(d.l, d.N).total() * sizeof(float);
  err = cudaFuncSetAttribute(fwd_walk_kernel<T, Lay>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fwd_walk_kernel<T, Lay>
      <<<dim3(d.P / kPT, d.H, d.B), kThreads, smem, stream>>>(
          lay, acum, dte, cdec, dtp, scores, static_cast<T*>(y),
          static_cast<T*>(ssave), d);
  return cudaGetLastError();
}

}  // namespace ssd_walk
