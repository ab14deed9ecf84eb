// The fused SSD forward chunk walk, for either operand layout
// (ssd_walk_common.cuh).  Instantiated by ssd_fused_fwd.cu (the single
// layout) and ssd_fused_dirs_fwd.cu (the four-direction stack).
//
// Replaces the TPU forward bodies
//   medical_image_classification_tpu/kernels/ssd_fused_dirs_pallas.py
//     ::_fwd_kernel (:178)
//   medical_image_classification_tpu/kernels/ssd_fused_pallas.py
//     ::_fwd_kernel (:139)
// Computes, for every batch b, head h and chunk c, from S = 0 at c = 0,
// with a = acum[b, c, h] and E[i, j] = exp(a_i - a_j) for i >= j (else 0):
//   M     = rnd(scores[b, c] * E)                  scores = C B^T
//   dtx   = rnd(x * dtp)                           x: [l, P]
//   y     = rnd(M dtx + (C rnd(S)^T) * exp(a) + x * D[h])
//   Ssave[b, c, h] = rnd(S)                        (the state entering c)
//   S     = cdec[b, c, h] * S + rnd(dtx * dte)^T B
// where rnd() rounds to the operand type (bf16 or fp32) as the TPU body's
// .astype(mm_dtype) does, every product sums in fp32, the state is carried
// in fp32, and D is 0 in the single layout.
//
// What bounds it on this card: operations.  At MedSSD 224x224 stage 0 in
// bf16 (B 32, nc 14, l 224, H 8, P 64, N 512) the products are ~128 GFLOP,
// 0.1298 ms at 989 TFLOP/s (chip_smoke.py::_walk_bound); the bytes take
// less.  Every operand of every product is a value of the operand type, so
// in bf16 each product runs on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 accumulators); fp32 keeps full-fp32 products on the CUDA cores
// through the same tiles and fragments (warp_mma's fp32 overload), since
// TF32 would not hold fp32's gate.
//
// Design: only S depends on the walk, and its recurrence is elementwise in
// (p, n), so the walk splits over tiles of P and N; given the entering
// states, everything else is chunk-local.  Four launches, no atomics, every
// product block 8 warps:
//  0. prep_kernel: the rounded rows the products read, once per (b, c, h):
//     pre[0] = dtx = rnd(x dtp), pre[1] = rnd(dtx dte), and for the dirs
//     stack plain copies of the coupled B/C rows (tiles::copy_bc_rows), so
//     every later tile copy is a 16-byte piece of a plain row-major array.
//  1. gram_kernel (ssd_walk_tiles.cuh, shared with the backward): scores =
//     C B^T per (b, c), 64 x 64 lower tiles.
//  2. state_kernel: one block per (b, h, 64 of P, 64 of N) walks the chunks
//     in order with S in fp32 registers: rnd(S) to Ssave, the chunk's
//     Δ = rnd(dtx dte)^T B on the tensor cores, S = cdec S + Δ (the last
//     chunk's Δ is never read, so it is not computed).
//  3. out_kernel: one block per (b, c, h, 64 of P), all chunks at once,
//     owning all of a chunk's rows, so each Ssave tile is read once:
//     Y_off = C Ssave^T over N, scaled by e^a in registers, then Y_diag =
//     rnd(M) dtx over the tiles of j that reach a warp's rows, M's A
//     fragments built in registers from the fp32 scores and the acum row;
//     y through the layout with the D skip.
// Without saved states (eval) the entering states go to a workspace of
// Ssave's shape, which is all the output pass reads.  Operand tiles reach
// shared memory through cp.async, two buffers deep, in 16-byte pieces;
// ragged chunks and the N, P edges are zero-filled in shared memory, never
// padded in device memory.  A second launch gives the same bits.

#pragma once

#include "ssd_walk_tiles.cuh"

namespace ssd_walk {
namespace fwd {

using namespace mma_tiles;

// ----------------------------------------------------------- 0. prep

// pre[0] = dtx = rnd(x dtp), pre[1] = rnd(dtx dte), [B, nc, H, l, P] in the
// operand type, per (b, c, h) in scan-position order; for a coupled layout
// block h also copies B/C rows h, h + H, ... of chunk (b, c) to bc_copy
// ([2, B, nc, l, N]).  Grid (H, B nc); a warp per row, lanes along P in
// element pairs.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads)
    prep_kernel(Lay lay, const float* __restrict__ dte,
                const float* __restrict__ dtp, T* __restrict__ pre,
                T* __restrict__ bc_copy, Dims d) {
  __shared__ float sTp[kMaxL], sTe[kMaxL];
  const int h = blockIdx.x, bc = blockIdx.y;
  const int b = bc / d.nc, c = bc - b * d.nc;
  const int l = d.l, P = d.P;
  if constexpr (Lay::kCoupled)
    tiles::copy_bc_rows(lay, bc_copy, b, c, h, d.H, d);
  const size_t bch = d.bch(b, c, h), rowoff = bch * l;
  const size_t plane = static_cast<size_t>(d.B) * d.nc * d.H * l * P;
  for (int t = threadIdx.x; t < l; t += kThreads) {
    sTp[t] = dtp[rowoff + t];
    sTe[t] = dte[rowoff + t];
  }
  __syncthreads();
  T* o = pre + bch * l * P;
  for (int t = threadIdx.x >> 5; t < l; t += kThreads / 32) {
    const T* xr = lay.x_ptr(d, b, h, c, t);
    for (int p = 2 * (threadIdx.x & 31); p < P; p += 64) {
      const float2 xv = ld2(xr + p);
      const float v0 = rnd<T>(xv.x * sTp[t]), v1 = rnd<T>(xv.y * sTp[t]);
      const size_t e = static_cast<size_t>(t) * P + p;
      st2(o + e, v0, v1);
      st2(o + plane + e, v0 * sTe[t], v1 * sTe[t]);
    }
  }
}

// ------------------------------------------------------------ 2. state

template <typename T>
constexpr size_t state_smem() {
  return kStages * 2 * tile_bytes<T>(kT, kT);
}

// One block per (64 of P, 64 of N) x head x batch walks the chunks in
// order; warps 4 (P) x 2 (N) of 16 x 32 hold S in fp32 registers.  Per
// chunk c: Ssave(c) = rnd(S); Δ = rnd(dtx dte)^T B over the chunk's rows in
// stages of 64 (rnd(dtx dte) = pre[1]); S = cdec S + Δ.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads, 3)
    state_kernel(const T* __restrict__ Bm, const float* __restrict__ cdec,
                 const T* __restrict__ pre, T* __restrict__ ssave, Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  constexpr int ld = ld_of<T>(kT);
  T* sX[kStages];
  T* sB[kStages];
  for (int i = 0; i < kStages; ++i) {
    sX[i] = bump.take<T>(kT * ld);
    sB[i] = bump.take<T>(kT * ld);
  }
  const int P = d.P, N = d.N, l = d.l;
  const int nnt = (N + kT - 1) / kT;
  const int p0 = (blockIdx.x / nnt) * kT, n0 = (blockIdx.x % nnt) * kT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
  const bool active = p0 + wm < P && n0 + wn < N;
  const int nk = (l + kT - 1) / kT;
  const T* dtxd = pre + static_cast<size_t>(d.B) * d.nc * d.H * l * P;

  float S[1][4][4], dlt[1][4][4];
  zero_acc(S);
  zero_acc(dlt);
  // Ssave(c) = rnd(S): this warp's 16 x 32 tile
  const auto save = [&](int c) {
    if (!active) return;
    T* o = ssave + (d.bch(b, c, h) * P + p0 + wm + g) * N + n0 + wn + 2 * q;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        st2(o + static_cast<size_t>(8 * e) * N + 8 * ni, S[0][ni][2 * e],
            S[0][ni][2 * e + 1]);
  };
  pipeline(
      (d.nc - 1) * nk,
      [&](int s, int buf) {
        const int c = s / nk, t0 = (s - c * nk) * kT;
        const T* xc = dtxd + d.bch(b, c, h) * l * P;
        stage_as<T, 16>(sX[buf], ld, kT, kT, [&](int r, int k) -> const T* {
          return t0 + r < l && p0 + k < P
                     ? xc + static_cast<size_t>(t0 + r) * P + p0 + k
                     : nullptr;
        });
        const T* Bc = Bm + d.row(b, c, 0) * N;
        stage_as<T, 16>(sB[buf], ld, kT, kT, [&](int r, int k) -> const T* {
          return t0 + r < l && n0 + k < N
                     ? Bc + static_cast<size_t>(t0 + r) * N + n0 + k
                     : nullptr;
        });
      },
      [&](int s, int buf) {
        const int c = s / nk, kc = s - c * nk;
        if (kc == 0) save(c);
        if (active)
          warp_mma<1, 4, true, true>(dlt, sX[buf], ld, wm, sB[buf], ld, wn, 0,
                                     kT / 16);
        if (kc == nk - 1) {
          const float dec = cdec[d.bch(b, c, h)];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              S[0][ni][e] = dec * S[0][ni][e] + dlt[0][ni][e];
              dlt[0][ni][e] = 0.f;
            }
        }
      });
  save(d.nc - 1);
}

// ----------------------------------------------------------- 3. output

// M[i, j] = scores[i, j] exp(a_i - a_j) for j <= i < l, else 0 (fp32,
// before the operand type's rounding), at (i, j) and (i, j + 1); j is even
__device__ __forceinline__ float2 m_pair(const float* sc, const float* sA,
                                         int l, int i, int j) {
  if (i >= l || j > i) return make_float2(0.f, 0.f);
  const float2 s = *reinterpret_cast<const float2*>(
      sc + static_cast<size_t>(i) * l + j);
  const float ai = sA[i];
  return make_float2(s.x * expf(ai - sA[j]),
                     j + 1 <= i ? s.y * expf(ai - sA[j + 1]) : 0.f);
}

// acc[mi][ni] += rnd(M)[m0 + 16 mi .., j0 + k] dtx[j0 + k, 8 ni ..] over
// the k-steps of the 64-wide j tile at j0 that reach rows m0 .. m0 + 31;
// dtx is the staged tile sX[k][p].  bf16: rnd(M)'s A fragments are built
// in registers (the m16n8k16 layout: a[f] is row g + 8 (f & 1), columns
// 2 q + 8 (f >> 1), +1), dtx's come from ldmatrix.trans, mma.sync.
__device__ __forceinline__ void diag_mma(float (&acc)[2][8][4],
                                         const float* sc, const float* sA,
                                         int l, int m0,
                                         const __nv_bfloat16* sX, int ld,
                                         int j0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int r8 = lane & 7, h1 = (lane >> 3) & 1, h2 = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    const int k = j0 + 16 * kk;
    if (k > m0 + 31) break;
    unsigned a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float2 m = m_pair(sc, sA, l, m0 + 16 * mi + g + 8 * (f & 1),
                                k + 2 * q + 8 * (f >> 1));
        a[mi][f] = pack_bf16(m.x, m.y);
      }
#pragma unroll
    for (int nj = 0; nj < 8; nj += 2) {
      unsigned r[4];
      ldsm4_t(r, sX + (16 * kk + r8 + 8 * h1) * ld + 8 * nj + 8 * h2);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][nj], a[mi], r[0], r[1]);
        mma_bf16(acc[mi][nj + 1], a[mi], r[2], r[3]);
      }
    }
  }
}

// The fp32 form: the same fragments as FMAs on the CUDA cores.
__device__ __forceinline__ void diag_mma(float (&acc)[2][8][4],
                                         const float* sc, const float* sA,
                                         int l, int m0, const float* sX,
                                         int ld, int j0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int kend = min(kT, m0 + 32 - j0);
  for (int kk = 0; kk < kend; ++kk) {
    const int j = j0 + kk;
    float a[2][2], bv[8][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = m0 + 16 * mi + g + 8 * e;
        a[mi][e] = i < l && j <= i
                       ? sc[static_cast<size_t>(i) * l + j] *
                             expf(sA[i] - sA[j])
                       : 0.f;
      }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) bv[ni][e] = sX[kk * ld + 8 * ni + 2 * q + e];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        acc[mi][ni][0] += a[mi][0] * bv[ni][0];
        acc[mi][ni][1] += a[mi][0] * bv[ni][1];
        acc[mi][ni][2] += a[mi][1] * bv[ni][0];
        acc[mi][ni][3] += a[mi][1] * bv[ni][1];
      }
  }
}

template <typename T>
constexpr size_t out_smem() {
  return kStages * (tile_bytes<T>(kMaxL, kT) + tile_bytes<T>(kT, kT)) +
         align16(kMaxL * sizeof(float));
}

// One block per (64 of P) x head x (b, c), owning all of the chunk's rows:
// warp w takes rows [32 w, 32 w + 32) (warps past l idle) and the tile's 64
// columns of P.  Stages: N in 64s for Y_off = C Ssave^T (C rows [l, 64],
// an Ssave tile [64 of P, 64]), then the rows scaled by e^a; then the tiles
// of j for Y_diag = rnd(M) dtx (a dtx tile [64 of j, 64 of P]).  The
// epilogue adds x D and writes y through the layout.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads, 2)
    out_kernel(Lay lay, const T* __restrict__ Cm,
               const float* __restrict__ acum,
               const float* __restrict__ scores, const T* __restrict__ pre,
               const T* __restrict__ ssave, T* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  constexpr int ld = ld_of<T>(kT);
  T* sC[kStages];
  T* sV[kStages];  // an Ssave tile [p][n], then a dtx tile [j][p]
  for (int i = 0; i < kStages; ++i) {
    sC[i] = bump.take<T>(kMaxL * ld);
    sV[i] = bump.take<T>(kT * ld);
  }
  float* sA = bump.take<float>(kMaxL);

  const int P = d.P, N = d.N, l = d.l;
  const int p0 = blockIdx.x * kT;
  const int h = blockIdx.y, bc = blockIdx.z;
  const int b = bc / d.nc, c = bc - b * d.nc;
  const size_t bch = d.bch(b, c, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = warp * 32;
  const bool active = m0 < l;
  const int lr = (l + 31) / 32 * 32;  // rows staged, zero past l
  const T* Cc = Cm + d.row(b, c, 0) * N;
  const T* sin_h = ssave + bch * P * N;
  const T* dtx_h = pre + bch * l * P;
  const float* sc = scores + static_cast<size_t>(bc) * l * l;

  // read after the pipeline's first barrier
  for (int t = threadIdx.x; t < l; t += kThreads) sA[t] = acum[bch * l + t];

  float acc[2][8][4];
  zero_acc(acc);
  const int nn = (N + kT - 1) / kT, nj = (l + kT - 1) / kT;
  pipeline(
      nn + nj,
      [&](int s, int buf) {
        if (s < nn) {
          const int n0 = s * kT;
          stage_as<T, 16>(sC[buf], ld, lr, kT, [&](int r, int k) -> const T* {
            return r < l && n0 + k < N
                       ? Cc + static_cast<size_t>(r) * N + n0 + k
                       : nullptr;
          });
          stage_as<T, 16>(sV[buf], ld, kT, kT, [&](int r, int k) -> const T* {
            return p0 + r < P && n0 + k < N
                       ? sin_h + static_cast<size_t>(p0 + r) * N + n0 + k
                       : nullptr;
          });
          return;
        }
        const int j0 = (s - nn) * kT;
        stage_as<T, 16>(sV[buf], ld, kT, kT, [&](int r, int k) -> const T* {
          return j0 + r < l && p0 + k < P
                     ? dtx_h + static_cast<size_t>(j0 + r) * P + p0 + k
                     : nullptr;
        });
      },
      [&](int s, int buf) {
        if (!active) return;
        if (s < nn) {
          warp_mma<2, 8, false, false>(acc, sC[buf], ld, m0, sV[buf], ld, 0,
                                       0, kT / 16);
          if (s < nn - 1) return;
          // Y_off is complete: scale its rows by e^a
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = m0 + 16 * mi + g + 8 * e;
              const float ea = i < l ? expf(sA[i]) : 0.f;
#pragma unroll
              for (int ni = 0; ni < 8; ++ni) {
                acc[mi][ni][2 * e] *= ea;
                acc[mi][ni][2 * e + 1] *= ea;
              }
            }
          return;
        }
        diag_mma(acc, sc, sA, l, m0, sV[buf], ld, (s - nn) * kT);
      });

  if (!active) return;
  const float Dh = lay.D(h);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = m0 + 16 * mi + g + 8 * e;
      if (i >= l) continue;
      T* yr = y + lay.yrow(d, b, h, c, i) + p0;
      const T* xr = lay.x_ptr(d, b, h, c, i) + p0;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int p = 8 * ni + 2 * q;
        if (p0 + p >= P) continue;
        float v0 = acc[mi][ni][2 * e], v1 = acc[mi][ni][2 * e + 1];
        if constexpr (Lay::kHasD) {
          const float2 xv = ld2(xr + p);
          v0 += xv.x * Dh;
          v1 += xv.y * Dh;
        }
        st2(yr + p, v0, v1);
      }
    }
}

}  // namespace fwd

// The workspaces of the forward (the wrapper allocates them): scores
// [B, nc, l, l] fp32; pre [2, B, nc, H, l, P] and, for a coupled layout,
// bc [2, B, nc, l, N] in the operand type.
struct FwdWork {
  float* scores;
  void* pre;
  void* bc;
};

// What the card grants each of the four passes (prep, gram, state, out):
// out[4 * pass ..] = registers a thread, local (spill) bytes a thread,
// shared bytes a block, resident warps per SM.
template <typename T, class Lay>
cudaError_t fwd_pass_info(int* out) {
  using namespace fwd;
  cudaError_t err = pass_info(prep_kernel<T, Lay>, 0, out);
  if (err == cudaSuccess)
    err = pass_info(tiles::gram_kernel<T, Lay>, tiles::gram_smem<T>(),
                    out + 4);
  if (err == cudaSuccess)
    err = pass_info(state_kernel<T, Lay>, state_smem<T>(), out + 8);
  if (err == cudaSuccess)
    err = pass_info(out_kernel<T, Lay>, out_smem<T>(), out + 12);
  return err;
}

// The four launches of the forward on `stream`; the first CUDA error, or
// cudaSuccess.  ssave [B, nc, H, P, N] (operand type) takes rnd(S) entering
// each chunk: the saved states, or a workspace.
template <typename T, class Lay>
cudaError_t launch_fwd(const Lay& lay, const float* acum, const float* dte,
                       const float* cdec, const float* dtp, void* y_,
                       void* ssave_, const FwdWork& w, const Dims& d,
                       cudaStream_t stream) {
  using namespace fwd;
  if (d.l > kMaxL || d.l % 4 || d.P % 32 || d.N % 32)
    return cudaErrorInvalidValue;
  T* y = static_cast<T*>(y_);
  T* ssave = static_cast<T*>(ssave_);
  T* pre = static_cast<T*>(w.pre);
  // B/C rows as plain [B, nc, l, N] arrays: the layout's own, or copies
  T* bc_copy = static_cast<T*>(w.bc);
  const size_t bc_plane = static_cast<size_t>(d.B) * d.nc * d.l * d.N;
  const T* Bm = bc_copy;
  const T* Cm = bc_copy + bc_plane;
  if constexpr (!Lay::kCoupled) {
    Bm = lay.Bm;
    Cm = lay.C;
  }
  const int nt = (d.l + kT - 1) / kT;
  const int npt = (d.P + kT - 1) / kT, nnt = (d.N + kT - 1) / kT;
  cudaError_t err;
  prep_kernel<T, Lay><<<dim3(d.H, d.B * d.nc), kThreads, 0, stream>>>(
      lay, dte, dtp, pre, bc_copy, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define SSD_FWD_LAUNCH(kernel, smem, grid, ...)                         \
  err = allow_smem(kernel<T, Lay>, smem<T>());                          \
  if (err != cudaSuccess) return err;                                   \
  kernel<T, Lay><<<grid, kThreads, smem<T>(), stream>>>(__VA_ARGS__);    \
  err = cudaGetLastError();                                             \
  if (err != cudaSuccess) return err;
  SSD_FWD_LAUNCH(tiles::gram_kernel, tiles::gram_smem,
                 dim3(nt, nt, d.B * d.nc), Bm, Cm, w.scores, d)
  SSD_FWD_LAUNCH(state_kernel, state_smem, dim3(npt * nnt, d.H, d.B), Bm,
                 cdec, pre, ssave, d)
  SSD_FWD_LAUNCH(out_kernel, out_smem, dim3(npt, d.H, d.B * d.nc), lay, Cm,
                 acum, w.scores, pre, ssave, y, d)
#undef SSD_FWD_LAUNCH
  return cudaSuccess;
}

}  // namespace ssd_walk
