// The fused SSD backward chunk walk, for either operand layout
// (ssd_walk_common.cuh).  Instantiated by ssd_fused_bwd.cu (the single
// layout) and ssd_fused_dirs_bwd.cu (the four-direction stack).
//
// Replaces the TPU backward bodies
//   medical_image_classification_tpu/kernels/ssd_fused_dirs_pallas.py
//     ::_bwd_kernel (:240)
//   medical_image_classification_tpu/kernels/ssd_fused_pallas.py
//     ::_bwd_kernel (:193)
// With the TPU body's formulas (M = scores * E in fp32, rnd() = the operand
// type's rounding, every product summed in fp32), per (b, c, h):
//   ddtx_diag = rnd(M)^T dy            dM = dy dtx^T
//   dscores  += dM * E                 G  = dM * M
//   dacum     = rowsum(G) - colsum(G) + rowsum(dy * (C Sin^T) * e^a)
//   dYoff     = rnd(dy * e^a)          dSin = dYoff^T C
//   t         = B rnd(dSout)^T         ddtx = ddtx_diag + t * dte
//   dx        = rnd(ddtx * dtp + dy * D)
//   ddtp = rowsum(ddtx * x)   ddte = rowsum(t * dtx)   dD = sum(dy * x)
//   dcdec = sum(dSout * Sin)  dSout(c-1) = cdec * dSout + dSin
// (D and dD only where the layout has a D skip) and per (b, c) the B/C
// cotangents
//   dC = sum_h dYoff Sin + rnd(dscores) B
//   dB = sum_h rnd(dtx * dte) rnd(dSout) + rnd(dscores)^T C
// which the layout stores (the dirs layout writes the flipped halves at the
// mirrored chunk, reversed).
//
// What bounds it on this card: operations.  At MedSSD 224x224 stage 0 in
// bf16 (B 32, nc 14, l 224, H 8, P 64, N 512) the products above are ~360
// GFLOP, 0.3244 ms at 989 TFLOP/s (chip_smoke.py::_walk_bound); the bytes
// take less.  Every operand of every product is a value of the operand
// type, so in bf16 each product runs on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulators), which compute the TPU body's
// function with the sums in another order; fp32 keeps full-fp32 products
// on the CUDA cores through the same tiles and fragments (warp_mma's fp32
// overload), since TF32 would not hold fp32's gate.
//
// Design: only dSout(c) depends on the walk, and its recurrence is
// elementwise in (p, n), so the walk is a decayed sum of [P, N] tiles that
// splits over tiles of P and N; everything else is chunk-local.  Six
// launches, no atomics, every product block 8 warps with <= 128 registers
// (85 in the state and flush passes) and shared memory for two blocks an
// SM (three in those two):
//  0. prep_kernel: the rounded rows the products read, once: rnd(dy e^a),
//     rnd(x dtp), rnd(dtx dte) per (b, c, h), and for the dirs stack
//     plain copies of the coupled B/C rows, so every later tile copy is a
//     16-byte piece of a plain row-major array.
//  1. gram_kernel (ssd_walk_tiles.cuh, shared with the forward): scores =
//     C B^T per (b, c), 64 x 64 lower tiles.
//  2. intra_kernel: per (b, c, 64 x 64 tile), the heads in turn: dM on
//     the tensor cores, the head sum of dM E (rounded once, for the flush)
//     in registers, G's row and column sums as per-tile partials.
//  3. state_kernel: one block per (b, h, 64 of P, 64 of N) walks the
//     chunks in reverse with dS in fp32 registers: rnd(dSout(c)) to dso,
//     sum(dSout * Sin) as per-tile partials, dSin = dYoff^T C on the
//     tensor cores, dS = cdec dS + dSin.
//  4. chunk_kernel: one block per (b, c, h, 64 rows, 64 of P), all chunks
//     at once: t = B dso^T, Y_off = C Sin^T, ddtx_diag = rnd(M)^T dy on
//     the tensor cores, then dx and the row-sum and dD partials.
//  5. flush_kernel: per (b, c, 64 rows, 128 of N) the two products of each
//     B/C cotangent, depth H P + l.
// Operand tiles reach shared memory through cp.async, two buffers deep
// (three measured no faster), in 16-byte pieces; ragged chunks and the N,
// P edges are zero-filled in shared memory, never padded in device memory.
// The wrapper sums the partials with torch in a fixed order, so a second
// launch gives the same bits.

#pragma once

#include "ssd_walk_tiles.cuh"

namespace ssd_walk {
namespace bwd {

constexpr int kFlushN = 128; // N columns of a flush block

using namespace mma_tiles;

// ----------------------------------------------------------- 0. prep

// The operand-type rows every later pass stages instead of recomputing,
// per (b, c, h) in scan-position order, [B, nc, H, l, P] each:
//   pre[0] = dYoff = rnd(dy e^a), pre[1] = dtx = rnd(x dtp),
//   pre[2] = rnd(dtx dte);
// and, for a layout whose B/C rows are coupled from two places (the dirs
// stack), plain copies of them: bc[0] = B, bc[1] = C [B, nc, l, N], block
// h copying rows h, h + H, ....  Grid (H, B nc); a warp per row, lanes
// along P (N).
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads)
    prep_kernel(Lay lay, const float* __restrict__ acum,
                const float* __restrict__ dte, const float* __restrict__ dtp,
                const T* __restrict__ dy, T* __restrict__ pre,
                T* __restrict__ bc_copy, Dims d) {
  __shared__ float sEa[kMaxL], sTp[kMaxL], sTe[kMaxL];
  const int h = blockIdx.x, bc = blockIdx.y;
  const int b = bc / d.nc, c = bc - b * d.nc;
  const int l = d.l, P = d.P;
  if constexpr (Lay::kCoupled)
    tiles::copy_bc_rows(lay, bc_copy, b, c, h, d.H, d);
  const size_t bch = d.bch(b, c, h), rowoff = bch * l;
  const size_t plane = static_cast<size_t>(d.B) * d.nc * d.H * l * P;
  for (int t = threadIdx.x; t < l; t += kThreads) {
    sEa[t] = expf(acum[rowoff + t]);
    sTp[t] = dtp[rowoff + t];
    sTe[t] = dte[rowoff + t];
  }
  __syncthreads();
  T* o = pre + bch * l * P;
  for (int t = threadIdx.x >> 5; t < l; t += kThreads / 32) {
    const T* dyr = dy + lay.yrow(d, b, h, c, t);
    const T* xr = lay.x_ptr(d, b, h, c, t);
    for (int p = threadIdx.x & 31; p < P; p += 32) {
      const size_t e = static_cast<size_t>(t) * P + p;
      const float dtx = rnd<T>(to_f32(xr[p]) * sTp[t]);
      o[e] = from_f32<T>(to_f32(dyr[p]) * sEa[t]);
      o[plane + e] = from_f32<T>(dtx);
      o[2 * plane + e] = from_f32<T>(dtx * sTe[t]);
    }
  }
}

// fp32 rows [0, kT) of a row vector from src (16-byte pieces; rows of the
// [B, nc, H, l] arrays are 16-byte aligned since l % 4 == 0), zero past l
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int from, int l) {
  stage_as<float, 16>(dst, kT, 1, kT, [&](int, int k) -> const float* {
    return from + k < l ? src + from + k : nullptr;
  });
}

// ------------------------------------------------------------- 2. intra

template <typename T>
constexpr size_t intra_smem() {
  return kStages *
             (2 * tile_bytes<T>(kT, kT) + align16(2 * kT * sizeof(float))) +
         align16(kT * 2 * sizeof(float)) + align16(kT * 4 * sizeof(float));
}

// rnd(dscores) and the row/column sums of G over one 64 x 64 tile, summed
// over the heads.  Grid (nt, nt, B nc); warps 4 (rows i) x 2 (columns j)
// of 16 x 32.  Upper tiles (jt > it) write zeros.  Stages walk (head, 64
// of P) over dy and dtx (the walks' pre[1]); each head ends in its
// epilogue.  Without a scores workspace (Lay::kScoresWorkspace false) the
// first stages build the tile's scores = C B^T over N in 64s, in the
// registers the gram pass's warp would hold them in.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads, 2)
    intra_kernel(Lay lay, const float* __restrict__ acum,
                 const T* __restrict__ dy, const T* __restrict__ dtx,
                 const float* __restrict__ scores, T* __restrict__ dsr,
                 float* __restrict__ row_part, float* __restrict__ col_part,
                 Dims d) {
  const int nt = gridDim.x;
  const int it = blockIdx.y, jt = blockIdx.x;
  const int bc = blockIdx.z;
  const int b = bc / d.nc, c = bc - b * d.nc;
  const int i0 = it * kT, j0 = jt * kT;
  const int tid = threadIdx.x, l = d.l, P = d.P;
  T* ds_out = dsr + static_cast<size_t>(bc) * l * l;

  if (jt > it) {
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int i = i0 + e / kT, j = j0 + e % kT;
      if (i < l && j < l)
        ds_out[static_cast<size_t>(i) * l + j] = from_f32<T>(0.f);
    }
    for (int e = tid; e < d.H * kT; e += kThreads) {
      const int h = e / kT, r = e % kT;
      const size_t base = d.bch(b, c, h) * nt;
      if (i0 + r < l) row_part[(base + jt) * l + i0 + r] = 0.f;
      if (j0 + r < l) col_part[(base + it) * l + j0 + r] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  constexpr int ld = ld_of<T>(kT);
  T* sDy[kStages];
  T* sX[kStages];
  float* sA[kStages];  // [a_i | a_j] of the stage's head
  for (int i = 0; i < kStages; ++i) {
    sDy[i] = bump.take<T>(kT * ld);
    sX[i] = bump.take<T>(kT * ld);
    sA[i] = bump.take<float>(2 * kT);
  }
  float* redR = bump.take<float>(kT * 2);  // [row][warp column]
  float* redC = bump.take<float>(kT * 4);  // [column][warp row]

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int wm = wr * 16, wn = wc * 32;
  const int npc = (P + kT - 1) / kT;
  constexpr bool kGram = !Lay::kScoresWorkspace;
  const int nns = kGram ? (d.N + kT - 1) / kT : 0;  // stages of the scores

  float sc[1][4][4], ds[4][4], dm[1][4][4];
  zero_acc(sc);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + wm + g + 8 * (e >> 1);
      const int j = j0 + wn + 8 * ni + 2 * q + (e & 1);
      if constexpr (!kGram)
        if (i < l && j < l)
          sc[0][ni][e] = scores[(static_cast<size_t>(bc) * l + i) * l + j];
      ds[ni][e] = 0.f;
    }
  zero_acc(dm);

  pipeline(
      nns + d.H * npc,
      [&](int s, int buf) {
        if constexpr (kGram)
          if (s < nns) {
            const int n0 = s * kT, N = d.N;
            stage_as<T, 16>(sDy[buf], ld, kT, kT,
                            [&](int r, int k) -> const T* {
                              return i0 + r < l && n0 + k < N
                                         ? lay.C_ptr(d, b, c, i0 + r, n0 + k)
                                         : nullptr;
                            });
            stage_as<T, 16>(sX[buf], ld, kT, kT,
                            [&](int r, int k) -> const T* {
                              return j0 + r < l && n0 + k < N
                                         ? lay.B_ptr(d, b, c, j0 + r, n0 + k)
                                         : nullptr;
                            });
            return;
          }
        s -= nns;
        const int h = s / npc, pc = (s - h * npc) * kT;
        const size_t bch = d.bch(b, c, h);
        const T* dtx_h = dtx + bch * l * P;
        stage_as<T, 16>(sDy[buf], ld, kT, kT, [&](int r, int k) -> const T* {
          return i0 + r < l && pc + k < P
                     ? dy + lay.yrow(d, b, h, c, i0 + r) + pc + k
                     : nullptr;
        });
        stage_as<T, 16>(sX[buf], ld, kT, kT, [&](int r, int k) -> const T* {
          return j0 + r < l && pc + k < P
                     ? dtx_h + static_cast<size_t>(j0 + r) * P + pc + k
                     : nullptr;
        });
        stage_row(sA[buf], acum + bch * l, i0, l);
        stage_row(sA[buf] + kT, acum + bch * l, j0, l);
      },
      [&](int s, int buf) {
        if constexpr (kGram)
          if (s < nns) {
            warp_mma<1, 4, false, false>(sc, sDy[buf], ld, wm, sX[buf], ld,
                                         wn, 0, kT / 16);
            return;
          }
        s -= nns;
        const int h = s / npc;
        warp_mma<1, 4, false, false>(dm, sDy[buf], ld, wm, sX[buf], ld, wn,
                                     0, kT / 16);
        if (s - h * npc != npc - 1) return;
        // the head's epilogue: dscores += dM E, G = dM (scores E)
        const float* ai = sA[buf];
        const float* aj = sA[buf] + kT;
        float rs[2] = {0.f, 0.f}, cs[4][2] = {};
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = wm + g + 8 * (e >> 1);
            const int cc = wn + 8 * ni + 2 * q + (e & 1);
            const int i = i0 + r, j = j0 + cc;
            const float E =
                (i < l && j <= i) ? expf(ai[r] - aj[cc]) : 0.f;
            ds[ni][e] += dm[0][ni][e] * E;
            const float G = dm[0][ni][e] * (sc[0][ni][e] * E);
            rs[e >> 1] += G;
            cs[ni][e & 1] += G;
            dm[0][ni][e] = 0.f;
          }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 1);
          rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 2);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int m = 4; m < 32; m <<= 1)
              cs[ni][e] += __shfl_xor_sync(0xffffffffu, cs[ni][e], m);
        if (q == 0) {
          redR[(wm + g) * 2 + wc] = rs[0];
          redR[(wm + g + 8) * 2 + wc] = rs[1];
        }
        if (g == 0)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              redC[(wn + 8 * ni + 2 * q + e) * 4 + wr] = cs[ni][e];
        __syncthreads();
        const size_t base = d.bch(b, c, h) * nt;
        if (tid < kT) {
          if (i0 + tid < l)
            row_part[(base + jt) * l + i0 + tid] =
                redR[tid * 2] + redR[tid * 2 + 1];
        } else if (tid < 2 * kT) {
          const int r = tid - kT;
          if (j0 + r < l)
            col_part[(base + it) * l + j0 + r] =
                ((redC[r * 4] + redC[r * 4 + 1]) + redC[r * 4 + 2]) +
                redC[r * 4 + 3];
        }
      });
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = i0 + wm + g + 8 * e, j = j0 + wn + 8 * ni + 2 * q;
      if (i < l && j < l)
        st2(ds_out + static_cast<size_t>(i) * l + j, ds[ni][2 * e],
            ds[ni][2 * e + 1]);
    }
}

// -------------------------------------------------- 3. state-cotangent walk

template <typename T>
constexpr size_t state_smem() {
  return kStages * 3 * tile_bytes<T>(kT, kT) + align16(8 * sizeof(float));
}

// One block per (64 of P, 64 of N) x head x batch walks the chunks in
// reverse; warps 4 (P) x 2 (N) of 16 x 32 hold dS in fp32 registers.  Per
// chunk c: dso(c) = rnd(dS), dcdec partial sum(dS Sin(c)); dSin = dYoff^T
// C over the chunk's rows in stages of 64 (dYoff = pre[0]); dS = cdec dS +
// dSin.  A chunk's first stage also brings its Sin tile.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads, 3)
    state_kernel(const T* __restrict__ Cm, const float* __restrict__ cdec,
                 const T* __restrict__ ssave, const T* __restrict__ pre,
                 T* __restrict__ dso, float* __restrict__ dcdec_part,
                 Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  constexpr int ld = ld_of<T>(kT);
  T* sDy[kStages];
  T* sC[kStages];
  T* sSin[kStages];
  for (int i = 0; i < kStages; ++i) {
    sDy[i] = bump.take<T>(kT * ld);
    sC[i] = bump.take<T>(kT * ld);
    sSin[i] = bump.take<T>(kT * ld);
  }
  float* red = bump.take<float>(8);

  const int P = d.P, N = d.N, l = d.l;
  const int nnt = (N + kT - 1) / kT;
  const int tile = blockIdx.x, ntiles = gridDim.x;
  const int p0 = (tile / nnt) * kT, n0 = (tile % nnt) * kT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
  const bool active = p0 + wm < P && n0 + wn < N;
  const int nk = (l + kT - 1) / kT;

  float dS[1][4][4], dSin[1][4][4];
  zero_acc(dS);
  zero_acc(dSin);
  pipeline(
      d.nc * nk,
      [&](int s, int buf) {
        const int c = d.nc - 1 - s / nk, t0 = (s % nk) * kT;
        const size_t bch = d.bch(b, c, h);
        const T* dyo = pre + bch * l * P;
        stage_as<T, 16>(sDy[buf], ld, kT, kT, [&](int r, int k) -> const T* {
          return t0 + r < l && p0 + k < P
                     ? dyo + static_cast<size_t>(t0 + r) * P + p0 + k
                     : nullptr;
        });
        const T* Cc = Cm + d.row(b, c, 0) * N;
        stage_as<T, 16>(sC[buf], ld, kT, kT, [&](int r, int k) -> const T* {
          return t0 + r < l && n0 + k < N
                     ? Cc + static_cast<size_t>(t0 + r) * N + n0 + k
                     : nullptr;
        });
        if (t0 == 0) {
          const T* sin = ssave + bch * P * N;
          stage_as<T, 16>(sSin[buf], ld, kT, kT, [&](int r, int k) -> const T* {
            return p0 + r < P && n0 + k < N
                       ? sin + static_cast<size_t>(p0 + r) * N + n0 + k
                       : nullptr;
          });
        }
      },
      [&](int s, int buf) {
        const int c = d.nc - 1 - s / nk, kc = s % nk;
        const size_t bch = d.bch(b, c, h);
        if (kc == 0) {
          // dSout(c) = dS: rounded for the chunk pass and the flush, and
          // this tile's share of dcdec = sum(dSout * Sin)
          float cd = 0.f;
          if (active) {
            const size_t base = bch * P * N;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int pr = wm + g + 8 * e, nc_ = wn + 8 * ni + 2 * q;
                const float v0 = dS[0][ni][2 * e], v1 = dS[0][ni][2 * e + 1];
                st2(dso + base + static_cast<size_t>(p0 + pr) * N + n0 + nc_,
                    v0, v1);
                const float2 sv = ld2(sSin[buf] + pr * ld + nc_);
                cd += v0 * sv.x + v1 * sv.y;
              }
          }
          cd = block_sum(cd, red);
          if (tid == 0) dcdec_part[bch * ntiles + tile] = cd;
        }
        if (active)
          warp_mma<1, 4, true, true>(dSin, sDy[buf], ld, wm, sC[buf], ld, wn,
                                     0, kT / 16);
        if (kc == nk - 1) {
          const float dec = cdec[bch];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              dS[0][ni][e] = dec * dS[0][ni][e] + dSin[0][ni][e];
              dSin[0][ni][e] = 0.f;
            }
        }
      });
}

// --------------------------------------------------------- 4. chunk-local

template <typename T>
constexpr size_t chunk_smem() {
  return kStages * 4 * tile_bytes<T>(kT, kT) +
         align16((kMaxL + 2 * kT + 3 * 2 * kT + 8) * sizeof(float));
}

// One block per (64 rows, 64 of P) x head x (b, c); warps 4 (rows) x 2
// (P) of 16 x 32.  Stages: N in 64s for t = B dso^T and Y_off = C Sin^T,
// whose row sums (ddte, the Y_off term of dacum) are taken at once, t dte
// starting ddtx; then the row tiles i >= this one add ddtx_diag = rnd(M)^T
// dy to ddtx, M built in shared memory from a staged scores tile and the
// head's acum row.  The epilogue writes dx and the per-(row, P tile)
// partials of ddtp, ddte and the Y_off term, and one dD partial.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads, 2)
    chunk_kernel(Lay lay, const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const float* __restrict__ acum,
                 const float* __restrict__ dte, const float* __restrict__ dtp,
                 const T* __restrict__ ssave, const T* __restrict__ dy,
                 const T* __restrict__ dso, const float* __restrict__ scores,
                 T* __restrict__ dx, float* __restrict__ off_part,
                 float* __restrict__ ddte_part, float* __restrict__ ddtp_part,
                 float* __restrict__ dD_part, Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  constexpr int ld = ld_of<T>(kT), lds = kT + 4;
  // phase 1: B rows, C rows, dso, Sin; phase 2: the scores tile (fp32,
  // over the first two), dy, M
  T* sT[kStages][4];
  for (int i = 0; i < kStages; ++i)
    for (int j = 0; j < 4; ++j) sT[i][j] = bump.take<T>(kT * ld);
  static_assert(kT * (kT + 4) * sizeof(float) <=
                    2 * kT * ld_of<__nv_bfloat16>(kT) * 2,
                "the fp32 scores tile fits in two operand tiles");
  float* sA = bump.take<float>(kMaxL + 2 * kT + 3 * 2 * kT + 8);
  float* sDtp = sA + kMaxL;
  float* sDte = sDtp + kT;
  float* red = sDte + kT;  // [3][row][warp column]
  float* red8 = red + 3 * 2 * kT;

  const int P = d.P, N = d.N, l = d.l;
  const int npt = (P + kT - 1) / kT;
  const int rt = blockIdx.x / npt, pt = blockIdx.x - rt * npt;
  const int r0 = rt * kT, p0 = pt * kT;
  const int nrt = (l + kT - 1) / kT;
  const int h = blockIdx.y, bc = blockIdx.z;
  const int b = bc / d.nc, c = bc - b * d.nc;
  const size_t bch = d.bch(b, c, h);
  const size_t rowoff = bch * l;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wc = warp >> 2;
  const int wm = (warp & 3) * 16, wn = wc * 32;
  const bool active = p0 + wn < P;
  const float* sc = scores + static_cast<size_t>(bc) * l * l;
  const T* sin_h = ssave + bch * P * N;
  const T* dso_h = dso + bch * P * N;
  const T* Bc = Bm + d.row(b, c, 0) * N;
  const T* Cc = Cm + d.row(b, c, 0) * N;

  for (int t = tid; t < l; t += kThreads) sA[t] = acum[rowoff + t];
  for (int r = tid; r < kT; r += kThreads) {
    sDtp[r] = r0 + r < l ? dtp[rowoff + r0 + r] : 0.f;
    sDte[r] = r0 + r < l ? dte[rowoff + r0 + r] : 0.f;
  }
  __syncthreads();

  // this thread's dy and x at row wm + g + 8 e, columns wn + 8 ni + 2 q
  // (+ 1) of the tile
  const auto load_dyx = [&](float2 (&dyv)[2][4], float2 (&xv)[2][4]) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = min(r0 + wm + g + 8 * e, l - 1);
      const T* dyr = dy + lay.yrow(d, b, h, c, i) + p0 + wn + 2 * q;
      const T* xr = lay.x_ptr(d, b, h, c, i) + p0 + wn + 2 * q;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        dyv[e][ni] = ld2(dyr + 8 * ni);
        xv[e][ni] = ld2(xr + 8 * ni);
      }
    }
  };

  float accT[1][4][4], accY[1][4][4], ddtx[1][4][4];
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f}, s3[2] = {0.f, 0.f};
  zero_acc(accT);
  zero_acc(accY);
  const int nk1 = (N + kT - 1) / kT;
  pipeline(
      nk1 + nrt - rt,
      [&](int s, int buf) {
        if (s < nk1) {
          const int n0 = s * kT;
          const T* src[4] = {Bc, Cc, dso_h, sin_h};
          const int lim[4] = {r0 < l ? l - r0 : 0, l - r0, P - p0, P - p0};
          const int off[4] = {r0, r0, p0, p0};
          for (int j = 0; j < 4; ++j)
            stage_as<T, 16>(sT[buf][j], ld, kT, kT,
                            [&](int r, int k) -> const T* {
                              return r < lim[j] && n0 + k < N
                                         ? src[j] + static_cast<size_t>(
                                                        off[j] + r) * N +
                                               n0 + k
                                         : nullptr;
                            });
          return;
        }
        const int i0 = (rt + s - nk1) * kT;
        stage_as<float, 16>(
            reinterpret_cast<float*>(sT[buf][0]), lds, kT, kT,
            [&](int r, int k) -> const float* {
              return i0 + r < l && r0 + k < l
                         ? sc + static_cast<size_t>(i0 + r) * l + r0 + k
                         : nullptr;
            });
        stage_as<T, 16>(sT[buf][2], ld, kT, kT, [&](int r, int k) -> const T* {
          return i0 + r < l && p0 + k < P
                     ? dy + lay.yrow(d, b, h, c, i0 + r) + p0 + k
                     : nullptr;
        });
      },
      [&](int s, int buf) {
        if (s < nk1) {
          if (!active) return;
          warp_mma<1, 4, false, false>(accT, sT[buf][0], ld, wm, sT[buf][2],
                                       ld, wn, 0, kT / 16);
          warp_mma<1, 4, false, false>(accY, sT[buf][1], ld, wm, sT[buf][3],
                                       ld, wn, 0, kT / 16);
          if (s < nk1 - 1) return;
          // t and Y_off are complete: their row sums, and ddtx = t dte
          float2 dyv[2][4], xv[2][4];
          load_dyx(dyv, xv);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = wm + g + 8 * e, i = r0 + r;
            const float eA = i < l ? expf(sA[i]) : 0.f;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
#pragma unroll
              for (int f = 0; f < 2; ++f) {
                const float dyf = f ? dyv[e][ni].y : dyv[e][ni].x;
                const float xf = f ? xv[e][ni].y : xv[e][ni].x;
                const float tv = accT[0][ni][2 * e + f];
                s2[e] += tv * rnd<T>(xf * sDtp[r]);
                s3[e] += dyf * accY[0][ni][2 * e + f] * eA;
                ddtx[0][ni][2 * e + f] = tv * sDte[r];
              }
          }
          return;
        }
        // M[i, j] = rnd(scores[i, j] exp(a_i - a_j)), j > i zero
        const int i0 = (rt + s - nk1) * kT;
        const float* sS = reinterpret_cast<const float*>(sT[buf][0]);
        T* sM = sT[buf][3];
        for (int e = tid; e < kT * kT; e += kThreads) {
          const int ii = e / kT, jj = e - ii * kT;
          const int i = i0 + ii, j = r0 + jj;
          float m = 0.f;
          if (i < l && j <= i) m = sS[ii * lds + jj] * expf(sA[i] - sA[j]);
          sM[ii * ld + jj] = from_f32<T>(m);
        }
        __syncthreads();
        if (active)
          warp_mma<1, 4, true, true>(ddtx, sM, ld, wm, sT[buf][2], ld, wn, 0,
                                     kT / 16);
      });

  const float Dh = lay.D(h);
  float dD = 0.f;
  if (active) {
    float2 dyv[2][4], xv[2][4];
    load_dyx(dyv, xv);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = wm + g + 8 * e, i = r0 + r;
      if (i >= l) {
        s1[e] = s2[e] = s3[e] = 0.f;
        continue;
      }
      const float dtpv = sDtp[r];
      T* dxr = dx + lay.yrow(d, b, h, c, i) + p0 + wn + 2 * q;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float o[2];
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const float dyf = f ? dyv[e][ni].y : dyv[e][ni].x;
          const float xf = f ? xv[e][ni].y : xv[e][ni].x;
          const float dd = ddtx[0][ni][2 * e + f];
          float dxv = dd * dtpv;
          if (Lay::kHasD) dxv += dyf * Dh;
          o[f] = dxv;
          s1[e] += dd * xf;
          dD += dyf * xf;
        }
        st2(dxr + 8 * ni, o[0], o[1]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], m);
      s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], m);
      s3[e] += __shfl_xor_sync(0xffffffffu, s3[e], m);
    }
    if (q == 0) {
      const int r = wm + g + 8 * e;
      red[(0 * kT + r) * 2 + wc] = s1[e];
      red[(1 * kT + r) * 2 + wc] = s2[e];
      red[(2 * kT + r) * 2 + wc] = s3[e];
    }
  }
  __syncthreads();
  const size_t part = (bch * npt + pt) * l;
  if (tid < kT && r0 + tid < l) {
    const float* rr = red + 2 * tid;  // the two warp columns' row sums
    ddtp_part[part + r0 + tid] = rr[0] + rr[1];
    ddte_part[part + r0 + tid] = rr[2 * kT] + rr[2 * kT + 1];
    off_part[part + r0 + tid] = rr[4 * kT] + rr[4 * kT + 1];
  }
  if (Lay::kHasD) {
    dD = block_sum(dD, red8);
    if (tid == 0) dD_part[bch * (nrt * npt) + blockIdx.x] = dD;
  }
}

// ------------------------------------------------------------- 5. flush

template <typename T>
constexpr size_t flush_smem() {
  return kStages * (tile_bytes<T>(kT, kT) + tile_bytes<T>(kT, kFlushN));
}

// The B/C cotangents of chunk (b, c), 64 rows x 128 columns of N per
// block.  Grid (2 ceil(N / 128), nt, B nc); which = 0 computes dC, 1 dB:
//   out[r, n] = sum_{h, p} U_h[r, p] V_h[p, n] + sum_k W[r, k] Z[k, n]
//   dC: U = rnd(dy e^a) (pre[0]), V = Sin,  W = rnd(dscores),   Z = B
//   dB: U = rnd(dtx dte) (pre[2]), V = rnd(dSout), W = rnd(dscores)^T,
//       Z = C
// stored through the layout.  Warps 2 (rows) x 4 (N) of 32 x 32.  Stages
// of depth 64 (32 where P is an odd multiple of 32): the heads' P (none
// without the state: Y_diag's cotangents are the W Z terms alone), then k
// of W, which is zero off its triangle: dC's k runs to this row tile's
// end, dB's from its start.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads, 3)
    flush_kernel(Lay lay, const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const T* __restrict__ ssave,
                 const T* __restrict__ pre, const T* __restrict__ dso,
                 const T* __restrict__ dsr, Dims d) {
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  constexpr int ldu = ld_of<T>(kT), ldv = ld_of<T>(kFlushN);
  T* sU[kStages];  // U, or W: [r][k] for dC, [k][r] for dB
  T* sV[kStages];
  for (int i = 0; i < kStages; ++i) {
    sU[i] = bump.take<T>(kT * ldu);
    sV[i] = bump.take<T>(kT * ldv);
  }
  const int P = d.P, N = d.N, l = d.l;
  const int nnf = (N + kFlushN - 1) / kFlushN;
  const int which = blockIdx.x / nnf;
  const int n0 = (blockIdx.x - which * nnf) * kFlushN;
  const int r0 = blockIdx.y * kT;
  const int bc = blockIdx.z;
  const int b = bc / d.nc, c = bc - b * d.nc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const bool active = n0 + wn < N;
  const T* ds = dsr + static_cast<size_t>(bc) * l * l;
  const T* U = Lay::kHasState ? pre + (which == 0 ? 0 : 2) *
                                          static_cast<size_t>(d.B) * d.nc *
                                          d.H * l * P
                              : nullptr;
  const int kp = P % kT == 0 ? kT : 32;  // depth of a P stage
  const int nhp = Lay::kHasState ? d.HP / kp : 0;
  const int k_lo = which == 0 ? 0 : r0;
  const int k_hi = which == 0 ? min(l, r0 + kT) : l;
  const T* Z = (which == 0 ? Bm : Cm) + d.row(b, c, 0) * N;
  // dsr's rows are 16-byte aligned where l sizeof(T) is a multiple of 16,
  // else 8-byte (l % 4 == 0)
  const bool wide_rows = l * sizeof(T) % 16 == 0;

  float acc[2][4][4];
  zero_acc(acc);
  pipeline(
      nhp + (k_hi - k_lo + kT - 1) / kT,
      [&](int s, int buf) {
        if (s < nhp) {
          const int h = s * kp / P, pb = s * kp - h * P;
          const size_t bch = d.bch(b, c, h);
          const T* Uh = U + bch * l * P + pb;
          stage_as<T, 16>(sU[buf], ldu, kT, kp, [&](int r, int k) -> const T* {
            return r0 + r < l ? Uh + static_cast<size_t>(r0 + r) * P + k
                              : nullptr;
          });
          const T* V = (which == 0 ? ssave : dso) + (bch * P + pb) * N;
          stage_as<T, 16>(sV[buf], ldv, kp, kFlushN,
                          [&](int r, int k) -> const T* {
                            return n0 + k < N
                                       ? V + static_cast<size_t>(r) * N + n0 +
                                             k
                                       : nullptr;
                          });
          return;
        }
        const int k0 = k_lo + (s - nhp) * kT;
        // dC: W rows r, columns k; dB: dsr rows k, columns r (k-major W)
        const int ra = which == 0 ? r0 : k0, ca = which == 0 ? k0 : r0;
        const auto w_src = [&](int r, int k) -> const T* {
          return ra + r < l && ca + k < l
                     ? ds + static_cast<size_t>(ra + r) * l + ca + k
                     : nullptr;
        };
        if (wide_rows)
          stage_as<T, 16>(sU[buf], ldu, kT, kT, w_src);
        else
          stage_as<T, 8>(sU[buf], ldu, kT, kT, w_src);
        stage_as<T, 16>(sV[buf], ldv, kT, kFlushN,
                        [&](int r, int k) -> const T* {
                          return k0 + r < l && n0 + k < N
                                     ? Z + static_cast<size_t>(k0 + r) * N +
                                           n0 + k
                                     : nullptr;
                        });
      },
      [&](int s, int buf) {
        if (!active) return;
        if (s < nhp || which == 0)
          warp_mma<2, 4, false, true>(acc, sU[buf], ldu, wm, sV[buf], ldv,
                                      wn, 0, (s < nhp ? kp : kT) / 16);
        else
          warp_mma<2, 4, true, true>(acc, sU[buf], ldu, wm, sV[buf], ldv, wn,
                                     0, kT / 16);
      });
  if (!active) return;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + wm + 16 * mi + g + 8 * e;
        const int n = n0 + wn + 8 * ni + 2 * q;
        if (r < l)
          lay.store_grad2(d, which, b, c, r, n, acc[mi][ni][2 * e],
                          acc[mi][ni][2 * e + 1]);
      }
}

}  // namespace bwd

// The workspaces and per-block fp32 partials of the backward (the wrapper
// allocates them and sums the partials over their last axis): scores
// [B, nc, l, l] fp32; dsr [B, nc, l, l], pre [3, B, nc, H, l, P] and, for
// a coupled layout, bc [2, B, nc, l, N] in the operand type; row_part,
// col_part [B, nc, H, nt, l]; off_part, ddte_part, ddtp_part [B, nc, H,
// npt, l]; dD_part [B, nc, H, nt npt] (unused, and may be null, without a
// D skip); dcdec_part [B, nc, H, npt nnt]; with nt = ceil(l / 64), npt =
// ceil(P / 64), nnt = ceil(N / 64).
struct BwdWork {
  float* scores;
  void* dsr;
  void* pre;
  void* bc;
  float *row_part, *col_part, *off_part, *ddte_part, *ddtp_part, *dD_part,
      *dcdec_part;
};

// What the card grants each of the six passes (prep, gram, intra, state,
// chunk, flush): out[4 * pass ..] = registers a thread, local (spill)
// bytes a thread, shared bytes a block, resident warps per SM.
template <typename T, class Lay>
cudaError_t bwd_pass_info(int* out) {
  using namespace bwd;
  cudaError_t err = pass_info(prep_kernel<T, Lay>, 0, out);
  if (err == cudaSuccess)
    err = pass_info(tiles::gram_kernel<T, Lay>, tiles::gram_smem<T>(),
                    out + 4);
  if (err == cudaSuccess)
    err = pass_info(intra_kernel<T, Lay>, intra_smem<T>(), out + 8);
  if (err == cudaSuccess)
    err = pass_info(state_kernel<T, Lay>, state_smem<T>(), out + 12);
  if (err == cudaSuccess)
    err = pass_info(chunk_kernel<T, Lay>, chunk_smem<T>(), out + 16);
  if (err == cudaSuccess)
    err = pass_info(flush_kernel<T, Lay>, flush_smem<T>(), out + 20);
  return err;
}

// The six launches of the backward on `stream`; the first CUDA error, or
// cudaSuccess.  dso [B, nc, H, P, N] (operand type) takes rnd(dSout).
template <typename T, class Lay>
cudaError_t launch_bwd(const Lay& lay, const float* acum, const float* dte,
                       const float* cdec, const float* dtp,
                       const void* ssave_, const void* dy_, void* dx_,
                       void* dso_, const BwdWork& w, const Dims& d,
                       cudaStream_t stream) {
  using namespace bwd;
  if (d.l > kMaxL || d.l % 4 || d.P % 32 || d.N % 32)
    return cudaErrorInvalidValue;
  const T* ssave = static_cast<const T*>(ssave_);
  const T* dy = static_cast<const T*>(dy_);
  T* dx = static_cast<T*>(dx_);
  T* dso = static_cast<T*>(dso_);
  T* dsr = static_cast<T*>(w.dsr);
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
  const dim3 grid_tiles(nt, nt, d.B * d.nc);
  cudaError_t err;
  prep_kernel<T, Lay><<<dim3(d.H, d.B * d.nc), kThreads, 0, stream>>>(
      lay, acum, dte, dtp, dy, pre, bc_copy, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define SSD_BWD_LAUNCH(kernel, smem, grid, ...)                         \
  err = allow_smem(kernel<T, Lay>, smem<T>());                          \
  if (err != cudaSuccess) return err;                                   \
  kernel<T, Lay><<<grid, kThreads, smem<T>(), stream>>>(__VA_ARGS__);    \
  err = cudaGetLastError();                                             \
  if (err != cudaSuccess) return err;
  SSD_BWD_LAUNCH(tiles::gram_kernel, tiles::gram_smem, grid_tiles, Bm, Cm,
                 w.scores, d)
  SSD_BWD_LAUNCH(intra_kernel, intra_smem, grid_tiles, lay, acum, dy,
                 pre + static_cast<size_t>(d.B) * d.nc * d.H * d.l * d.P,
                 w.scores, dsr, w.row_part, w.col_part, d)
  SSD_BWD_LAUNCH(state_kernel, state_smem, dim3(npt * nnt, d.H, d.B), Cm,
                 cdec, ssave, pre, dso, w.dcdec_part, d)
  SSD_BWD_LAUNCH(chunk_kernel, chunk_smem, dim3(nt * npt, d.H, d.B * d.nc),
                 lay, Bm, Cm, acum, dte, dtp, ssave, dy, dso, w.scores, dx,
                 w.off_part, w.ddte_part, w.ddtp_part, w.dD_part, d)
  SSD_BWD_LAUNCH(flush_kernel, flush_smem,
                 dim3(2 * ((d.N + kFlushN - 1) / kFlushN), nt, d.B * d.nc),
                 lay, Bm, Cm, ssave, pre, dso, dsr, d)
#undef SSD_BWD_LAUNCH
  return cudaSuccess;
}

}  // namespace ssd_walk
