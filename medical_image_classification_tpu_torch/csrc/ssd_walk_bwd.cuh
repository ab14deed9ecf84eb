// The fused SSD backward chunk walk, for either operand layout
// (ssd_walk_common.cuh).  Instantiated by ssd_fused_bwd.cu (the single
// layout) and ssd_fused_dirs_bwd.cu (the four-direction stack).
//
// Walks the chunks in reverse from the saved boundary states Ssave, with
// the TPU body's formulas (M = scores * E in fp32, rnd() = the operand
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
// Design (simple and right first): four launches, no atomics.
//  1. scores_kernel recomputes C B^T per (b, c).
//  2. intra_kernel, per (b, c, 64 x 64 tile), loops over the heads: dM from
//     dy and x (neither depends on the walk), the head sum dscores in
//     registers, and G's row and column sums as per-tile partials.
//  3. bwd_walk_kernel, one block per (b, head, 32 columns of P), carries
//     dS [32, N] fp32 in shared memory through the chunks in reverse; it
//     writes dx, rnd(dSout) for step 4, and per-block partials of the row
//     sums, dD and dcdec.
//  4. flush_kernel, per (b, c, 64 rows, 64 columns of N), sums over heads
//     and positions the two products of each B/C cotangent.
// The wrapper sums the partials with torch, so a second launch gives the
// same bits.

#pragma once

#include "ssd_walk_common.cuh"

namespace ssd_walk {

// dscores and the row/column sums of G over one 64 x 64 tile, summed over
// the heads.  Grid (nt, nt, B nc).  Upper tiles (jt > it) write zeros.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads)
    intra_kernel(Lay lay, const float* __restrict__ acum,
                 const float* __restrict__ dtp, const T* __restrict__ dy,
                 const float* __restrict__ scores,
                 float* __restrict__ dscores, float* __restrict__ row_part,
                 float* __restrict__ col_part, Dims d) {
  constexpr int kK = 16;
  __shared__ float sDy[kK][kTile + 4];
  __shared__ float sDx[kK][kTile + 4];
  __shared__ float sai[kTile], saj[kTile], sdtpj[kTile];
  __shared__ float rowred[kTile][17], colred[kTile][17];
  const int nt = gridDim.x;
  const int it = blockIdx.y, jt = blockIdx.x;
  const int bc = blockIdx.z;
  const int b = bc / d.nc, c = bc - b * d.nc;
  const int i0 = it * kTile, j0 = jt * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int l = d.l;
  float* dsc = dscores + static_cast<size_t>(bc) * l * l;

  if (jt > it) {
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int i = i0 + e / kTile, j = j0 + e % kTile;
      if (i < l && j < l) dsc[static_cast<size_t>(i) * l + j] = 0.f;
    }
    for (int e = tid; e < d.H * kTile; e += kThreads) {
      const int h = e / kTile, r = e % kTile;
      const size_t base = d.bch(b, c, h) * nt;
      if (i0 + r < l) row_part[(base + jt) * l + i0 + r] = 0.f;
      if (j0 + r < l) col_part[(base + it) * l + j0 + r] = 0.f;
    }
    return;
  }

  float sc[4][4], ds[4][4];
#pragma unroll
  for (int qi = 0; qi < 4; ++qi)
#pragma unroll
    for (int qj = 0; qj < 4; ++qj) {
      const int i = i0 + ty * 4 + qi, j = j0 + tx * 4 + qj;
      sc[qi][qj] = (i < l && j < l)
                       ? scores[(static_cast<size_t>(bc) * l + i) * l + j]
                       : 0.f;
      ds[qi][qj] = 0.f;
    }

  for (int h = 0; h < d.H; ++h) {
    const size_t rowoff = d.bch(b, c, h) * l;
    for (int r = tid; r < kTile; r += kThreads) {
      sai[r] = i0 + r < l ? acum[rowoff + i0 + r] : 0.f;
      saj[r] = j0 + r < l ? acum[rowoff + j0 + r] : 0.f;
      sdtpj[r] = j0 + r < l ? dtp[rowoff + j0 + r] : 0.f;
    }
    __syncthreads();
    float dm[4][4] = {};
    for (int k0 = 0; k0 < d.P; k0 += kK) {
      for (int e = tid; e < kTile * kK; e += kThreads) {
        const int r = e / kK, k = e % kK;
        const int p = k0 + k;
        sDy[k][r] = i0 + r < l
                        ? to_f32(dy[lay.yrow(d, b, h, c, i0 + r) + p])
                        : 0.f;
        sDx[k][r] = j0 + r < l
                        ? rnd<T>(lay.load_x(d, b, h, c, j0 + r, p) *
                                 sdtpj[r])
                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kK; ++k) {
        float a[4], bb[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = sDy[k][ty * 4 + q];
          bb[q] = sDx[k][tx * 4 + q];
        }
#pragma unroll
        for (int qi = 0; qi < 4; ++qi)
#pragma unroll
          for (int qj = 0; qj < 4; ++qj) dm[qi][qj] += a[qi] * bb[qj];
      }
      __syncthreads();
    }
    float rs[4] = {0.f, 0.f, 0.f, 0.f}, cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int qi = 0; qi < 4; ++qi)
#pragma unroll
      for (int qj = 0; qj < 4; ++qj) {
        const int i = i0 + ty * 4 + qi, j = j0 + tx * 4 + qj;
        const float E = (i < l && j <= i)
                            ? expf(sai[ty * 4 + qi] - saj[tx * 4 + qj])
                            : 0.f;
        ds[qi][qj] += dm[qi][qj] * E;
        const float G = dm[qi][qj] * (sc[qi][qj] * E);
        rs[qi] += G;
        cs[qj] += G;
      }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      rowred[ty * 4 + q][tx] = rs[q];
      colred[tx * 4 + q][ty] = cs[q];
    }
    __syncthreads();
    const size_t base = d.bch(b, c, h) * nt;
    if (tid < kTile) {
      float s = 0.f;
      for (int k = 0; k < 16; ++k) s += rowred[tid][k];
      if (i0 + tid < l) row_part[(base + jt) * l + i0 + tid] = s;
    } else if (tid < 2 * kTile) {
      const int r = tid - kTile;
      float s = 0.f;
      for (int k = 0; k < 16; ++k) s += colred[r][k];
      if (j0 + r < l) col_part[(base + it) * l + j0 + r] = s;
    }
    __syncthreads();
  }
#pragma unroll
  for (int qi = 0; qi < 4; ++qi) {
    const int i = i0 + ty * 4 + qi;
    if (i >= l) continue;
#pragma unroll
    for (int qj = 0; qj < 4; ++qj) {
      const int j = j0 + tx * 4 + qj;
      if (j < l) dsc[static_cast<size_t>(i) * l + j] = ds[qi][qj];
    }
  }
}

// Shared memory of the walking block, in floats.
struct BwdSmem {
  int LP, N;
  __host__ __device__ BwdSmem(int l, int N_) : LP((l + 31) / 32 * 32),
                                               N(N_) {}
  __host__ __device__ int dS() const { return 0; }                // [32][N+1]
  __host__ __device__ int x() const { return kPT * (N + 1); }     // [LP][32]
  __host__ __device__ int dy() const { return x() + LP * kPT; }   // [LP][32]
  __host__ __device__ int dYo() const { return dy() + LP * kPT; }  // [LP][32]
  __host__ __device__ int a() const { return dYo() + LP * kPT; }  // [LP]
  __host__ __device__ int dtp() const { return a() + LP; }        // [LP]
  __host__ __device__ int dte() const { return dtp() + LP; }      // [LP]
  __host__ __device__ int stage() const { return dte() + LP; }    // 32 x 128
  __host__ __device__ int red() const { return stage() + 32 * 128; }
  __host__ __device__ int total() const { return red() + 32; }
};

// Its shared memory allows one block per SM at N 512, so ptxas may spend
// registers freely.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_walk_kernel(Lay lay, const float* __restrict__ acum,
                    const float* __restrict__ dte,
                    const float* __restrict__ cdec,
                    const float* __restrict__ dtp,
                    const T* __restrict__ ssave, const T* __restrict__ dy,
                    const float* __restrict__ scores, T* __restrict__ dx,
                    T* __restrict__ dso, float* __restrict__ off_part,
                    float* __restrict__ ddte_part,
                    float* __restrict__ ddtp_part,
                    float* __restrict__ dD_part,
                    float* __restrict__ dcdec_part, Dims d) {
  extern __shared__ float smem[];
  const BwdSmem L(d.l, d.N);
  const int N = d.N, NP = d.N + 1, l = d.l, LP = L.LP;
  float* sdS = smem + L.dS();
  float* sx = smem + L.x();
  float* sdy = smem + L.dy();
  float* sdYo = smem + L.dYo();
  float* sa = smem + L.a();
  float* sdtp = smem + L.dtp();
  float* sdte = smem + L.dte();
  float* stg = smem + L.stage();
  float* red = smem + L.red();

  const int pt = blockIdx.x, npt = gridDim.x;
  const int p0 = pt * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float Dh = lay.D(h);
  float* sBt = stg;               // three 32 x 33 tiles in the t / Y_off pass
  float* sCt = stg + 32 * 33;
  float* sSs = stg + 2 * 32 * 33;

  for (int e = tid; e < kPT * NP; e += kThreads) sdS[e] = 0.f;
  __syncthreads();

  for (int c = d.nc - 1; c >= 0; --c) {
    const size_t bch = d.bch(b, c, h);
    const size_t rowoff = bch * l;
    const size_t part = (bch * npt + pt) * l;
    for (int t = tid; t < LP; t += kThreads) {
      const bool in = t < l;
      sa[t] = in ? acum[rowoff + t] : 0.f;
      sdtp[t] = in ? dtp[rowoff + t] : 0.f;
      sdte[t] = in ? dte[rowoff + t] : 0.f;
    }
    for (int e = tid; e < LP * kPT; e += kThreads) {
      const int t = e / kPT, p = e % kPT;
      const bool in = t < l;
      sx[e] = in ? lay.load_x(d, b, h, c, t, p0 + p) : 0.f;
      sdy[e] = in ? to_f32(dy[lay.yrow(d, b, h, c, t) + p0 + p]) : 0.f;
      sdYo[e] = 0.f;
    }
    // rnd(dSout) for the flush, and dcdec = sum(dSout * Sin)
    const T* sinp = ssave + (bch * d.P + p0) * N;
    T* dst = dso + (bch * d.P + p0) * N;
    float cd = 0.f;
    for (int e = tid; e < kPT * N; e += kThreads) {
      const int p = e / N, n = e - p * N;
      const float v = sdS[p * NP + n];
      dst[e] = from_f32<T>(v);
      cd += v * to_f32(sinp[e]);
    }
    cd = block_sum(cd, red);
    if (tid == 0) dcdec_part[bch * npt + pt] = cd;
    __syncthreads();

    const float* sc = scores + (static_cast<size_t>(b) * d.nc + c) * l * l;
    float dD = 0.f;
    for (int i0 = 0; i0 < l; i0 += 32) {
      float accG[4] = {0.f, 0.f, 0.f, 0.f};   // ddtx_diag
      float accT[4] = {0.f, 0.f, 0.f, 0.f};   // t = B rnd(dS)^T
      float accY[4] = {0.f, 0.f, 0.f, 0.f};   // Y_off = C Sin^T
      // ddtx_diag[j] = sum_{i >= j} rnd(M[i, j]) dy[i], rows j of this block
      for (int k0 = i0; k0 < l; k0 += 32) {
        for (int e = tid; e < 32 * 32; e += kThreads) {
          const int kk = e / 32, jj = e % 32;
          const int i = k0 + kk, j = i0 + jj;
          float m = 0.f;
          if (i < l && j <= i)
            m = rnd<T>(sc[static_cast<size_t>(i) * l + j] *
                       expf(sa[i] - sa[j]));
          stg[kk * 33 + jj] = m;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < 32; ++kk) {
          const float dv = sdy[(k0 + kk) * kPT + lane];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            accG[q] += stg[kk * 33 + warp * 4 + q] * dv;
        }
        __syncthreads();
      }
      for (int n0 = 0; n0 < N; n0 += 32) {
        for (int e = tid; e < 32 * 32; e += kThreads) {
          const int r = e / 32, nn = e % 32;
          const int i = i0 + r;
          const bool in = i < l;
          sBt[r * 33 + nn] = in ? lay.load_B(d, b, c, i, n0 + nn) : 0.f;
          sCt[r * 33 + nn] = in ? lay.load_C(d, b, c, i, n0 + nn) : 0.f;
          sSs[r * 33 + nn] = to_f32(sinp[static_cast<size_t>(r) * N + n0 + nn]);
        }
        __syncthreads();
#pragma unroll 8
        for (int nn = 0; nn < 32; ++nn) {
          const float dsv = rnd<T>(sdS[lane * NP + n0 + nn]);
          const float sv = sSs[lane * 33 + nn];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            accT[q] += sBt[(warp * 4 + q) * 33 + nn] * dsv;
            accY[q] += sCt[(warp * 4 + q) * 33 + nn] * sv;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + warp * 4 + q;
        if (i >= l) continue;                      // warp-uniform
        const float eA = expf(sa[i]);
        const float dyv = sdy[i * kPT + lane];
        const float xv = sx[i * kPT + lane];
        const float dtxv = rnd<T>(xv * sdtp[i]);
        const float ddtx = accG[q] + accT[q] * sdte[i];
        float dxv = ddtx * sdtp[i];
        if (Lay::kHasD) dxv += dyv * Dh;
        dx[lay.yrow(d, b, h, c, i) + p0 + lane] = from_f32<T>(dxv);
        const float s1 = warp_sum(ddtx * xv);
        const float s2 = warp_sum(accT[q] * dtxv);
        const float s3 = warp_sum(dyv * accY[q] * eA);
        if (lane == 0) {
          ddtp_part[part + i] = s1;
          ddte_part[part + i] = s2;
          off_part[part + i] = s3;
        }
        sdYo[i * kPT + lane] = rnd<T>(dyv * eA);
        dD += dyv * xv;
      }
    }
    if (Lay::kHasD) {
      dD = block_sum(dD, red);
      if (tid == 0) dD_part[bch * npt + pt] = dD;
    }
    __syncthreads();

    // dS = cdec dS + dYoff^T C
    const float dec = cdec[bch];
    for (int n0 = 0; n0 < N; n0 += 128) {
      float acc[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) acc[k] = 0.f;
      for (int t0 = 0; t0 < l; t0 += 32) {
        for (int e = tid; e < 32 * 128; e += kThreads) {
          const int tt = e / 128, nn = e % 128;
          const int t = t0 + tt, n = n0 + nn;
          stg[e] = (t < l && n < N) ? lay.load_C(d, b, c, t, n) : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int tt = 0; tt < 32; ++tt) {
          const float dd = sdYo[(t0 + tt) * kPT + lane];
#pragma unroll
          for (int k = 0; k < 16; ++k)
            acc[k] += dd * stg[tt * 128 + warp + 8 * k];
        }
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int n = n0 + warp + 8 * k;
        if (n < N) sdS[lane * NP + n] = dec * sdS[lane * NP + n] + acc[k];
      }
    }
    __syncthreads();
  }
}

// The B/C cotangents of chunk (b, c), 64 rows x 64 columns of N per block.
// Grid (2 * ceil(N / 64), nt, B nc); which = 0 computes dC, 1 dB:
//   out[r, n] = sum_{h, p} U_h[r, p] V_h[p, n] + sum_k W[r, k] Z[k, n]
//   dC: U = rnd(dy e^a), V = Sin,  W = rnd(dscores),   Z = B
//   dB: U = rnd(dtx dte), V = rnd(dSout), W = rnd(dscores)^T, Z = C
// stored through the layout (Lay::store_grad).  Four blocks per SM: at 64
// registers a thread; above it only three fit, which costs more than the
// spills.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads, 4)
    flush_kernel(Lay lay, const float* __restrict__ acum,
                 const float* __restrict__ dte, const float* __restrict__ dtp,
                 const T* __restrict__ ssave, const T* __restrict__ dy,
                 const T* __restrict__ dso,
                 const float* __restrict__ dscores, Dims d) {
  constexpr int kK = 16;
  __shared__ float sU[kK][kTile + 4];
  __shared__ float sV[kK][kTile + 4];
  const int ntn = (d.N + kTile - 1) / kTile;
  const int which = blockIdx.x / ntn;
  const int n0 = (blockIdx.x - which * ntn) * kTile;
  const int r0 = blockIdx.y * kTile;
  const int bc = blockIdx.z;
  const int b = bc / d.nc, c = bc - b * d.nc;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int l = d.l, N = d.N;
  const float* dsc = dscores + static_cast<size_t>(bc) * l * l;
  float acc[4][4] = {};

  // sum over heads and positions of P
  for (int k0 = 0; k0 < d.HP; k0 += kK) {
    const int h = k0 / d.P, pb = k0 - h * d.P;
    const size_t rowoff = d.bch(b, c, h) * l;
    const T* V = (which == 0 ? ssave : dso) + d.bch(b, c, h) * d.P * N;
    for (int e = tid; e < kTile * kK; e += kThreads) {
      const int r = e / kK, k = e % kK;
      const int row = r0 + r;
      float u = 0.f;
      if (row < l) {
        if (which == 0) {
          const float dyv = to_f32(dy[lay.yrow(d, b, h, c, row) + pb + k]);
          u = rnd<T>(dyv * expf(acum[rowoff + row]));
        } else {
          const float xv = lay.load_x(d, b, h, c, row, pb + k);
          u = rnd<T>(rnd<T>(xv * dtp[rowoff + row]) * dte[rowoff + row]);
        }
      }
      sU[k][r] = u;
      const int kr = e / kTile, n = e % kTile;
      sV[kr][n] = n0 + n < N
                      ? to_f32(V[static_cast<size_t>(pb + kr) * N + n0 + n])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = sU[k][ty * 4 + q];
        bb[q] = sV[k][tx * 4 + q];
      }
#pragma unroll
      for (int qi = 0; qi < 4; ++qi)
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) acc[qi][qj] += a[qi] * bb[qj];
    }
    __syncthreads();
  }
  // the scores term
  for (int k0 = 0; k0 < l; k0 += kK) {
    for (int e = tid; e < kTile * kK; e += kThreads) {
      const int r = e / kK, k = e % kK;
      const int row = r0 + r, kk = k0 + k;
      float w = 0.f;
      if (row < l && kk < l)
        w = rnd<T>(which == 0 ? dsc[static_cast<size_t>(row) * l + kk]
                              : dsc[static_cast<size_t>(kk) * l + row]);
      sU[k][r] = w;
      const int kr = e / kTile, n = e % kTile;
      float z = 0.f;
      if (k0 + kr < l && n0 + n < N)
        z = which == 0 ? lay.load_B(d, b, c, k0 + kr, n0 + n)
                       : lay.load_C(d, b, c, k0 + kr, n0 + n);
      sV[kr][n] = z;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = sU[k][ty * 4 + q];
        bb[q] = sV[k][tx * 4 + q];
      }
#pragma unroll
      for (int qi = 0; qi < 4; ++qi)
#pragma unroll
        for (int qj = 0; qj < 4; ++qj) acc[qi][qj] += a[qi] * bb[qj];
    }
    __syncthreads();
  }
#pragma unroll
  for (int qi = 0; qi < 4; ++qi) {
    const int r = r0 + ty * 4 + qi;
    if (r >= l) continue;
#pragma unroll
    for (int qj = 0; qj < 4; ++qj) {
      const int n = n0 + tx * 4 + qj;
      if (n < N) lay.store_grad(d, which, b, c, r, n, acc[qi][qj]);
    }
  }
}

// The fp32 workspaces and per-block partials of the backward (the wrapper
// allocates them and sums the partials): scores, dscores [B, nc, l, l];
// row_part, col_part [B, nc, H, ceil(l / 64), l]; off_part, ddte_part,
// ddtp_part [B, nc, H, P / 32, l]; dD_part, dcdec_part [B, nc, H, P / 32]
// (dD_part unused, and may be null, without a D skip).
struct BwdWork {
  float *scores, *dscores, *row_part, *col_part, *off_part, *ddte_part,
      *ddtp_part, *dD_part, *dcdec_part;
};

// The four launches of the backward on `stream`; the first CUDA error, or
// cudaSuccess.  dso [B, nc, H, P, N] (operand type) takes rnd(dSout).
template <typename T, class Lay>
cudaError_t launch_bwd(const Lay& lay, const float* acum, const float* dte,
                       const float* cdec, const float* dtp,
                       const void* ssave_, const void* dy_, void* dx,
                       void* dso, const BwdWork& w, const Dims& d,
                       cudaStream_t stream) {
  const T* ssave = static_cast<const T*>(ssave_);
  const T* dy = static_cast<const T*>(dy_);
  const int nt = (d.l + kTile - 1) / kTile;
  const dim3 tiles(nt, nt, d.B * d.nc);
  scores_kernel<T, Lay><<<tiles, kThreads, 0, stream>>>(lay, w.scores, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  intra_kernel<T, Lay><<<tiles, kThreads, 0, stream>>>(
      lay, acum, dtp, dy, w.scores, w.dscores, w.row_part, w.col_part, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = BwdSmem(d.l, d.N).total() * sizeof(float);
  err = cudaFuncSetAttribute(bwd_walk_kernel<T, Lay>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bwd_walk_kernel<T, Lay>
      <<<dim3(d.P / kPT, d.H, d.B), kThreads, smem, stream>>>(
          lay, acum, dte, cdec, dtp, ssave, dy, w.scores,
          static_cast<T*>(dx), static_cast<T*>(dso), w.off_part,
          w.ddte_part, w.ddtp_part, w.dD_part, w.dcdec_part, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ntn = (d.N + kTile - 1) / kTile;
  flush_kernel<T, Lay><<<dim3(2 * ntn, nt, d.B * d.nc), kThreads, 0,
                         stream>>>(lay, acum, dte, dtp, ssave, dy,
                                   static_cast<const T*>(dso), w.dscores, d);
  return cudaGetLastError();
}

}  // namespace ssd_walk
