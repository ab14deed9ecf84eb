// The strip passes of the SSD intra-chunk output Y_diag (ssd_ydiag_fwd.cu,
// ssd_ydiag_bwd.cu): one block owns a 64-row strip of a chunk's decayed
// scores, builds the strip's scores once, and walks a group of heads over
// it with the decayed, masked and rounded scores in registers.
//
// With scores = C B^T over N (fp32 sums), a = acum[bc, h] and rnd() the
// operand type's rounding:
//   rows_kernel (the forward, ssd_ydiag_pallas.py::_fwd_kernel): rows r of
//     the strip are rows i of the chunk, its columns c = j in [0, r0 + 64):
//     S = C[i] B[j]^T,  y[i] = sum_{j <= i} rnd(S exp(a_i - a_j)) dtx[j]
//   cols_kernel (ddtx, of ssd_ydiag_pallas.py::_bwd_kernel): rows r are
//     positions j, its columns c = i in [r0, l):
//     S^T = B[j] C[i]^T,  ddtx[j] = sum_{i >= j} rnd(S^T exp(a_i - a_j)) dy[i]
// which are one pass with the roles of C and B, of the rows and columns,
// and of dtx and dy swapped.
//
// Design.  Grid (row tiles, 64 of P x head groups, BC); 8 warps.  Stages
// run through mma_tiles::pipeline (two cp.async buffers, 16-byte pieces;
// ragged l and the N, P edges zero-filled in shared memory):
//  1. the strip's scores, per column tile and 64 of N: X rows [64, 64] and
//     Y rows [64, 64], warps 4 (rows) x 2 (columns) of 16 x 32 on
//     warp_mma, each column tile's sums stored to the fp32 strip in shared
//     memory ([64][kLdS], up to 66 KB: the block keeps all l columns);
//  2. per pair of heads of the group and column tile: the two heads' V
//     tiles [64 of c, 64 of P] and their acum rows of r and c.  Warp (wr,
//     wh) takes rows 16 wr of head wh of the pair over all 64 of P, so no
//     element's exp is computed twice: each k-step's A fragments come from
//     the strip times exp of the exact difference of the cumsums (no
//     exp(a) exp(-a) factoring, which overflows for long chunks), masked
//     off the causal triangle and past l, rounded in registers; bf16
//     multiplies them into V on mma.sync (warp_mma_ra), fp32 as FMAs with
//     the A values passed along each row's four lanes by shuffles.  A
//     head's last tile writes its rows out.
// The heads split into groups only where the (row tile, P tile, chunk)
// blocks would not fill the card once (MedSSD's N 512: 128 blocks for 132
// SMs, two groups of 16); each group builds the strip again.  The longest
// strips start first.

#pragma once

#include <algorithm>

#include "mma_tiles.cuh"

namespace ssd_ydiag {

using namespace mma_tiles;

constexpr int kT = 64;           // rows of a strip; the c, N and P tiles
constexpr int kMaxL = 256;       // the longest chunk: a strip holds all of it
constexpr int kLdS = kMaxL + 8;  // fp32 strip row stride: a warp's float2
                                 // reads of 8 rows x 4 lanes hit 32 banks

struct Dims {
  int BC, l, N, H, P;
  int hpb;  // heads of a block
};

// heads per block: all H, unless the blocks without a head split would not
// give each SM one (two blocks an SM ran slower at N 512 on an H100 SXM:
// the strip's scores then cost more than the blocks gain)
inline Dims make_dims(int BC, int l, int N, int H, int P) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int base = (l + kT - 1) / kT * ((P + kT - 1) / kT) * BC;
  const int groups = std::min(H, std::max(1, (sms + base - 1) / base));
  return Dims{BC, l, N, H, P, (H + groups - 1) / groups};
}

inline dim3 strip_grid(const Dims& d) {
  return dim3((d.l + kT - 1) / kT,
              (d.P + kT - 1) / kT * ((d.H + d.hpb - 1) / d.hpb), d.BC);
}

template <typename T>
constexpr size_t strip_smem() {
  return align16(static_cast<size_t>(kT) * kLdS * sizeof(float)) +
         kStages * (2 * tile_bytes<T>(kT, kT) + align16(4 * kT * sizeof(float)));
}

// The decayed strip values of rows m at columns k, k + 1 (k even) of the
// column tile at strip column cs: strip * exp(a_r - a_c) (rows pass) or
// exp(a_c - a_r) (columns pass) inside the causal triangle (c <= r, or
// c >= r) and the chunk, else 0.  r = r0 + m, c = c0 + k are chunk rows.
template <bool kCols>
__device__ __forceinline__ float2 decayed(const float* strip, int cs,
                                          const float* ar, const float* ac,
                                          int m, int k, int r, int c, int l) {
  const float2 s =
      *reinterpret_cast<const float2*>(strip + m * kLdS + cs + k);
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int ce = c + e;
    if (r < l && ce < l && (kCols ? ce >= r : ce <= r)) {
      const float diff = kCols ? ac[k + e] - ar[m] : ar[m] - ac[k + e];
      v[e] = (e ? s.y : s.x) * expf(diff);
    }
  }
  return make_float2(v[0], v[1]);
}

// acc += rnd(A) V over the k-step at tile column kc, A's m16n8k16 fragment
// values v (a[f] = row g + 8 (f & 1), columns 2 q + 8 (f >> 1), + 1); V the
// staged tile [k][p], all 64 of P.  bf16: mma.sync.
__device__ __forceinline__ void step_product(float (&acc)[1][8][4],
                                             const float2 (&v)[4],
                                             const __nv_bfloat16* sV, int ld,
                                             int kc) {
  unsigned a[1][4];
#pragma unroll
  for (int f = 0; f < 4; ++f) a[0][f] = pack_bf16(v[f].x, v[f].y);
  warp_mma_ra<1, 8, true>(acc, a, sV, ld, 0, kc);
}

// fp32: FMAs on the CUDA cores, A's value at (row, k) shuffled from the
// lane of the row's quad that built it
__device__ __forceinline__ void step_product(float (&acc)[1][8][4],
                                             const float2 (&v)[4],
                                             const float* sV, int ld,
                                             int kc) {
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int kl = 0; kl < 16; ++kl) {
    const int f = 2 * (kl >> 3), src = (lane & ~3) | ((kl & 7) >> 1);
    const float a0 = __shfl_sync(0xffffffffu, kl & 1 ? v[f].y : v[f].x, src);
    const float a1 =
        __shfl_sync(0xffffffffu, kl & 1 ? v[f + 1].y : v[f + 1].x, src);
    const float* row = sV + (kc + kl) * ld + 2 * q;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float2 b = ld2(row + 8 * ni);
      acc[0][ni][0] += a0 * b.x;
      acc[0][ni][1] += a0 * b.y;
      acc[0][ni][2] += a1 * b.x;
      acc[0][ni][3] += a1 * b.y;
    }
  }
}

// The pass (see the file's comment): X, Y [BC, l, N] the strip's row and
// column operands, V [BC, H, l, P] the product's, out [BC, H, l, P].
template <typename T, bool kCols>
__device__ __forceinline__ void strip_pass(const T* __restrict__ X,
                                           const T* __restrict__ Y,
                                           const float* __restrict__ acum,
                                           const T* __restrict__ V,
                                           T* __restrict__ out,
                                           const Dims& d) {
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  constexpr int ld = ld_of<T>(kT);
  float* strip = bump.take<float>(kT * kLdS);
  T* sV[kStages][2];   // X and Y rows, then the head pair's V tiles
  float* sA[kStages];  // [a_r | a_c] of each head of the pair
  for (int i = 0; i < kStages; ++i) {
    sV[i][0] = bump.take<T>(kT * ld);
    sV[i][1] = bump.take<T>(kT * ld);
    sA[i] = bump.take<float>(4 * kT);
  }
  const int l = d.l, N = d.N, P = d.P;
  const int nt = (l + kT - 1) / kT, npt = (P + kT - 1) / kT;
  const int rt = kCols ? blockIdx.x : nt - 1 - blockIdx.x;
  const int r0 = rt * kT;
  const int hg = blockIdx.y / npt, p0 = (blockIdx.y - hg * npt) * kT;
  const int h0 = hg * d.hpb, nh = min(d.hpb, d.H - h0);
  const int bc = blockIdx.z;
  const int c_lo = kCols ? r0 : 0;
  const int nct = kCols ? nt - rt : rt + 1;  // column tiles of the strip
  const int nn = (N + kT - 1) / kT;
  const int ns = nct * nn;                   // stages of the scores
  const T* Xc = X + static_cast<size_t>(bc) * l * N;
  const T* Yc = Y + static_cast<size_t>(bc) * l * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp & 3) * 16, wh = warp >> 2;

  float sacc[1][4][4], acc[1][8][4];
  zero_acc(sacc);
  zero_acc(acc);
  pipeline(
      ns + (nh + 1) / 2 * nct,
      [&](int s, int buf) {
        if (s < ns) {
          const int c0 = c_lo + (s / nn) * kT, n0 = (s % nn) * kT;
          stage_as<T, 16>(sV[buf][0], ld, kT, kT,
                          [&](int r, int k) -> const T* {
                            return r0 + r < l && n0 + k < N
                                       ? Xc + static_cast<size_t>(r0 + r) * N +
                                             n0 + k
                                       : nullptr;
                          });
          stage_as<T, 16>(sV[buf][1], ld, kT, kT,
                          [&](int r, int k) -> const T* {
                            return c0 + r < l && n0 + k < N
                                       ? Yc + static_cast<size_t>(c0 + r) * N +
                                             n0 + k
                                       : nullptr;
                          });
          return;
        }
        const int hs = s - ns, c0 = c_lo + (hs % nct) * kT;
        for (int j = 0; j < 2 && 2 * (hs / nct) + j < nh; ++j) {
          const size_t row =
              static_cast<size_t>(bc) * d.H + h0 + 2 * (hs / nct) + j;
          const T* Vh = V + row * l * P;
          stage_as<T, 16>(sV[buf][j], ld, kT, kT,
                          [&](int r, int k) -> const T* {
                            return c0 + r < l && p0 + k < P
                                       ? Vh + static_cast<size_t>(c0 + r) * P +
                                             p0 + k
                                       : nullptr;
                          });
          const float* ah = acum + row * l;
          for (int half = 0; half < 2; ++half) {
            const int from = half ? c0 : r0;
            stage_as<float, 16>(sA[buf] + (2 * j + half) * kT, kT, 1, kT,
                                [&](int, int k) -> const float* {
                                  return from + k < l ? ah + from + k
                                                      : nullptr;
                                });
          }
        }
      },
      [&](int s, int buf) {
        if (s < ns) {
          warp_mma<1, 4, false, false, true>(sacc, sV[buf][0], ld, wm,
                                             sV[buf][1], ld, 32 * wh, 0,
                                             kT / 16);
          if (s % nn != nn - 1) return;
          // the column tile's scores are complete: into the strip
          const int cs = (s / nn) * kT + 32 * wh;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float* o = strip + (wm + g + 8 * e) * kLdS + cs + 8 * ni + 2 * q;
              *reinterpret_cast<float2*>(o) =
                  make_float2(sacc[0][ni][2 * e], sacc[0][ni][2 * e + 1]);
              sacc[0][ni][2 * e] = sacc[0][ni][2 * e + 1] = 0.f;
            }
          return;
        }
        // warp (rows wm, head wh of the pair) over the column tile
        const int hs = s - ns, ct = hs % nct, hh = 2 * (hs / nct) + wh;
        if (hh >= nh) return;
        const int c0 = c_lo + ct * kT;
        const float* ar = sA[buf] + 2 * kT * wh;
        const float* ac = ar + kT;
        const int rlo = r0 + wm;  // the warp's 16 rows
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          const int kc = 16 * kk, c = c0 + kc;
          if (rlo >= l || c >= l || (kCols ? c + 15 < rlo : c > rlo + 15))
            continue;  // past the chunk or off the causal triangle
          float2 v[4];
#pragma unroll
          for (int f = 0; f < 4; ++f) {
            const int m = wm + g + 8 * (f & 1), k = kc + 2 * q + 8 * (f >> 1);
            v[f] = decayed<kCols>(strip, ct * kT, ar, ac, m, k, r0 + m,
                                  c0 + k, l);
          }
          step_product(acc, v, sV[buf][wh], ld, kc);
        }
        if (ct != nct - 1) return;
        // the head's last tile: round and write its 16 rows
        T* o = out + (static_cast<size_t>(bc) * d.H + h0 + hh) * l * P;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = rlo + g + 8 * e;
          if (r >= l) continue;
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int p = p0 + 8 * ni + 2 * q;
            if (p < P)
              st2(o + static_cast<size_t>(r) * P + p, acc[0][ni][2 * e],
                  acc[0][ni][2 * e + 1]);
          }
        }
        zero_acc(acc);
      });
}

// The forward: y = Y_diag from C, B, acum and dtx.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    rows_kernel(const T* __restrict__ C, const T* __restrict__ B,
                const float* __restrict__ acum, const T* __restrict__ dtx,
                T* __restrict__ y, Dims d) {
  strip_pass<T, false>(C, B, acum, dtx, y, d);
}

// The backward's ddtx from B, C, acum and dy.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    cols_kernel(const T* __restrict__ B, const T* __restrict__ C,
                const float* __restrict__ acum, const T* __restrict__ dy,
                T* __restrict__ ddtx, Dims d) {
  strip_pass<T, true>(B, C, acum, dy, ddtx, d);
}

}  // namespace ssd_ydiag
