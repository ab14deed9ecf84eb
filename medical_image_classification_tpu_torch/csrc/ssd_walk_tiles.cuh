// The pieces both directions of the fused SSD chunk walk share
// (ssd_walk_fwd.cuh, ssd_walk_bwd.cuh): the tile sizes, the plain copies of
// a coupled layout's B/C rows, and the gram pass scores = C B^T on the
// tensor cores through mma_tiles.cuh.

#pragma once

#include <cstdint>

#include "mma_tiles.cuh"
#include "ssd_walk_common.cuh"

namespace ssd_walk {

constexpr int kT = 64;      // rows, P and N tiles of every pass
constexpr int kMaxL = 256;  // the longest chunk: a pass may keep its rows

namespace tiles {

using namespace mma_tiles;

// 16 bytes from p, which is at least 4-byte aligned: one vector load where
// p is 16-byte aligned, else two or four narrower ones (the dirs stack's
// bf16 rows are only 8-byte aligned)
__device__ __forceinline__ uint4 load16(const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (a % 16 == 0) return *reinterpret_cast<const uint4*>(p);
  if (a % 8 == 0) {
    const uint2* w = reinterpret_cast<const uint2*>(p);
    const uint2 lo = w[0], hi = w[1];
    return make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
  const unsigned* w = reinterpret_cast<const unsigned*>(p);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// For a layout whose B/C rows are coupled from two places (the dirs
// stack): plain copies bc[0] = B, bc[1] = C [B, nc, l, N] of chunk (b, c),
// rows t = share, share + shares, ..., in 16-byte pieces (a piece never
// straddles the coupled halves: 2 gn is a multiple of 16 elements).
template <typename T, class Lay>
__device__ __forceinline__ void copy_bc_rows(const Lay& lay, T* bc, int b,
                                             int c, int share, int shares,
                                             const Dims& d) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const size_t plane = static_cast<size_t>(d.B) * d.nc * d.l * d.N;
  const int per_row = d.N / V;
  const int rows = (d.l - share + shares - 1) / shares;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int t = share + shares * (e / per_row);
    const int n = (e % per_row) * V;
    T* o = bc + d.row(b, c, t) * d.N + n;
    *reinterpret_cast<uint4*>(o) = load16(lay.B_ptr(d, b, c, t, n));
    *reinterpret_cast<uint4*>(o + plane) = load16(lay.C_ptr(d, b, c, t, n));
  }
}

template <typename T>
constexpr size_t gram_smem() {
  return kStages * 2 * tile_bytes<T>(kT, kT);
}

// scores[b, c] = C B^T, [l, l] fp32, for the lower-triangle 64 x 64 tiles
// (every reader masks j > i), from plain [B, nc, l, N] B/C rows.  Grid
// (nt, nt, B nc); warps 4 (rows) x 2 (columns) of 16 x 32.  The layout
// parameter only names the instantiation (profiles tell the layouts apart
// by it).
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads, 2)
    gram_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                float* __restrict__ scores, Dims d) {
  const int it = blockIdx.y, jt = blockIdx.x;
  if (jt > it) return;
  extern __shared__ __align__(16) char smem_raw[];
  Bump bump{smem_raw};
  constexpr int ld = ld_of<T>(kT);
  T* sC[kStages];
  T* sB[kStages];
  for (int i = 0; i < kStages; ++i) {
    sC[i] = bump.take<T>(kT * ld);
    sB[i] = bump.take<T>(kT * ld);
  }
  const int bc = blockIdx.z;
  const int b = bc / d.nc, c = bc - b * d.nc;
  const int i0 = it * kT, j0 = jt * kT, l = d.l, N = d.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp & 3) * 16, wn = (warp >> 2) * 32;
  const T* Cc = Cm + d.row(b, c, 0) * N;
  const T* Bc = Bm + d.row(b, c, 0) * N;
  float acc[1][4][4];
  zero_acc(acc);
  pipeline(
      (N + kT - 1) / kT,
      [&](int s, int buf) {
        const int n0 = s * kT;
        stage_as<T, 16>(sC[buf], ld, kT, kT, [&](int r, int k) -> const T* {
          return i0 + r < l && n0 + k < N
                     ? Cc + static_cast<size_t>(i0 + r) * N + n0 + k
                     : nullptr;
        });
        stage_as<T, 16>(sB[buf], ld, kT, kT, [&](int r, int k) -> const T* {
          return j0 + r < l && n0 + k < N
                     ? Bc + static_cast<size_t>(j0 + r) * N + n0 + k
                     : nullptr;
        });
      },
      [&](int, int buf) {
        warp_mma<1, 4, false, false>(acc, sC[buf], ld, wm, sB[buf], ld, wn,
                                     0, kT / 16);
      });
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = i0 + wm + g + 8 * e, j = j0 + wn + 8 * ni + 2 * q;
      if (i < l && j < l)
        st2(scores + (static_cast<size_t>(bc) * l + i) * l + j,
            acc[0][ni][2 * e], acc[0][ni][2 * e + 1]);
    }
}

}  // namespace tiles
}  // namespace ssd_walk
