// Shared pieces of the fused SSD chunk-walk kernels: types, the two operand
// layouts the walk reads, the scores pass C B^T, and block reductions.  The
// walks themselves are in ssd_walk_fwd.cuh and ssd_walk_bwd.cuh; each kernel
// source (ssd_fused_{fwd,bwd}.cu, ssd_fused_dirs_{fwd,bwd}.cu) instantiates
// them for its layout.
//
// The walk sees, per batch b, chunk c and head h, in scan-position order:
//   x [l, P] (head h's columns), B and C [l, N] (one group, shared by every
//   head), acum, dte, dtp [B, nc, H, l] fp32, cdec [B, nc, H] fp32, and
//   writes y (backward: reads dy, writes dx) at head h's columns.
// A layout says where those values live:
//   FlatLayout  (ssd_fused_pallas.py): C, B [B, nc, l, N]; x, y, dy, dx flat
//               and l-major [B, nc, l, H P]; no D skip.
//   DirsLayout  (ssd_fused_dirs_pallas.py): everything is cut from the
//               role-major d0/d1 stack [B, nc, l, 2 C'], C' = d_ssm + 2 gn +
//               H/4, channels [x_j0|x_j1|B_j0|B_j1|C_j0|C_j1|dt_j0|dt_j1];
//               head h reads x columns (h mod H/2) P; heads h >= H/2 are
//               the reverse class, whose data at chunk c, position t lives at
//               chunk nc-1-c, row l-1-t; the coupled B/C row t of chunk c is
//               [direct slab of (c, t) | direct slab of (nc-1-c, l-1-t)],
//               each 2 gn wide (N = 4 gn); a per-head D skip.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace ssd_walk {

constexpr int kThreads = 256;
constexpr int kPT = 32;    // columns of P per walking block (one per lane)
constexpr int kTile = 64;  // square tiles of the [l, l] passes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to the operand type and back: the TPU body's .astype(mm_dtype)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

struct Dims {
  int B, nc, l, H, P, N, HP;

  __host__ __device__ Dims(int B_, int nc_, int l_, int H_, int P_, int N_)
      : B(B_), nc(nc_), l(l_), H(H_), P(P_), N(N_), HP(H_ * P_) {}

  // flat row index of (b, c, t) in any [B, nc, l, ...] array
  __device__ __forceinline__ size_t row(int b, int c, int t) const {
    return (static_cast<size_t>(b) * nc + c) * l + t;
  }
  // index of (b, c, h) in [B, nc, H, ...] arrays, times the row length
  __device__ __forceinline__ size_t bch(int b, int c, int h) const {
    return (static_cast<size_t>(b) * nc + c) * H + h;
  }
};

template <typename T>
struct FlatLayout {
  static constexpr bool kHasD = false;
  const T* C;
  const T* Bm;
  const T* x;
  T* dC;  // the backward's B/C cotangents [B, nc, l, N]; null in the forward
  T* dB;

  // offset of head h's P values at scan position (c, t) in x, y, dy, dx
  __device__ __forceinline__ size_t yrow(const Dims& d, int b, int h, int c,
                                         int t) const {
    return d.row(b, c, t) * d.HP + static_cast<size_t>(h) * d.P;
  }
  __device__ __forceinline__ float load_x(const Dims& d, int b, int h, int c,
                                          int t, int p) const {
    return to_f32(x[yrow(d, b, h, c, t) + p]);
  }
  __device__ __forceinline__ float load_B(const Dims& d, int b, int c, int t,
                                          int n) const {
    return to_f32(Bm[d.row(b, c, t) * d.N + n]);
  }
  __device__ __forceinline__ float load_C(const Dims& d, int b, int c, int t,
                                          int n) const {
    return to_f32(C[d.row(b, c, t) * d.N + n]);
  }
  __device__ __forceinline__ float D(int) const { return 0.f; }
  // which 0: dC, 1: dB, at row r of chunk (b, c), column n
  __device__ __forceinline__ void store_grad(const Dims& d, int which, int b,
                                             int c, int r, int n,
                                             float v) const {
    (which == 0 ? dC : dB)[d.row(b, c, r) * d.N + n] = from_f32<T>(v);
  }
};

template <typename T>
struct DirsLayout {
  static constexpr bool kHasD = true;
  const T* stack;
  const float* Dsk;
  T* dBC;  // [4, B, nc, l, 2 gn]: dB_dir, dC_dir, dB_flip, dC_flip; null in
           // the forward
  int H2, C2, g2, offB, offC;

  DirsLayout(const T* stack_, const float* Dsk_, T* dBC_, int H, int d_ssm,
             int gn)
      : stack(stack_), Dsk(Dsk_), dBC(dBC_), H2(H / 2),
        C2(2 * (d_ssm + 2 * gn + H / 4)), g2(2 * gn), offB(2 * d_ssm),
        offC(2 * d_ssm + 2 * gn) {}

  // the stored (chunk, row) of head h's data at its scan position (c, t)
  __device__ __forceinline__ size_t head_row(const Dims& d, int b, int h,
                                             int c, int t) const {
    return h < H2 ? d.row(b, c, t) : d.row(b, d.nc - 1 - c, d.l - 1 - t);
  }
  __device__ __forceinline__ size_t yrow(const Dims& d, int b, int h, int c,
                                         int t) const {
    return head_row(d, b, h, c, t) * d.HP + static_cast<size_t>(h) * d.P;
  }
  __device__ __forceinline__ float load_x(const Dims& d, int b, int h, int c,
                                          int t, int p) const {
    const int hc = h < H2 ? h : h - H2;
    return to_f32(stack[head_row(d, b, h, c, t) * C2 + hc * d.P + p]);
  }
  // element n of coupled row t of chunk c, from the run at channel off
  __device__ __forceinline__ float coupled(const Dims& d, int b, int c, int t,
                                           int n, int off) const {
    if (n < g2) return to_f32(stack[d.row(b, c, t) * C2 + off + n]);
    return to_f32(
        stack[d.row(b, d.nc - 1 - c, d.l - 1 - t) * C2 + off + n - g2]);
  }
  __device__ __forceinline__ float load_B(const Dims& d, int b, int c, int t,
                                          int n) const {
    return coupled(d, b, c, t, n, offB);
  }
  __device__ __forceinline__ float load_C(const Dims& d, int b, int c, int t,
                                          int n) const {
    return coupled(d, b, c, t, n, offC);
  }
  __device__ __forceinline__ float D(int h) const { return Dsk[h]; }
  // the first 2 gn columns go to the direct slab of chunk c; the rest to
  // the flipped slab of chunk nc-1-c, row l-1-r
  __device__ __forceinline__ void store_grad(const Dims& d, int which, int b,
                                             int c, int r, int n,
                                             float v) const {
    const size_t slab = static_cast<size_t>(d.B) * d.nc * d.l * g2;
    const T o = from_f32<T>(v);
    if (n < g2)
      dBC[(which == 0 ? 1 : 0) * slab + d.row(b, c, r) * g2 + n] = o;
    else
      dBC[(which == 0 ? 3 : 2) * slab +
          d.row(b, d.nc - 1 - c, d.l - 1 - r) * g2 + n - g2] = o;
  }
};

// scores[b, c] = C B^T, [l, l] fp32, for the lower-triangle tiles only
// (every reader masks j > i).  Grid (nt, nt, B nc), 256 threads; each
// thread owns a 4 x 4 patch of a 64 x 64 tile.  The products are of
// operand-type values accumulated in fp32.
template <typename T, class Lay>
__global__ void __launch_bounds__(kThreads)
    scores_kernel(Lay lay, float* __restrict__ scores, Dims d) {
  constexpr int kK = 16;
  __shared__ float sC[kK][kTile + 4];
  __shared__ float sB[kK][kTile + 4];
  const int it = blockIdx.y, jt = blockIdx.x;
  if (jt > it) return;
  const int bc = blockIdx.z;
  const int b = bc / d.nc, c = bc - b * d.nc;
  const int i0 = it * kTile, j0 = jt * kTile;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d.N; k0 += kK) {
    for (int e = tid; e < kTile * kK; e += kThreads) {
      const int r = e / kK, k = e % kK;
      const int n = k0 + k;
      const bool kin = n < d.N;
      sC[k][r] = (i0 + r < d.l && kin) ? lay.load_C(d, b, c, i0 + r, n) : 0.f;
      sB[k][r] = (j0 + r < d.l && kin) ? lay.load_B(d, b, c, j0 + r, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = sC[k][ty * 4 + q];
        bb[q] = sB[k][tx * 4 + q];
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
    const int i = i0 + ty * 4 + qi;
    if (i >= d.l) continue;
#pragma unroll
    for (int qj = 0; qj < 4; ++qj) {
      const int j = j0 + tx * 4 + qj;
      if (j < d.l)
        scores[(static_cast<size_t>(bc) * d.l + i) * d.l + j] = acc[qi][qj];
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Sum of v over the block's 256 threads, in a fixed order; every thread
// gets the result.  red: 8 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

}  // namespace ssd_walk
