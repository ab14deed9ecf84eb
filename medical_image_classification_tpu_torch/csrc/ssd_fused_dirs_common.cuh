// Shared pieces of the four-direction fused SSD kernels
// (ssd_fused_dirs_fwd.cu, ssd_fused_dirs_bwd.cu): types, the index
// arithmetic of the role-major d0/d1 stack and its mirrored directions, and
// the scores pass C_full . B_full^T over the coupled rows.
//
// Layouts (ref_flat, one B/C group; H4 = 4 nh heads, direction-major;
// N = 4 gn; C' = d_ssm + 2 gn + nh), all row-major:
//   stack  [B, nc, l, 2 C']  channels [x_j0|x_j1|B_j0|B_j1|C_j0|C_j1|dt_j0|
//                            dt_j1]; head h reads x columns (h mod H4/2) P
//   acum, dte, dtp [B, nc, H4, l] fp32;  cdec [B, nc, H4] fp32;  D [H4]
//   y, dy, dx [B, nc, l, H4 P];  Ssave [B, nc, H4, P, N]
// Heads h >= H4/2 are the reverse class: their data at chunk c, position t
// lives at chunk nc-1-c, row l-1-t of the d0/d1 bytes.  The coupled B/C row
// t of chunk c is [direct slab of (c, t) | direct slab of (nc-1-c, l-1-t)],
// each slab 2 gn wide.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace ssd_dirs {

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
  int B, nc, l, H4, P, d_ssm, gn;
  int H2, N, C2, HP;

  __host__ __device__ Dims(int B_, int nc_, int l_, int H4_, int P_,
                           int d_ssm_, int gn_)
      : B(B_), nc(nc_), l(l_), H4(H4_), P(P_), d_ssm(d_ssm_), gn(gn_),
        H2(H4_ / 2), N(4 * gn_), C2(2 * (d_ssm_ + 2 * gn_ + H4_ / 4)),
        HP(H4_ * P_) {}

  // flat row index of (b, c, t) in any [B, nc, l, ...] array
  __device__ __forceinline__ size_t row(int b, int c, int t) const {
    return (static_cast<size_t>(b) * nc + c) * l + t;
  }
  // the stored (chunk, row) of head h's data at its scan position (c, t)
  __device__ __forceinline__ size_t head_row(int b, int h, int c,
                                             int t) const {
    return h < H2 ? row(b, c, t) : row(b, nc - 1 - c, l - 1 - t);
  }
  // index of (b, c, h) in [B, nc, H4, ...] arrays, times the row length
  __device__ __forceinline__ size_t bch(int b, int c, int h) const {
    return (static_cast<size_t>(b) * nc + c) * H4 + h;
  }
};

// x of head h at scan position (c, t), column p
template <typename T>
__device__ __forceinline__ float load_x(const T* stack, const Dims& d, int b,
                                        int h, int c, int t, int p) {
  const int hc = h < d.H2 ? h : h - d.H2;
  return to_f32(stack[d.head_row(b, h, c, t) * d.C2 + hc * d.P + p]);
}

// element n of coupled row t of chunk c; off = 2 d_ssm (B) or 2 d_ssm + 2 gn
// (C)
template <typename T>
__device__ __forceinline__ float load_coupled(const T* stack, const Dims& d,
                                              int b, int c, int t, int n,
                                              int off) {
  const int g2 = 2 * d.gn;
  if (n < g2) return to_f32(stack[d.row(b, c, t) * d.C2 + off + n]);
  return to_f32(
      stack[d.row(b, d.nc - 1 - c, d.l - 1 - t) * d.C2 + off + n - g2]);
}

// scores[b, c] = C_full . B_full^T, [l, l] fp32, for the lower-triangle
// tiles only (every reader masks j > i).  Grid (nt, nt, B nc), 256 threads;
// each thread owns a 4 x 4 patch of a 64 x 64 tile.  The products are of
// operand-type values accumulated in fp32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    scores_kernel(const T* __restrict__ stack, float* __restrict__ scores,
                  Dims d) {
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
  const int offB = 2 * d.d_ssm, offC = offB + 2 * d.gn;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d.N; k0 += kK) {
    for (int e = tid; e < kTile * kK; e += kThreads) {
      const int r = e / kK, k = e % kK;
      const int n = k0 + k;
      const bool kin = n < d.N;
      sC[k][r] = (i0 + r < d.l && kin)
                     ? load_coupled(stack, d, b, c, i0 + r, n, offC)
                     : 0.f;
      sB[k][r] = (j0 + r < d.l && kin)
                     ? load_coupled(stack, d, b, c, j0 + r, n, offB)
                     : 0.f;
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

}  // namespace ssd_dirs
