// Shared pieces of the fused SSD chunk-walk kernels: types, the two operand
// layouts the walk reads, and block reductions (the tile pieces both walks
// share are in ssd_walk_tiles.cuh).  The walks themselves are in
// ssd_walk_fwd.cuh and ssd_walk_bwd.cuh; each kernel
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
//   YDiagLayout (ssd_ydiag_pallas.py): the intra-chunk output Y_diag alone,
//               no state: B = BC chunks of nc 1; C, B [BC, 1, l, N]; x (dtx),
//               y, dy, dx (ddtx) head-major [BC, H, l, P]; no D skip.  The
//               Y_diag backward runs the walk backward's intra and flush
//               passes over it (ssd_ydiag_bwd.cu).
// Two traits say what a pass may skip: kHasState (the chunk states enter:
// the walks) and kScoresWorkspace (a gram pass writes the fp32 [l, l]
// scores for the later passes to read; without it a pass builds the scores
// tile it needs from B and C).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace ssd_walk {

constexpr int kThreads = 256;

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
  static constexpr bool kCoupled = false;  // B/C rows are plain arrays
  static constexpr bool kHasState = true;
  static constexpr bool kScoresWorkspace = true;
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
  // addresses of head h's P values at (c, t) and of element n of B/C row t
  __device__ __forceinline__ const T* x_ptr(const Dims& d, int b, int h,
                                            int c, int t) const {
    return x + yrow(d, b, h, c, t);
  }
  __device__ __forceinline__ const T* B_ptr(const Dims& d, int b, int c,
                                            int t, int n) const {
    return Bm + d.row(b, c, t) * d.N + n;
  }
  __device__ __forceinline__ const T* C_ptr(const Dims& d, int b, int c,
                                            int t, int n) const {
    return C + d.row(b, c, t) * d.N + n;
  }
  __device__ __forceinline__ float D(int) const { return 0.f; }
  // which 0: dC, 1: dB, at row r of chunk (b, c), columns n and n + 1
  __device__ __forceinline__ void store_grad2(const Dims& d, int which, int b,
                                              int c, int r, int n, float v0,
                                              float v1) const {
    T* o = (which == 0 ? dC : dB) + d.row(b, c, r) * d.N + n;
    o[0] = from_f32<T>(v0);
    o[1] = from_f32<T>(v1);
  }
};

template <typename T>
struct DirsLayout {
  static constexpr bool kHasD = true;
  static constexpr bool kCoupled = true;  // B/C rows come from two places
  static constexpr bool kHasState = true;
  static constexpr bool kScoresWorkspace = true;
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
  // the addresses FlatLayout gives (the walks' tile copies)
  __device__ __forceinline__ const T* x_ptr(const Dims& d, int b, int h,
                                            int c, int t) const {
    return stack + head_row(d, b, h, c, t) * C2 + (h < H2 ? h : h - H2) * d.P;
  }
  // the address of coupled element n (a run of up to 16 elements from a
  // multiple of its length never straddles the halves: 2 gn is a multiple
  // of 16)
  __device__ __forceinline__ const T* coupled_ptr(const Dims& d, int b, int c,
                                                  int t, int n,
                                                  int off) const {
    return n < g2 ? stack + d.row(b, c, t) * C2 + off + n
                  : stack + d.row(b, d.nc - 1 - c, d.l - 1 - t) * C2 + off +
                        n - g2;
  }
  __device__ __forceinline__ const T* B_ptr(const Dims& d, int b, int c,
                                            int t, int n) const {
    return coupled_ptr(d, b, c, t, n, offB);
  }
  __device__ __forceinline__ const T* C_ptr(const Dims& d, int b, int c,
                                            int t, int n) const {
    return coupled_ptr(d, b, c, t, n, offC);
  }
  __device__ __forceinline__ float D(int h) const { return Dsk[h]; }
  // columns n, n + 1 (one half): the first 2 gn columns go to the direct
  // slab of chunk c; the rest to the flipped slab of chunk nc-1-c, row
  // l-1-r
  __device__ __forceinline__ void store_grad2(const Dims& d, int which, int b,
                                              int c, int r, int n, float v0,
                                              float v1) const {
    const size_t slab = static_cast<size_t>(d.B) * d.nc * d.l * g2;
    T* o = n < g2 ? dBC + (which == 0 ? 1 : 0) * slab + d.row(b, c, r) * g2 + n
                  : dBC + (which == 0 ? 3 : 2) * slab +
                        d.row(b, d.nc - 1 - c, d.l - 1 - r) * g2 + n - g2;
    o[0] = from_f32<T>(v0);
    o[1] = from_f32<T>(v1);
  }
};

// FlatLayout's B/C rows with head-major x and y: Y_diag's operands
template <typename T>
struct YDiagLayout : FlatLayout<T> {
  static constexpr bool kHasState = false;
  static constexpr bool kScoresWorkspace = false;

  __device__ __forceinline__ size_t yrow(const Dims& d, int b, int h, int c,
                                         int t) const {
    return (d.bch(b, c, h) * d.l + t) * d.P;
  }
  __device__ __forceinline__ const T* x_ptr(const Dims& d, int b, int h,
                                            int c, int t) const {
    return this->x + yrow(d, b, h, c, t);
  }
};

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
