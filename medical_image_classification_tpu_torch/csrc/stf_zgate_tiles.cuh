// The ST-SSD fusion gate's tiles for Hopper (sm_90a), shared by
// stf_zgate_fwd.cu and stf_zgate_bwd.cu.
//
// The gate has the STL mixer's shapes (a [P, P] score matrix over a depth
// C of 128 or 256, never in device memory) with an elementwise sigmoid in
// place of the softmax, so its passes are built from the mixer's tiles
// (stl_mixer_tiles.cuh): a row pass owns rows i of P and walks the columns
// q in steps of kStep, a column pass owns columns q and walks the rows i;
// each step a warp computes score chunks over C into fp32 accumulators,
// gates them in registers and multiplies the rounded result into its
// [16, C] fp32 output tile.  At bf16 C 128 the A operands stay in
// registers and Z and dS go from the score accumulators straight into A
// fragments (acc_to_a): no score tile touches shared memory.

#pragma once

#include "stl_mixer_tiles.cuh"

namespace stf_zgate {

using namespace stl_mixer;

__device__ __forceinline__ float rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// sigmoid(s) in fp32.  bf16, whose Z is rounded to 8 bits, takes
// 1 / (1 + 2^(-s log2 e)) on two MUFU ops (ex2.approx.ftz, rcp.approx.ftz;
// exactly 0 and 1 at the far ends: 2^x overflows to inf or flushes to 0),
// which keeps Z's relative error far below a bf16 step at every Z.  The
// one-op form 0.5 tanh.approx(s / 2) + 0.5 errs by up to ~2^-12 in Z near
// 0, more than a bf16 step of every Z below 2^-5.  fp32 takes expf and an
// IEEE divide, so the fp32 gradients keep their last bits.
template <typename T>
__device__ __forceinline__ float sigmoid(float s) {
  if constexpr (std::is_same<T, float>::value)
    return 1.f / (1.f + expf(-s));
  else
    return rcp(1.f + ex2(-s * kLog2e));
}

// The column pass's tiles: the mixer's, with score chunks of 16 columns
// where the operands stay in registers (two A operand sets and two [16, C]
// fp32 outputs leave no room for wider ones).
template <typename T, int C>
struct ColsCfg : Cfg<T, C> {
  static constexpr int kChunk = Cfg<T, C>::kRegs ? 16 : Cfg<T, C>::kCols;
  static constexpr int NIs = kChunk / 8;
};

// v <- rnd-ready Z = sigmoid(v) of a warp's 16 x 8 NI score chunk, 0 at
// walked-axis indices >= P (pc: the index of this thread's element e = 0
// of n8 tile 0); with D given, D <- dS = D Z (1 - Z) in fp32, 0 there too.
template <typename T, int NI>
__device__ __forceinline__ void gate(float (&v)[1][NI][4], int pc, int P,
                                     float (*D)[NI][4] = nullptr) {
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = pc + 8 * ni + (e & 1) < P;
      const float z = in ? sigmoid<T>(v[0][ni][e]) : 0.f;
      v[0][ni][e] = z;
      if (D != nullptr) D[0][ni][e] = D[0][ni][e] * z * (1.f - z);
    }
}

}  // namespace stf_zgate
