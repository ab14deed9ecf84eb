// Four-direction fused SSD forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/ssd_fused_dirs_pallas.py
//   ::_fwd_kernel (launched by _run_fwd), save=True and save=False.
//
// The chunk walk of ssd_walk_fwd.cuh over the role-major d0/d1 stack
// (DirsLayout, ssd_walk_common.cuh): the four directions fold into H4
// heads, reverse-class heads read x and write y at the mirrored chunk,
// reversed within it, and y adds the per-head D skip x * D[h].
//
// What bounds it on this card: operations.  At MedSSD stage 0 (B 32, L 3136,
// l 224, H4 8, P 64, N 512, bf16) a call needs ~128 GFLOP (over the causal
// pairs of a chunk, l (l + 1) / 2: the scores 2 pairs N per chunk, and per
// head 2 pairs P + 4 l N P) against ~260 MB moved.

#include "ssd_walk_fwd.cuh"

using namespace ssd_walk;

namespace {

template <typename T>
cudaError_t launch(const void* stack, const float* Dsk, const float* acum,
                   const float* dte, const float* cdec, const float* dtp,
                   void* y, void* ssave, float* scores, const Dims& d,
                   int d_ssm, int gn, cudaStream_t stream) {
  const DirsLayout<T> lay(static_cast<const T*>(stack), Dsk, nullptr, d.H,
                          d_ssm, gn);
  return launch_fwd<T>(lay, acum, dte, cdec, dtp, y, ssave, scores, d,
                       stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the two launches (0 on success).  is_bf16 selects the type of stack, y and
// ssave; ssave may be null (no saved states); scores is a [B, nc, l, l] fp32
// workspace.  The caller checks the shapes: P % 32 == 0, l <= 256,
// N = 4 gn <= 512 and a multiple of 32.
extern "C" int ssd_fused_dirs_fwd(const void* stack, const void* acum,
                                  const void* dte, const void* cdec,
                                  const void* dtp, const void* Dsk, void* y,
                                  void* ssave, void* scores, int B, int nc,
                                  int l, int H4, int P, int d_ssm, int gn,
                                  int is_bf16, void* stream) {
  const Dims d(B, nc, l, H4, P, 4 * gn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* sc = static_cast<float*>(scores);
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(
        stack, f(Dsk), f(acum), f(dte), f(cdec), f(dtp), y, ssave, sc, d,
        d_ssm, gn, s));
  return static_cast<int>(launch<float>(stack, f(Dsk), f(acum), f(dte),
                                        f(cdec), f(dtp), y, ssave, sc, d,
                                        d_ssm, gn, s));
}

extern "C" const char* ssd_fused_dirs_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
