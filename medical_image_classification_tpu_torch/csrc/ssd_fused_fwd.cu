// Single-layout fused SSD forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/ssd_fused_pallas.py
//   ::_fwd_kernel (launched by _run_fwd), save=True and save=False.
//
// The whole SSD of one B/C group (Y_diag, the chunk states, the walk over
// the chunks and Y_off) for C, B [B, nc, l, N] and x, y flat and l-major
// [B, nc, l, H P]: the chunk walk of ssd_walk_fwd.cuh over FlatLayout
// (ssd_walk_common.cuh), with no D skip (the caller, kernels/ssd.py::
// ssd_chunked, adds it).  dtx = rnd(x * dtp) is formed in the kernel, as the
// TPU body forms it in VMEM.  A padded last chunk needs nothing special: its
// steps carry dt = 0, so they add nothing to the state or to y.
//
// What bounds it on this card: operations.  At MedSSD stage 1 at 240x240
// (B 32, L 900 padded to nc 4 chunks of l 256, H 16, P 64, N 512, bf16) a
// call needs ~82 GFLOP (over the causal pairs of a chunk, l (l + 1) / 2:
// the scores 2 pairs N per chunk, and per head 2 pairs P + 4 l N P) against
// ~210 MB moved.

#include "ssd_walk_fwd.cuh"

using namespace ssd_walk;

namespace {

template <typename T>
cudaError_t launch(const void* C, const void* Bm, const void* x,
                   const float* acum, const float* dte, const float* cdec,
                   const float* dtp, void* y, void* ssave, float* scores,
                   const Dims& d, cudaStream_t stream) {
  const FlatLayout<T> lay{static_cast<const T*>(C), static_cast<const T*>(Bm),
                          static_cast<const T*>(x), nullptr, nullptr};
  return launch_fwd<T>(lay, acum, dte, cdec, dtp, y, ssave, scores, d,
                       stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the two launches (0 on success).  is_bf16 selects the type of C, B, x, y
// and ssave; ssave may be null (no saved states); scores is a
// [B, nc, l, l] fp32 workspace.  The caller checks the shapes: P % 32 == 0,
// l <= 256, N <= 512 and a multiple of 32.
extern "C" int ssd_fused_fwd(const void* C, const void* Bm, const void* acum,
                             const void* dte, const void* cdec,
                             const void* dtp, const void* x, void* y,
                             void* ssave, void* scores, int B, int nc, int l,
                             int H, int P, int N, int is_bf16, void* stream) {
  const Dims d(B, nc, l, H, P, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* sc = static_cast<float*>(scores);
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(C, Bm, x, f(acum), f(dte),
                                                  f(cdec), f(dtp), y, ssave,
                                                  sc, d, s));
  return static_cast<int>(launch<float>(C, Bm, x, f(acum), f(dte), f(cdec),
                                        f(dtp), y, ssave, sc, d, s));
}

extern "C" const char* ssd_fused_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
