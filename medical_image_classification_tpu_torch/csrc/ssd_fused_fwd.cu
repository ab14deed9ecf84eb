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
// ssd_chunked, adds it).  dtx = rnd(x * dtp) is formed on the card (the prep
// pass), as the TPU body forms it in VMEM.  A padded last chunk needs
// nothing special: its steps carry dt = 0, so they add nothing to the state
// or to y.
//
// What bounds it on this card: operations (0.0826 ms at MedSSD stage 1 at
// 240x240: B 32, L 900 padded to nc 4 chunks of l 256, H 16, P 64, N 512,
// bf16); ssd_walk_fwd.cuh says what its four passes do about it.

#include <cstdint>
#include <initializer_list>

#include "ssd_walk_fwd.cuh"

using namespace ssd_walk;

namespace {

template <typename T>
cudaError_t launch(const void* C, const void* Bm, const void* x,
                   const float* acum, const float* dte, const float* cdec,
                   const float* dtp, void* y, void* ssave, const FwdWork& w,
                   const Dims& d, cudaStream_t stream) {
  const FlatLayout<T> lay{static_cast<const T*>(C), static_cast<const T*>(Bm),
                          static_cast<const T*>(x), nullptr, nullptr};
  return launch_fwd<T>(lay, acum, dte, cdec, dtp, y, ssave, w, d, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the four launches (0 on success); cudaErrorInvalidValue, before any
// launch, for an operand that is not 16-byte aligned.  is_bf16 selects the
// type of C, B, x, y, ssave and pre.  ssave [B, nc, H, P, N] takes the
// entering states (the saved states, or a workspace); workspaces as
// ssd_walk_fwd.cuh::FwdWork lists them, without bc (see kernels/
// ssd_fused.py::_launch_fwd_cuda).  The caller checks the shapes:
// P % 32 == 0, l <= 256 and l % 4 == 0, N <= 512 and a multiple of 32.
extern "C" int ssd_fused_fwd(const void* C, const void* Bm, const void* acum,
                             const void* dte, const void* cdec,
                             const void* dtp, const void* x, void* y,
                             void* ssave, void* scores, void* pre, int B,
                             int nc, int l, int H, int P, int N, int is_bf16,
                             void* stream) {
  const Dims d(B, nc, l, H, P, N);
  for (const void* p : {C, Bm, static_cast<const void*>(ssave),
                        static_cast<const void*>(scores),
                        static_cast<const void*>(pre)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const FwdWork work{static_cast<float*>(scores), pre, nullptr};
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(C, Bm, x, f(acum), f(dte),
                                                  f(cdec), f(dtp), y, ssave,
                                                  work, d, s));
  return static_cast<int>(launch<float>(C, Bm, x, f(acum), f(dte), f(cdec),
                                        f(dtp), y, ssave, work, d, s));
}

// Registers, local (spill) bytes, dynamic shared bytes and resident warps
// per SM of the four passes (prep, gram, state, out): out[16].
extern "C" int ssd_fused_fwd_pass_info(int is_bf16, int* out) {
  return static_cast<int>(
      is_bf16 ? fwd_pass_info<__nv_bfloat16, FlatLayout<__nv_bfloat16>>(out)
              : fwd_pass_info<float, FlatLayout<float>>(out));
}

extern "C" const char* ssd_fused_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
