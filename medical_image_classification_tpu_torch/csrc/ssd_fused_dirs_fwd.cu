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
// What bounds it on this card: operations (0.1298 ms at MedSSD 224x224
// stage 0 in bf16); ssd_walk_fwd.cuh says what its four passes do about
// it.

#include <cstdint>
#include <initializer_list>

#include "ssd_walk_fwd.cuh"

using namespace ssd_walk;

namespace {

template <typename T>
cudaError_t launch(const void* stack, const float* Dsk, const float* acum,
                   const float* dte, const float* cdec, const float* dtp,
                   void* y, void* ssave, const FwdWork& w, const Dims& d,
                   int d_ssm, int gn, cudaStream_t stream) {
  const DirsLayout<T> lay(static_cast<const T*>(stack), Dsk, nullptr, d.H,
                          d_ssm, gn);
  return launch_fwd<T>(lay, acum, dte, cdec, dtp, y, ssave, w, d, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the four launches (0 on success); cudaErrorInvalidValue, before any
// launch, for an operand that is not 16-byte aligned.  is_bf16 selects the
// type of stack, y, ssave, pre and bc.  ssave [B, nc, H4, P, N] takes the
// entering states (the saved states, or a workspace); workspaces as
// ssd_walk_fwd.cuh::FwdWork lists them (see kernels/ssd_fused_dirs.py::
// _launch_fwd_cuda).  The caller checks the shapes: P % 32 == 0,
// l <= 256 and l % 4 == 0, N = 4 gn <= 512 and a multiple of 32.
extern "C" int ssd_fused_dirs_fwd(const void* stack, const void* acum,
                                  const void* dte, const void* cdec,
                                  const void* dtp, const void* Dsk, void* y,
                                  void* ssave, void* scores, void* pre,
                                  void* bc, int B, int nc, int l, int H4,
                                  int P, int d_ssm, int gn, int is_bf16,
                                  void* stream) {
  const Dims d(B, nc, l, H4, P, 4 * gn);
  for (const void* p : {static_cast<const void*>(ssave),
                        static_cast<const void*>(scores),
                        static_cast<const void*>(pre),
                        static_cast<const void*>(bc)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const FwdWork work{static_cast<float*>(scores), pre, bc};
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(
        stack, f(Dsk), f(acum), f(dte), f(cdec), f(dtp), y, ssave, work, d,
        d_ssm, gn, s));
  return static_cast<int>(launch<float>(stack, f(Dsk), f(acum), f(dte),
                                        f(cdec), f(dtp), y, ssave, work, d,
                                        d_ssm, gn, s));
}

// Registers, local (spill) bytes, dynamic shared bytes and resident warps
// per SM of the four passes (prep, gram, state, out): out[16].
extern "C" int ssd_fused_dirs_fwd_pass_info(int is_bf16, int* out) {
  return static_cast<int>(
      is_bf16 ? fwd_pass_info<__nv_bfloat16, DirsLayout<__nv_bfloat16>>(out)
              : fwd_pass_info<float, DirsLayout<float>>(out));
}

extern "C" const char* ssd_fused_dirs_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
