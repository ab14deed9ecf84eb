// Four-direction fused SSD backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/ssd_fused_dirs_pallas.py
//   ::_bwd_kernel (launched by _run_bwd).
//
// The reverse chunk walk of ssd_walk_bwd.cuh over the role-major d0/d1
// stack (DirsLayout, ssd_walk_common.cuh): the coupled B/C cotangents'
// flipped halves are written at the mirrored chunk, reversed, and the D
// skip adds dy * D[h] to dx and its own cotangent dD.
//
// What bounds it on this card: operations (0.3244 ms at MedSSD 224x224
// stage 0 in bf16); ssd_walk_bwd.cuh says what its five passes do about
// it.

#include <cstdint>
#include <initializer_list>

#include "ssd_walk_bwd.cuh"

using namespace ssd_walk;

namespace {

template <typename T>
cudaError_t launch(const void* stack, const float* Dsk, const float* acum,
                   const float* dte, const float* cdec, const float* dtp,
                   const void* ssave, const void* dy, void* dx, void* dso,
                   void* dBC, const BwdWork& w, const Dims& d, int d_ssm,
                   int gn, cudaStream_t stream) {
  const DirsLayout<T> lay(static_cast<const T*>(stack), Dsk,
                          static_cast<T*>(dBC), d.H, d_ssm, gn);
  return launch_bwd<T>(lay, acum, dte, cdec, dtp, ssave, dy, dx, dso, w, d,
                       stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the six launches (0 on success); cudaErrorInvalidValue, before any
// launch, for an operand that is not 16-byte aligned.  is_bf16 selects
// the type of stack, ssave, dy, dx, dso and dBC.  Workspaces and
// per-block fp32 partials as ssd_walk_bwd.cuh::BwdWork lists them (see
// kernels/ssd_fused_dirs.py::_launch_bwd_cuda); dso [B, nc, H4, P, N]; dBC
// [4, B, nc, l, 2 gn] as dB_dir, dC_dir, dB_flip, dC_flip.
extern "C" int ssd_fused_dirs_bwd(
    const void* stack, const void* acum, const void* dte, const void* cdec,
    const void* dtp, const void* Dsk, const void* ssave, const void* dy,
    void* dx, void* dso, void* scores, void* dsr, void* pre, void* bc,
    void* row_part,
    void* col_part, void* off_part, void* ddte_part, void* ddtp_part,
    void* dD_part, void* dcdec_part, void* dBC, int B, int nc, int l, int H4,
    int P, int d_ssm, int gn, int is_bf16, void* stream) {
  const Dims d(B, nc, l, H4, P, 4 * gn);
  for (const void* p : {stack, acum, ssave, dy, static_cast<const void*>(dx),
                        static_cast<const void*>(dso),
                        static_cast<const void*>(dsr),
                        static_cast<const void*>(pre),
                        static_cast<const void*>(bc),
                        static_cast<const void*>(dBC)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const BwdWork work{w(scores),    dsr,          pre,          bc,
                     w(row_part),  w(col_part),  w(off_part),
                     w(ddte_part), w(ddtp_part), w(dD_part),
                     w(dcdec_part)};
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(
        stack, f(Dsk), f(acum), f(dte), f(cdec), f(dtp), ssave, dy, dx, dso,
        dBC, work, d, d_ssm, gn, s));
  return static_cast<int>(launch<float>(stack, f(Dsk), f(acum), f(dte),
                                        f(cdec), f(dtp), ssave, dy, dx, dso,
                                        dBC, work, d, d_ssm, gn, s));
}

// Registers, local (spill) bytes, dynamic shared bytes and resident warps
// per SM of the five passes (gram, intra, state, chunk, flush): out[20].
extern "C" int ssd_fused_dirs_bwd_pass_info(int is_bf16, int* out) {
  return static_cast<int>(
      is_bf16 ? bwd_pass_info<__nv_bfloat16, DirsLayout<__nv_bfloat16>>(out)
              : bwd_pass_info<float, DirsLayout<float>>(out));
}

extern "C" const char* ssd_fused_dirs_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
