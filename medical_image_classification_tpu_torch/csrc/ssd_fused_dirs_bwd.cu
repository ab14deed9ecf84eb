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
// What bounds it on this card: operations, about 2.5x the forward's.

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
// the four launches (0 on success).  is_bf16 selects the type of stack,
// ssave, dy, dx, dso and dBC.  Workspaces and per-block fp32 partials as
// ssd_walk_bwd.cuh::BwdWork lists them (see kernels/ssd_fused_dirs.py::
// _launch_bwd_cuda); dso [B, nc, H4, P, N]; dBC [4, B, nc, l, 2 gn] as
// dB_dir, dC_dir, dB_flip, dC_flip.
extern "C" int ssd_fused_dirs_bwd(
    const void* stack, const void* acum, const void* dte, const void* cdec,
    const void* dtp, const void* Dsk, const void* ssave, const void* dy,
    void* dx, void* dso, void* scores, void* dscores, void* row_part,
    void* col_part, void* off_part, void* ddte_part, void* ddtp_part,
    void* dD_part, void* dcdec_part, void* dBC, int B, int nc, int l, int H4,
    int P, int d_ssm, int gn, int is_bf16, void* stream) {
  const Dims d(B, nc, l, H4, P, 4 * gn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const BwdWork work{w(scores),   w(dscores),   w(row_part),
                     w(col_part), w(off_part),  w(ddte_part),
                     w(ddtp_part), w(dD_part), w(dcdec_part)};
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(
        stack, f(Dsk), f(acum), f(dte), f(cdec), f(dtp), ssave, dy, dx, dso,
        dBC, work, d, d_ssm, gn, s));
  return static_cast<int>(launch<float>(stack, f(Dsk), f(acum), f(dte),
                                        f(cdec), f(dtp), ssave, dy, dx, dso,
                                        dBC, work, d, d_ssm, gn, s));
}

extern "C" const char* ssd_fused_dirs_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
