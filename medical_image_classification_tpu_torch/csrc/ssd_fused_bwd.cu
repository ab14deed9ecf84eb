// Single-layout fused SSD backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/ssd_fused_pallas.py
//   ::_bwd_kernel (launched by _run_bwd).
//
// The reverse chunk walk of ssd_walk_bwd.cuh from the saved boundary
// states, over C, B [B, nc, l, N] and x, dy, dx flat and l-major
// [B, nc, l, H P] (FlatLayout, ssd_walk_common.cuh), no D skip.  Its
// outputs are the cotangents of the forward's primal inputs, as the TPU
// body's: dC, dB, and per-block fp32 partials of dacum, ddte, dcdec and
// ddtp (dte and cdec keep their own cotangents; autograd chains them to
// acum outside the kernel), and dx.
//
// What bounds it on this card: operations, about 2.5x the forward's.  The
// sums the TPU body carried over its sequential head axis (dscores, dC,
// dB) are a loop over the heads inside the one block that owns the tile of
// (b, c) (intra_kernel, flush_kernel); per-head [B, nc, H, l, N] fp32
// partials would have cost ~1.07 GB at MedSSD stage 1 at 240x240.

#include "ssd_walk_bwd.cuh"

using namespace ssd_walk;

namespace {

template <typename T>
cudaError_t launch(const void* C, const void* Bm, const void* x,
                   const float* acum, const float* dte, const float* cdec,
                   const float* dtp, const void* ssave, const void* dy,
                   void* dx, void* dso, void* dC, void* dB, const BwdWork& w,
                   const Dims& d, cudaStream_t stream) {
  const FlatLayout<T> lay{static_cast<const T*>(C), static_cast<const T*>(Bm),
                          static_cast<const T*>(x), static_cast<T*>(dC),
                          static_cast<T*>(dB)};
  return launch_bwd<T>(lay, acum, dte, cdec, dtp, ssave, dy, dx, dso, w, d,
                       stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the four launches (0 on success).  is_bf16 selects the type of C, B, x,
// ssave, dy, dx, dso, dC and dB.  Workspaces and per-block fp32 partials as
// ssd_walk_bwd.cuh::BwdWork lists them, without dD_part (see
// kernels/ssd_fused.py::_launch_bwd_cuda); dso [B, nc, H, P, N].
extern "C" int ssd_fused_bwd(
    const void* C, const void* Bm, const void* acum, const void* dte,
    const void* cdec, const void* dtp, const void* x, const void* ssave,
    const void* dy, void* dx, void* dso, void* scores, void* dscores,
    void* row_part, void* col_part, void* off_part, void* ddte_part,
    void* ddtp_part, void* dcdec_part, void* dC, void* dB, int B, int nc,
    int l, int H, int P, int N, int is_bf16, void* stream) {
  const Dims d(B, nc, l, H, P, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const BwdWork work{w(scores),    w(dscores),   w(row_part),
                     w(col_part),  w(off_part),  w(ddte_part),
                     w(ddtp_part), nullptr,      w(dcdec_part)};
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(
        C, Bm, x, f(acum), f(dte), f(cdec), f(dtp), ssave, dy, dx, dso, dC,
        dB, work, d, s));
  return static_cast<int>(launch<float>(C, Bm, x, f(acum), f(dte), f(cdec),
                                        f(dtp), ssave, dy, dx, dso, dC, dB,
                                        work, d, s));
}

extern "C" const char* ssd_fused_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
