// SSD intra-chunk output Y_diag, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/ssd_ydiag_pallas.py
//   ::_fwd_kernel (launched by _run_fwd).
//
// Computes, for every chunk bc, head h and row i of the chunk,
//   y[bc, h, i] = sum_{j <= i} M[i, j] dtx[bc, h, j]
//   M[i, j]     = rnd(scores[i, j] * exp(a_i - a_j)),  a = acum[bc, h]
//   scores      = Cc[bc] . Bc[bc]^T                    ([l, l], K = N)
// where rnd() rounds to the operand type (bf16 or fp32) as the TPU body's
// .astype(mm_dtype) does, and both products sum in fp32.  No [l, l] tensor
// goes to device memory.
//
// What bounds it on this card: the bytes.  At ST-SSD stage 0 (BC 448 =
// batch 32 x 14 chunks of l 224, H 8 heads over the four directions, N 64,
// P 64, bf16) dtx in and y out are ~0.21 GB against ~13 GFLOP of causal
// products; at MedSSD stage 2 at 240x240 (BC 32 single chunks of l 232,
// H 32, N 512, P 64) ~77 MB.
//
// Design: one pass, ssd_ydiag_strip.cuh's rows_kernel.  The TPU body built
// the scores once per chunk in VMEM and kept them over its sequential head
// axis; here a block builds a 64-row strip of them once into shared memory
// and walks its heads over it, M's fragments in registers, the product on
// mma.sync in bf16 (FMAs in fp32).

#include <cstdint>
#include <initializer_list>

#include "ssd_ydiag_strip.cuh"

using namespace ssd_ydiag;

namespace {

template <typename T>
cudaError_t launch(const void* Cc, const void* Bc, const float* acum,
                   const void* dtx, void* y, const Dims& d,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem(rows_kernel<T>, strip_smem<T>());
  if (err != cudaSuccess) return err;
  rows_kernel<T><<<strip_grid(d), kThreads, strip_smem<T>(), stream>>>(
      static_cast<const T*>(Cc), static_cast<const T*>(Bc), acum,
      static_cast<const T*>(dtx), static_cast<T*>(y), d);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the CUDA error of the
// launch (0 on success); cudaErrorInvalidValue, before it, for a shape
// outside the pass's tiles (l <= 256 and l % 4 == 0, N % 8 == 0, P % 8 ==
// 0: 16-byte pieces) or an operand that is not 16-byte aligned.  is_bf16
// selects the type of Cc, Bc, dtx and y; acum is fp32.  The caller also
// checks BC <= 65535.
extern "C" int ssd_ydiag_fwd(const void* Cc, const void* Bc, const void* acum,
                             const void* dtx, void* y, int BC, int l, int N,
                             int H, int P, int is_bf16, void* stream) {
  if (l > kMaxL || l % 4 || N % 8 || P % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {Cc, Bc, acum, dtx, static_cast<const void*>(y)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  const Dims d = make_dims(BC, l, N, H, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acum);
  if (is_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(Cc, Bc, a, dtx, y, d, s));
  return static_cast<int>(launch<float>(Cc, Bc, a, dtx, y, d, s));
}

// Registers, local (spill) bytes, dynamic shared bytes and resident warps
// per SM of the one pass (rows): out[4].
extern "C" int ssd_ydiag_fwd_pass_info(int is_bf16, int* out) {
  return static_cast<int>(
      is_bf16 ? pass_info(rows_kernel<__nv_bfloat16>,
                          strip_smem<__nv_bfloat16>(), out)
              : pass_info(rows_kernel<float>, strip_smem<float>(), out));
}

extern "C" const char* ssd_ydiag_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
