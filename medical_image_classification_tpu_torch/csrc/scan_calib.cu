// The selective-scan kernel bench's calibration floor, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   scripts/kernel_bench.py::calib_kernel_bench (its body `kern`, launched
//   by `run`): the scan forward's per-element work without the scan, so the
//   gap between the scan's time and this one's is the scan machinery's.
//
// Computes, for every sequence g, step t and channel d (k = g % K):
//   dt = softplus(delta[g, t, d])                       (no bias)
//   y[g, t, d] = sum_n C[g, t, n] exp(dt At[k, n, d]) dt u[g, t, d] B[g, t, n]
// over L padded to Lp (a multiple of the bench's chunk T): the pad rows
// hold zeros (the TPU kernel reads zero-padded inputs, where u = 0 gives
// y = 0).  With bf16_compute the operands, softplus, exp and each product
// are rounded to bf16 where `kern` rounds them (CALIB_BF16: the product
// C (a b) cast to fp32 before the sum); otherwise everything is fp32.  The
// sum over n is fp32, y is in u's type.
//
// Layout: u, delta, y [G, L or Lp, Dm] and B, C [G, L, N] in one type (fp32
// or bf16); At [K, N, Dm] fp32 (A transposed, as `run` takes it).
//
// What bounds it on this card: bytes.  At the bench's stage 0 (G 128, L
// 3136, Dm 96, N 16, bf16, T 224: no pad) it moves 257 MB, 0.077 ms at
// 3.35 TB/s; it takes one exp per (g, t, d, n), 617 M of them, 0.15 ms at
// 16 per clock per SM (the MUFU rate) over 132 SMs at 1.98 GHz.
//
// Design: one thread per output element, d fastest, so a warp reads 32
// neighbouring channels of one row (u, delta, y coalesced) and broadcasts
// that row's B and C values; At is 24 KB and stays in L1.  CUDA rather than
// Triton: the function is a loop over n in one thread, and the ctypes build
// the other kernels share needs no second toolchain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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

// rounded to bf16 (round to nearest even) and back
__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float softplus_f32(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    calib_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                 const float* __restrict__ At, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y, int L, int Lp,
                 int Dm, int K, int N, size_t total) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const int d = static_cast<int>(i % Dm);
    const size_t gt = i / Dm;
    const int t = static_cast<int>(gt % Lp);
    const int g = static_cast<int>(gt / Lp);
    float acc = 0.f;
    if (t < L) {  // pad rows: u = 0, so every term is 0
      const size_t row = static_cast<size_t>(g) * L + t;
      // with kBf16 every operand is cast to bf16 first (a no-op for bf16
      // inputs), as `kern` casts its blocks
      float uf = to_f32(u[row * Dm + d]);
      float dv = to_f32(delta[row * Dm + d]);
      if (kBf16) {
        uf = rb(uf);
        dv = rb(dv);
      }
      float dt = softplus_f32(dv);
      if (kBf16) dt = rb(dt);
      const float* a_col = At + static_cast<size_t>(g % K) * N * Dm + d;
      const float dtu = kBf16 ? rb(dt * uf) : dt * uf;
      for (int n = 0; n < N; ++n) {
        float bn = to_f32(Bm[row * N + n]);
        float cn = to_f32(Cm[row * N + n]);
        float term;
        if (kBf16) {
          bn = rb(bn);
          cn = rb(cn);
          const float av = rb(a_col[static_cast<size_t>(n) * Dm]);
          const float a = rb(expf(rb(dt * av)));
          term = rb(cn * rb(a * rb(dtu * bn)));
        } else {
          const float a = expf(dt * a_col[static_cast<size_t>(n) * Dm]);
          term = cn * (a * (dtu * bn));
        }
        acc += term;
      }
    }
    y[i] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* At,
                   const void* B, const void* C, void* y, int G, int L,
                   int Lp, int Dm, int K, int N, bool bf16,
                   cudaStream_t stream) {
  if (G < 1 || L < 1 || Lp < L || Dm < 1 || N < 1) {
    return cudaErrorInvalidValue;
  }
  const size_t total = static_cast<size_t>(G) * Lp * Dm;
  const size_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < (1u << 20) ? want : (1u << 20));
#define CALIB_LAUNCH(BF)                                                     \
  calib_kernel<T, BF><<<blocks, kThreads, 0, stream>>>(                      \
      static_cast<const T*>(u), static_cast<const T*>(delta),                \
      static_cast<const float*>(At), static_cast<const T*>(B),               \
      static_cast<const T*>(C), static_cast<T*>(y), L, Lp, Dm, K, N, total)
  if (bf16) {
    CALIB_LAUNCH(true);
  } else {
    CALIB_LAUNCH(false);
  }
#undef CALIB_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success).  is_bf16 selects the type of u, delta, B, C
// and y; bf16_compute the rounding of the arithmetic.
extern "C" int scan_calib(const void* u, const void* delta, const void* At,
                          const void* B, const void* C, void* y, int G, int L,
                          int Lp, int Dm, int K, int N, int is_bf16,
                          int bf16_compute, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return static_cast<int>(launch<__nv_bfloat16>(
        u, delta, At, B, C, y, G, L, Lp, Dm, K, N, bf16_compute != 0, s));
  }
  return static_cast<int>(launch<float>(u, delta, At, B, C, y, G, L, Lp, Dm,
                                        K, N, bf16_compute != 0, s));
}

extern "C" const char* scan_calib_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
