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
// What bounds it on this card: at ST-SSD stage 0 (BC 448 = batch 32 x 14
// chunks of l 224, H 8 heads over the four directions, N 64, P 64, bf16)
// the products are 2 BC l^2 (N + H P) ~ 26 GFLOP against ~0.2 GB moved, so
// the tensor cores' rate (operations), not the bytes.  At MedSSD stage 2 at
// 240x240 (BC 32 single chunks of l 232, H 32, N 512, P 64) the causal
// pairs give ~4.4 GFLOP against ~77 MB.
//
// Design (simple and right first): one block per (64-row tile of the
// chunk, head and 64-column tile of P, chunk).  It walks only the causal
// column tiles j <= i: per tile it recomputes the scores from C and B (the
// TPU body computed them once per chunk and kept them in VMEM over its
// head axis; here that would cost an [l, l] fp32 workspace round trip, and
// recomputing costs 2 l^2 N per head, as much as the head's own product at
// N = P = 64), masks and decays them into M, rounds M, and accumulates
// M . dtx.  The scores contraction runs over N in slabs of kNS = 128
// columns of C and B, summed in the fp32 scores tile, so shared memory does
// not grow with N (two [64, 512] fp32 row tiles would not fit at N 512);
// where N fits one slab the block's rows of C are loaded once.  l 224 is
// not a multiple of 64, and N and P need not be either: every tile edge is
// masked.  bf16 on the tensor cores (WMMA), fp32 on the CUDA cores
// (st_tiles.cuh).

#include "st_tiles.cuh"

namespace {

using namespace st_tiles;

struct YdDims {
  int BC, l, N, H, P, NK;  // NK: N rounded up to 16, the product depth
};

constexpr int kNS = 128;   // columns of C and B per slab of the scores

// Dynamic shared memory of one block, byte offsets: a slab of the C rows
// and of the B rows ([64][kNS]), the dtx tile, the fp32 scores tile, the
// rounded M tile (bf16 only: fp32 rounds in place) and the two cumsum rows.
template <typename T>
struct YdSmem {
  size_t c, b, x, s, m, ai, aj, total;
  __host__ __device__ YdSmem() {
    const size_t rows = round128(kT * ld<T>(kNS) * sizeof(T));
    const size_t tile = round128(kT * ld<T>(kT) * sizeof(T));
    c = 0;
    b = c + rows;
    x = b + rows;
    s = x + tile;
    m = s + round128(kT * kLdS * sizeof(float));
    ai = m + (std::is_same<T, float>::value ? 0 : tile);
    aj = ai + round128(kT * sizeof(float));
    total = aj + round128(kT * sizeof(float));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ydiag_kernel(const T* __restrict__ Cc, const T* __restrict__ Bc,
                 const float* __restrict__ acum, const T* __restrict__ dtx,
                 T* __restrict__ y, YdDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const YdSmem<T> L;
  constexpr bool kF32 = std::is_same<T, float>::value;
  T* sC = reinterpret_cast<T*>(smem + L.c);
  T* sB = reinterpret_cast<T*>(smem + L.b);
  T* sX = reinterpret_cast<T*>(smem + L.x);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  T* sM = reinterpret_cast<T*>(smem + (kF32 ? L.s : L.m));
  float* sai = reinterpret_cast<float*>(smem + L.ai);
  float* saj = reinterpret_cast<float*>(smem + L.aj);
  const int ldK = ld<T>(kNS), ldX = ld<T>(kT);
  const int ldM = kF32 ? kLdS : ld<T>(kT);

  const int npt = (d.P + kT - 1) / kT;
  const int it = blockIdx.x;
  const int h = blockIdx.y / npt, p0 = (blockIdx.y - h * npt) * kT;
  const int bc = blockIdx.z;
  const int i0 = it * kT;
  const T* Cb = Cc + static_cast<size_t>(bc) * d.l * d.N;
  const T* Bb = Bc + static_cast<size_t>(bc) * d.l * d.N;
  const size_t row = static_cast<size_t>(bc) * d.H + h;
  const float* ab = acum + row * d.l;
  const T* xb = dtx + row * d.l * d.P;

  const bool one_slab = d.NK <= kNS;
  if (one_slab) load_tile(sC, ldK, Cb, d.N, i0, 0, kT, d.NK, d.l, d.N);
  for (int t = threadIdx.x; t < kT; t += kThreads)
    sai[t] = i0 + t < d.l ? ab[i0 + t] : 0.f;
  Acc<T, kT> acc;
  acc.zero();
  for (int jt = 0; jt <= it; ++jt) {           // causal column tiles only
    const int j0 = jt * kT;
    load_tile(sX, ldX, xb, d.P, j0, p0, kT, kT, d.l, d.P);
    for (int t = threadIdx.x; t < kT; t += kThreads)
      saj[t] = j0 + t < d.l ? ab[j0 + t] : 0.f;
    // scores = C B^T, summed over the slabs of N
    for (int n0 = 0; n0 < d.NK; n0 += kNS) {
      const int kw = min(kNS, d.NK - n0);
      if (!one_slab) load_tile(sC, ldK, Cb, d.N, i0, n0, kT, kw, d.l, d.N);
      load_tile(sB, ldK, Bb, d.N, j0, n0, kT, kw, d.l, d.N);
      __syncthreads();
      if (n0 == 0)
        gemm_s(sS, sC, ldK, sB, ldK, kw);
      else
        gemm_s<true>(sS, sC, ldK, sB, ldK, kw);
      __syncthreads();
    }
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e - r * kT;
      const int i = i0 + r, j = j0 + c;
      float m = 0.f;
      if (i < d.l && j <= i) m = sS[r * kLdS + c] * expf(sai[r] - saj[c]);
      sM[r * ldM + c] = from_f32<T>(m);
    }
    __syncthreads();
    acc.template mma<false>(sM, ldM, sX, ldX);  // y += M dtx
    __syncthreads();
  }
  T* yb = y + row * d.l * d.P;
  acc.store(
      [&](int r, int c, float v) {
        const int i = i0 + r, p = p0 + c;
        if (i < d.l && p < d.P)
          yb[static_cast<size_t>(i) * d.P + p] = from_f32<T>(v);
      },
      sS + (threadIdx.x >> 5) * 256);
}

template <typename T>
cudaError_t launch(const void* Cc, const void* Bc, const float* acum,
                   const void* dtx, void* y, const YdDims& d,
                   cudaStream_t stream) {
  const size_t smem = YdSmem<T>().total;
  cudaError_t err = cudaFuncSetAttribute(
      ydiag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((d.l + kT - 1) / kT, d.H * ((d.P + kT - 1) / kT), d.BC);
  ydiag_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(Cc), static_cast<const T*>(Bc), acum,
      static_cast<const T*>(dtx), static_cast<T*>(y), d);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the CUDA error of the
// launch (0 on success).  is_bf16 selects the type of Cc, Bc, dtx and y;
// acum is fp32.  The caller checks the shapes: N <= 512, BC <= 65535.
extern "C" int ssd_ydiag_fwd(const void* Cc, const void* Bc, const void* acum,
                             const void* dtx, void* y, int BC, int l, int N,
                             int H, int P, int is_bf16, void* stream) {
  const YdDims d{BC, l, N, H, P, (N + 15) / 16 * 16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acum);
  if (is_bf16)
    return static_cast<int>(launch<bf16>(Cc, Bc, a, dtx, y, d, s));
  return static_cast<int>(launch<float>(Cc, Bc, a, dtx, y, d, s));
}

extern "C" const char* ssd_ydiag_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
