// SSD intra-chunk output Y_diag, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   medical_image_classification_tpu/kernels/ssd_ydiag_pallas.py
//   ::_bwd_kernel (launched by _run_bwd).
//
// Computes, for every chunk bc and head h, with scores = Cc[bc] . Bc[bc]^T,
// decay[i, j] = exp(a_i - a_j) for j <= i (else 0), a = acum[bc, h], and
// M = scores * decay in fp32 (Cc, Bc, dtx, dy of the operand type; rnd()
// rounds to it):
//   ddtx[bc, h, j] = sum_{i >= j} rnd(M)[i, j] dy[bc, h, i]
//   dM             = dy[bc, h] . dtx[bc, h]^T,  G = dM * M
//   dacum          = rowsums(G) - colsums(G)
//   dscores        = sum over the H heads of dM * decay     (fp32)
//   dC = rnd(dscores) . Bc[bc],  dB = rnd(dscores)^T . Cc[bc]
// every product summed in fp32 (the TPU body's rounding points: M rounded
// for ddtx only, G and dscores from the unrounded M and decay, dscores
// summed over all heads before it is rounded).  No [l, l] tensor per head
// goes to device memory; the head-summed dscores does, once per chunk.
//
// What bounds it on this card: at ST-SSD stage 0 (BC 448 = batch 32 x 14
// chunks of l 224, H 8, N 64, P 64, bf16) the products are ~27 GFLOP
// against ~0.37 GB moved: the bytes.
//
// Design (simple and right first).  The TPU body walked the heads of a
// chunk in order, with the scores and the dscores sum in VMEM scratch; its
// row sums of G and its dscores sum span tiles that Hopper blocks, which
// run in no order, cannot share.  So two kernels, no atomics, the same bits
// on every run:
//  1. ydiag_grad_kernel, per (64-column tile of source positions j, chunk
//     bc): computes its column strip of the scores (rows j0..l) once into
//     shared memory, then per head walks the causal row tiles i >= j0: dM
//     from dy and dtx, M and G from the strip and the decay, ddtx
//     accumulated in registers, the strip's dscores summed over the heads
//     in shared memory, G's column sums in registers, and G's row sums
//     written per (head, column tile) as fp32 partials that the caller
//     sums.  The block owns its strip of dscores, written once to an fp32
//     [BC, l, l] workspace.
//  2. ydiag_dcb_kernel, per (64-row tile, which of dC / dB, 64 columns of
//     N, bc): the two products of the rounded dscores with Bc and Cc over
//     the causal tiles.
// The strips hold up to 256 rows (l <= 256), ~140 KB of shared memory in
// all, so one block runs per SM; neither kernel holds more than 64
// columns of N at a time (the strip sums N in 64-wide chunks, the dC/dB
// kernel takes 64 columns per block), so N does not bound shared memory.  l 224 is not a multiple of 64: every tile
// edge is masked, and entries above the diagonal give M = G = 0.  P must
// be <= 64 (one 64-wide ddtx accumulator per block).  bf16 on the tensor
// cores (WMMA), fp32 on the CUDA cores (st_tiles.cuh).

#include "st_tiles.cuh"

namespace {

using namespace st_tiles;

struct YdDims {
  int BC, l, N, H, P, nt;  // nt: 64-row tiles of the chunk
};

// Dynamic shared memory of a ydiag_grad_kernel block, byte offsets: the scores
// strip and the dscores strip ([nt * 64][kLdS] fp32), the two operand
// tiles (C and B chunks while the strip is built, then dy's and dtx's
// tiles), the fp32 dM / G tile, the rounded M tile, the head's cumsum row
// and the column-sum staging.
template <typename T>
struct YdBwdSmem {
  size_t sc, ds, a, b, g, mm, acum, cols, total;
  __host__ __device__ explicit YdBwdSmem(int nt) {
    const size_t strip = round128(static_cast<size_t>(nt) * kT * kLdS * 4);
    const size_t tile = round128(kT * ld<T>(kT) * sizeof(T));
    sc = 0;
    ds = sc + strip;
    a = ds + strip;
    b = a + tile;
    g = b + tile;
    mm = g + round128(kT * kLdS * sizeof(float));
    acum = mm + tile;
    cols = acum + round128(static_cast<size_t>(nt) * kT * sizeof(float));
    total = cols + round128(4 * kT * sizeof(float));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ydiag_grad_kernel(const T* __restrict__ Cc, const T* __restrict__ Bc,
                const float* __restrict__ acum, const T* __restrict__ dtx,
                const T* __restrict__ dy, T* __restrict__ ddtx,
                float* __restrict__ row_part, float* __restrict__ col_sums,
                float* __restrict__ dscores, YdDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const YdBwdSmem<T> L(d.nt);
  float* sSc = reinterpret_cast<float*>(smem + L.sc);
  float* sDs = reinterpret_cast<float*>(smem + L.ds);
  T* sA = reinterpret_cast<T*>(smem + L.a);
  T* sB = reinterpret_cast<T*>(smem + L.b);
  float* sG = reinterpret_cast<float*>(smem + L.g);
  T* sM = reinterpret_cast<T*>(smem + L.mm);
  float* sa = reinterpret_cast<float*>(smem + L.acum);
  float* scol = reinterpret_cast<float*>(smem + L.cols);
  const int ld64 = ld<T>(kT);
  const int jt = blockIdx.x, bc = blockIdx.y, j0 = jt * kT;
  const T* Cb = Cc + static_cast<size_t>(bc) * d.l * d.N;
  const T* Bb = Bc + static_cast<size_t>(bc) * d.l * d.N;

  // the scores strip [i][j0 + c] for the row tiles i >= j0, summed over N
  // in 64-wide chunks; the dscores strip starts at 0
  for (int i = threadIdx.x; i < d.nt * kT * kLdS; i += kThreads) sDs[i] = 0.f;
  for (int it = jt; it < d.nt; ++it)
    for (int n0 = 0; n0 < d.N; n0 += kT) {
      load_tile(sA, ld64, Cb, d.N, it * kT, n0, kT, kT, d.l, d.N);
      load_tile(sB, ld64, Bb, d.N, j0, n0, kT, kT, d.l, d.N);
      __syncthreads();
      float* S = sSc + it * kT * kLdS;
      if (n0 == 0)
        gemm_s<true>(S, sA, ld64, sB, ld64, kT);
      else
        gemm_s<true, true>(S, sA, ld64, sB, ld64, kT);
      __syncthreads();
    }

  // four threads per row for the row sums; one column and 16 rows per
  // thread for the column sums
  const int rr = threadIdx.x / 4, rc = (threadIdx.x % 4) * 16;
  const int cc = threadIdx.x % kT, cr = (threadIdx.x / kT) * 16;
  for (int h = 0; h < d.H; ++h) {
    const size_t row = static_cast<size_t>(bc) * d.H + h;
    const float* ab = acum + row * d.l;
    const T* xb = dtx + row * d.l * d.P;
    const T* yb = dy + row * d.l * d.P;
    load_tile(sB, ld64, xb, d.P, j0, 0, kT, kT, d.l, d.P);   // dtx[j]
    for (int i = threadIdx.x; i < d.nt * kT; i += kThreads)
      sa[i] = i < d.l ? ab[i] : 0.f;
    Acc<T, kT> acc;
    acc.zero();
    float colsum = 0.f;
    for (int it = jt; it < d.nt; ++it) {
      const int i0 = it * kT;
      load_tile(sA, ld64, yb, d.P, i0, 0, kT, kT, d.l, d.P);  // dy[i]
      __syncthreads();
      gemm_s<true>(sG, sA, ld64, sB, ld64, kT);   // dM = dy dtx^T
      __syncthreads();
      for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
        const int r = e / kT, c = e - r * kT;
        const int i = i0 + r, j = j0 + c;
        float m = 0.f, g = 0.f;
        if (i < d.l && j <= i) {
          const float dec = expf(sa[i] - sa[j]);
          const float dm = sG[r * kLdS + c];
          m = sSc[i * kLdS + c] * dec;
          g = dm * m;
          sDs[i * kLdS + c] += dm * dec;
        }
        sG[r * kLdS + c] = g;
        sM[r * ld64 + c] = from_f32<T>(m);
      }
      __syncthreads();
      float rs = 0.f;
      for (int c = rc; c < rc + 16; ++c) rs += sG[rr * kLdS + c];
      rs = group4_sum(rs);
      if (threadIdx.x % 4 == 0 && i0 + rr < d.l)
        row_part[(row * d.nt + jt) * d.l + i0 + rr] = rs;
      for (int r = cr; r < cr + 16; ++r) colsum += sG[r * kLdS + cc];
      acc.template mma<true>(sM, ld64, sA, ld64);  // ddtx += rnd(M)^T dy
      __syncthreads();
    }
    scol[threadIdx.x] = colsum;      // [4][64]: the four 16-row groups
    __syncthreads();
    if (threadIdx.x < kT && j0 + threadIdx.x < d.l)
      col_sums[row * d.l + j0 + threadIdx.x] =
          scol[threadIdx.x] + scol[kT + threadIdx.x] +
          scol[2 * kT + threadIdx.x] + scol[3 * kT + threadIdx.x];
    T* ob = ddtx + row * d.l * d.P;
    acc.store(
        [&](int r, int c, float v) {
          if (j0 + r < d.l && c < d.P)
            ob[static_cast<size_t>(j0 + r) * d.P + c] = from_f32<T>(v);
        },
        sG + (threadIdx.x >> 5) * 256);
    __syncthreads();
  }

  // the block's strip of the head-summed dscores, rows j0..l
  float* db = dscores + static_cast<size_t>(bc) * d.l * d.l;
  for (int e = threadIdx.x; e < (d.l - j0) * kT; e += kThreads) {
    const int i = j0 + e / kT, c = e % kT;
    if (j0 + c < d.l) db[static_cast<size_t>(i) * d.l + j0 + c] =
        sDs[i * kLdS + c];
  }
}

// dC (which 0) for the rows of tile t: sum over j <= i of rnd(ds)[i, j]
// B[j]; dB (which 1) for the rows j of tile t: sum over i >= j of
// rnd(ds)[i, j] C[i]; 64 columns of N per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ydiag_dcb_kernel(const T* __restrict__ Cc, const T* __restrict__ Bc,
               const float* __restrict__ dscores, T* __restrict__ dC,
               T* __restrict__ dB, YdDims d) {
  constexpr int kLd = ld<T>(kT);
  __shared__ __align__(128) T sD[kT * kLd];
  __shared__ __align__(128) T sX[kT * kLd];
  __shared__ __align__(128) float stg[8 * 256];
  const int which = blockIdx.x / d.nt, t = blockIdx.x % d.nt;
  const int n0 = blockIdx.y * kT, bc = blockIdx.z;
  const size_t rows = static_cast<size_t>(bc) * d.l * d.N;
  const float* db = dscores + static_cast<size_t>(bc) * d.l * d.l;
  const T* other = which == 0 ? Bc + rows : Cc + rows;

  Acc<T, kT> acc;
  acc.zero();
  const int first = which == 0 ? 0 : t, last = which == 0 ? t : d.nt - 1;
  for (int u = first; u <= last; ++u) {
    const int i0 = (which == 0 ? t : u) * kT, k0 = (which == 0 ? u : t) * kT;
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e - r * kT;
      const int i = i0 + r, j = k0 + c;
      const float v = (i < d.l && j <= i)
                          ? db[static_cast<size_t>(i) * d.l + j] : 0.f;
      sD[r * kLd + c] = from_f32<T>(v);   // the rounded dscores tile [i][j]
    }
    // B's rows j (dC) or C's rows i (dB)
    load_tile(sX, kLd, other, d.N, which == 0 ? k0 : i0, n0, kT, kT, d.l,
              d.N);
    __syncthreads();
    if (which == 0)
      acc.template mma<false>(sD, kLd, sX, kLd);   // dC[i] += ds[i, j] B[j]
    else
      acc.template mma<true>(sD, kLd, sX, kLd);    // dB[j] += ds[i, j] C[i]
    __syncthreads();
  }
  T* out = (which == 0 ? dC : dB) + rows;
  acc.store(
      [&](int r, int c, float v) {
        if (t * kT + r < d.l && n0 + c < d.N)
          out[static_cast<size_t>(t * kT + r) * d.N + n0 + c] =
              from_f32<T>(v);
      },
      stg + (threadIdx.x >> 5) * 256);
}

template <typename T>
cudaError_t launch(const void* Cc, const void* Bc, const float* acum,
                   const void* dtx, const void* dy, void* ddtx,
                   float* row_part, float* col_sums, float* dscores, void* dC,
                   void* dB, const YdDims& d, cudaStream_t stream) {
  const size_t smem = YdBwdSmem<T>(d.nt).total;
  cudaError_t err = cudaFuncSetAttribute(
      ydiag_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const T* Ct = static_cast<const T*>(Cc);
  const T* Bt = static_cast<const T*>(Bc);
  ydiag_grad_kernel<T><<<dim3(d.nt, d.BC), kThreads, smem, stream>>>(
      Ct, Bt, acum, static_cast<const T*>(dtx), static_cast<const T*>(dy),
      static_cast<T*>(ddtx), row_part, col_sums, dscores, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ydiag_dcb_kernel<T><<<dim3(2 * d.nt, (d.N + kT - 1) / kT, d.BC), kThreads, 0,
                  stream>>>(Ct, Bt, dscores, static_cast<T*>(dC),
                            static_cast<T*>(dB), d);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the two launches (0 on success).  is_bf16 selects the type of Cc, Bc,
// dtx, dy, ddtx, dC and dB; acum is fp32.  row_part [BC, H, nt, l] (zeroed
// by the caller: each column tile writes only its causal rows) takes G's
// row sums per 64-column tile, col_sums [BC, H, l] its column sums, and
// dscores [BC, l, l] is an fp32 workspace.  The caller checks the shapes:
// l <= 256, N <= 512, P <= 64, BC <= 65535.
extern "C" int ssd_ydiag_bwd(const void* Cc, const void* Bc, const void* acum,
                             const void* dtx, const void* dy, void* ddtx,
                             void* row_part, void* col_sums, void* dscores,
                             void* dC, void* dB, int BC, int l, int N, int H,
                             int P, int is_bf16, void* stream) {
  const YdDims d{BC, l, N, H, P, (l + kT - 1) / kT};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acum);
  float* rp = static_cast<float*>(row_part);
  float* cs = static_cast<float*>(col_sums);
  float* ds = static_cast<float*>(dscores);
  if (is_bf16)
    return static_cast<int>(launch<bf16>(Cc, Bc, a, dtx, dy, ddtx, rp, cs, ds,
                                         dC, dB, d, s));
  return static_cast<int>(launch<float>(Cc, Bc, a, dtx, dy, ddtx, rp, cs, ds,
                                        dC, dB, d, s));
}

extern "C" const char* ssd_ydiag_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
