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
//   dscores        = rnd(sum over the H heads of dM * decay)
//   dC = dscores . Bc[bc],  dB = dscores^T . Cc[bc]
// every product summed in fp32 (the TPU body's rounding points: M rounded
// for ddtx only, G and dscores from the unrounded M and decay, dscores
// summed over all heads in fp32 before it is rounded once).
//
// What bounds it on this card: the bytes.  At ST-SSD stage 0 (BC 448 =
// batch 32 x 14 chunks of l 224, H 8, N 64, P 64, bf16) dtx and dy in and
// ddtx out are ~0.31 GB against ~27 GFLOP.
//
// Design (bf16): three passes, no atomics, the same bits on every run:
//  1. the SSD walk backward's intra pass (ssd_walk_bwd.cuh) over
//     YDiagLayout: per (64 x 64 tile, chunk) the tile's scores built once
//     from C and B, then the heads in turn: dM on the tensor cores, the head
//     sum of dM decay in fp32 registers, rounded once into the operand-type
//     workspace dsr [BC, l, l], and G's row and column sums as per-tile fp32
//     partials that the caller sums;
//  2. ssd_ydiag_strip.cuh's cols_kernel: ddtx = rnd(M)^T dy, per 64
//     positions j a strip of the scores' columns built once for the heads;
//  3. the walk's flush pass without its state terms: dC = dsr Bc and
//     dB = dsr^T Cc over the causal tiles.
// The scores are built once per tile in pass 1 and once per strip and head
// group in pass 2; no fp32 [l, l] tensor goes to device memory.
//
// fp32 keeps the two passes of the first port (st_tiles.cuh's 4 x 4 FMA
// register tiles): the three above on warp_mma's FMA fragments took
// 1.36x (ST-SSD stage 0) and 1.50x (N 512) their time on an H100 SXM at
// 700 W.
//  1. grad_kernel, per (64-column tile of positions j, chunk bc): its
//     column strip of the scores (rows j0..l) once into shared memory, then
//     per head the row tiles i >= j0: dM, M, G, ddtx in registers, the
//     strip's dscores summed over the heads in shared memory (fp32, the
//     operand type), G's column sums whole and its row sums per column
//     tile; the strip of dscores to an fp32 [BC, l, l] workspace;
//  2. dcb_kernel, per (64-row tile, dC or dB, 64 of N, bc): the two
//     products of dscores with Bc and Cc over the causal tiles.
// The strips hold up to 256 rows (~140 KB of shared memory, one block an
// SM), and P <= 64 (one 64-wide ddtx accumulator a block).

#include <cstdint>
#include <initializer_list>

#include "ssd_walk_bwd.cuh"
#include "ssd_ydiag_strip.cuh"
#include "st_tiles.cuh"

namespace {

// ------------------------------------------------------------ fp32 passes

namespace f32 {

using namespace st_tiles;

struct Dims {
  int BC, l, N, H, P, nt;  // nt: 64-row tiles of the chunk
};

// Dynamic shared memory of a grad_kernel block, byte offsets: the scores
// strip and the dscores strip ([nt * 64][kLdS] fp32), the two operand
// tiles (C and B chunks while the strip is built, then dy's and dtx's
// tiles), the dM / G tile, the M tile, the head's cumsum row
// and the column-sum staging.
struct GradSmem {
  size_t sc, ds, a, b, g, mm, acum, cols, total;
  __host__ __device__ explicit GradSmem(int nt) {
    const size_t strip = round128(static_cast<size_t>(nt) * kT * kLdS * 4);
    const size_t tile = round128(kT * ld(kT) * sizeof(float));
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

__global__ void __launch_bounds__(kThreads)
    grad_kernel(const float* __restrict__ Cc, const float* __restrict__ Bc,
                const float* __restrict__ acum, const float* __restrict__ dtx,
                const float* __restrict__ dy, float* __restrict__ ddtx,
                float* __restrict__ row_part, float* __restrict__ col_part,
                float* __restrict__ dscores, Dims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GradSmem L(d.nt);
  float* sSc = reinterpret_cast<float*>(smem + L.sc);
  float* sDs = reinterpret_cast<float*>(smem + L.ds);
  float* sA = reinterpret_cast<float*>(smem + L.a);
  float* sB = reinterpret_cast<float*>(smem + L.b);
  float* sG = reinterpret_cast<float*>(smem + L.g);
  float* sM = reinterpret_cast<float*>(smem + L.mm);
  float* sa = reinterpret_cast<float*>(smem + L.acum);
  float* scol = reinterpret_cast<float*>(smem + L.cols);
  const int ld64 = ld(kT);
  const int jt = blockIdx.x, bc = blockIdx.y, j0 = jt * kT;
  const float* Cb = Cc + static_cast<size_t>(bc) * d.l * d.N;
  const float* Bb = Bc + static_cast<size_t>(bc) * d.l * d.N;

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
        gemm_s(S, sA, ld64, sB, ld64, kT);
      else
        gemm_s<true>(S, sA, ld64, sB, ld64, kT);
      __syncthreads();
    }

  // four threads per row for the row sums; one column and 16 rows per
  // thread for the column sums
  const int rr = threadIdx.x / 4, rc = (threadIdx.x % 4) * 16;
  const int cc = threadIdx.x % kT, cr = (threadIdx.x / kT) * 16;
  for (int h = 0; h < d.H; ++h) {
    const size_t row = static_cast<size_t>(bc) * d.H + h;
    const float* ab = acum + row * d.l;
    const float* xb = dtx + row * d.l * d.P;
    const float* yb = dy + row * d.l * d.P;
    load_tile(sB, ld64, xb, d.P, j0, 0, kT, kT, d.l, d.P);   // dtx[j]
    for (int i = threadIdx.x; i < d.nt * kT; i += kThreads)
      sa[i] = i < d.l ? ab[i] : 0.f;
    Acc<kT> acc;
    acc.zero();
    float colsum = 0.f;
    for (int it = jt; it < d.nt; ++it) {
      const int i0 = it * kT;
      load_tile(sA, ld64, yb, d.P, i0, 0, kT, kT, d.l, d.P);  // dy[i]
      __syncthreads();
      gemm_s(sG, sA, ld64, sB, ld64, kT);   // dM = dy dtx^T
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
        sM[r * ld64 + c] = m;
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
      col_part[row * d.l + j0 + threadIdx.x] =
          scol[threadIdx.x] + scol[kT + threadIdx.x] +
          scol[2 * kT + threadIdx.x] + scol[3 * kT + threadIdx.x];
    float* ob = ddtx + row * d.l * d.P;
    acc.store(
        [&](int r, int c, float v) {
          if (j0 + r < d.l && c < d.P)
            ob[static_cast<size_t>(j0 + r) * d.P + c] = v;
        });
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
__global__ void __launch_bounds__(kThreads)
    dcb_kernel(const float* __restrict__ Cc, const float* __restrict__ Bc,
               const float* __restrict__ dscores, float* __restrict__ dC,
               float* __restrict__ dB, Dims d) {
  constexpr int kLd = ld(kT);
  __shared__ __align__(128) float sD[kT * kLd];
  __shared__ __align__(128) float sX[kT * kLd];
  const int which = blockIdx.x / d.nt, t = blockIdx.x % d.nt;
  const int n0 = blockIdx.y * kT, bc = blockIdx.z;
  const size_t rows = static_cast<size_t>(bc) * d.l * d.N;
  const float* db = dscores + static_cast<size_t>(bc) * d.l * d.l;
  const float* other = which == 0 ? Bc + rows : Cc + rows;

  Acc<kT> acc;
  acc.zero();
  const int first = which == 0 ? 0 : t, last = which == 0 ? t : d.nt - 1;
  for (int u = first; u <= last; ++u) {
    const int i0 = (which == 0 ? t : u) * kT, k0 = (which == 0 ? u : t) * kT;
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e - r * kT;
      const int i = i0 + r, j = k0 + c;
      const float v = (i < d.l && j <= i)
                          ? db[static_cast<size_t>(i) * d.l + j] : 0.f;
      sD[r * kLd + c] = v;   // the dscores tile [i][j]
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
  float* out = (which == 0 ? dC : dB) + rows;
  acc.store(
      [&](int r, int c, float v) {
        if (t * kT + r < d.l && n0 + c < d.N)
          out[static_cast<size_t>(t * kT + r) * d.N + n0 + c] = v;
      });
}

cudaError_t launch(const float* Cc, const float* Bc, const float* acum,
                   const float* dtx, const float* dy, float* ddtx,
                   float* dscores, float* row_part, float* col_part,
                   float* dC, float* dB, const Dims& d, cudaStream_t stream) {
  const size_t smem = GradSmem(d.nt).total;
  cudaError_t err = cudaFuncSetAttribute(
      grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  grad_kernel<<<dim3(d.nt, d.BC), kThreads, smem, stream>>>(
      Cc, Bc, acum, dtx, dy, ddtx, row_part, col_part, dscores, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dcb_kernel<<<dim3(2 * d.nt, (d.N + kT - 1) / kT, d.BC), kThreads, 0,
               stream>>>(Cc, Bc, dscores, dC, dB, d);
  return cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------------------------ bf16 passes

using ssd_walk::YDiagLayout;

cudaError_t launch_bf16(const void* Cc, const void* Bc, const float* acum,
                        const void* dtx, const void* dy, void* ddtx, void* dsr,
                        float* row_part, float* col_part, void* dC, void* dB,
                        const ssd_ydiag::Dims& d, cudaStream_t stream) {
  namespace bwd = ssd_walk::bwd;
  using T = __nv_bfloat16;
  using Lay = YDiagLayout<T>;
  const T* C = static_cast<const T*>(Cc);
  const T* B = static_cast<const T*>(Bc);
  const Lay lay{{C, B, static_cast<const T*>(dtx), static_cast<T*>(dC),
                 static_cast<T*>(dB)}};
  const ssd_walk::Dims wd(d.BC, 1, d.l, d.H, d.P, d.N);
  const int nt = (d.l + ssd_walk::kT - 1) / ssd_walk::kT;
  const auto intra = bwd::intra_kernel<T, Lay>;
  const auto cols = ssd_ydiag::cols_kernel<T>;
  const auto flush = bwd::flush_kernel<T, Lay>;
  cudaError_t err;
#define YDIAG_BWD_LAUNCH(kernel, smem, grid, ...)                       \
  err = mma_tiles::allow_smem(kernel, smem);                            \
  if (err != cudaSuccess) return err;                                   \
  kernel<<<grid, mma_tiles::kThreads, smem, stream>>>(__VA_ARGS__);     \
  err = cudaGetLastError();                                             \
  if (err != cudaSuccess) return err;
  YDIAG_BWD_LAUNCH(intra, bwd::intra_smem<T>(), dim3(nt, nt, d.BC), lay,
                   acum, static_cast<const T*>(dy),
                   static_cast<const T*>(dtx), nullptr, static_cast<T*>(dsr),
                   row_part, col_part, wd)
  YDIAG_BWD_LAUNCH(cols, ssd_ydiag::strip_smem<T>(), ssd_ydiag::strip_grid(d),
                   B, C, acum, static_cast<const T*>(dy),
                   static_cast<T*>(ddtx), d)
  YDIAG_BWD_LAUNCH(flush, bwd::flush_smem<T>(),
                   dim3(2 * ((d.N + bwd::kFlushN - 1) / bwd::kFlushN), nt,
                        d.BC),
                   lay, B, C, nullptr, nullptr, nullptr,
                   static_cast<const T*>(dsr), wd)
#undef YDIAG_BWD_LAUNCH
  return cudaSuccess;
}

cudaError_t bf16_pass_info(int* out) {
  namespace bwd = ssd_walk::bwd;
  using T = __nv_bfloat16;
  using Lay = YDiagLayout<T>;
  cudaError_t err =
      mma_tiles::pass_info(bwd::intra_kernel<T, Lay>, bwd::intra_smem<T>(),
                           out);
  if (err == cudaSuccess)
    err = mma_tiles::pass_info(ssd_ydiag::cols_kernel<T>,
                               ssd_ydiag::strip_smem<T>(), out + 4);
  if (err == cudaSuccess)
    err = mma_tiles::pass_info(bwd::flush_kernel<T, Lay>,
                               bwd::flush_smem<T>(), out + 8);
  return err;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the first CUDA error of
// the launches (0 on success); cudaErrorInvalidValue, before any launch,
// for a shape outside the passes' tiles (l <= 256 and l % 4 == 0, P % 8 ==
// 0: 16-byte pieces; N % 32 == 0: the flush pass's warps store 32 columns;
// fp32 P <= 64) or an operand that is not 16-byte aligned.  is_bf16
// selects the type of Cc, Bc, dtx, dy, ddtx, ws, dC and dB; acum is fp32.
// ws [BC, l, l] takes the head-summed dscores (a workspace).  row_part
// [BC, H, ceil(l / 64), l] takes G's row sums per column tile (fp32:
// zeroed by the caller, each column tile writing only its causal rows),
// col_part [BC, H, ceil(l / 64), l] its column sums per row tile (fp32:
// [BC, H, 1, l], the whole sums).  The caller checks BC <= 65535.
extern "C" int ssd_ydiag_bwd(const void* Cc, const void* Bc, const void* acum,
                             const void* dtx, const void* dy, void* ddtx,
                             void* ws, void* row_part, void* col_part,
                             void* dC, void* dB, int BC, int l, int N, int H,
                             int P, int is_bf16, void* stream) {
  if (l > ssd_ydiag::kMaxL || l % 4 || N % 32 || P % 8 ||
      (!is_bf16 && P > st_tiles::kT))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {Cc, Bc, acum, dtx, dy, static_cast<const void*>(ddtx),
                        static_cast<const void*>(ws),
                        static_cast<const void*>(dC),
                        static_cast<const void*>(dB)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acum);
  float* rp = static_cast<float*>(row_part);
  float* cp = static_cast<float*>(col_part);
  if (is_bf16)
    return static_cast<int>(launch_bf16(Cc, Bc, a, dtx, dy, ddtx, ws, rp, cp,
                                        dC, dB,
                                        ssd_ydiag::make_dims(BC, l, N, H, P),
                                        s));
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const f32::Dims d{BC, l, N, H, P, (l + st_tiles::kT - 1) / st_tiles::kT};
  return static_cast<int>(f32::launch(f(Cc), f(Bc), a, f(dtx), f(dy),
                                      w(ddtx), w(ws), rp, cp, w(dC), w(dB), d,
                                      s));
}

// Registers, local (spill) bytes, dynamic shared bytes and resident warps
// per SM of the passes: bf16 (intra, cols, flush), out[12]; fp32 (grad,
// dcb), out[8].
extern "C" int ssd_ydiag_bwd_pass_info(int is_bf16, int* out) {
  if (is_bf16) return static_cast<int>(bf16_pass_info(out));
  const int nt = ssd_ydiag::kMaxL / st_tiles::kT;
  cudaError_t err =
      mma_tiles::pass_info(f32::grad_kernel, f32::GradSmem(nt).total, out);
  if (err == cudaSuccess) err = mma_tiles::pass_info(f32::dcb_kernel, 0, out + 4);
  return static_cast<int>(err);
}

extern "C" const char* ssd_ydiag_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
