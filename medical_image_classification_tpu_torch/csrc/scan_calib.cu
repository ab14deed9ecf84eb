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
// y = 0).  y is in u's type; the sum over n is fp32, in order of n.
//   fp32 compute: y = (dt u) sum_n 2^(dt A'_n) (B_n C_n), with A' = A log2 e
//     and B C formed once a (t, n): one FMUL, one ex2.approx and one FFMA
//     an exp (`scan_calib_factored_ref` is the plain twin of this order).
//   bf16 compute (CALIB_BF16): `kern`'s rounding points, each kept: the
//     operands, softplus, dt A, the exp, dt u, (dt u) B, a (...) and
//     C (...) rounded to bf16, the last cast to fp32 for the sum.  A
//     product of two bf16 values is exact in fp32, so a packed bf16x2
//     multiply rounds it once, bit for bit as rb(x * y) does; the exp is
//     ex2.approx of rb(dt A) log2 e rounded to bf16, which may land one bf16
//     step from rb(expf(.)) next to a rounding point.
//
// Layout: u, delta [G, L, Dm], y [G, Lp, Dm] and B, C [G, L, N] in one type
// (fp32 or bf16); At [K, N, Dm] fp32 (A transposed, as `run` takes it).
//
// What bounds it on this card: the MUFU.  At the bench's stage 0 (G 128, L
// 3136, Dm 96, N 16, bf16, T 224: no pad) it takes one exp per (g, t, d,
// n), 617 M of them, 0.147 ms at 16 a clock an SM over 132 SMs at 1.98 GHz,
// and moves 257 MB, 0.077 ms at 3.35 TB/s.
//
// Design: a block covers one sequence g (so k is fixed), a tile of up to
// 128 channel pairs and a tile of rows; each thread owns two neighbouring
// channels, so u, delta and y move as bf16x2 (float2), neighbouring threads
// on neighbouring pairs, and a thread walks the tile's rows R apart with u
// and delta loaded kAhead rows ahead.  The grid is flat: each block finds
// its (g, row tile, channel tile) with three 32-bit divisions, and no
// element pays one.  A's first 16 states sit in registers for the whole
// block (pre-scaled by log2 e in fp32 compute, rounded to bf16 in bf16
// compute); the tile's B and C rows are staged once in shared memory (B C
// in fp32 compute, each as a bf16x2 pair in bf16 compute; states past N
// zero-filled up to 16, where they add exact zeros) and read back four
// states a 16-byte broadcast load, all four groups unguarded so a row's
// code is one block the compiler schedules whole (at N < 16 the padded
// states cost their exps).  States from 16 on (N > 16) read A, B and
// C from device memory (L1) in the same arithmetic, so any N >= 1 is
// taken; odd Dm, or a tensor not aligned to a pair, takes the pairs as two
// scalars.  Softplus runs once a (t, d) on one ex2 and FMAs, branch-free,
// for the same reason.  No atomics: a second launch is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kRegN = 16;        // states whose A columns sit in registers
constexpr int kMaxPairs = 128;   // channel pairs a block, at most
constexpr int kMaxThreads = 256;
constexpr int kMaxRows = 256;    // rows a tile, at most
constexpr int kMaxSteps = 16;    // rows a thread walks in a tile, at most
constexpr int kAhead = 2;        // rows whose u and delta a thread has in flight
// fewer rows a tile (down to 4 steps) while the grid has fewer blocks than
// this: 16 an SM
constexpr long long kFillBlocks = 16 * 132;
constexpr float kLog2e = 1.4426950408889634f;

struct Geometry {
  int pairs;    // channel pairs of Dm: ceil(Dm / 2)
  int P;        // channel pairs a block
  int R;        // rows a step: threads R P, rounded up to a warp
  int S;        // steps a tile: a tile covers R S rows
  int ntc;      // channel tiles
  int nrt;      // row tiles a sequence
  int threads;
  long long blocks;
};

// The block shape for Dm, and the rows a tile for G and Lp: at most 128
// pairs a block, split evenly; R rows a step with 128 <= R P <= 256 and the
// fewest idle lanes in the last warp; 16 steps a tile (at most 256 rows),
// halved down to 4 while the grid has under kFillBlocks blocks.
Geometry geometry(int G, int Lp, int Dm) {
  Geometry s;
  s.pairs = (Dm + 1) / 2;
  s.ntc = (s.pairs + kMaxPairs - 1) / kMaxPairs;
  s.P = (s.pairs + s.ntc - 1) / s.ntc;
  s.R = 1;
  int waste = 1 << 30;
  for (int r = 1; r * s.P <= kMaxThreads; ++r) {
    const int n = r * s.P;
    if (n < 128 && (r + 1) * s.P <= kMaxThreads) continue;
    const int w = (n + 31) / 32 * 32 - n;
    if (w < waste) {
      waste = w;
      s.R = r;
    }
  }
  s.threads = (s.R * s.P + 31) / 32 * 32;
  s.S = kMaxSteps < kMaxRows / s.R ? kMaxSteps : kMaxRows / s.R;
  for (;;) {
    const int rows = s.R * s.S;
    s.nrt = (Lp + rows - 1) / rows;
    s.blocks = static_cast<long long>(G) * s.nrt * s.ntc;
    if (s.blocks >= kFillBlocks || s.S <= 4) break;
    s.S /= 2;
  }
  return s;
}

// 16-byte words a staged row: 16 B C values (fp32 compute) or 16 bf16x2
// pairs of B and 16 of C (bf16 compute), and one word of padding, so rows
// one apart fall on other banks
template <bool kBf16>
__host__ __device__ constexpr int row_words() {
  return kBf16 ? 9 : 5;
}

template <bool kBf16>
size_t smem_bytes(const Geometry& s) {
  return static_cast<size_t>(s.R) * s.S * row_words<kBf16>() * 16;
}

template <typename T>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
};
template <>
struct PairOf<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float2 to_f32x2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f32x2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
// rounded to bf16, nearest even (a no-op on bf16 values)
__device__ __forceinline__ __nv_bfloat162 to_bf16x2(float2 v) {
  return __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ __nv_bfloat162 to_bf16x2(__nv_bfloat162 v) {
  return v;
}

// channels d and d + 1 of a row (the second 0 where d + 1 is no channel):
// one vector load where the pair is aligned, else two scalar loads
template <typename T>
__device__ __forceinline__ typename PairOf<T>::type load_pair(
    const T* __restrict__ p, bool two, bool vec) {
  using V = typename PairOf<T>::type;
  if (vec) return *reinterpret_cast<const V*>(p);
  V v;
  v.x = p[0];
  v.y = two ? p[1] : T(0.f);
  return v;
}

__device__ __forceinline__ void store_pair(float* __restrict__ p, float2 v,
                                           bool two, bool vec) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = v;
  } else {
    p[0] = v.x;
    if (two) p[1] = v.y;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* __restrict__ p,
                                           float2 v, bool two, bool vec) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
  if (vec) {
    *reinterpret_cast<__nv_bfloat162*>(p) = b;
  } else {
    p[0] = b.x;
    if (two) p[1] = b.y;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16x2 product rounded once (mul.bf16x2: the exact product, rounded to
// nearest even), rb(x * y) on each half; nothing here adds in bf16, so no
// add can be fused into it
__device__ __forceinline__ __nv_bfloat162 mul2(__nv_bfloat162 a,
                                               __nv_bfloat162 b) {
  return __hmul2(a, b);
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(float w) {
  return *reinterpret_cast<__nv_bfloat162*>(&w);
}
__device__ __forceinline__ float as_word(__nv_bfloat162 v) {
  return *reinterpret_cast<float*>(&v);
}

// softplus(v) = max(v, 0) + log1p(e), e = exp(-|v|) in (0, 1], without the
// library's special-case branches, which would split the row's code: e is
// ex2.approx of -|v| log2 e with the product's rounding error carried, and
// log1p(e) = e q(e), q a degree-9 fit of log1p(e) / e on [0, 1] (q(0) = 1,
// so log1p(e) = e where e is tiny).  Within ~4 ulp of softplus in fp32;
// -|v| is held at -128 or above (exp(-128) is 0 in fp32), so v = +-inf
// gives inf and 0, and NaN stays NaN.
__device__ __forceinline__ float softplus_f32(float v) {
  constexpr float kLog2eLo = 1.925963033500011e-08f;   // log2 e - kLog2e
  float m = -fabsf(v);
  m = m < -128.f ? -128.f : m;
  const float hi = m * kLog2e;
  const float lo = fmaf(m, kLog2eLo, fmaf(m, kLog2e, -hi));
  const float p = ex2(hi);
  const float e = fmaf(p, lo * 0.6931471805599453f, p);
  float q = -0.002764213364571333f;
  q = fmaf(q, e, 0.01762656681239605f);
  q = fmaf(q, e, -0.052633415907621384f);
  q = fmaf(q, e, 0.1014614850282669f);
  q = fmaf(q, e, -0.15020227432250977f);
  q = fmaf(q, e, 0.1956954002380371f);
  q = fmaf(q, e, -0.24931226670742035f);
  q = fmaf(q, e, 0.333273708820343f);
  q = fmaf(q, e, -0.4999977648258209f);
  q = fmaf(q, e, 1.f);
  return fmaf(e, q, fmaxf(v, 0.f));
}

// What a thread keeps for the block: its channels' A for n < 16, as fp32
// pairs pre-scaled by log2 e (fp32 compute) or as rounded bf16 pairs (bf16
// compute); 0 where n >= N or a channel is missing.
template <bool kBf16>
struct ACols;
template <>
struct ACols<false> {
  float2 a[kRegN];
};
template <>
struct ACols<true> {
  __nv_bfloat162 a[kRegN];
};

// One state's term on a thread's two channels, fp32 compute.
__device__ __forceinline__ void term_f32(float2 dt, float2 a, float bc,
                                         float2& acc) {
  acc.x = fmaf(ex2(dt.x * a.x), bc, acc.x);
  acc.y = fmaf(ex2(dt.y * a.y), bc, acc.y);
}

// One state's term on a thread's two channels, bf16 compute: `kern`'s
// rb(C rb(rb(exp(rb(dt A))) rb(rb(dt u) B))) on each half, into fp32.
__device__ __forceinline__ void term_bf16(__nv_bfloat162 dt,
                                          __nv_bfloat162 dtu,
                                          __nv_bfloat162 a,
                                          __nv_bfloat162 b,
                                          __nv_bfloat162 c, float2& acc) {
  const float2 x = __bfloat1622float2(mul2(dt, a));
  const __nv_bfloat162 e =
      __floats2bfloat162_rn(ex2(x.x * kLog2e), ex2(x.y * kLog2e));
  const float2 t = __bfloat1622float2(mul2(c, mul2(e, mul2(dtu, b))));
  acc.x += t.x;
  acc.y += t.y;
}

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kMaxThreads)
    calib_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                 const float* __restrict__ At, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, T* __restrict__ y, int L, int Lp,
                 int Dm, int K, int N, Geometry s, bool vec) {
  extern __shared__ float4 stage[];
  constexpr int kWords = row_words<kBf16>();
  const int ct = blockIdx.x % s.ntc;
  const int rest = blockIdx.x / s.ntc;
  const int rt = rest % s.nrt;
  const int g = rest / s.nrt;
  const int k = g % K;
  const int rows = s.R * s.S;
  const int t0 = rt * rows;
  const int tid = threadIdx.x;

  // the tile's B and C rows, states 0..15 (0 past N and past L)
#pragma unroll 4
  for (int i = tid; i < rows * kRegN; i += blockDim.x) {
    const int r = i / kRegN, n = i % kRegN, t = t0 + r;
    float b = 0.f, c = 0.f;
    if (t < L && n < N) {
      const size_t at = (static_cast<size_t>(g) * L + t) * N + n;
      b = to_f32(Bm[at]);
      c = to_f32(Cm[at]);
    }
    float* w = reinterpret_cast<float*>(stage + r * kWords);
    if (kBf16) {
      w[n] = as_word(__bfloat162bfloat162(__float2bfloat16(b)));
      w[kRegN + n] = as_word(__bfloat162bfloat162(__float2bfloat16(c)));
    } else {
      w[n] = b * c;
    }
  }

  const int rl = tid / s.P;
  const int pair = ct * s.P + tid % s.P;
  const bool active = rl < s.R && pair < s.pairs;
  const int d = 2 * pair;
  const bool two = d + 1 < Dm;
  ACols<kBf16> A;
  const float* a_col = At + static_cast<size_t>(k) * N * Dm + d;
#pragma unroll
  for (int n = 0; n < kRegN; ++n) {
    float a0 = 0.f, a1 = 0.f;
    if (active && n < N) {
      a0 = a_col[static_cast<size_t>(n) * Dm];
      if (two) a1 = a_col[static_cast<size_t>(n) * Dm + 1];
    }
    if constexpr (kBf16) {
      A.a[n] = __floats2bfloat162_rn(a0, a1);
    } else {
      A.a[n] = make_float2(a0 * kLog2e, a1 * kLog2e);
    }
  }
  __syncthreads();
  if (!active) return;

  using V = typename PairOf<T>::type;
  // offsets of the thread's first row in u and delta, and in y; a step
  // moves both R rows on
  const size_t step_size = static_cast<size_t>(s.R) * Dm;
  const size_t in0 = (static_cast<size_t>(g) * L + t0 + rl) * Dm + d;
  size_t out_at = (static_cast<size_t>(g) * Lp + t0 + rl) * Dm + d;
  // u and delta of this step's row and the next kAhead - 1 rows' in flight
  V u_in[kAhead], d_in[kAhead];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    u_in[j].x = u_in[j].y = d_in[j].x = d_in[j].y = T(0.f);
    if (j < s.S && t0 + rl + j * s.R < L) {
      u_in[j] = load_pair(u + in0 + j * step_size, two, vec);
      d_in[j] = load_pair(delta + in0 + j * step_size, two, vec);
    }
  }
  size_t in_at = in0 + kAhead * step_size;
  int t = t0 + rl;
  for (int step = 0; step < s.S && t < Lp;
       ++step, t += s.R, in_at += step_size, out_at += step_size) {
    const V uc = u_in[0], dc = d_in[0];
#pragma unroll
    for (int j = 0; j + 1 < kAhead; ++j) {
      u_in[j] = u_in[j + 1];
      d_in[j] = d_in[j + 1];
    }
    if (step + kAhead < s.S && t + kAhead * s.R < L) {
      u_in[kAhead - 1] = load_pair(u + in_at, two, vec);
      d_in[kAhead - 1] = load_pair(delta + in_at, two, vec);
    }
    float2 out = make_float2(0.f, 0.f);
    if (t < L) {   // pad rows: u = 0, so every term is 0
      const float4* w = stage + (t - t0) * kWords;
      const size_t row = static_cast<size_t>(g) * L + t;
      float2 acc = make_float2(0.f, 0.f);
      if constexpr (kBf16) {
        const __nv_bfloat162 u2 = to_bf16x2(uc);
        const float2 dv = __bfloat1622float2(to_bf16x2(dc));
        const __nv_bfloat162 dt = __floats2bfloat162_rn(softplus_f32(dv.x),
                                                        softplus_f32(dv.y));
        const __nv_bfloat162 dtu = mul2(dt, u2);
#pragma unroll
        for (int q = 0; q < kRegN / 4; ++q) {
          const float4 b = w[q], c = w[kRegN / 4 + q];
          term_bf16(dt, dtu, A.a[4 * q], as_bf16x2(b.x), as_bf16x2(c.x),
                    acc);
          term_bf16(dt, dtu, A.a[4 * q + 1], as_bf16x2(b.y),
                    as_bf16x2(c.y), acc);
          term_bf16(dt, dtu, A.a[4 * q + 2], as_bf16x2(b.z),
                    as_bf16x2(c.z), acc);
          term_bf16(dt, dtu, A.a[4 * q + 3], as_bf16x2(b.w),
                    as_bf16x2(c.w), acc);
        }
        for (int n = kRegN; n < N; ++n) {
          const float* an = a_col + static_cast<size_t>(n) * Dm;
          const __nv_bfloat162 a =
              __floats2bfloat162_rn(an[0], two ? an[1] : 0.f);
          const size_t at = row * N + n;
          term_bf16(dt, dtu, a,
                    __bfloat162bfloat162(__float2bfloat16(to_f32(Bm[at]))),
                    __bfloat162bfloat162(__float2bfloat16(to_f32(Cm[at]))),
                    acc);
        }
        out = acc;
      } else {
        const float2 uf = to_f32x2(uc), dv = to_f32x2(dc);
        const float2 dt = make_float2(softplus_f32(dv.x), softplus_f32(dv.y));
#pragma unroll
        for (int q = 0; q < kRegN / 4; ++q) {
          const float4 bc = w[q];
          term_f32(dt, A.a[4 * q], bc.x, acc);
          term_f32(dt, A.a[4 * q + 1], bc.y, acc);
          term_f32(dt, A.a[4 * q + 2], bc.z, acc);
          term_f32(dt, A.a[4 * q + 3], bc.w, acc);
        }
        for (int n = kRegN; n < N; ++n) {
          const float* an = a_col + static_cast<size_t>(n) * Dm;
          const float2 a =
              make_float2(an[0] * kLog2e, two ? an[1] * kLog2e : 0.f);
          const size_t at = row * N + n;
          term_f32(dt, a, to_f32(Bm[at]) * to_f32(Cm[at]), acc);
        }
        out = make_float2(dt.x * uf.x * acc.x, dt.y * uf.y * acc.y);
      }
    }
    store_pair(y + out_at, out, two, vec);
  }
}

template <typename T, bool kBf16>
cudaError_t launch_with(const void* u, const void* delta, const void* At,
                        const void* B, const void* C, void* y, int G, int L,
                        int Lp, int Dm, int K, int N, cudaStream_t stream) {
  const Geometry s = geometry(G, Lp, Dm);
  if (s.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // pairs move as one vector where Dm is even and every pair is aligned
  const uintptr_t align = 2 * sizeof(T);
  const bool vec = Dm % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(u) % align == 0 &&
                   reinterpret_cast<uintptr_t>(delta) % align == 0 &&
                   reinterpret_cast<uintptr_t>(y) % align == 0;
  calib_kernel<T, kBf16>
      <<<static_cast<unsigned>(s.blocks), s.threads, smem_bytes<kBf16>(s),
         stream>>>(static_cast<const T*>(u), static_cast<const T*>(delta),
                   static_cast<const float*>(At), static_cast<const T*>(B),
                   static_cast<const T*>(C), static_cast<T*>(y), L, Lp, Dm,
                   K, N, s, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* u, const void* delta, const void* At,
                   const void* B, const void* C, void* y, int G, int L,
                   int Lp, int Dm, int K, int N, bool bf16,
                   cudaStream_t stream) {
  if (G < 1 || L < 1 || Lp < L || Dm < 1 || K < 1 || N < 1) {
    return cudaErrorInvalidValue;
  }
  return bf16 ? launch_with<T, true>(u, delta, At, B, C, y, G, L, Lp, Dm, K,
                                     N, stream)
              : launch_with<T, false>(u, delta, At, B, C, y, G, L, Lp, Dm, K,
                                      N, stream);
}

template <typename T, bool kBf16>
cudaError_t info(int G, int Lp, int Dm, int* out) {
  const Geometry s = geometry(G, Lp, Dm);
  const auto kernel = calib_kernel<T, kBf16>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<kBf16>(s);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      s.threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[3] = blocks * s.threads / 32;
  out[4] = s.threads;
  out[5] = s.R * s.S;
  out[6] = static_cast<int>(s.blocks);
  return cudaSuccess;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success).  is_bf16 selects the type of u, delta, B, C
// and y; bf16_compute the rounding of the arithmetic.  Refuses
// (cudaErrorInvalidValue) G, L, Dm, K or N below 1 and Lp below L.
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

// What the card grants the one pass at (G, Lp, Dm): out[0..6] = registers
// a thread, local (spill) bytes a thread, shared bytes a block, resident
// warps an SM, threads a block, rows a tile, blocks.
extern "C" int scan_calib_pass_info(int G, int Lp, int Dm, int is_bf16,
                                    int bf16_compute, int* out) {
  if (G < 1 || Lp < 1 || Dm < 1) return cudaErrorInvalidValue;
  if (is_bf16) {
    return static_cast<int>(bf16_compute
                                ? info<__nv_bfloat16, true>(G, Lp, Dm, out)
                                : info<__nv_bfloat16, false>(G, Lp, Dm, out));
  }
  return static_cast<int>(bf16_compute ? info<float, true>(G, Lp, Dm, out)
                                       : info<float, false>(G, Lp, Dm, out));
}

extern "C" const char* scan_calib_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
