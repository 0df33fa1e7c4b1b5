// Fused CMA-ES sampling for Hopper (sm_90a), slot-batched.
//
// Replaces repro/kernels/cma_gen.py::cma_gen_sample (_sample_kernel),
// cma_gen_sample_eval (_sample_call -> _make_sample_kernel(fused_eval=True)),
// and the in-kernel RNG tier: cma_gen_sample_rng and cma_gen_sample_rng_eval
// (_make_sample_kernel(rng=True)) and cma_sample_z_rng (_z_kernel).
//
//   Y[s] = (Z[s] * diag(D[s])) * B[s]^T        (lam x n, a GEMM with K = n)
//   X[s] = m[s] + sigma[s] * Y[s]               (epilogue, in registers)
//   EVAL: F[s, r] = sum_j scale[s,j] * g(X[s,r,j] - shift[s,j])^2 + fopt[s],
//         g = identity (mode 0) or t_osz (mode 1), NaN when valid[s] == 0;
//         X is never written.
//
// What bounds it: at the campaign path's shape (S = 1, lam = 3072, n = 1000,
// float64) the GEMM is 2*lam*n^2 = 6.1 GFLOP against about 82 MB of traffic,
// so it is bound by FP64 arithmetic.  The design is the plain register-tiled
// GEMM: a 64 x 64 output tile per block of 256 threads, 4 x 4 outputs per
// thread, a k-loop over n through shared memory in stages of 16, the D
// scaling applied as Z is staged and the X / fitness epilogue applied while
// the tile is still in registers.  It computes and accumulates in T (float
// or double); the TPU kernel's forced float32 is not carried over.  The
// fitness row sums are deterministic: each block writes one partial per row
// for its column tile, and a second small kernel adds the partials of a row
// in column-tile order.  Faster forms (FP64 tensor-core DMMA tiles, TMA
// staging) are later work.
//
// RNG: Z is not read.  The stage that scales Z by diag(D) draws each Z
// element instead, from the slot's seed words (threefry.cuh), so Z never
// exists in device memory.  Each block still needs all n columns of its 64
// rows of Z, and a block covers 64 output columns, so each Z element is
// drawn once per column tile: ceil(n / 64) times (16 at n = 1000).  That
// redundancy was chosen over a block that spans all n columns (the TPU
// kernel's shape), which at n = 1000 would need a (64 x 1000) accumulator
// or slab per block, far beyond registers and the 227 KB of shared memory.
// The draw is about 100 integer operations, one log1p and one cos per
// element; chip_smoke.py times this kernel against the Z-operand one at
// the same shape, so the cost of the redundancy is on record.  The Z-only
// kernel draws each element once and writes it.
#include <cmath>
#include <cstdint>

#include "cma_gen_common.cuh"
#include "threefry.cuh"

namespace {

constexpr int BM = 64;       // population rows per tile
constexpr int BN = 64;       // coordinates per tile
constexpr int BK = 16;       // depth of one shared-memory stage
constexpr int TX = 16;       // threads along a tile row
constexpr int TY = 16;       // threads along a tile column
constexpr int THREADS = TX * TY;

template <typename T>
__device__ __forceinline__ T t_osz(T x) {
  const T xhat = x != T(0) ? log(fabs(x)) : T(0);
  const T c1 = x > T(0) ? T(10.0) : T(5.5);
  const T c2 = x > T(0) ? T(7.9) : T(3.1);
  const T sgn = x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
  return sgn * exp(xhat + T(0.049) * (sin(c1 * xhat) + sin(c2 * xhat)));
}

template <typename T, bool EVAL, bool RNG>
__global__ void __launch_bounds__(THREADS) sample_kernel(
    const T* __restrict__ m, const T* __restrict__ sigma,
    const T* __restrict__ B, const T* __restrict__ D,
    const T* __restrict__ Z, const uint32_t* __restrict__ seeds,
    const T* __restrict__ scale,
    const T* __restrict__ shift, const int* __restrict__ mode,
    T* __restrict__ Y, T* __restrict__ X, T* __restrict__ Fpart, int lam,
    int n) {
  __shared__ T As[BK][BM + 1];   // (Z * diag D) stage, k-major
  __shared__ T Bs[BK][BN + 1];   // B stage, k-major
  const int s = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const T* Zs = RNG ? nullptr : Z + static_cast<size_t>(s) * lam * n;
  const uint32_t seed0 = RNG ? seeds[2 * s] : 0u;
  const uint32_t seed1 = RNG ? seeds[2 * s + 1] : 0u;
  const T* Bm = B + static_cast<size_t>(s) * n * n;
  const T* Dv = D + static_cast<size_t>(s) * n;

  T acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = T(0);

  for (int k0 = 0; k0 < n; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / THREADS; ++q) {
      const int e = tid + THREADS * q;
      const int row = e / BK;
      const int kk = e % BK;
      const int k = k0 + kk;
      const int r = r0 + row;
      const int j = j0 + row;
      T z = T(0);
      if (r < lam && k < n) {
        if constexpr (RNG) {
          z = cma_rng::threefry_normal<T>(seed0, seed1, r, k);
        } else {
          z = Zs[static_cast<size_t>(r) * n + k];
        }
      }
      As[kk][row] = (r < lam && k < n) ? z * Dv[k] : T(0);
      Bs[kk][row] = (j < n && k < n) ? Bm[static_cast<size_t>(j) * n + k]
                                     : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[kk][ty + TY * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[kk][tx + TX * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += av[a] * bv[b];
    }
    __syncthreads();
  }

  const T sg = sigma[s];
  const T* mv = m + static_cast<size_t>(s) * n;
  T rowsum[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + TY * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + TX * b;
      if (r < lam && j < n) {
        const T y = acc[a][b];
        const T x = mv[j] + sg * y;
        const size_t o = (static_cast<size_t>(s) * lam + r) * n + j;
        Y[o] = y;
        if constexpr (EVAL) {
          const size_t c = static_cast<size_t>(s) * n + j;
          const T t = x - shift[c];
          const T tg = mode[s] == 1 ? t_osz(t) : t;
          rowsum[a] += scale[c] * (tg * tg);   // padding columns never enter
        } else {
          X[o] = x;
        }
      }
    }
  }

  if constexpr (EVAL) {
    __shared__ T red[BM][TX + 1];
#pragma unroll
    for (int a = 0; a < 4; ++a) red[ty + TY * a][tx] = rowsum[a];
    __syncthreads();
    if (tid < BM) {
      const int r = r0 + tid;
      T sum = T(0);
      for (int c = 0; c < TX; ++c) sum += red[tid][c];
      if (r < lam) {
        Fpart[(static_cast<size_t>(s) * gridDim.x + blockIdx.x) * lam + r] =
            sum;
      }
    }
  }
}

// F[s, r] = sum of the column-tile partials of row r, in tile order.
template <typename T>
__global__ void eval_reduce_kernel(const T* __restrict__ Fpart,
                                   const T* __restrict__ fopt,
                                   const int* __restrict__ valid,
                                   T* __restrict__ F, int lam, int ntiles) {
  const int s = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= lam) return;
  T sum = T(0);
  for (int t = 0; t < ntiles; ++t)
    sum += Fpart[(static_cast<size_t>(s) * ntiles + t) * lam + r];
  F[static_cast<size_t>(s) * lam + r] =
      valid[s] ? sum + fopt[s] : static_cast<T>(NAN);
}

// Z[s, r, c] of the counter stream, one element per thread.
template <typename T>
__global__ void z_rng_kernel(const uint32_t* __restrict__ seeds,
                             T* __restrict__ Z, int lam, int n) {
  const int s = blockIdx.y;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(lam) * n) return;
  const uint32_t r = static_cast<uint32_t>(e / n);
  const uint32_t c = static_cast<uint32_t>(e % n);
  Z[static_cast<size_t>(s) * lam * n + e] =
      cma_rng::threefry_normal<T>(seeds[2 * s], seeds[2 * s + 1], r, c);
}

// Z is null when RNG, seeds null otherwise.
template <typename T, bool RNG>
int launch_sample(const T* m, const T* sigma, const T* B, const T* D,
                  const T* Z, const uint32_t* seeds, T* Y, T* X, int S,
                  int lam, int n, cudaStream_t stream) {
  const dim3 grid(cma_gen::cdiv(n, BN), cma_gen::cdiv(lam, BM), S);
  sample_kernel<T, false, RNG><<<grid, THREADS, 0, stream>>>(
      m, sigma, B, D, Z, seeds, nullptr, nullptr, nullptr, Y, X, nullptr,
      lam, n);
  return cma_gen::launch_status();
}

template <typename T, bool RNG>
int launch_sample_eval(const T* m, const T* sigma, const T* B, const T* D,
                       const T* Z, const uint32_t* seeds, const T* scale,
                       const T* shift, const T* fopt, const int* mode,
                       const int* valid, T* Y, T* F, T* Fpart, int S,
                       int lam, int n, cudaStream_t stream) {
  const dim3 grid(cma_gen::cdiv(n, BN), cma_gen::cdiv(lam, BM), S);
  sample_kernel<T, true, RNG><<<grid, THREADS, 0, stream>>>(
      m, sigma, B, D, Z, seeds, scale, shift, mode, Y, nullptr, Fpart, lam,
      n);
  int err = cma_gen::launch_status();
  if (err != 0) return err;
  const dim3 rgrid(cma_gen::cdiv(lam, 256), S);
  eval_reduce_kernel<T><<<rgrid, 256, 0, stream>>>(Fpart, fopt, valid, F,
                                                   lam, grid.x);
  return cma_gen::launch_status();
}

template <typename T>
int launch_z_rng(const uint32_t* seeds, T* Z, int S, int lam, int n,
                 cudaStream_t stream) {
  const size_t total = static_cast<size_t>(lam) * n;
  const dim3 grid(static_cast<unsigned>((total + 255) / 256), S);
  z_rng_kernel<T><<<grid, 256, 0, stream>>>(seeds, Z, lam, n);
  return cma_gen::launch_status();
}

}  // namespace

// Fpart is scratch of cdiv(n, 64) * S * lam elements.  seeds is (S, 2)
// uint32 words; the wrappers keep lam and n below 2^16.
#define CMA_GEN_SAMPLE_API(T, SUFFIX)                                        \
  extern "C" int cma_gen_sample_##SUFFIX(                                    \
      const T* m, const T* sigma, const T* B, const T* D, const T* Z, T* Y,  \
      T* X, int S, int lam, int n, void* stream) {                           \
    return launch_sample<T, false>(m, sigma, B, D, Z, nullptr, Y, X, S, lam, \
                                   n, static_cast<cudaStream_t>(stream));    \
  }                                                                          \
  extern "C" int cma_gen_sample_eval_##SUFFIX(                               \
      const T* m, const T* sigma, const T* B, const T* D, const T* Z,        \
      const T* scale, const T* shift, const T* fopt, const int* mode,        \
      const int* valid, T* Y, T* F, T* Fpart, int S, int lam, int n,         \
      void* stream) {                                                        \
    return launch_sample_eval<T, false>(                                     \
        m, sigma, B, D, Z, nullptr, scale, shift, fopt, mode, valid, Y, F,   \
        Fpart, S, lam, n, static_cast<cudaStream_t>(stream));                \
  }                                                                          \
  extern "C" int cma_gen_sample_rng_##SUFFIX(                                \
      const T* m, const T* sigma, const T* B, const T* D,                    \
      const uint32_t* seeds, T* Y, T* X, int S, int lam, int n,              \
      void* stream) {                                                        \
    return launch_sample<T, true>(m, sigma, B, D, nullptr, seeds, Y, X, S,   \
                                  lam, n,                                    \
                                  static_cast<cudaStream_t>(stream));        \
  }                                                                          \
  extern "C" int cma_gen_sample_rng_eval_##SUFFIX(                           \
      const T* m, const T* sigma, const T* B, const T* D,                    \
      const uint32_t* seeds, const T* scale, const T* shift, const T* fopt,  \
      const int* mode, const int* valid, T* Y, T* F, T* Fpart, int S,        \
      int lam, int n, void* stream) {                                        \
    return launch_sample_eval<T, true>(                                      \
        m, sigma, B, D, nullptr, seeds, scale, shift, fopt, mode, valid, Y,  \
        F, Fpart, S, lam, n, static_cast<cudaStream_t>(stream));             \
  }                                                                          \
  extern "C" int cma_sample_z_rng_##SUFFIX(const uint32_t* seeds, T* Z,      \
                                           int S, int lam, int n,            \
                                           void* stream) {                   \
    return launch_z_rng<T>(seeds, Z, S, lam, n,                              \
                           static_cast<cudaStream_t>(stream));               \
  }                                                                          \
  extern "C" int cma_gen_sample_tile_cols_##SUFFIX() { return BN; }

CMA_GEN_SAMPLE_API(float, f32)
CMA_GEN_SAMPLE_API(double, f64)
