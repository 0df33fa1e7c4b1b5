// Fused CMA-ES sampling for Hopper (sm_90a), slot-batched.
//
// Replaces repro/kernels/cma_gen.py::cma_gen_sample (_sample_kernel),
// cma_gen_sample_eval (_sample_call -> _make_sample_kernel(fused_eval=True)),
// and the in-kernel RNG tier: cma_gen_sample_rng and cma_gen_sample_rng_eval
// (_make_sample_kernel(rng=True)) and cma_sample_z_rng (_z_kernel).
//
//   Y[s] = (Z[s] * diag(D[s])) * B[s]^T        (lam x n, a GEMM with K = n)
//   X[s] = m[s] + sigma[s] * Y[s]               (epilogue)
//   EVAL: F[s, r] = sum_j scale[s,j] * g(X[s,r,j] - shift[s,j])^2 + fopt[s],
//         g = identity (mode 0) or t_osz (mode 1), NaN when valid[s] == 0;
//         X is never written.
//
// The slots are the groups of sample_gemm.cuh, which holds the design,
// what bounds it and its two plans: slot s owns rows [s lam, (s + 1) lam)
// of Z (S lam x n), and the wrapper cuts them into the plan's row tiles
// (kernels/sample_plan.py).
//
// RNG (rows 3-4): z_rng_kernel (row 5) first draws Z into scratch, each
// element once, from the slot's seed words (threefry.cuh); the GEMM then
// reads it as rows 1-2 do.  Drawing inside the GEMM's staging would draw
// each element once per column block: 16 times at n = 1000 in the tile
// plan, 125 times in the stream plan (the draw is about 100 integer
// operations, a log1p and a cos).  Both launches are one call.
#include <cmath>
#include <cstdint>

#include "cma_gen_common.cuh"
#include "sample_gemm.cuh"
#include "threefry.cuh"

namespace {

using cma_sample_gemm::E_EVAL;
using cma_sample_gemm::E_YX;
using cma_sample_gemm::launch_sample;
using cma_sample_gemm::sample_args;
using cma_sample_gemm::SampleArgs;

// Z[s, r, c] of the counter stream, one element per thread; the seed words
// are the low 32 bits of each int64.
template <typename T>
__global__ void z_rng_kernel(const long long* __restrict__ seeds,
                             T* __restrict__ Z, int lam, int n) {
  const int s = blockIdx.y;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(lam) * n) return;
  const uint32_t r = static_cast<uint32_t>(e / n);
  const uint32_t c = static_cast<uint32_t>(e % n);
  Z[static_cast<size_t>(s) * lam * n + e] = cma_rng::threefry_normal<T>(
      static_cast<uint32_t>(seeds[2 * s]),
      static_cast<uint32_t>(seeds[2 * s + 1]), r, c);
}

template <typename T>
int launch_z_rng(const long long* seeds, T* Z, int S, int lam, int n,
                 cudaStream_t stream) {
  const size_t total = static_cast<size_t>(lam) * n;
  const dim3 grid(static_cast<unsigned>((total + 255) / 256), S);
  z_rng_kernel<T><<<grid, 256, 0, stream>>>(seeds, Z, lam, n);
  return cma_gen::launch_status();
}

template <typename T>
int sample_yx(const T* m, const T* sigma, const T* B, const T* D, const T* Z,
              const int* tiles, T* Y, T* X, int ntiles, int rows, int n,
              int kind, int tile_rows, cudaStream_t stream) {
  SampleArgs<T> a =
      sample_args(m, sigma, B, D, Z, tiles, ntiles, rows, n, kind, tile_rows);
  a.Y = Y;
  a.X = X;
  return launch_sample<T, E_YX>(a, stream);
}

template <typename T>
int sample_eval(const T* m, const T* sigma, const T* B, const T* D,
                const T* Z, const T* scale, const T* shift, const T* fopt,
                const int* mode, const int* valid, const int* tiles, T* Y,
                T* F, T* Fpart, int ntiles, int rows, int n, int lam,
                int kind, int tile_rows, cudaStream_t stream) {
  SampleArgs<T> a =
      sample_args(m, sigma, B, D, Z, tiles, ntiles, rows, n, kind, tile_rows);
  a.scale = scale;
  a.shift = shift;
  a.fopt = fopt;
  a.mode = mode;
  a.valid = valid;
  a.Y = Y;
  a.F = F;
  a.Fpart = Fpart;
  a.lam = lam;
  return launch_sample<T, E_EVAL>(a, stream);
}

}  // namespace

// tiles is the plan's (ntiles, 3) int32 table (slot, first row, end row),
// rows = S lam; kind 0 is the tile plan, 1 the stream plan, whose
// tile_rows is the most rows of a table entry.  Fpart is scratch of
// (column blocks) x rows elements when the eval call has more than one
// column block, else null.  Zs is the RNG calls' (S, lam, n) scratch;
// seeds is (S, 2) int64 whose low 32 bits are the seed words, and the
// wrappers keep lam and n below 2^16.
#define CMA_GEN_SAMPLE_API(T, SUFFIX)                                        \
  extern "C" int cma_gen_sample_##SUFFIX(                                    \
      const T* m, const T* sigma, const T* B, const T* D, const T* Z,        \
      const int* tiles, T* Y, T* X, int ntiles, int rows, int n, int kind,   \
      int tile_rows, void* stream) {                                         \
    return sample_yx<T>(m, sigma, B, D, Z, tiles, Y, X, ntiles, rows, n,     \
                        kind, tile_rows,                                     \
                        static_cast<cudaStream_t>(stream));                  \
  }                                                                          \
  extern "C" int cma_gen_sample_eval_##SUFFIX(                               \
      const T* m, const T* sigma, const T* B, const T* D, const T* Z,        \
      const T* scale, const T* shift, const T* fopt, const int* mode,        \
      const int* valid, const int* tiles, T* Y, T* F, T* Fpart, int ntiles,  \
      int rows, int n, int lam, int kind, int tile_rows, void* stream) {     \
    return sample_eval<T>(m, sigma, B, D, Z, scale, shift, fopt, mode,       \
                          valid, tiles, Y, F, Fpart, ntiles, rows, n, lam,   \
                          kind, tile_rows,                                   \
                          static_cast<cudaStream_t>(stream));                \
  }                                                                          \
  extern "C" int cma_gen_sample_rng_##SUFFIX(                                \
      const T* m, const T* sigma, const T* B, const T* D,                    \
      const long long* seeds, T* Zs, const int* tiles, T* Y, T* X,           \
      int ntiles, int S, int lam, int n, int kind, int tile_rows,            \
      void* stream) {                                                        \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);               \
    const int err = launch_z_rng<T>(seeds, Zs, S, lam, n, st);               \
    if (err != 0) return err;                                                \
    return sample_yx<T>(m, sigma, B, D, Zs, tiles, Y, X, ntiles, S * lam, n, \
                        kind, tile_rows, st);                                \
  }                                                                          \
  extern "C" int cma_gen_sample_rng_eval_##SUFFIX(                           \
      const T* m, const T* sigma, const T* B, const T* D,                    \
      const long long* seeds, T* Zs, const T* scale, const T* shift,         \
      const T* fopt, const int* mode, const int* valid, const int* tiles,    \
      T* Y, T* F, T* Fpart, int ntiles, int S, int lam, int n, int kind,     \
      int tile_rows, void* stream) {                                         \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);               \
    const int err = launch_z_rng<T>(seeds, Zs, S, lam, n, st);               \
    if (err != 0) return err;                                                \
    return sample_eval<T>(m, sigma, B, D, Zs, scale, shift, fopt, mode,      \
                          valid, tiles, Y, F, Fpart, ntiles, S * lam, n,     \
                          lam, kind, tile_rows, st);                         \
  }                                                                          \
  extern "C" int cma_sample_z_rng_##SUFFIX(const long long* seeds, T* Z,     \
                                           int S, int lam, int n,            \
                                           void* stream) {                   \
    return launch_z_rng<T>(seeds, Z, S, lam, n,                              \
                           static_cast<cudaStream_t>(stream));               \
  }                                                                          \
  extern "C" int cma_gen_sample_constant_##SUFFIX(int which) {               \
    return cma_sample_gemm::sample_constant(which);                          \
  }

CMA_GEN_SAMPLE_API(float, f32)
CMA_GEN_SAMPLE_API(double, f64)
