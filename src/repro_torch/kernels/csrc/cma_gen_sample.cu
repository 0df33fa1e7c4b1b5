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
// RNG (rows 3-4): Z is the counter stream of the slot's seed words
// (threefry.cuh).  Where one column block spans the row (n <= TILE_COLS,
// every n = 40 path) the tile plan draws it inside the sample kernel
// (sample_gemm.cuh's draw policy): no Z scratch, and the one launch of the
// Z-operand call of the shape.  On wider rows row 5's kernel first draws Z
// into the wrapper's scratch, each element once, and the load form reads
// it: drawn inside the GEMM, every column block would draw its own copy
// (16 at n = 1000 in the tile plan, 125 in the stream plan; a draw is about
// 320 instructions issued), and a cluster of column blocks sharing one
// draw ran slower than the two launches (PERF.md).  Either way the slabs
// hold row 5's values and zeros, so Y, X and F equal the Z-operand call's
// on row 5's Z, bit for bit.
//
// Row 5 alone (cma_sample_z_rng, the parity surface of the stream), in
// two forms, neither with a 64-bit division per element:
// * wide, for large launches (at least Z_WIDE_MIN elements) where n keeps
//   every row 16-byte aligned: one block per Z_ROWS rows x 32 VEC columns
//   of a slot (VEC = 16 bytes of T), a warp a row, a thread VEC adjacent
//   columns with its seed words loaded once and one 16-byte store;
// * flat, elsewhere: a thread an element of a slot's lam x n, its row and
//   column by one 32-bit division.  A launch of few elements (12 x 1000 on
//   the bucketed path) then takes one draw's latency, not VEC draws'.
// Not bound by its 24.6 MB of stores at (1, 3072, 1000) (7.3 us on an
// H100) but by the draw: about 80 FP64 and 76 INT32 operations an element
// (about 15 us each at 64 lanes an SM), and about 320 instructions issued
// in all, 29 us at an SM's 128 a clock.
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
using cma_sample_gemm::Z_DRAW;

constexpr int Z_THREADS = 128;
constexpr int Z_ROWS = Z_THREADS / 32;         // wide form: a row a warp
// the elements of a launch from which the wide form runs: about two for
// every thread an H100 holds at once (132 SMs x 2048)
constexpr long long Z_WIDE_MIN = 1 << 19;

// Z[s, r, c] of the counter stream; the seed words are the low 32 bits of
// each int64.  Grid: (column blocks, row blocks, slots) in the wide form,
// (blocks over lam n, slots) in the flat one.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(Z_THREADS)
    z_rng_kernel(const long long* __restrict__ seeds, T* __restrict__ Z,
                 int lam, int n) {
  const int s = WIDE ? blockIdx.z : blockIdx.y;
  const uint32_t w0 = static_cast<uint32_t>(seeds[2 * s]);
  const uint32_t w1 = static_cast<uint32_t>(seeds[2 * s + 1]);
  if constexpr (WIDE) {
    constexpr int VEC = 16 / sizeof(T);
    const int c0 = (blockIdx.x * 32 + (threadIdx.x & 31)) * VEC;
    const int r = blockIdx.y * Z_ROWS + (threadIdx.x >> 5);
    if (c0 >= n || r >= lam) return;
    T v[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q)
      v[q] = cma_rng::threefry_normal<T>(w0, w1, static_cast<uint32_t>(r),
                                         static_cast<uint32_t>(c0 + q));
    T* dst = Z + (static_cast<size_t>(s) * lam + r) * n + c0;
    if constexpr (VEC == 2) {
      *reinterpret_cast<double2*>(dst) = make_double2(v[0], v[1]);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    const uint32_t e = blockIdx.x * Z_THREADS + threadIdx.x;
    const uint32_t un = static_cast<uint32_t>(n);
    if (e >= static_cast<uint32_t>(lam) * un) return;
    const uint32_t r = e / un;
    Z[static_cast<size_t>(s) * lam * n + e] =
        cma_rng::threefry_normal<T>(w0, w1, r, e - r * un);
  }
}

template <typename T>
int launch_z_rng(const long long* seeds, T* Z, int S, int lam, int n,
                 cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long elems = static_cast<long long>(S) * lam * n;
  if (elems == 0) return 0;
  if (elems >= Z_WIDE_MIN && n % VEC == 0 && cma_sample_gemm::aligned16(Z)) {
    const dim3 grid(cma_gen::cdiv(n, 32 * VEC), cma_gen::cdiv(lam, Z_ROWS),
                    S);
    z_rng_kernel<T, true><<<grid, Z_THREADS, 0, stream>>>(seeds, Z, lam, n);
  } else {
    const dim3 grid(static_cast<unsigned>((elems / S + Z_THREADS - 1) /
                                          Z_THREADS),
                    S);
    z_rng_kernel<T, false><<<grid, Z_THREADS, 0, stream>>>(seeds, Z, lam, n);
  }
  return cma_gen::launch_status();
}

// The Y, X form with Z from Z (seeds null) or drawn from seeds.
template <typename T>
int sample_yx(const T* m, const T* sigma, const T* B, const T* D, const T* Z,
              const long long* seeds, const int* tiles, T* Y, T* X,
              int ntiles, int rows, int n, int lam, int kind, int tile_rows,
              cudaStream_t stream) {
  SampleArgs<T> a =
      sample_args(m, sigma, B, D, Z, tiles, ntiles, rows, n, kind, tile_rows);
  a.Y = Y;
  a.X = X;
  if (seeds == nullptr) return launch_sample<T, E_YX>(a, stream);
  a.seeds = seeds;
  a.lam = lam;
  return launch_sample<T, E_YX, Z_DRAW>(a, stream);
}

// The Y, F form, Z as in sample_yx.
template <typename T>
int sample_eval(const T* m, const T* sigma, const T* B, const T* D,
                const T* Z, const long long* seeds, const T* scale,
                const T* shift, const T* fopt, const int* mode,
                const int* valid, const int* tiles, T* Y, T* F, T* Fpart,
                int ntiles, int rows, int n, int lam, int kind, int tile_rows,
                cudaStream_t stream) {
  SampleArgs<T> a =
      sample_args(m, sigma, B, D, Z, tiles, ntiles, rows, n, kind, tile_rows);
  a.seeds = seeds;
  a.scale = scale;
  a.shift = shift;
  a.fopt = fopt;
  a.mode = mode;
  a.valid = valid;
  a.Y = Y;
  a.F = F;
  a.Fpart = Fpart;
  a.lam = lam;
  return seeds == nullptr ? launch_sample<T, E_EVAL>(a, stream)
                          : launch_sample<T, E_EVAL, Z_DRAW>(a, stream);
}

// The Z of an RNG call (rows 3-4): drawn in the sample kernel where
// draws_z(n) (*Z null, *drawn the seeds; Zs unused), else row 5's kernel
// draws it into the scratch Zs first and the load form reads it (*Z = Zs,
// *drawn null).  Returns that launch's error.
template <typename T>
int rng_source(const long long* seeds, T* Zs, int S, int lam, int n,
               cudaStream_t stream, const T** Z, const long long** drawn) {
  if (cma_sample_gemm::draws_z(n)) {
    *Z = nullptr;
    *drawn = seeds;
    return 0;
  }
  if (Zs == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  *Z = Zs;
  *drawn = nullptr;
  return launch_z_rng<T>(seeds, Zs, S, lam, n, stream);
}

}  // namespace

// tiles is the plan's (ntiles, 3) int32 table (slot, first row, end row),
// rows = S lam; kind 0 is the tile plan, 1 the stream plan, whose
// tile_rows is the most rows of a table entry.  Fpart is scratch of
// (column blocks) x rows elements when the eval call has more than one
// column block, else null.  seeds is (S, 2) int64 whose low 32 bits are
// the seed words, and the wrappers keep lam and n below 2^16.  Zs is the
// RNG calls' (S, lam, n) scratch where n > TILE_COLS, else unused (null).
#define CMA_GEN_SAMPLE_API(T, SUFFIX)                                        \
  extern "C" int cma_gen_sample_##SUFFIX(                                    \
      const T* m, const T* sigma, const T* B, const T* D, const T* Z,        \
      const int* tiles, T* Y, T* X, int ntiles, int rows, int n, int kind,   \
      int tile_rows, void* stream) {                                         \
    return sample_yx<T>(m, sigma, B, D, Z, nullptr, tiles, Y, X, ntiles,     \
                        rows, n, 0, kind, tile_rows,                         \
                        static_cast<cudaStream_t>(stream));                  \
  }                                                                          \
  extern "C" int cma_gen_sample_eval_##SUFFIX(                               \
      const T* m, const T* sigma, const T* B, const T* D, const T* Z,        \
      const T* scale, const T* shift, const T* fopt, const int* mode,        \
      const int* valid, const int* tiles, T* Y, T* F, T* Fpart, int ntiles,  \
      int rows, int n, int lam, int kind, int tile_rows, void* stream) {     \
    return sample_eval<T>(m, sigma, B, D, Z, nullptr, scale, shift, fopt,    \
                          mode, valid, tiles, Y, F, Fpart, ntiles, rows, n,  \
                          lam, kind, tile_rows,                              \
                          static_cast<cudaStream_t>(stream));                \
  }                                                                          \
  extern "C" int cma_gen_sample_rng_##SUFFIX(                                \
      const T* m, const T* sigma, const T* B, const T* D,                    \
      const long long* seeds, T* Zs, const int* tiles, T* Y, T* X,           \
      int ntiles, int S, int lam, int n, int kind, int tile_rows,            \
      void* stream) {                                                        \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);               \
    const T* Z;                                                              \
    const long long* drawn;                                                  \
    const int err = rng_source<T>(seeds, Zs, S, lam, n, st, &Z, &drawn);     \
    if (err != 0) return err;                                                \
    return sample_yx<T>(m, sigma, B, D, Z, drawn, tiles, Y, X, ntiles,       \
                        S * lam, n, lam, kind, tile_rows, st);               \
  }                                                                          \
  extern "C" int cma_gen_sample_rng_eval_##SUFFIX(                           \
      const T* m, const T* sigma, const T* B, const T* D,                    \
      const long long* seeds, T* Zs, const T* scale, const T* shift,         \
      const T* fopt, const int* mode, const int* valid, const int* tiles,    \
      T* Y, T* F, T* Fpart, int ntiles, int S, int lam, int n, int kind,     \
      int tile_rows, void* stream) {                                         \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);               \
    const T* Z;                                                              \
    const long long* drawn;                                                  \
    const int err = rng_source<T>(seeds, Zs, S, lam, n, st, &Z, &drawn);     \
    if (err != 0) return err;                                                \
    return sample_eval<T>(m, sigma, B, D, Z, drawn, scale, shift, fopt,      \
                          mode, valid, tiles, Y, F, Fpart, ntiles, S * lam,  \
                          n, lam, kind, tile_rows, st);                      \
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
