// Fused CMA-ES sampling for Hopper (sm_90a), slot-batched.
//
// Replaces repro/kernels/cma_gen.py::cma_gen_sample (_sample_kernel) and
// cma_gen_sample_eval (_sample_call -> _make_sample_kernel(fused_eval=True)).
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
#include <cmath>

#include "cma_gen_common.cuh"

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

template <typename T, bool EVAL>
__global__ void __launch_bounds__(THREADS) sample_kernel(
    const T* __restrict__ m, const T* __restrict__ sigma,
    const T* __restrict__ B, const T* __restrict__ D,
    const T* __restrict__ Z, const T* __restrict__ scale,
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
  const T* Zs = Z + static_cast<size_t>(s) * lam * n;
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
      As[kk][row] = (r < lam && k < n)
                        ? Zs[static_cast<size_t>(r) * n + k] * Dv[k]
                        : T(0);
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

template <typename T>
int launch_sample(const T* m, const T* sigma, const T* B, const T* D,
                  const T* Z, T* Y, T* X, int S, int lam, int n,
                  cudaStream_t stream) {
  const dim3 grid(cma_gen::cdiv(n, BN), cma_gen::cdiv(lam, BM), S);
  sample_kernel<T, false><<<grid, THREADS, 0, stream>>>(
      m, sigma, B, D, Z, nullptr, nullptr, nullptr, Y, X, nullptr, lam, n);
  return cma_gen::launch_status();
}

template <typename T>
int launch_sample_eval(const T* m, const T* sigma, const T* B, const T* D,
                       const T* Z, const T* scale, const T* shift,
                       const T* fopt, const int* mode, const int* valid,
                       T* Y, T* F, T* Fpart, int S, int lam, int n,
                       cudaStream_t stream) {
  const dim3 grid(cma_gen::cdiv(n, BN), cma_gen::cdiv(lam, BM), S);
  sample_kernel<T, true><<<grid, THREADS, 0, stream>>>(
      m, sigma, B, D, Z, scale, shift, mode, Y, nullptr, Fpart, lam, n);
  int err = cma_gen::launch_status();
  if (err != 0) return err;
  const dim3 rgrid(cma_gen::cdiv(lam, 256), S);
  eval_reduce_kernel<T><<<rgrid, 256, 0, stream>>>(Fpart, fopt, valid, F,
                                                   lam, grid.x);
  return cma_gen::launch_status();
}

}  // namespace

// Fpart is scratch of cdiv(n, 64) * S * lam elements.
#define CMA_GEN_SAMPLE_API(T, SUFFIX)                                        \
  extern "C" int cma_gen_sample_##SUFFIX(                                    \
      const T* m, const T* sigma, const T* B, const T* D, const T* Z, T* Y,  \
      T* X, int S, int lam, int n, void* stream) {                           \
    return launch_sample<T>(m, sigma, B, D, Z, Y, X, S, lam, n,              \
                            static_cast<cudaStream_t>(stream));              \
  }                                                                          \
  extern "C" int cma_gen_sample_eval_##SUFFIX(                               \
      const T* m, const T* sigma, const T* B, const T* D, const T* Z,        \
      const T* scale, const T* shift, const T* fopt, const int* mode,        \
      const int* valid, T* Y, T* F, T* Fpart, int S, int lam, int n,         \
      void* stream) {                                                        \
    return launch_sample_eval<T>(m, sigma, B, D, Z, scale, shift, fopt,      \
                                 mode, valid, Y, F, Fpart, S, lam, n,        \
                                 static_cast<cudaStream_t>(stream));         \
  }                                                                          \
  extern "C" int cma_gen_sample_tile_cols_##SUFFIX() { return BN; }

CMA_GEN_SAMPLE_API(float, f32)
CMA_GEN_SAMPLE_API(double, f64)
