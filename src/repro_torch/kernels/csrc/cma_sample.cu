// Grouped CMA-ES sampling for Hopper (sm_90a).
//
// Replaces repro/kernels/cma_sample.py::cma_sample (_kernel), which the JAX
// package calls once per virtual device inside a vmap, each device with its
// own copy of its descent's state.  Here the rows of all devices form one
// population Z (R x n), cut into contiguous row ranges, one per group (a
// descent of the strategies): rows [starts[g], starts[g+1]) use group g's
// state.
//
//   X[r] = m[g] + sigma[g] * (Z[r] * diag(D[g])) * B[g]^T   (AFFINE)
//   Y[r] =                   (Z[r] * diag(D[g])) * B[g]^T   (m, sigma null:
//                                  the sample_transform form the strategies
//                                  path calls, with m = 0 and sigma = 1)
//
// Layout: the wrapper cuts every group's range into row tiles of at most 64
// rows that never cross a group boundary, and hands the kernel the table
// (group, first row, end row) of each tile.  A block computes one 64 x 64
// output tile, so it reads the state of exactly one descent; B, D, m and
// sigma are read per descent, never copied per device (at n = 1000 in
// float64 one B is 8 MB; a copy for each of 512 devices would be 4 GB).
// Ragged n and row ranges (lam = 12 rows a device, n = 1000 = 15 * 64 + 40)
// are masked in the kernel: nothing is padded on the host.
//
// What bounds it: at the strategies path's full width (R = 512 * 12 = 6144
// rows, n = 1000, nine descents, float64) the GEMM is 2 R n^2 = 12.3 GFLOP
// against about 170 MB of traffic (Z and X once, nine B), so it is bound by
// FP64 arithmetic.  The design is the plain register-tiled GEMM of
// cma_gen_sample.cu: 256 threads, 4 x 4 outputs a thread, a k-loop over n
// through shared memory in stages of 16, the D scaling applied as Z is
// staged and the affine epilogue applied in registers.  It computes and
// accumulates in T (float or double); the TPU kernel's forced float32 is
// not carried over.  Each output row depends only on its own Z row and its
// group's state, so the result equals the per-device plain version row for
// row.  Faster forms (FP64 tensor-core DMMA tiles, TMA staging) are later
// work.
#include "cma_gen_common.cuh"

namespace {

constexpr int BM = 64;       // population rows per tile
constexpr int BN = 64;       // coordinates per tile
constexpr int BK = 16;       // depth of one shared-memory stage
constexpr int TX = 16;       // threads along a tile row
constexpr int TY = 16;       // threads along a tile column
constexpr int THREADS = TX * TY;

template <typename T, bool AFFINE>
__global__ void __launch_bounds__(THREADS) grouped_sample_kernel(
    const T* __restrict__ m, const T* __restrict__ sigma,
    const T* __restrict__ B, const T* __restrict__ D,
    const T* __restrict__ Z, const int* __restrict__ tiles,
    T* __restrict__ X, int n) {
  __shared__ T As[BK][BM + 1];   // (Z * diag D) stage, k-major
  __shared__ T Bs[BK][BN + 1];   // B stage, k-major
  const int g = tiles[3 * blockIdx.y];
  const int r0 = tiles[3 * blockIdx.y + 1];
  const int r1 = tiles[3 * blockIdx.y + 2];
  const int j0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const T* Bm = B + static_cast<size_t>(g) * n * n;
  const T* Dv = D + static_cast<size_t>(g) * n;

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
      As[kk][row] = (r < r1 && k < n)
                        ? Z[static_cast<size_t>(r) * n + k] * Dv[k]
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

  const T sg = AFFINE ? sigma[g] : T(1);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + TY * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + TX * b;
      if (r < r1 && j < n) {
        const T y = acc[a][b];
        X[static_cast<size_t>(r) * n + j] =
            AFFINE ? m[static_cast<size_t>(g) * n + j] + sg * y : y;
      }
    }
  }
}

template <typename T>
int launch_grouped_sample(const T* m, const T* sigma, const T* B, const T* D,
                          const T* Z, const int* tiles, T* X, int ntiles,
                          int n, cudaStream_t stream) {
  if (ntiles == 0) return 0;
  const dim3 grid(cma_gen::cdiv(n, BN), ntiles);
  if (m != nullptr) {
    grouped_sample_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        m, sigma, B, D, Z, tiles, X, n);
  } else {
    grouped_sample_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        m, sigma, B, D, Z, tiles, X, n);
  }
  return cma_gen::launch_status();
}

}  // namespace

// tiles is (ntiles, 3) int32: group, first row, end row of each row tile,
// at most cma_sample_tile_rows() rows and within one group.  m and sigma
// are both null (X = (Z * diag D) B^T) or both set.
#define CMA_SAMPLE_API(T, SUFFIX)                                            \
  extern "C" int cma_sample_##SUFFIX(const T* m, const T* sigma, const T* B, \
                                     const T* D, const T* Z,                 \
                                     const int* tiles, T* X, int ntiles,     \
                                     int n, void* stream) {                  \
    return launch_grouped_sample<T>(m, sigma, B, D, Z, tiles, X, ntiles, n,  \
                                    static_cast<cudaStream_t>(stream));      \
  }                                                                          \
  extern "C" int cma_sample_tile_rows_##SUFFIX() { return BM; }

CMA_SAMPLE_API(float, f32)
CMA_SAMPLE_API(double, f64)
