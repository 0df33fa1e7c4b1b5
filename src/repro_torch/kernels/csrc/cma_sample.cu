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
// The design is sample_gemm.cuh's, shared with cma_gen_sample.cu: the
// wrapper cuts every group's range into the row tiles of its plan
// (kernels/sample_plan.py), none crossing a group boundary, and a block
// reads the state of exactly one descent; B, D, m and sigma are read per
// descent, never copied per device (at n = 1000 in float64 one B is 8 MB;
// a copy for each of 512 devices would be 4 GB).  The strategies path's
// full width (R = 512 * 12 = 6144 rows, n = 1000, nine descents of 12 to
// 3072 rows) takes the tile plan: 12.3 GFLOP on the FP64 tensor cores,
// the small descents' few tiles alongside the large ones'.  K-Replicated's
// groups (12 to 96 rows, one B each) take the stream plan, bound by
// reading each group's B once.  Ragged n and row ranges are masked in the
// kernel: nothing is padded on the host.  Each output row depends only on
// its own Z row and its group's state, so the result equals the per-device
// plain version row for row.
#include "cma_gen_common.cuh"
#include "sample_gemm.cuh"

namespace {

using cma_sample_gemm::E_AFFINE;
using cma_sample_gemm::E_X;
using cma_sample_gemm::launch_sample;
using cma_sample_gemm::sample_args;
using cma_sample_gemm::SampleArgs;

template <typename T>
int launch_grouped_sample(const T* m, const T* sigma, const T* B, const T* D,
                          const T* Z, const int* tiles, T* X, int ntiles,
                          int rows, int n, int kind, int tile_rows,
                          cudaStream_t stream) {
  SampleArgs<T> a =
      sample_args(m, sigma, B, D, Z, tiles, ntiles, rows, n, kind, tile_rows);
  a.X = X;
  return m != nullptr ? launch_sample<T, E_AFFINE>(a, stream)
                      : launch_sample<T, E_X>(a, stream);
}

}  // namespace

// tiles is the plan's (ntiles, 3) int32 table (group, first row, end row),
// rows = R; kind 0 is the tile plan, 1 the stream plan, whose tile_rows is
// the most rows of a table entry.  m and sigma are both null
// (X = (Z * diag D) B^T) or both set.
#define CMA_SAMPLE_API(T, SUFFIX)                                            \
  extern "C" int cma_sample_##SUFFIX(                                        \
      const T* m, const T* sigma, const T* B, const T* D, const T* Z,        \
      const int* tiles, T* X, int ntiles, int rows, int n, int kind,         \
      int tile_rows, void* stream) {                                         \
    return launch_grouped_sample<T>(m, sigma, B, D, Z, tiles, X, ntiles,     \
                                    rows, n, kind, tile_rows,                \
                                    static_cast<cudaStream_t>(stream));      \
  }                                                                          \
  extern "C" int cma_sample_constant_##SUFFIX(int which) {                   \
    return cma_sample_gemm::sample_constant(which);                          \
  }

CMA_SAMPLE_API(float, f32)
CMA_SAMPLE_API(double, f64)
