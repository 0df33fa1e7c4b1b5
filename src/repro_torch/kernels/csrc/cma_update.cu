// Fused rank-mu covariance update for Hopper (sm_90a), slot-batched.
//
// Replaces repro/kernels/cma_update.py::cma_rank_mu_update (_kernel).  Per
// slot s:
//
//   C'[i, j] = decay C[i, j] + c_mu sum_k w[k] Y[k, i] Y[k, j]
//              + c_1 p_c[i] p_c[j]
//
// with (decay, c_mu, c_1) the slot's row of coef.
//
// What bounds it: the upper triangle's gram is about n^2 lam_nz FLOP
// (lam_nz the rows of non-zero weight), 1.5 GFLOP at n = 1000 and
// lam = 3072 with half the rows weighted, against 16 MB of C and C' and
// 12 MB of weighted rows of Y: bound by FP64 arithmetic (23 us at the 67
// TFLOP/s tensor-core rate).  At lam = 12 it is bound by bytes.
//
// The TPU kernel walks the population in one sequential grid; here one
// call is one or two launches, in a fixed order (no atomics: a second
// launch gives the same bits):
//
// 1. the gram of row 6 (gram_gemm.cuh, without its y_w column): one block
//    per (upper-triangle 64 x 64 tile, chunk of population rows, slot),
//    the chunks cut by cma_update.rank_mu_plan (row 6's split) so that at
//    least 132 blocks are in flight; only rows of non-zero weight are
//    staged (so zero-weight rows cost nothing and change nothing), w
//    enters as it is (any sign of weight is taken); float64 tiles on DMMA,
//    float32 on FFMA;
// 2. rank_mu_epilogue sums each tile's partials in chunk order and writes
//    decay C + c_mu G + c_1 p_c p_c^T for i <= j to (i, j) and (j, i): C'
//    is exactly symmetric, and C is read on and above its diagonal only.
//
// Where the plan takes one chunk (small populations: a block walks a few
// stages), the gram blocks write those values from their registers
// (ToUpdate): one launch, and no partial tiles to write and read back.
#include "gram_gemm.cuh"

namespace {

enum Coef { DECAY = 0, C_MU, C_1, N_COEF };

// C'[s, i, j] from the gram's value g there.
template <typename T>
__device__ __forceinline__ T rank_mu_value(const T* __restrict__ C,
                                           const T* __restrict__ pc,
                                           const T* __restrict__ coef, int n,
                                           int s, int i, int j, T g) {
  const T* c = coef + static_cast<size_t>(s) * N_COEF;
  const size_t o = static_cast<size_t>(s) * n;
  return c[DECAY] * C[(o + i) * n + j] + c[C_MU] * g
         + c[C_1] * (pc[o + i] * pc[o + j]);
}

// STAGED: the plan's lanes are at most 2 (gram::epilogue_tile).
template <typename T, bool STAGED>
__global__ void __launch_bounds__(gram::EPI_THREADS) rank_mu_epilogue(
    const T* __restrict__ C, const T* __restrict__ pc,
    const T* __restrict__ coef, const T* __restrict__ Gp,
    T* __restrict__ Cn, int n, int chunks, int lanes) {
  gram::epilogue_tile<STAGED>(Gp, Cn, n, chunks, lanes,
                              [&](int s, int i, int j, T g) {
    return rank_mu_value(C, pc, coef, n, s, i, j, g);
  });
}

// The gram's output with one chunk: each value with i <= j < n, written
// to (i, j) and (j, i).
template <typename T>
struct ToUpdate {
  const T* C;
  const T* pc;
  const T* coef;
  T* Cn;

  __device__ __forceinline__ void operator()(const gram::GramTile<T>& acc,
                                             T, int s, int, int i0, int j0,
                                             bool, int n, int tid) const {
    const size_t o = static_cast<size_t>(s) * n;
    acc.each(tid, [&](int r, int c, T g) {
      const int i = i0 + r;
      const int j = j0 + c;
      if (i < n && j < n && i <= j) {
        const T v = rank_mu_value(C, pc, coef, n, s, i, j, g);
        Cn[(o + i) * n + j] = v;
        Cn[(o + j) * n + i] = v;
      }
    });
  }
};

template <typename T>
int launch_rank_mu(const T* C, const T* Y, const T* w, const T* pc,
                   const T* coef, T* Cn, T* Gp, int S, int lam, int n,
                   int chunk_rows, int chunks, int lanes,
                   cudaStream_t stream) {
  if (!gram::plan_ok(lam, chunk_rows, chunks, lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks == 1)
    return gram::launch_gram<T, false>(Y, w, ToUpdate<T>{C, pc, coef, Cn}, S,
                                       lam, n, chunk_rows, 1, stream);
  const int err = gram::launch_gram<T, false>(
      Y, w, gram::ToScratch<T, false>{Gp, nullptr}, S, lam, n, chunk_rows,
      chunks, stream);
  if (err != 0) return err;
  const dim3 grid = gram::epilogue_grid(n, lanes, S);
  if (lanes <= 2)
    rank_mu_epilogue<T, true><<<grid, gram::EPI_THREADS, 0, stream>>>(
        C, pc, coef, Gp, Cn, n, chunks, lanes);
  else
    rank_mu_epilogue<T, false><<<grid, gram::EPI_THREADS, 0, stream>>>(
        C, pc, coef, Gp, Cn, n, chunks, lanes);
  return cma_gen::launch_status();
}

}  // namespace

// coef is (S, 3): decay, c_mu, c_1 of each slot.  Gp is the gram's scratch
// (S, chunks, tiles, 64, 64), sized by cma_update.gram_scratch; unused
// (and may be null) with one chunk.
#define CMA_UPDATE_API(T, SUFFIX)                                            \
  extern "C" int cma_rank_mu_update_##SUFFIX(                                \
      const T* C, const T* Y, const T* w, const T* pc, const T* coef, T* Cn, \
      T* Gp, int S, int lam, int n, int chunk_rows, int chunks, int lanes,   \
      void* stream) {                                                        \
    return launch_rank_mu<T>(C, Y, w, pc, coef, Cn, Gp, S, lam, n,           \
                             chunk_rows, chunks, lanes,                      \
                             static_cast<cudaStream_t>(stream));             \
  }

CMA_UPDATE_API(float, f32)
CMA_UPDATE_API(double, f64)
