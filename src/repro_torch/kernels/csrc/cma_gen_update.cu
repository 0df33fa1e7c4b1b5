// Fused CMA-ES generation update for Hopper (sm_90a), slot-batched.
//
// Replaces repro/kernels/cma_gen.py::cma_gen_update (_update_kernel).  Per
// slot s, with Y_s = sqrt(w) * Y:
//
//   y_w    = Y_s^T sqrt(w)
//   whiten = B ((B^T y_w) / max(D, floor))
//   p_sigma' = (1 - c_sigma) p_sigma + sqrt(c_sigma (2 - c_sigma) mu_eff) whiten
//   h_sigma  = |p_sigma'| / sqrt(1 - (1 - c_sigma)^(2 gen1)) / chi_n < 1.4 + 2/(n+1)
//   p_c'   = (1 - c_c) p_c + h_sigma sqrt(c_c (2 - c_c) mu_eff) y_w
//   decay  = 1 - c_1 - c_mu + (1 - h_sigma) c_1 c_c (2 - c_c)
//   C'     = decay C + c_mu Y_s^T Y_s + c_1 p_c' p_c'^T
//
// What bounds it: the gram is n^2 lam_nz FLOP over the upper triangle
// (lam_nz the rows of non-zero weight), 1.5 GFLOP at n = 1000 and
// lam = 3072, against about 40 MB of traffic: bound by FP64 arithmetic
// (23 us at the 67 TFLOP/s tensor-core rate).  At n = 40 the whole update
// moves 1 MB and is bound by bytes (under 1 us): there only the depth of
// the lam walk and the number of launches count.
//
// The TPU kernel walks the population in one sequential grid; on 132 SMs
// that walk must be cut, so one call is three launches (n <= 128) or five,
// all in a fixed order (no atomics: the result does not vary from run to
// run):
//
// 1. gram::gram_kernel (gram_gemm.cuh, shared with cma_update.cu): one
//    block per (upper-triangle 64 x 64 tile of C', chunk of population
//    rows, slot), the chunks cut by cma_gen.update_plan so that at n = 40
//    and at n = 1000 at least 132 blocks are in flight; only rows of
//    non-zero weight are staged (cp.async ring), float64 tiles on DMMA,
//    float32 on FFMA.  A block on a diagonal tile also sums w Y over its
//    64 columns: y_w is the gram against the sqrt(w) column, so it costs
//    no separate walk.  Each block writes its partial tile and partial y_w
//    to scratch.
// 2. The vector phase.  For n <= 128 one block per slot (vec_small_kernel)
//    sums the y_w partials, then does B^T y_w / D, whiten, p_sigma',
//    |p_sigma'|, h_sigma, decay and the p_c' pull.  Above that, B (8 MB at
//    n = 1000, read twice) is streamed by many blocks: t_kernel (32 columns
//    by 128 rows a block: 256 blocks at n = 1000) and whiten_kernel (8 rows
//    a block, one warp a row), each block writing a partial of B^T y_w or
//    of |p_sigma'|^2; paths_kernel sums the latter for h_sigma.
// 3. epilogue_kernel (gram::epilogue_tile) sums the partial tiles in chunk
//    order and writes p_c' and each C' value with i <= j to (i, j) and
//    (j, i): C' is exactly symmetric.
#include <cmath>

#include "gram_gemm.cuh"

namespace {

using gram::EPI_THREADS;

enum Coef { C_SIGMA = 0, MU_EFF, C_C, C_1, C_MU, CHI_N, GEN1, N_COEF };

// These constants are mirrored by cma_gen.update_plan (the gram's are in
// gram_gemm.cuh).
constexpr int VEC_THREADS = 256;
constexpr int T_COLS = 32;            // t_kernel: columns of B a block
constexpr int T_ROWS = 128;           // t_kernel: rows of B a block
constexpr int W_ROWS = 8;             // whiten_kernel: rows (warps) a block

template <typename T>
__device__ __forceinline__ T whiten_floor();
template <>
__device__ __forceinline__ float whiten_floor<float>() { return 1e-30f; }
template <>
__device__ __forceinline__ double whiten_floor<double>() { return 1e-300; }

// The chunks' y_w partials summed in chunk order.
template <typename T>
__device__ __forceinline__ T sum_yw(const T* __restrict__ Yp, int s, int j,
                                    int n, int chunks) {
  T acc = T(0);
  for (int ch = 0; ch < chunks; ++ch)
    acc += Yp[(static_cast<size_t>(s) * chunks + ch) * n + j];
  return acc;
}

template <typename T>
__device__ __forceinline__ T p_sigma_new(const T* c, T ps, T whiten) {
  const T cs = c[C_SIGMA];
  return (T(1) - cs) * ps + sqrt(cs * (T(2) - cs) * c[MU_EFF]) * whiten;
}

// h_sigma from |p_sigma'|^2, then (decay, pull = h_sigma sqrt(c_c (2 - c_c)
// mu_eff)) into scal[0..1].
template <typename T>
__device__ __forceinline__ void path_scalars(const T* c, T psq, int n,
                                             T* scal) {
  const T cs = c[C_SIGMA];
  const T cc = c[C_C];
  const T denom = sqrt(T(1) - pow(T(1) - cs, T(2) * c[GEN1]));
  const T h = (sqrt(psq) / denom / c[CHI_N] < T(1.4) + T(2) / (n + T(1)))
                  ? T(1) : T(0);
  scal[0] = T(1) - c[C_1] - c[C_MU] + (T(1) - h) * c[C_1] * cc * (T(2) - cc);
  scal[1] = h * sqrt(cc * (T(2) - cc) * c[MU_EFF]);
}

// n <= 128: the whole vector phase of one slot in one block: y_w (the
// chunks' partials summed by eight lanes a column, each over every eighth
// chunk, then the lanes in order), t, whiten, p_sigma', |p_sigma'|^2 and
// the path scalars.
template <typename T>
__global__ void __launch_bounds__(VEC_THREADS) vec_small_kernel(
    const T* __restrict__ B, const T* __restrict__ D,
    const T* __restrict__ ps, const T* __restrict__ coef,
    const T* __restrict__ Yp, T* __restrict__ yw, T* __restrict__ psn,
    T* __restrict__ scal, int n, int chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* yws = reinterpret_cast<T*>(smem_raw);    // [n]
  T* ts = yws + n;                            // [n]
  __shared__ T part[VEC_THREADS];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t o = static_cast<size_t>(s) * n;
  const T* Bm = B + o * n;
  constexpr int LANES = VEC_THREADS / 32;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + tid % 32;
    T acc = T(0);
    if (j < n)
      for (int ch = tid / 32; ch < chunks; ch += LANES)
        acc += Yp[(static_cast<size_t>(s) * chunks + ch) * n + j];
    part[tid] = acc;
    __syncthreads();
    if (tid < 32 && j < n) {
      T y = part[tid];
#pragma unroll
      for (int q = 1; q < LANES; ++q) y += part[tid + 32 * q];
      yws[j] = y;
      yw[o + j] = y;
    }
    __syncthreads();
  }
  for (int k = tid; k < n; k += VEC_THREADS) {
    T acc = T(0);
    for (int j = 0; j < n; ++j)
      acc += Bm[static_cast<size_t>(j) * n + k] * yws[j];
    ts[k] = acc / fmax(D[o + k], whiten_floor<T>());
  }
  __syncthreads();
  const T* c = coef + static_cast<size_t>(s) * N_COEF;
  T sq = T(0);
  for (int i = tid; i < n; i += VEC_THREADS) {
    T acc = T(0);
    for (int k = 0; k < n; ++k)
      acc += Bm[static_cast<size_t>(i) * n + k] * ts[k];
    const T p = p_sigma_new(c, ps[o + i], acc);
    psn[o + i] = p;
    sq += p * p;
  }
  part[tid] = sq;
  __syncthreads();
  for (int half = VEC_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) part[tid] += part[tid + half];
    __syncthreads();
  }
  if (tid == 0) path_scalars(c, part[0], n, scal + 2 * s);
}

// Partial t[k] = sum_j B[j, k] y_w[j] over rows [y*T_ROWS, +T_ROWS); the
// blocks of column group 0 also write y_w for their rows.
template <typename T>
__global__ void __launch_bounds__(VEC_THREADS) t_kernel(
    const T* __restrict__ B, const T* __restrict__ Yp, T* __restrict__ yw,
    T* __restrict__ tpart, int n, int chunks) {
  __shared__ T yws[T_ROWS];
  __shared__ T part[VEC_THREADS / T_COLS][T_COLS];
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int col = tid % T_COLS;
  const int lane = tid / T_COLS;
  const int k = blockIdx.x * T_COLS + col;
  const int j0 = blockIdx.y * T_ROWS;
  const int j1 = min(n, j0 + T_ROWS);
  const size_t o = static_cast<size_t>(s) * n;
  for (int jj = tid; jj < j1 - j0; jj += VEC_THREADS) {
    const T y = sum_yw(Yp, s, j0 + jj, n, chunks);
    yws[jj] = y;
    if (blockIdx.x == 0) yw[o + j0 + jj] = y;
  }
  __syncthreads();
  T acc = T(0);
  if (k < n) {
    const T* Bm = B + o * n;
#pragma unroll 4
    for (int j = j0 + lane; j < j1; j += VEC_THREADS / T_COLS)
      acc += Bm[static_cast<size_t>(j) * n + k] * yws[j - j0];
  }
  part[lane][col] = acc;
  __syncthreads();
  if (lane == 0 && k < n) {
    T tot = part[0][col];
#pragma unroll
    for (int q = 1; q < VEC_THREADS / T_COLS; ++q) tot += part[q][col];
    tpart[(static_cast<size_t>(s) * gridDim.y + blockIdx.y) * n + k] = tot;
  }
}

// whiten and p_sigma' for W_ROWS rows (one warp a row), with t summed from
// its row-split partials; writes this block's part of |p_sigma'|^2.
template <typename T>
__global__ void __launch_bounds__(W_ROWS * 32) whiten_kernel(
    const T* __restrict__ B, const T* __restrict__ D,
    const T* __restrict__ ps, const T* __restrict__ coef,
    const T* __restrict__ tpart, T* __restrict__ psn, T* __restrict__ psq,
    int n, int t_splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ts = reinterpret_cast<T*>(smem_raw);     // [n]
  __shared__ T sq[W_ROWS];
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t o = static_cast<size_t>(s) * n;
  for (int k = tid; k < n; k += W_ROWS * 32) {
    T acc = T(0);
    for (int q = 0; q < t_splits; ++q)
      acc += tpart[(static_cast<size_t>(s) * t_splits + q) * n + k];
    ts[k] = acc / fmax(D[o + k], whiten_floor<T>());
  }
  __syncthreads();
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i = blockIdx.x * W_ROWS + warp;
  T p = T(0);
  if (i < n) {
    const T* row = B + (o + i) * n;
    T acc = T(0);
#pragma unroll 4
    for (int k = lane; k < n; k += 32) acc += row[k] * ts[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    p = p_sigma_new(coef + static_cast<size_t>(s) * N_COEF, ps[o + i], acc);
    if (lane == 0) psn[o + i] = p;
  }
  if (lane == 0) sq[warp] = p * p;
  __syncthreads();
  if (tid == 0) {
    T tot = sq[0];
#pragma unroll
    for (int q = 1; q < W_ROWS; ++q) tot += sq[q];
    psq[static_cast<size_t>(s) * gridDim.x + blockIdx.x] = tot;
  }
}

// The path scalars of one slot from whiten_kernel's |p_sigma'|^2 partials.
template <typename T>
__global__ void __launch_bounds__(32) paths_kernel(
    const T* __restrict__ coef, const T* __restrict__ psq,
    T* __restrict__ scal, int n, int psq_parts) {
  const int s = blockIdx.x;
  T acc = T(0);
  for (int q = threadIdx.x; q < psq_parts; q += 32)
    acc += psq[static_cast<size_t>(s) * psq_parts + q];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x == 0)
    path_scalars(coef + static_cast<size_t>(s) * N_COEF, acc, n,
                 scal + 2 * s);
}

// C' for EPI_THREADS / lanes elements of one tile (gram::epilogue_tile):
// h_sigma, decay and p_c' from the vector phase's scalars.
template <typename T>
__global__ void __launch_bounds__(EPI_THREADS) epilogue_kernel(
    const T* __restrict__ C, const T* __restrict__ pc,
    const T* __restrict__ yw, const T* __restrict__ coef,
    const T* __restrict__ Gp, const T* __restrict__ scal,
    T* __restrict__ Cn, T* __restrict__ pcn, int n, int chunks, int lanes) {
  gram::epilogue_tile<false>(Gp, Cn, n, chunks, lanes,
                             [&](int s, int i, int j, T g) {
    const T* c = coef + static_cast<size_t>(s) * N_COEF;
    const T decay = scal[2 * s];
    const T pull = scal[2 * s + 1];
    const T cc = c[C_C];
    const size_t o = static_cast<size_t>(s) * n;
    const T pi = (T(1) - cc) * pc[o + i] + pull * yw[o + i];
    const T pj = (T(1) - cc) * pc[o + j] + pull * yw[o + j];
    if (i == j) pcn[o + i] = pi;
    return decay * C[(o + i) * n + j] + c[C_MU] * g + (c[C_1] * pi) * pj;
  });
}

template <typename T>
int launch_update(const T* C, const T* B, const T* D, const T* ps,
                  const T* pc, const T* Y, const T* w, const T* coef, T* Cn,
                  T* psn, T* pcn, T* yw, T* Gp, T* Yp, T* tpart, T* psq,
                  T* scal, int S, int lam, int n, int chunk_rows, int chunks,
                  int t_splits, int psq_parts, int lanes,
                  cudaStream_t stream) {
  using cma_gen::cdiv;
  using cma_gen::set_smem;
  if (!gram::plan_ok(lam, chunk_rows, chunks, lanes) ||
      (t_splits == 0 ? psq_parts != 1
                     : t_splits != cdiv(n, T_ROWS) ||
                           psq_parts != cdiv(n, W_ROWS)))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = gram::launch_gram<T, true>(Y, w, gram::ToScratch<T, true>{Gp, Yp},
                                       S, lam, n, chunk_rows, chunks, stream);
  if (err != 0) return err;
  if (t_splits == 0) {
    const size_t vsm = 2 * static_cast<size_t>(n) * sizeof(T);
    if ((err = set_smem<vec_small_kernel<T>>(vsm)) != 0) return err;
    vec_small_kernel<T><<<S, VEC_THREADS, vsm, stream>>>(
        B, D, ps, coef, Yp, yw, psn, scal, n, chunks);
  } else {
    t_kernel<T><<<dim3(cdiv(n, T_COLS), t_splits, S), VEC_THREADS, 0,
                  stream>>>(B, Yp, yw, tpart, n, chunks);
    if ((err = cma_gen::launch_status()) != 0) return err;
    const size_t wsm = static_cast<size_t>(n) * sizeof(T);
    if ((err = set_smem<whiten_kernel<T>>(wsm)) != 0) return err;
    whiten_kernel<T><<<dim3(psq_parts, S), W_ROWS * 32, wsm, stream>>>(
        B, D, ps, coef, tpart, psn, psq, n, t_splits);
    if ((err = cma_gen::launch_status()) != 0) return err;
    paths_kernel<T><<<S, 32, 0, stream>>>(coef, psq, scal, n, psq_parts);
  }
  if ((err = cma_gen::launch_status()) != 0) return err;
  epilogue_kernel<T><<<gram::epilogue_grid(n, lanes, S), EPI_THREADS, 0,
                       stream>>>(C, pc, yw, coef, Gp, scal, Cn, pcn, n,
                                 chunks, lanes);
  return cma_gen::launch_status();
}

}  // namespace

// coef is (S, 7) in COEF_FIELDS order.  Scratch, sized by
// cma_gen.update_plan: Gp (S, chunks, tiles, 64, 64), Yp (S, chunks, n),
// tpart (S, t_splits, n), psq (S, psq_parts) and scal (S, 2).  t_splits ==
// 0 selects the one-block vector phase (psq_parts is then 1, tpart and psq
// unused).
#define CMA_GEN_UPDATE_API(T, SUFFIX)                                        \
  extern "C" int cma_gen_update_##SUFFIX(                                    \
      const T* C, const T* B, const T* D, const T* ps, const T* pc,          \
      const T* Y, const T* w, const T* coef, T* Cn, T* psn, T* pcn, T* yw,   \
      T* Gp, T* Yp, T* tpart, T* psq, T* scal, int S, int lam, int n,        \
      int chunk_rows, int chunks, int t_splits, int psq_parts, int lanes,    \
      void* stream) {                                                        \
    return launch_update<T>(C, B, D, ps, pc, Y, w, coef, Cn, psn, pcn, yw,   \
                            Gp, Yp, tpart, psq, scal, S, lam, n, chunk_rows, \
                            chunks, t_splits, psq_parts, lanes,              \
                            static_cast<cudaStream_t>(stream));              \
  }

CMA_GEN_UPDATE_API(float, f32)
CMA_GEN_UPDATE_API(double, f64)
