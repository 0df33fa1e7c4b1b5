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
// The TPU kernel holds whole (n, n) tiles in VMEM; 227 KB of shared memory
// cannot, so the update is split.  Phase (i), four small launches per call,
// computes the vectors: y_w (one thread per coordinate, skipping zero-weight
// rows), t = (B^T y_w) / max(D, floor) (one thread per coordinate), whiten
// and p_sigma' (one warp per row of B, shuffle reduction), then |p_sigma'|,
// h_sigma, decay and p_c' (one block per slot, fixed-order tree reduction).
// Phase (ii) is a tiled GEMM over the upper-triangle 64 x 64 tiles of C'
// only: each block accumulates Y_s^T Y_s for its tile over the population
// in stages of 16 rows (a stage whose 16 weights are all zero is skipped:
// the padding rows of a small rung cost nothing), applies the epilogue in
// registers and writes each value with i <= j to both (i, j) and (j, i), so
// C' is exactly symmetric.  Every sum is in a fixed order: the result does
// not vary from run to run.
//
// What bounds it: the gram is n^2 * lam_nz FLOP (upper triangle, lam_nz the
// rows with non-zero weight), 1.5 GFLOP at n = 1000 with 1536 weighted rows,
// against about 40 MB of traffic, so it is bound by FP64 arithmetic;
// phase (i) moves B twice (16 MB at n = 1000) and is bound by bytes.  Faster
// forms (FP64 tensor-core tiles, fusing phase (i) into fewer launches) are
// later work.
#include <cmath>

#include "cma_gen_common.cuh"

namespace {

enum Coef { C_SIGMA = 0, MU_EFF, C_C, C_1, C_MU, CHI_N, GEN1, N_COEF };

constexpr int VEC_THREADS = 256;
constexpr int ROWS_PER_BLOCK = 8;     // warps per block in the whiten kernel
constexpr int PATH_THREADS = 1024;
constexpr int BT = 64;                // edge of a C' tile
constexpr int BK = 16;                // population rows per stage
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int GRAM_THREADS = TX * TY;

template <typename T>
__device__ __forceinline__ T whiten_floor();
template <>
__device__ __forceinline__ float whiten_floor<float>() { return 1e-30f; }
template <>
__device__ __forceinline__ double whiten_floor<double>() { return 1e-300; }

// y_w[s, j] = sum_k (sqrt(w_k) Y[s, k, j]) sqrt(w_k)
template <typename T>
__global__ void yw_kernel(const T* __restrict__ Y, const T* __restrict__ w,
                          T* __restrict__ yw, int lam, int n) {
  const int s = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const T* Ys = Y + static_cast<size_t>(s) * lam * n;
  const T* ws = w + static_cast<size_t>(s) * lam;
  T acc = T(0);
  for (int k = 0; k < lam; ++k) {
    const T wk = ws[k];
    if (wk == T(0)) continue;                 // the same k for every thread
    const T rw = sqrt(wk);
    acc += (rw * Ys[static_cast<size_t>(k) * n + j]) * rw;
  }
  yw[static_cast<size_t>(s) * n + j] = acc;
}

// t[s, k] = (sum_j B[s, j, k] y_w[s, j]) / max(D[s, k], floor)
template <typename T>
__global__ void whiten_t_kernel(const T* __restrict__ B,
                                const T* __restrict__ D,
                                const T* __restrict__ yw, T* __restrict__ t,
                                int n) {
  const int s = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const T* Bm = B + static_cast<size_t>(s) * n * n;
  const T* y = yw + static_cast<size_t>(s) * n;
  T acc = T(0);
  for (int j = 0; j < n; ++j) acc += Bm[static_cast<size_t>(j) * n + k] * y[j];
  t[static_cast<size_t>(s) * n + k] =
      acc / fmax(D[static_cast<size_t>(s) * n + k], whiten_floor<T>());
}

// whiten[s, i] = sum_k B[s, i, k] t[s, k]; writes p_sigma'[s, i].
template <typename T>
__global__ void whiten_kernel(const T* __restrict__ B,
                              const T* __restrict__ t,
                              const T* __restrict__ ps,
                              const T* __restrict__ coef,
                              T* __restrict__ psn, int n) {
  const int s = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (i >= n) return;                          // whole warps leave together
  const T* row = B + (static_cast<size_t>(s) * n + i) * n;
  const T* tv = t + static_cast<size_t>(s) * n;
  T acc = T(0);
  for (int k = lane; k < n; k += 32) acc += row[k] * tv[k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const T* c = coef + static_cast<size_t>(s) * N_COEF;
    const T cs = c[C_SIGMA];
    const size_t o = static_cast<size_t>(s) * n + i;
    psn[o] = (T(1) - cs) * ps[o] + sqrt(cs * (T(2) - cs) * c[MU_EFF]) * acc;
  }
}

// |p_sigma'|, h_sigma, decay and p_c' for one slot per block.
template <typename T>
__global__ void __launch_bounds__(PATH_THREADS) paths_kernel(
    const T* __restrict__ psn, const T* __restrict__ pc,
    const T* __restrict__ yw, const T* __restrict__ coef,
    T* __restrict__ pcn, T* __restrict__ scal, int n) {
  __shared__ T part[PATH_THREADS];
  __shared__ T h_shared;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const T* p = psn + static_cast<size_t>(s) * n;
  T acc = T(0);
  for (int j = tid; j < n; j += PATH_THREADS) acc += p[j] * p[j];
  part[tid] = acc;
  __syncthreads();
  for (int half = PATH_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) part[tid] += part[tid + half];
    __syncthreads();
  }
  const T* c = coef + static_cast<size_t>(s) * N_COEF;
  if (tid == 0) {
    const T cs = c[C_SIGMA];
    const T cc = c[C_C];
    const T ps_norm = sqrt(part[0]);
    const T denom = sqrt(T(1) - pow(T(1) - cs, T(2) * c[GEN1]));
    const T h = (ps_norm / denom / c[CHI_N] < T(1.4) + T(2) / (n + T(1)))
                    ? T(1) : T(0);
    scal[2 * s] = h;
    scal[2 * s + 1] = T(1) - c[C_1] - c[C_MU] +
                      (T(1) - h) * c[C_1] * cc * (T(2) - cc);
    h_shared = h;
  }
  __syncthreads();
  const T cc = c[C_C];
  const T pull = h_shared * sqrt(cc * (T(2) - cc) * c[MU_EFF]);
  for (int j = tid; j < n; j += PATH_THREADS) {
    const size_t o = static_cast<size_t>(s) * n + j;
    pcn[o] = (T(1) - cc) * pc[o] + pull * yw[o];
  }
}

// C' over the upper-triangle tiles, mirrored.
template <typename T>
__global__ void __launch_bounds__(GRAM_THREADS) gram_kernel(
    const T* __restrict__ C, const T* __restrict__ Y,
    const T* __restrict__ w, const T* __restrict__ pcn,
    const T* __restrict__ coef, const T* __restrict__ scal,
    T* __restrict__ Cn, int lam, int n, int nt) {
  __shared__ T As[BK][BT];
  __shared__ T Bs[BK][BT];
  __shared__ T rws[BK];
  const int s = blockIdx.y;
  int bi = 0;
  int rem = blockIdx.x;
  while (rem >= nt - bi) {
    rem -= nt - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const int i0 = bi * BT;
  const int j0 = bj * BT;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const T* Ys = Y + static_cast<size_t>(s) * lam * n;
  const T* ws = w + static_cast<size_t>(s) * lam;

  T acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = T(0);

  for (int k0 = 0; k0 < lam; k0 += BK) {
    bool any = false;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk)
      any |= (k0 + kk < lam) && ws[k0 + kk] != T(0);
    if (!any) continue;                        // the same for every thread
    if (tid < BK) rws[tid] = k0 + tid < lam ? sqrt(ws[k0 + tid]) : T(0);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < (BT * BK) / GRAM_THREADS; ++q) {
      const int e = tid + GRAM_THREADS * q;
      const int kk = e / BT;
      const int col = e % BT;
      const int k = k0 + kk;
      const size_t base = static_cast<size_t>(k) * n;
      const int i = i0 + col;
      const int j = j0 + col;
      As[kk][col] = (k < lam && i < n) ? rws[kk] * Ys[base + i] : T(0);
      Bs[kk][col] = (k < lam && j < n) ? rws[kk] * Ys[base + j] : T(0);
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

  const T* c = coef + static_cast<size_t>(s) * N_COEF;
  const T c1 = c[C_1];
  const T cmu = c[C_MU];
  const T decay = scal[2 * s + 1];
  const T* p = pcn + static_cast<size_t>(s) * n;
  const T* Cs = C + static_cast<size_t>(s) * n * n;
  T* Cns = Cn + static_cast<size_t>(s) * n * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + TY * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx + TX * b;
      if (i < n && j < n && i <= j) {
        const size_t ij = static_cast<size_t>(i) * n + j;
        const T v = decay * Cs[ij] + cmu * acc[a][b] + (c1 * p[i]) * p[j];
        Cns[ij] = v;
        Cns[static_cast<size_t>(j) * n + i] = v;
      }
    }
  }
}

template <typename T>
int launch_update(const T* C, const T* B, const T* D, const T* ps,
                  const T* pc, const T* Y, const T* w, const T* coef, T* Cn,
                  T* psn, T* pcn, T* yw, T* t, T* scal, int S, int lam, int n,
                  cudaStream_t stream) {
  using cma_gen::cdiv;
  int err;
  const dim3 vgrid(cdiv(n, VEC_THREADS), S);
  yw_kernel<T><<<vgrid, VEC_THREADS, 0, stream>>>(Y, w, yw, lam, n);
  if ((err = cma_gen::launch_status()) != 0) return err;
  whiten_t_kernel<T><<<vgrid, VEC_THREADS, 0, stream>>>(B, D, yw, t, n);
  if ((err = cma_gen::launch_status()) != 0) return err;
  const dim3 wgrid(cdiv(n, ROWS_PER_BLOCK), S);
  whiten_kernel<T><<<wgrid, ROWS_PER_BLOCK * 32, 0, stream>>>(B, t, ps, coef,
                                                             psn, n);
  if ((err = cma_gen::launch_status()) != 0) return err;
  paths_kernel<T><<<S, PATH_THREADS, 0, stream>>>(psn, pc, yw, coef, pcn,
                                                  scal, n);
  if ((err = cma_gen::launch_status()) != 0) return err;
  const int nt = cdiv(n, BT);
  const dim3 ggrid(nt * (nt + 1) / 2, S);
  gram_kernel<T><<<ggrid, GRAM_THREADS, 0, stream>>>(C, Y, w, pcn, coef, scal,
                                                     Cn, lam, n, nt);
  return cma_gen::launch_status();
}

}  // namespace

// coef is (S, 7) in COEF_FIELDS order; t (S, n) and scal (S, 2) are scratch.
#define CMA_GEN_UPDATE_API(T, SUFFIX)                                        \
  extern "C" int cma_gen_update_##SUFFIX(                                    \
      const T* C, const T* B, const T* D, const T* ps, const T* pc,          \
      const T* Y, const T* w, const T* coef, T* Cn, T* psn, T* pcn, T* yw,   \
      T* t, T* scal, int S, int lam, int n, void* stream) {                  \
    return launch_update<T>(C, B, D, ps, pc, Y, w, coef, Cn, psn, pcn, yw,   \
                            t, scal, S, lam, n,                              \
                            static_cast<cudaStream_t>(stream));              \
  }

CMA_GEN_UPDATE_API(float, f32)
CMA_GEN_UPDATE_API(double, f64)
