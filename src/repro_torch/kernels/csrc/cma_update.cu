// Fused rank-mu covariance update for Hopper (sm_90a), slot-batched.
//
// Replaces repro/kernels/cma_update.py::cma_rank_mu_update (_kernel).  Per
// slot s:
//
//   C'[i, j] = decay C[i, j] + c_mu sum_k w[k] Y[k, i] Y[k, j]
//              + c_1 p_c[i] p_c[j]
//
// with (decay, c_mu, c_1) the slot's row of coef.  The weighted gram
// Y^T diag(w) Y is a GEMM with the population as its contraction.
//
// Layout: one block per 64 x 64 tile of C' in the upper triangle (i <= j
// tiles only), the lam contraction inside the block in stages of 16 rows,
// and the decay, c_mu and c_1 epilogue applied once per tile in registers:
// C is read once and C' written once.  Each value with i <= j is written to
// both (i, j) and (j, i), so C' is exactly symmetric, and C is only read on
// and above its diagonal.  A stage whose 16 weights are all zero is skipped,
// so zero-weight rows cost nothing and change nothing.  w enters as it is
// (no square root), so any sign of weight is taken.  Every sum is in a fixed
// order: the result does not vary from run to run.  The TPU kernel's tiles
// cover the whole (i, j) grid and accumulate in float32; this one covers
// the upper triangle and accumulates in T (float or double).
//
// What bounds it: the upper triangle's gram is about n^2 lam_nz FLOP (lam_nz
// the rows with non-zero weight), 3.1 GFLOP at n = 1000 and lam = 3072,
// against 16 MB of C and C' and 25 MB of Y, so it is bound by FP64
// arithmetic at that shape, and by bytes at lam = 12.  Faster forms (FP64
// tensor-core tiles, splitting the lam contraction over blocks at small n)
// are later work.
#include "cma_gen_common.cuh"

namespace {

enum Coef { DECAY = 0, C_MU, C_1, N_COEF };

constexpr int BT = 64;                // edge of a C' tile
constexpr int BK = 16;                // population rows per stage
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int THREADS = TX * TY;

template <typename T>
__global__ void __launch_bounds__(THREADS) rank_mu_kernel(
    const T* __restrict__ C, const T* __restrict__ Y,
    const T* __restrict__ w, const T* __restrict__ pc,
    const T* __restrict__ coef, T* __restrict__ Cn, int lam, int n, int nt) {
  __shared__ T As[BK][BT];   // Y rows, columns i
  __shared__ T Bs[BK][BT];   // w * Y rows, columns j
  __shared__ T wst[BK];
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
    if (tid < BK) wst[tid] = k0 + tid < lam ? ws[k0 + tid] : T(0);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < (BT * BK) / THREADS; ++q) {
      const int e = tid + THREADS * q;
      const int kk = e / BT;
      const int col = e % BT;
      const int k = k0 + kk;
      const size_t base = static_cast<size_t>(k) * n;
      const int i = i0 + col;
      const int j = j0 + col;
      As[kk][col] = (k < lam && i < n) ? Ys[base + i] : T(0);
      Bs[kk][col] = (k < lam && j < n) ? wst[kk] * Ys[base + j] : T(0);
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
  const T decay = c[DECAY];
  const T cmu = c[C_MU];
  const T c1 = c[C_1];
  const T* p = pc + static_cast<size_t>(s) * n;
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
        const T v = decay * Cs[ij] + cmu * acc[a][b] + c1 * (p[i] * p[j]);
        Cns[ij] = v;
        Cns[static_cast<size_t>(j) * n + i] = v;
      }
    }
  }
}

template <typename T>
int launch_rank_mu(const T* C, const T* Y, const T* w, const T* pc,
                   const T* coef, T* Cn, int S, int lam, int n,
                   cudaStream_t stream) {
  const int nt = cma_gen::cdiv(n, BT);
  const dim3 grid(nt * (nt + 1) / 2, S);
  rank_mu_kernel<T><<<grid, THREADS, 0, stream>>>(C, Y, w, pc, coef, Cn, lam,
                                                  n, nt);
  return cma_gen::launch_status();
}

}  // namespace

// coef is (S, 3): decay, c_mu, c_1 of each slot.
#define CMA_UPDATE_API(T, SUFFIX)                                            \
  extern "C" int cma_rank_mu_update_##SUFFIX(                                \
      const T* C, const T* Y, const T* w, const T* pc, const T* coef, T* Cn, \
      int S, int lam, int n, void* stream) {                                 \
    return launch_rank_mu<T>(C, Y, w, pc, coef, Cn, S, lam, n,               \
                             static_cast<cudaStream_t>(stream));             \
  }

CMA_UPDATE_API(float, f32)
CMA_UPDATE_API(double, f64)
