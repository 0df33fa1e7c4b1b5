// The shared design of the CMA-ES sample kernels for Hopper (sm_90a):
// cma_gen_sample.cu (rows 1-4 of the port's kernel table, slot-batched) and
// cma_sample.cu (row 7, grouped rows of the strategies path).
//
// Both compute Y = (Z * diag D) * B^T, a GEMM with K = n, for rows of Z
// (rows x n) grouped by state: the rows of group g share B[g] (n x n),
// D[g], m[g] and sigma[g].  The wrapper hands the kernel a table of row
// tiles (group, first row, end row), none crossing a group, cut by the plan
// of kernels/sample_plan.py.  The epilogue works on Y while it is still in
// registers or shared memory:
//   E_X      X = Y                       (cma_sample without m and sigma)
//   E_AFFINE X = m + sigma Y             (cma_sample)
//   E_YX     Y, and X = m + sigma Y      (cma_gen_sample)
//   E_EVAL   Y, and F[r] = sum_j scale_j g(x_j - shift_j)^2 + fopt, with
//            g = identity (mode 0) or t_osz (mode 1), NaN where the group is
//            not valid; X is never written     (cma_gen_sample_eval)
// It computes and accumulates in T (float or double); the TPU kernels'
// forced float32 is not carried over.
//
// What bounds it, and the two plans:
//
// * Tile plan: some group has more than STREAM_ROWS rows, or one tile spans
//   all n columns (n <= TILE_COLS).  At (lam, n) = (3072, 1000) the GEMM is
//   2 lam n^2 = 6.1 GFLOP against about 60 MB of traffic: bound by FP64
//   arithmetic (92 us at 67 TFLOP/s).  One block per TILE_ROWS x TILE_COLS
//   output tile of a row tile; slabs of BK columns of k of Z and B come in
//   through a cp.async ring of STAGES stages (16-byte copies where n and
//   the pointers keep every row aligned), at a row pitch of LDK = BK + 4 so
//   that no fragment load hits a bank twice.  float64 runs on the FP64
//   tensor cores (mma.sync m16n8k16 DMMA, 16 MI x 32 outputs a warp) with
//   diag(D) applied to the A fragment in registers; float32 stays on exact
//   FP32 FFMA (TF32 would miss the 1e-4 check), 8 x 4 values a thread, over
//   the same slabs.
// * Stream plan: every group has at most STREAM_ROWS rows and n > TILE_COLS.
//   The work is then reading each group's B once (8 MB at n = 1000), a
//   batched GEMV: a 64-row tile would walk all of K for rows that are
//   mostly zeros, in 16 blocks.  Here one block takes STREAM_COLS rows of B
//   (output columns) of one group, 125 blocks a group at n = 1000, and all
//   of the group's rows, one warp per 16 of them (and at least four warps
//   to issue the copies); stages of KC columns of k of both come in
//   through a cp.async ring of S_STAGES, after one L2 prefetch of the
//   block's B rows, since a block has little else to hide the memory's
//   latency behind.
//
// Bit for bit across plans: the bucket property (a call of lam rows gives
// the first rows of a wider call, bit for bit) needs every output element
// computed the same way whichever plan holds it.  So both plans take the
// same steps per element: float64 one m16n8k16 DMMA per 16 columns of k,
// in ascending order from a zero accumulator, on A = Z * D rounded; float32
// one FFMA per column of k, in ascending order, on (Z * D) rounded, up to
// the same 16-column boundary.  F sums its terms in fixed 8-column groups,
// ((t0 + t1) + (t2 + t3)) + ((t4 + t5) + (t6 + t7)) (shuffles over the lanes
// that hold a group), then the groups in ascending order from 0, in the
// block where one block spans all n columns (gridDim.x == 1: the tile plan
// at n <= TILE_COLS, n = 40 on every restart path; one launch) and
// otherwise in eval_reduce_kernel over one partial per group and row.
//
// Deterministic: no atomics, every sum in a fixed order, so a second launch
// on the same inputs gives the same bits.
//
// Where the tile plan's Z slabs come from, the Z-source policy:
//
// * Z_LOAD: Z is an operand in device memory, copied into the slab ring by
//   cp.async as B is (rows 1, 2 and 7, and rows 3-4 on wide rows).
// * Z_DRAW: Z is the counter stream of the slot's seed words
//   (threefry.cuh), drawn in the kernel (rows 3-4 where n <= TILE_COLS):
//   element (r, k) of slot g is threefry_normal(seed[g], r - g lam, k),
//   zero outside the row tile or n, so the slabs hold the values and zeros
//   the load policy would copy from row 5's Z, and Y, X and F keep their
//   bits.  There one column block spans the row and the STAGES slabs of
//   the ring hold all of its k, so the block draws its whole row tile once,
//   behind the first copies of B, before its stages run.  Wider rows have
//   several column blocks that need the same Z: drawn in each, every
//   element would be drawn once per column block, and shared over a
//   thread-block cluster through distributed shared memory, the blocks ran
//   in lockstep behind cluster barriers and lost to the two launches of
//   row 5 and the load form at n = 1000 (PERF.md), so rows 3-4 take those
//   there.
#pragma once

#include <cmath>
#include <cstdint>

#include "cma_gen_common.cuh"
#include "threefry.cuh"

namespace cma_sample_gemm {

using cma_gen::cdiv;

// The four plan constants are mirrored by kernels/sample_plan.py and read
// back through sample_constant().
constexpr int TILE_ROWS = 64;                // rows of an output tile
constexpr int TILE_COLS = 64;                // columns of an output tile
constexpr int STREAM_ROWS = 96;              // most rows a stream block holds
constexpr int STREAM_COLS = 8;               // rows of B a stream block takes,
                                             // and the width of an F group
constexpr int MI = 2;                        // m16 tiles of a float64 warp
constexpr int BK = 32;                       // tile plan: k columns a stage
constexpr int STAGES = 2;                    // tile plan: cp.async ring depth
constexpr int LDK = BK + 4;                  // tile plan: slab row pitch
constexpr int KSTEP = 16;                    // k columns of a DMMA step
static_assert(TILE_ROWS % (16 * MI) == 0, "whole warps a tile");
static_assert(BK % KSTEP == 0 && STAGES >= 2, "whole DMMA steps a stage");
static_assert(TILE_COLS % STREAM_COLS == 0, "F groups tile a column tile");
static_assert(STAGES * BK >= TILE_COLS, "the draw policy's ring holds a row");
constexpr int KC = 64;                       // stream plan: k columns a stage
static_assert(KC % KSTEP == 0, "whole DMMA steps a stream stage");
constexpr int S_STAGES = 3;                  // stream plan: ring depth
constexpr int SLD = KC + 4;                  // stream plan: slab row pitch
// stream plan: a warp per 16 rows computes; at least four warps copy
constexpr int S_MIN_THREADS = 128;
constexpr int S_MAX_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

enum Epi { E_X = 0, E_AFFINE = 1, E_YX = 2, E_EVAL = 3 };
enum Kind { K_TILE = 0, K_STREAM = 1 };
enum ZSrc { Z_LOAD = 0, Z_DRAW = 1 };

// Whether an RNG call at width n draws Z inside the sample kernel (one
// column block spans the row), else it takes row 5's Z from device memory.
__host__ __device__ constexpr bool draws_z(int n) { return n <= TILE_COLS; }

inline int sample_constant(int which) {
  switch (which) {
    case 0: return TILE_ROWS;
    case 1: return TILE_COLS;
    case 2: return STREAM_ROWS;
    case 3: return STREAM_COLS;
    default: return -1;
  }
}

template <typename T>
struct SampleArgs {
  const T* m;
  const T* sigma;
  const T* B;
  const T* D;
  const T* Z;           // Z_LOAD
  const long long* seeds;  // Z_DRAW: (groups, 2), the low 32 bits are words
  const int* tiles;     // (ntiles, 3): group, first row, end row
  const T* scale;       // E_EVAL: (groups, n)
  const T* shift;       // E_EVAL: (groups, n)
  const T* fopt;        // E_EVAL: (groups,)
  const int* mode;      // E_EVAL: (groups,)
  const int* valid;     // E_EVAL: (groups,)
  T* Y;
  T* X;
  T* F;                 // E_EVAL: (rows,)
  T* Fpart;             // E_EVAL, more than one column block: (groups8, rows)
  int ntiles;
  int rows;             // rows of Z
  int n;
  int lam;              // E_EVAL, Z_DRAW: rows of a group (a slot)
  int kind;
  int tile_rows;        // stream plan: the most rows of a table entry
  int mtiles;           // stream plan: warps a block (launcher)
};

template <typename T>
__device__ __forceinline__ T t_osz(T x) {
  const T xhat = x != T(0) ? log(fabs(x)) : T(0);
  const T c1 = x > T(0) ? T(10.0) : T(5.5);
  const T c2 = x > T(0) ? T(7.9) : T(3.1);
  const T sgn = x > T(0) ? T(1) : (x < T(0) ? T(-1) : T(0));
  return sgn * exp(xhat + T(0.049) * (sin(c1 * xhat) + sin(c2 * xhat)));
}

// Writes the outputs of element (r, j) of group g from y; returns its
// fitness term under E_EVAL, else 0.
template <typename T, int EPI>
__device__ __forceinline__ T emit(const SampleArgs<T>& a, int g, int r, int j,
                                  T y) {
  const size_t o = static_cast<size_t>(r) * a.n + j;
  if constexpr (EPI == E_X) {
    a.X[o] = y;
    return T(0);
  } else {
    const size_t c = static_cast<size_t>(g) * a.n + j;
    const T x = a.m[c] + a.sigma[g] * y;
    if constexpr (EPI == E_AFFINE) {
      a.X[o] = x;
      return T(0);
    } else {
      a.Y[o] = y;
      if constexpr (EPI == E_YX) {
        a.X[o] = x;
        return T(0);
      } else {
        const T t = x - a.shift[c];
        const T tg = a.mode[g] == 1 ? t_osz(t) : t;
        return a.scale[c] * (tg * tg);
      }
    }
  }
}

// emit() of (r, j) when it lies inside the row tile and n, else 0.
template <typename T, int EPI>
__device__ __forceinline__ T emit_in(const SampleArgs<T>& a, int g, int r,
                                     int r1, int j, T y) {
  return (r < r1 && j < a.n) ? emit<T, EPI>(a, g, r, j, y) : T(0);
}

// The sum of a row's 8-column group from its lanes (the lanes differing in
// bits 0..1 hold a pair each in float64, bits 0..2 one value each in
// float32): ((t0 + t1) + (t2 + t3)) + ((t4 + t5) + (t6 + t7)), the same bits
// on every lane of the group.
__device__ __forceinline__ double group_sum(double t0, double t1) {
  double p = t0 + t1;
  p += __shfl_xor_sync(FULL, p, 1);
  p += __shfl_xor_sync(FULL, p, 2);
  return p;
}
__device__ __forceinline__ float group_sum(float t) {
  t += __shfl_xor_sync(FULL, t, 1);
  t += __shfl_xor_sync(FULL, t, 2);
  t += __shfl_xor_sync(FULL, t, 4);
  return t;
}

// One F group's sum of row r: its partial (several column blocks), or kept
// in red[r - r0][group in the tile] for the block to finish.
template <typename T>
__device__ __forceinline__ void put_group(const SampleArgs<T>& a, T* red,
                                          int r0, int r1, int r, int j8,
                                          int gi, T s) {
  if (r >= r1 || j8 >= cdiv(a.n, STREAM_COLS)) return;
  if (gridDim.x == 1) {
    red[(r - r0) * (TILE_COLS / STREAM_COLS) + gi] = s;
  } else {
    a.Fpart[static_cast<size_t>(j8) * a.rows + r] = s;
  }
}

// F[r] from its groups' sums, added in ascending order from 0.
template <typename T>
__device__ __forceinline__ void finish_f(const SampleArgs<T>& a, int g, int r,
                                         const T* sums, int groups) {
  T s = T(0);
  for (int q = 0; q < groups; ++q) s += sums[q];
  a.F[r] = a.valid[g] ? s + a.fopt[g] : static_cast<T>(NAN);
}

// ---------------------------------------------------------------------------
// the per-element steps, shared by both plans
// ---------------------------------------------------------------------------

// One KSTEP-column step of k for a warp's m16 x n8 block of outputs
// (float64):
// rows of As from row ar, rows of Bs from row br, k from column kc.
__device__ __forceinline__ void dmma_step(double (&acc)[4], const double* As,
                                          const double* Bs, const double* Ds,
                                          int ld, int ar, int br, int kc,
                                          int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  double a[8], b[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kk = kc + t + 4 * (i / 2);
    a[i] = As[(ar + g + 8 * (i % 2)) * ld + kk] * Ds[kk];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = Bs[(br + g) * ld + kc + t + 4 * i];
  cma_gen::dmma(acc, a, b);
}

// ---------------------------------------------------------------------------
// tile plan
// ---------------------------------------------------------------------------

// The draw policy's Z of a row tile (rows [r0, r1) of slot g, all of its
// n <= STAGES BK columns of k) into the STAGES slabs of the Z ring
// (a[k / BK][row][k % BK]): each warp draws runs of 32 consecutive
// elements of the tile's live rows over all STAGES BK columns, zero where
// k >= n, and the rows past the tile are zero.  (Drawing only the live
// rows' n columns, with a division by n an element, measured slower.)
template <typename T, int THREADS>
__device__ __forceinline__ void draw_tile(T (*a)[TILE_ROWS][LDK],
                                          const SampleArgs<T>& args, int g,
                                          int r0, int r1, int tid) {
  constexpr int W = STAGES * BK;
  const uint32_t w0 = static_cast<uint32_t>(args.seeds[2 * g]);
  const uint32_t w1 = static_cast<uint32_t>(args.seeds[2 * g + 1]);
  const int row0 = r0 - g * args.lam;
  const int live = r1 - r0;
  for (int e = tid; e < live * W; e += THREADS) {
    const int i = e / W;
    const int k = e % W;
    a[k / BK][i][k % BK] =
        k < args.n ? cma_rng::threefry_normal<T>(
                         w0, w1, static_cast<uint32_t>(row0 + i),
                         static_cast<uint32_t>(k))
                   : T(0);
  }
  for (int e = live * W + tid; e < TILE_ROWS * W; e += THREADS) {
    const int k = e % W;
    a[k / BK][e / W][k % BK] = T(0);
  }
}

template <typename T>
struct TileSmem {
  T a[STAGES][TILE_ROWS][LDK];   // Z rows of the tile
  T b[STAGES][TILE_COLS][LDK];   // B rows (the tile's output columns)
  T d[STAGES][BK];
};

// One block's TILE_ROWS x TILE_COLS tile, accumulated stage by stage.
template <typename T>
struct TileMath;

template <>
struct TileMath<double> {
  // (TILE_ROWS / (16 MI)) x 2 warps, each 16 MI rows x 32 columns
  static constexpr int THREADS = 64 * TILE_ROWS / (16 * MI);
  double acc[MI][4][4] = {};

  // dmma_step's arithmetic for every (mi, ni), each fragment loaded once;
  // the stage's DMMA steps from column 0 while k0 + their column < n
  __device__ __forceinline__ void stage(const double (*As)[LDK],
                                        const double (*Bs)[LDK],
                                        const double* Ds, int k0, int n,
                                        int tid) {
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wr = (tid >> 6) * 16 * MI;
    const int wc = ((tid >> 5) & 1) * 32;
#pragma unroll
    for (int kc = 0; kc < BK; kc += KSTEP) {
      if (k0 + kc >= n) break;
      double a[MI][8], b[4][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int kk = kc + t + 4 * (i / 2);
        const double dk = Ds[kk];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          a[mi][i] = As[wr + 16 * mi + g + 8 * (i % 2)][kk] * dk;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          b[ni][i] = Bs[wc + 8 * ni + g][kc + t + 4 * i];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          cma_gen::dmma(acc[mi][ni], a[mi], b[ni]);
    }
  }

  // emits every value; under E_EVAL passes each (row, F group) sum to put
  template <int EPI, class Put>
  __device__ __forceinline__ void epilogue(const SampleArgs<double>& a, int g,
                                           int r0, int r1, int j0, int tid,
                                           Put&& put) const {
    const int lane = tid & 31;
    const int wr = (tid >> 6) * 16 * MI + (lane >> 2);
    const int cw = ((tid >> 5) & 1) * 4;        // the warp's first group
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + wr + 16 * mi + 8 * h;
          const int j = j0 + 8 * (cw + ni) + 2 * (lane & 3);
          const double t0 = emit_in<double, EPI>(a, g, r, r1, j,
                                                 acc[mi][ni][2 * h]);
          const double t1 = emit_in<double, EPI>(a, g, r, r1, j + 1,
                                                 acc[mi][ni][2 * h + 1]);
          if constexpr (EPI == E_EVAL) {
            const double s = group_sum(t0, t1);
            if ((lane & 3) == 0) put(r, cw + ni, s);
          }
        }
  }
};

template <>
struct TileMath<float> {
  static constexpr int THREADS = 2 * TILE_ROWS;
  static constexpr int TY = THREADS / 16;
  static constexpr int RPT = TILE_ROWS / TY;
  float acc[RPT][4] = {};

  // one FFMA per column of k, ascending, in the stage's 16-column steps
  // while k0 + their column < n
  __device__ __forceinline__ void stage(const float (*As)[LDK],
                                        const float (*Bs)[LDK],
                                        const float* Ds, int k0, int n,
                                        int tid) {
    const int tx = tid % 16;
    const int ty = tid / 16;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk % KSTEP == 0 && k0 + kk >= n) break;
      const float dk = Ds[kk];
      float av[RPT], bv[4];
#pragma unroll
      for (int a = 0; a < RPT; ++a) av[a] = As[ty + TY * a][kk] * dk;
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[tx + 16 * b][kk];
#pragma unroll
      for (int a = 0; a < RPT; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += av[a] * bv[b];
    }
  }

  template <int EPI, class Put>
  __device__ __forceinline__ void epilogue(const SampleArgs<float>& a, int g,
                                           int r0, int r1, int j0, int tid,
                                           Put&& put) const {
    const int tx = tid % 16;
    const int ty = tid / 16;
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = r0 + ty + TY * q;
        const float t = emit_in<float, EPI>(a, g, r, r1, j0 + tx + 16 * b,
                                            acc[q][b]);
        if constexpr (EPI == E_EVAL) {
          const float s = group_sum(t);
          if ((tx & 7) == 0) put(r, 2 * b + (tx >> 3), s);
        }
      }
  }
};

template <typename T, int EPI, bool WIDE, int ZSRC>
__global__ void __launch_bounds__(TileMath<T>::THREADS)
    tile_kernel(const SampleArgs<T> a) {
  using M = TileMath<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<T>& sm = *reinterpret_cast<TileSmem<T>*>(smem_raw);
  const int g = a.tiles[3 * blockIdx.y];
  const int r0 = a.tiles[3 * blockIdx.y + 1];
  const int r1 = a.tiles[3 * blockIdx.y + 2];
  const int n = a.n;
  const int j0 = blockIdx.x * TILE_COLS;
  const int tid = threadIdx.x;
  const T* Bg = a.B + static_cast<size_t>(g) * n * n;
  const T* Dg = a.D + static_cast<size_t>(g) * n;
  // VEC elements a copy: 16 bytes when every row is 16-byte aligned
  constexpr int VEC = WIDE ? 16 / sizeof(T) : 1;
  constexpr int BYTES = VEC * sizeof(T);

  // This thread's copies of a stage: Z and B slab rows base_i + q RSTEP,
  // all at column kk; zoff/boff are their element offsets at k = 0, or -1
  // where the row lies outside the tile or n.
  constexpr int RSTEP = M::THREADS * VEC / BK;
  constexpr int CZ = TILE_ROWS / RSTEP;
  constexpr int CB = TILE_COLS / RSTEP;
  static_assert(M::THREADS * VEC % BK == 0 && TILE_ROWS % RSTEP == 0 &&
                    TILE_COLS % RSTEP == 0,
                "whole slab rows a round of copies");
  const int base_i = tid * VEC / BK;
  const int kk = tid * VEC % BK;
  int zoff[CZ], boff[CB];
#pragma unroll
  for (int q = 0; q < CZ; ++q) {
    const int r = r0 + base_i + q * RSTEP;
    zoff[q] = r < r1 ? r * n + kk : -1;
  }
#pragma unroll
  for (int q = 0; q < CB; ++q) {
    const int j = j0 + base_i + q * RSTEP;
    boff[q] = j < n ? j * n + kk : -1;
  }

  auto issue = [&](int st) {
    const int slot = st % STAGES;
    const int k0 = st * BK;
    const bool kok = k0 + kk < n;
    if constexpr (ZSRC == Z_LOAD) {
#pragma unroll
      for (int q = 0; q < CZ; ++q) {
        const bool ok = kok && zoff[q] >= 0;
        cma_gen::cp_async<BYTES>(&sm.a[slot][base_i + q * RSTEP][kk],
                                 ok ? a.Z + zoff[q] + k0 : a.Z, ok);
      }
    }
#pragma unroll
    for (int q = 0; q < CB; ++q) {
      const bool ok = kok && boff[q] >= 0;
      cma_gen::cp_async<BYTES>(&sm.b[slot][base_i + q * RSTEP][kk],
                               ok ? Bg + boff[q] + k0 : Bg, ok);
    }
    if (tid * VEC < BK) {
      const int k = k0 + tid * VEC;
      cma_gen::cp_async<BYTES>(&sm.d[slot][tid * VEC], k < n ? Dg + k : Dg,
                               k < n);
    }
  };

  const int nst = cdiv(n, BK);
  M math;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nst) issue(p);
    cma_gen::cp_async_commit();
  }
  // the draw policy's Z, all of it (nst <= STAGES: no slab is reused)
  if constexpr (ZSRC == Z_DRAW)
    draw_tile<T, M::THREADS>(sm.a, a, g, r0, r1, tid);
  for (int st = 0; st < nst; ++st) {
    cma_gen::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (st + STAGES - 1 < nst) issue(st + STAGES - 1);
    cma_gen::cp_async_commit();
    const int slot = st % STAGES;
    math.stage(sm.a[slot], sm.b[slot], sm.d[slot], st * BK, n, tid);
  }
  cma_gen::cp_async_wait<0>();
  __syncthreads();

  // F groups kept for the block to finish: [TILE_ROWS][TILE_COLS / 8]
  T* red = reinterpret_cast<T*>(smem_raw);
  math.template epilogue<EPI>(
      a, g, r0, r1, j0, tid, [&](int r, int gi, T s) {
        put_group(a, red, r0, r1, r,
                  blockIdx.x * (TILE_COLS / STREAM_COLS) + gi, gi, s);
      });
  if constexpr (EPI == E_EVAL) {
    if (gridDim.x == 1) {
      __syncthreads();
      if (tid < r1 - r0)
        finish_f(a, g, r0 + tid, red + tid * (TILE_COLS / STREAM_COLS),
                 cdiv(n, STREAM_COLS));
    }
  }
}

// ---------------------------------------------------------------------------
// stream plan
// ---------------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr size_t stream_smem_bytes(int mtiles) {
  return sizeof(T) * static_cast<size_t>(S_STAGES) *
         ((16 * mtiles + STREAM_COLS) * SLD + KC);
}

// Warp w's 16 rows of the group against the block's STREAM_COLS rows of B,
// over all of k, in the tile plan's steps (float64: one DMMA per 16 columns
// of k; float32: lane (rq, j) keeps rows rq, rq + 4, rq + 8, rq + 12 against
// column j, one FFMA per column of k).
template <typename T>
struct StreamMath;

template <>
struct StreamMath<double> {
  double acc[4] = {};
  __device__ __forceinline__ void chunk(const double* zs, const double* bs,
                                        const double* ds, int k0, int n,
                                        int warp, int lane) {
#pragma unroll
    for (int kc = 0; kc < KC; kc += KSTEP)
      if (k0 + kc < n) dmma_step(acc, zs, bs, ds, SLD, 16 * warp, 0, kc, lane);
  }
  template <int EPI>
  __device__ __forceinline__ void epilogue(const SampleArgs<double>& a, int g,
                                           int r0, int r1, int j0, int warp,
                                           int lane) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 16 * warp + (lane >> 2) + 8 * h;
      const int j = j0 + 2 * (lane & 3);
      const double t0 = emit_in<double, EPI>(a, g, r, r1, j, acc[2 * h]);
      const double t1 = emit_in<double, EPI>(a, g, r, r1, j + 1,
                                             acc[2 * h + 1]);
      if constexpr (EPI == E_EVAL) {
        const double s = group_sum(t0, t1);
        if ((lane & 3) == 0)
          put_group(a, static_cast<double*>(nullptr), r0, r1, r, blockIdx.x,
                    0, s);
      }
    }
  }
};

template <>
struct StreamMath<float> {
  float acc[4] = {};
  __device__ __forceinline__ void chunk(const float* zs, const float* bs,
                                        const float* ds, int k0, int n,
                                        int warp, int lane) {
    const int j = lane & 7;
    const float* z = zs + (16 * warp + (lane >> 3)) * SLD;
    const float* b = bs + j * SLD;
#pragma unroll
    for (int kc = 0; kc < KC; kc += KSTEP) {
      if (k0 + kc >= n) break;
#pragma unroll
      for (int kk = kc; kk < kc + KSTEP; ++kk) {
        const float bv = b[kk];
        const float dk = ds[kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float av = z[4 * q * SLD + kk] * dk;
          acc[q] += av * bv;
        }
      }
    }
  }
  template <int EPI>
  __device__ __forceinline__ void epilogue(const SampleArgs<float>& a, int g,
                                           int r0, int r1, int j0, int warp,
                                           int lane) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + 16 * warp + (lane >> 3) + 4 * q;
      const float t = emit_in<float, EPI>(a, g, r, r1, j0 + (lane & 7),
                                          acc[q]);
      if constexpr (EPI == E_EVAL) {
        const float s = group_sum(t);
        if ((lane & 7) == 0)
          put_group(a, static_cast<float*>(nullptr), r0, r1, r, blockIdx.x,
                    0, s);
      }
    }
  }
};

template <typename T, int EPI, bool WIDE>
__global__ void __launch_bounds__(S_MAX_THREADS)
    stream_kernel(const SampleArgs<T> a) {
  constexpr int VEC = WIDE ? 16 / sizeof(T) : 1;
  constexpr int BYTES = VEC * sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int zrows = 16 * a.mtiles;
  T* zs = reinterpret_cast<T*>(smem_raw);        // [S_STAGES][zrows][SLD]
  T* bs = zs + S_STAGES * zrows * SLD;           // [S_STAGES][STREAM_COLS][SLD]
  T* ds = bs + S_STAGES * STREAM_COLS * SLD;     // [S_STAGES][KC]
  const int g = a.tiles[3 * blockIdx.y];
  const int r0 = a.tiles[3 * blockIdx.y + 1];
  const int r1 = a.tiles[3 * blockIdx.y + 2];
  const int n = a.n;
  const int j0 = blockIdx.x * STREAM_COLS;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const T* Bg = a.B + static_cast<size_t>(g) * n * n;
  const T* Dg = a.D + static_cast<size_t>(g) * n;
  // the block's rows of B are read once, in small stages: ask L2 for all
  // of them first, so that the ring waits on L2 and not on device memory
  if constexpr (WIDE) {
    if (tid < STREAM_COLS && j0 + tid < n) {
      const T* row = Bg + static_cast<size_t>(j0 + tid) * n;
      const unsigned bytes = static_cast<unsigned>(n * sizeof(T)) & ~15u;
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(row),
                   "r"(bytes)
                   : "memory");
    }
  }

  // This thread's copies of a stage, as in tile_kernel: the slab rows
  // base_i + q rstep below zrows (Z) and below STREAM_COLS (B), all at
  // column kk
  constexpr int MAX_CZ = 16 * 6 * KC / (S_MIN_THREADS * VEC);
  const int rstep = nt * VEC / KC;
  const int base_i = tid * VEC / KC;
  const int kk = tid * VEC % KC;
  int zoff[MAX_CZ], boff[STREAM_COLS];
#pragma unroll
  for (int q = 0; q < MAX_CZ; ++q) {
    const int r = r0 + base_i + q * rstep;
    zoff[q] = r < r1 ? r * n + kk : -1;
  }
#pragma unroll
  for (int q = 0; q < STREAM_COLS; ++q) {
    const int j = j0 + base_i + q * rstep;
    boff[q] = j < n ? j * n + kk : -1;
  }

  auto issue = [&](int st) {
    const int slot = st % S_STAGES;
    const int k0 = st * KC;
    const bool kok = k0 + kk < n;
    T* z = zs + (slot * zrows + base_i) * SLD + kk;
    T* b = bs + (slot * STREAM_COLS + base_i) * SLD + kk;
#pragma unroll
    for (int q = 0; q < MAX_CZ; ++q) {
      if (base_i + q * rstep >= zrows) break;
      const bool ok = kok && zoff[q] >= 0;
      cma_gen::cp_async<BYTES>(z + q * rstep * SLD,
                               ok ? a.Z + zoff[q] + k0 : a.Z, ok);
    }
#pragma unroll
    for (int q = 0; q < STREAM_COLS; ++q) {
      if (base_i + q * rstep >= STREAM_COLS) break;
      const bool ok = kok && boff[q] >= 0;
      cma_gen::cp_async<BYTES>(b + q * rstep * SLD, ok ? Bg + boff[q] + k0 : Bg,
                               ok);
    }
    if (tid * VEC < KC) {
      const int k = k0 + tid * VEC;
      cma_gen::cp_async<BYTES>(ds + slot * KC + tid * VEC, k < n ? Dg + k : Dg,
                               k < n);
    }
  };

  const int nst = cdiv(n, KC);
  StreamMath<T> math;
#pragma unroll
  for (int p = 0; p < S_STAGES - 1; ++p) {
    if (p < nst) issue(p);
    cma_gen::cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cma_gen::cp_async_wait<S_STAGES - 2>();
    __syncthreads();
    if (st + S_STAGES - 1 < nst) issue(st + S_STAGES - 1);
    cma_gen::cp_async_commit();
    const int slot = st % S_STAGES;
    if (tid < 32 * a.mtiles)
      math.chunk(zs + slot * zrows * SLD, bs + slot * STREAM_COLS * SLD,
                 ds + slot * KC, st * KC, n, tid >> 5, tid & 31);
  }
  cma_gen::cp_async_wait<0>();
  if (tid < 32 * a.mtiles)
    math.template epilogue<EPI>(a, g, r0, r1, j0, tid >> 5, tid & 31);
}

// F[r] from one partial per F group: the groups added in ascending order.
template <typename T>
__global__ void eval_reduce_kernel(const SampleArgs<T> a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.rows) return;
  const int groups = cdiv(a.n, STREAM_COLS);
  T s = T(0);
  for (int q = 0; q < groups; ++q)
    s += a.Fpart[static_cast<size_t>(q) * a.rows + r];
  const int g = r / a.lam;
  a.F[r] = a.valid[g] ? s + a.fopt[g] : static_cast<T>(NAN);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T, int EPI, bool WIDE, int ZSRC>
int launch_plan(const SampleArgs<T>& a, cudaStream_t stream, int& col_blocks) {
  int err;
  if (a.kind == K_TILE) {
    constexpr auto tile = tile_kernel<T, EPI, WIDE, ZSRC>;
    const size_t smem = sizeof(TileSmem<T>);
    if ((err = cma_gen::set_smem<tile>(smem)) != 0) return err;
    col_blocks = cdiv(a.n, TILE_COLS);
    tile<<<dim3(col_blocks, a.ntiles), TileMath<T>::THREADS, smem, stream>>>(
        a);
  } else if constexpr (ZSRC == Z_LOAD) {
    const size_t smem = stream_smem_bytes<T>(a.mtiles);
    if ((err = cma_gen::set_smem<stream_kernel<T, EPI, WIDE>>(smem)) != 0)
      return err;
    col_blocks = cdiv(a.n, STREAM_COLS);
    stream_kernel<T, EPI, WIDE>
        <<<dim3(col_blocks, a.ntiles),
           a.mtiles <= 4 ? S_MIN_THREADS : S_MAX_THREADS, smem, stream>>>(a);
  }
  return cma_gen::launch_status();
}

// One call of the plan a.kind with Z from ZSRC (one launch, or two for
// E_EVAL with more than one column block); the draw policy runs only in the
// tile plan where draws_z(n).
template <typename T, int EPI, int ZSRC = Z_LOAD>
int launch_sample(SampleArgs<T> a, cudaStream_t stream) {
  if (a.ntiles == 0) return 0;
  // copies address Z and B by int element offsets
  if (static_cast<long long>(a.rows) * a.n >= (1LL << 31) ||
      static_cast<long long>(a.n) * a.n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.kind == K_STREAM) {
    if (a.tile_rows < 1 || a.tile_rows > STREAM_ROWS)
      return static_cast<int>(cudaErrorInvalidValue);
    a.mtiles = cdiv(a.tile_rows, 16);
  } else if (a.kind != K_TILE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ZSRC == Z_DRAW && (a.kind != K_TILE || !draws_z(a.n) ||
                        a.seeds == nullptr || a.lam < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = a.n % (16 / sizeof(T)) == 0 && aligned16(a.Z) &&
                    aligned16(a.B) && aligned16(a.D);
  int cols = 0;
  const int err = wide ? launch_plan<T, EPI, true, ZSRC>(a, stream, cols)
                       : launch_plan<T, EPI, false, ZSRC>(a, stream, cols);
  if (err != 0) return err;
  if constexpr (EPI == E_EVAL) {
    if (cols > 1) {
      if (a.Fpart == nullptr || a.lam < 1)
        return static_cast<int>(cudaErrorInvalidValue);
      eval_reduce_kernel<T><<<cdiv(a.rows, 256), 256, 0, stream>>>(a);
      return cma_gen::launch_status();
    }
  }
  return 0;
}

// The arguments every entry point shares; the outputs are set by the caller.
template <typename T>
SampleArgs<T> sample_args(const T* m, const T* sigma, const T* B, const T* D,
                          const T* Z, const int* tiles, int ntiles, int rows,
                          int n, int kind, int tile_rows) {
  SampleArgs<T> a = {};
  a.m = m;
  a.sigma = sigma;
  a.B = B;
  a.D = D;
  a.Z = Z;
  a.tiles = tiles;
  a.ntiles = ntiles;
  a.rows = rows;
  a.n = n;
  a.kind = kind;
  a.tile_rows = tile_rows;
  return a;
}

}  // namespace cma_sample_gemm
