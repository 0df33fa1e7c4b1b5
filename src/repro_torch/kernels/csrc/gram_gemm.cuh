// The weighted gram Y^T diag(w) Y of the CMA-ES covariance updates, split
// over population rows, shared by cma_gen_update.cu (row 6) and
// cma_update.cu (row 8).
//
// gram_kernel runs one block per (upper-triangle 64 x 64 tile of the gram,
// chunk of population rows, slot); the wrapper cuts the chunks
// (cma_gen.update_plan) so that at least 132 blocks are in flight.  A block
// first lists its chunk's rows of non-zero weight in order (a ballot scan
// in shared memory), so the weighted rows, scattered through Y in sample
// order, are the only rows it stages: zero-weight rows cost nothing and
// change nothing.  Y slabs of 16 listed rows come in by cp.async (16 bytes
// a copy where n keeps rows aligned) into a ring of three stages.  float64
// tiles run on the FP64 tensor cores (DMMA, mma.sync m16n8k16: four warps
// of 32 x 32), with w applied to the A fragment in registers as it is (any
// sign of weight is taken); float32 stays on FFMA (TF32 would miss the
// 1e-4 tolerance) over the same slabs.  With YW, a block on a diagonal tile
// also sums w Y over its 64 columns (row 6's y_w: the gram against the
// sqrt(w) column, at no separate walk).  Each block hands its partial
// tile (and partial y_w) to an output policy: ToScratch writes them to
// scratch; where one chunk holds every row, a caller's policy may write
// its final values from the registers instead.
//
// epilogue_tile then sums a tile's partials in chunk order, asks the
// caller for each value with i <= j and writes it to (i, j) and (j, i): the
// result is exactly symmetric.  No atomics: a second launch gives the same
// bits.
#pragma once

#include "cma_gen_common.cuh"

namespace gram {

using cma_gen::cp_async;
using cma_gen::cp_async_commit;
using cma_gen::cp_async_wait;
using cma_gen::dmma;
using cma_gen::DMMA_K;

// These constants are mirrored by cma_gen.update_plan.
constexpr int BT = 64;                // edge of a gram tile
constexpr int BK = 16;                // listed population rows per stage
constexpr int STAGES = 3;             // cp.async ring depth
constexpr int LD = BT + 4;            // slab row pitch: conflict-free DMMA
constexpr int MAX_CHUNK_ROWS = 1024;  // population rows a chunk may hold
constexpr int EPI_THREADS = 256;

template <typename T>
struct GramSmem {
  T a[STAGES][BK][LD];
  T b[STAGES][BK][LD];
  T wl[MAX_CHUNK_ROWS];               // weights of the listed rows
  int idx[MAX_CHUNK_ROWS];            // the listed rows, ascending
  int warp_tot[32];
};

__device__ __forceinline__ void tile_of(int tile, int nt, int& bi, int& bj) {
  bi = 0;
  while (tile >= nt - bi) {
    tile -= nt - bi;
    ++bi;
  }
  bj = bi + tile;
}

// Lists the rows of [r0, r1) with non-zero weight, ascending, into sm.idx
// and sm.wl; pads sm.wl with zeros to a whole stage; returns the count.
template <typename T>
__device__ int list_rows(const T* __restrict__ ws, int r0, int r1,
                         GramSmem<T>& sm) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  int base = 0;
  for (int g = r0; g < r1; g += blockDim.x) {
    const int r = g + tid;
    const T wr = r < r1 ? ws[r] : T(0);
    const bool keep = wr != T(0);
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) sm.warp_tot[warp] = __popc(m);
    __syncthreads();
    int off = base;
    for (int q = 0; q < warp; ++q) off += sm.warp_tot[q];
    off += __popc(m & ((1u << lane) - 1u));
    if (keep) {
      sm.idx[off] = r;
      sm.wl[off] = wr;
    }
    for (int q = 0; q < nw; ++q) base += sm.warp_tot[q];
    __syncthreads();
  }
  const int padded = cma_gen::cdiv(base, BK) * BK;
  for (int q = base + tid; q < padded; q += blockDim.x) sm.wl[q] = T(0);
  __syncthreads();
  return base;
}

// One block's 64 x 64 tile of the gram, accumulated stage by stage from
// the slabs As (rows of the tile's i columns) and Bs (its j columns) with
// the stage's weights w.  float64: four warps, each a 32 x 32 quarter in
// DMMA 16 x 8 tiles; float32: 16 x 16 threads, each 4 x 4 values on FFMA.
template <typename T>
struct GramTile;

template <>
struct GramTile<double> {
  static constexpr int THREADS = 128;
  double acc[2][4][4] = {};

  __device__ __forceinline__ void stage(const double (*As)[LD],
                                        const double (*Bs)[LD],
                                        const double* w, int tid) {
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wr = (tid >> 6) * 32;
    const int wc = ((tid >> 5) & 1) * 32;
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += DMMA_K) {
      double a[2][DMMA_K / 2], b[4][DMMA_K / 4];
#pragma unroll
      for (int i = 0; i < DMMA_K / 2; ++i) {
        const int kk = k0 + t + 4 * (i / 2);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          a[mi][i] = As[kk][wr + 16 * mi + g + 8 * (i % 2)] * w[kk];
      }
#pragma unroll
      for (int i = 0; i < DMMA_K / 4; ++i)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          b[ni][i] = Bs[k0 + t + 4 * i][wc + 8 * ni + g];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) dmma(acc[mi][ni], a[mi], b[ni]);
    }
  }

  // Calls f(r, c, value) for each entry (r, c) of the tile this thread
  // holds.
  template <typename F>
  __device__ __forceinline__ void each(int tid, F&& f) const {
    const int lane = tid & 31;
    const int wr = (tid >> 6) * 32 + (lane >> 2);
    const int wc = ((tid >> 5) & 1) * 32 + 2 * (lane & 3);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f(wr + 16 * mi + 8 * (e / 2), wc + 8 * ni + e % 2,
            acc[mi][ni][e]);
  }
};

template <>
struct GramTile<float> {
  static constexpr int THREADS = 256;
  float acc[4][4] = {};

  __device__ __forceinline__ void stage(const float (*As)[LD],
                                        const float (*Bs)[LD],
                                        const float* w, int tid) {
    const int tx = tid % 16;
    const int ty = tid / 16;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = As[kk][ty + 16 * a] * w[kk];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[kk][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += av[a] * bv[b];
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(int tid, F&& f) const {
    const int tx = tid % 16;
    const int ty = tid / 16;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) f(ty + 16 * a, tx + 16 * b, acc[a][b]);
  }
};

// Where a gram block's result goes: its partial tile to Gp (S, chunks,
// tiles, BT, BT) and, with YW on a diagonal tile, its partial y_w to Yp
// (S, chunks, n); only entries inside n x n are written.
template <typename T, bool YW>
struct ToScratch {
  T* Gp;
  T* Yp;

  __device__ __forceinline__ void operator()(const GramTile<T>& gram, T yw,
                                             int s, int ch, int i0, int j0,
                                             bool diag, int n,
                                             int tid) const {
    const size_t blk = (static_cast<size_t>(s) * gridDim.y + ch) * gridDim.x
                       + blockIdx.x;
    T* out = Gp + blk * BT * BT;
    gram.each(tid, [&](int r, int c, T v) {
      if (i0 + r < n && j0 + c < n) out[r * BT + c] = v;
    });
    if (YW && diag && tid < BT && i0 + tid < n)
      Yp[(static_cast<size_t>(s) * gridDim.y + ch) * n + i0 + tid] = yw;
  }
};

// Partial gram (and with YW, on diagonal tiles, partial y_w) of one tile
// over one chunk of population rows, handed to out (ToScratch, or with one
// chunk the caller's epilogue) with the block's slot, chunk and tile.
template <typename T, bool WIDE, bool YW, typename Out>
__global__ void __launch_bounds__(GramTile<T>::THREADS) gram_kernel(
    const T* __restrict__ Y, const T* __restrict__ w, Out out, int lam,
    int n, int nt, int chunk_rows) {
  constexpr int NT = GramTile<T>::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GramSmem<T>& sm = *reinterpret_cast<GramSmem<T>*>(smem_raw);
  const int tile = blockIdx.x;
  const int ch = blockIdx.y;
  const int s = blockIdx.z;
  int bi, bj;
  tile_of(tile, nt, bi, bj);
  const bool diag = bi == bj;
  const int i0 = bi * BT;
  const int j0 = bj * BT;
  const int tid = threadIdx.x;
  const T* Ys = Y + static_cast<size_t>(s) * lam * n;
  const int r0 = ch * chunk_rows;
  const int r1 = min(lam, r0 + chunk_rows);
  const int cnt = list_rows(w + static_cast<size_t>(s) * lam, r0, r1, sm);
  const int nst = cma_gen::cdiv(cnt, BK);

  // VEC elements a copy: 16 bytes when n keeps every row 16-byte aligned
  constexpr int VEC = WIDE ? 16 / sizeof(T) : 1;
  auto issue = [&](int st) {
    const int slot = st % STAGES;
    for (int e = tid * VEC; e < BK * BT; e += NT * VEC) {
      const int kk = e / BT;
      const int c = e % BT;
      const int q = st * BK + kk;
      const bool row_ok = q < cnt;
      const T* row = Ys + (row_ok ? static_cast<size_t>(sm.idx[q]) * n : 0);
      const bool a_ok = row_ok && i0 + c < n;
      cp_async<VEC * sizeof(T)>(&sm.a[slot][kk][c], a_ok ? row + i0 + c : Ys,
                                a_ok);
      if (!diag) {
        const bool b_ok = row_ok && j0 + c < n;
        cp_async<VEC * sizeof(T)>(&sm.b[slot][kk][c],
                                  b_ok ? row + j0 + c : Ys, b_ok);
      }
    }
  };

  GramTile<T> gram;
  T yw_acc = T(0);
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nst) issue(p);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (st + STAGES - 1 < nst) issue(st + STAGES - 1);
    cp_async_commit();
    const int slot = st % STAGES;
    const T* wst = sm.wl + st * BK;
    gram.stage(sm.a[slot], diag ? sm.a[slot] : sm.b[slot], wst, tid);
    if (YW && diag && tid < BT) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) yw_acc += wst[kk] * sm.a[slot][kk][tid];
    }
  }
  cp_async_wait<0>();
  out(gram, yw_acc, s, ch, i0, j0, diag, n, tid);
}

// Launches gram_kernel over (tiles, chunks, S), 16-byte copies where n
// keeps every row aligned.
template <typename T, bool YW, typename Out>
int launch_gram(const T* Y, const T* w, Out out, int S, int lam, int n,
                int chunk_rows, int chunks, cudaStream_t stream) {
  const int nt = cma_gen::cdiv(n, BT);
  const size_t gsm = sizeof(GramSmem<T>);
  const dim3 grid(nt * (nt + 1) / 2, chunks, S);
  int err;
  if (n % (16 / sizeof(T)) == 0) {
    if ((err = cma_gen::set_smem<gram_kernel<T, true, YW, Out>>(gsm)) != 0)
      return err;
    gram_kernel<T, true, YW, Out>
        <<<grid, GramTile<T>::THREADS, gsm, stream>>>(Y, w, out, lam, n, nt,
                                                      chunk_rows);
  } else {
    if ((err = cma_gen::set_smem<gram_kernel<T, false, YW, Out>>(gsm)) != 0)
      return err;
    gram_kernel<T, false, YW, Out>
        <<<grid, GramTile<T>::THREADS, gsm, stream>>>(Y, w, out, lam, n, nt,
                                                      chunk_rows);
  }
  return cma_gen::launch_status();
}

// The plan's arguments as the kernels take them: chunks of whole stages
// that cover lam and fit a block's row list, and chunk lanes that divide
// the epilogue's threads.
inline bool plan_ok(int lam, int chunk_rows, int chunks, int lanes) {
  return chunk_rows <= MAX_CHUNK_ROWS && chunk_rows % BK == 0 &&
         chunks >= 1 && static_cast<long long>(chunks) * chunk_rows >= lam &&
         lanes >= 1 && EPI_THREADS % lanes == 0;
}

// The grid of an epilogue over the gram's tiles: EPI_THREADS / lanes
// elements of one tile a block.
inline dim3 epilogue_grid(int n, int lanes, int S) {
  const int nt = cma_gen::cdiv(n, BT);
  return dim3(nt * (nt + 1) / 2, cma_gen::cdiv(BT * BT, EPI_THREADS / lanes),
              S);
}

// The body of an epilogue block (grid from epilogue_grid, EPI_THREADS
// threads): EPI_THREADS / lanes elements of one tile, each summed over the
// partial tiles in chunk order (lane l takes chunks l, l + lanes, ...),
// then the lanes in order.  value(s, i, j, g) gives C'[s, i, j] for each
// element with i <= j < n; it is written to (i, j) and to (j, i).  With
// STAGED (lanes <= 2: a block holds two or more whole rows of the tile)
// the mirror is staged in shared memory and written a column of the
// block's rows at a time, consecutive threads on consecutive addresses.
template <bool STAGED, typename T, typename Value>
__device__ __forceinline__ void epilogue_tile(const T* __restrict__ Gp,
                                              T* __restrict__ Cn, int n,
                                              int chunks, int lanes,
                                              Value&& value) {
  __shared__ T part[EPI_THREADS];
  const int tile = blockIdx.x;
  const int s = blockIdx.z;
  const int tiles = gridDim.x;
  int bi, bj;
  tile_of(tile, cma_gen::cdiv(n, BT), bi, bj);
  const int epb = EPI_THREADS / lanes;
  const int e0 = blockIdx.y * epb;
  if (bi * BT + e0 / BT >= n) return;          // the whole block is past n
  const int tid = threadIdx.x;
  const int e = e0 + tid % epb;
  const int l = tid / epb;
  const int i = bi * BT + e / BT;
  const int j = bj * BT + e % BT;
  const bool ok = e < BT * BT && i < n && j < n && i <= j;
  T g = T(0);
  if (ok) {
    const T* gp =
        Gp + (static_cast<size_t>(s) * chunks * tiles + tile) * BT * BT + e;
    for (int ch = l; ch < chunks; ch += lanes)
      g += gp[static_cast<size_t>(ch) * tiles * BT * BT];
  }
  part[tid] = g;
  __syncthreads();
  const size_t o = static_cast<size_t>(s) * n;
  if constexpr (!STAGED) {
    if (l != 0 || !ok) return;
    for (int q = 1; q < lanes; ++q) g += part[tid + q * epb];
    const T v = value(s, i, j, g);
    Cn[(o + i) * n + j] = v;
    Cn[(o + j) * n + i] = v;
  } else {
    if (l == 0 && ok) {
      for (int q = 1; q < lanes; ++q) g += part[tid + q * epb];
      const T v = value(s, i, j, g);
      Cn[(o + i) * n + j] = v;
      part[tid] = v;
    }
    __syncthreads();
    const int rows = epb / BT;
    for (int q = tid; q < epb; q += EPI_THREADS) {
      const int et = (q % rows) * BT + q / rows;  // row q % rows, col q / rows
      const int it = bi * BT + (e0 + et) / BT;
      const int jt = bj * BT + (e0 + et) % BT;
      if (it < n && jt < n && it < jt) Cn[(o + jt) * n + it] = part[et];
    }
  }
}

}  // namespace gram
