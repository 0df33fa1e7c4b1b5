// Backward of the chunked RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package differentiates
// repro/models/rwkv6.py::wkv_chunked with autodiff of its chunk scan; the
// port's forward is a CUDA kernel (rwkv6_wkv.cu), so its gradient is one
// too.  Per (b, h), with CHUNK = 16 tokens a chunk and, inside a chunk,
//
//   Lc_t = sum_{s<=t} logw_s,  Lp_t = Lc_t - logw_t,  Ll = Lc_15,
//   qt_t = r_t e^{Lp_t},  ki_t = k_t e^{-Lc_t},  ko_t = k_t e^{Ll - Lc_t},
//   A_tj = qt_t . ki_j (j < t),  bonus_t = sum_d r_t u k_t,
//   o_t  = sum_{j<t} A_tj v_j + bonus_t v_t + qt_t S,
//   S'   = diag(e^{Ll}) S + sum_j ko_j (x) v_j,
//
// (repro/models/rwkv6.py's chunk body, term for term) it computes dr, dk,
// dv (the inputs' type), dlogw and du (f32) and d(initial state) (f32)
// from do and an optional d(final state), by the chain rule through the
// same terms, chunk by chunk in reverse:
//
//   dA_tj = do_t . v_j,  dbonus_t = do_t . v_t,
//   dqt_t = sum_{j<t} dA_tj ki_j + S do_t,   dki_j = sum_{t>j} dA_tj qt_t,
//   dko_j = dS' v_j,   dv_j = sum_{t>j} A_tj do_t + bonus_j do_j + dS'^T ko_j,
//   dS    = diag(e^{Ll}) dS' + sum_t qt_t (x) do_t,
//
// then dr, dk, du from qt, ki, ko and the bonus, and dlogw from the
// exponents (dLc_t = dLp_t - dki_t ki_t - dko_t ko_t, plus dLl =
// e^{Ll} sum_c dS' S + sum_t dko_t ko_t on every token; dlogw_t =
// sum_{s>=t} dLc_s - dLp_t + dLl).
//
// What bounds it: one read of r, k, v, do (bf16 or f32) and logw (f32)
// and one write of the gradients; at rwkv6-3b's training shape (B = 4,
// S = 1024, H = 40, D = 64) 231 MB in bf16, 0.069 ms at 3.35 TB/s (the
// scratch below is not counted), against, per token, the state
// recurrence again (2 D^2 FLOP), the S and dS products of dqt, dko, dv
// and dS (8 D^2) and the chunk's pair terms (160 D): 8.4 GFLOP of f32 FMA
// work, 0.125 ms at 67 TFLOP/s.  The chunks of a (b, h) pair are a
// sequential chain: the time is the length of one chunk step times the
// number of chunks, and how many chains share an SM.
//
// Three launches a call:
//
// 1. wkv_bwd_pairs_kernel, one block per (b*h, chunk), all chunks at once:
//    the terms that depend on no state.  A and dA (zero on and above the
//    diagonal) as 4 x 4 register tiles over an eighth of the dims a lane,
//    the bonus and dbonus, and dA's shares of dqt and dki, sum_j dA_tj
//    ki_j and sum_s dA_st qt_s, for every key dim.  A, the bonus and
//    dbonus (C^2 + 2 C floats a chunk, 12 MB at the training shape) and
//    the two shares (2 C D floats a chunk, 84 MB) go to a scratch.
// 2. wkv_bwd_sweep_kernel: the state recurrence S' = diag(w) S + k (x) v
//    scales the state's rows (key dims), so each row evolves alone, and
//    dr, dk, dlogw, du and dS_0 of a key dim are sums over value columns
//    of its own row.  A head is split over D/16 blocks of 16 key dims
//    each (640 at the training shape, against 160 for a block a head),
//    one thread-block cluster a head.  A block first runs the recurrence
//    of its 16 rows forward and writes each chunk's entry rows to a
//    scratch (B H S/16 D D f32 in all: 168 MB at the training shape, one
//    layer's backward at a time; the forward saves only its inputs), then
//    sweeps the chunks in reverse with its 16 x D slice of dS in
//    registers: dko, the state's share of dqt and the e^{Ll} dS' . S of
//    dLl per key dim (4 key dims x 2 tokens a thread over a quarter of the
//    columns, summed over four lanes by shuffles), the slice's share of
//    dv, the dS update, and the outputs of its key dims with the state-
//    free terms of launch 1.  Only
//    dv crosses the split (dS'^T ko sums over every key dim): each block
//    leaves its share of a chunk's dv in its shared memory, and after a
//    cluster barrier block q sums value columns [16 q, 16 q + 16) of the
//    D/16 shares, through distributed shared memory in rank order, onto
//    the state-free A and bonus terms.  The split over value columns (the
//    forward's) would instead leave dqt, dki, dko and dbonus to be summed
//    across blocks.  Each chunk's logw, k (and in reverse r, its entry
//    rows and pair terms) come in by cp.async into the other half of a
//    two-stage ring while the chunk before computes, its v (and do) by
//    loads into registers; a reverse step passes two block barriers and
//    one cluster barrier.  What limits it: every product reads its
//    operands from shared memory, so the shared memory's wavefronts and
//    the instruction slots of the three blocks an SM set the time (timed
//    per section on an H100); each product step reads whole float4s
//    without bank conflicts (see Sweep).  168 registers a thread (three blocks an SM) beat 128 (four)
//    and 96 (five), which spill.
// 3. du_reduce_kernel: du (H, D), the per-(b, h) sums added over b in b
//    order.
//
// All the state's arithmetic stays in f32 FMAs: its chunk exponentials
// reach e^80.  Every sum runs in a fixed order and nothing is atomic: a
// second launch gives the same bits.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cma_gen_common.cuh"

namespace cg = cooperative_groups;

namespace {

using cma_gen::cp_async;
using cma_gen::cp_async_commit;
using cma_gen::cp_async_wait;

constexpr int C = 16;          // tokens per chunk
constexpr int KD = 16;         // key dims (rows of the state) per block
constexpr int NT = 128;        // threads per sweep block
constexpr int PT = 256;        // threads per pair block: 2 x 16 tiles x 8
// A chunk's pair terms, floats: A [C][C] (zero on and above the
// diagonal), the bonus and dbonus [C]
constexpr int P_BON = C * C;
constexpr int P_DBON = P_BON + C;
constexpr int PAIR = P_DBON + C;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// ---- launch 1: the state-free pair terms -------------------------------------

// 4 consecutive values as floats
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ void put4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// Shared memory, in floats: r, k, v, do, logw (then Lp), Lc (then qt) and
// ki of the chunk (16 rows of D + 4), u, and dA and its transpose (16 rows
// of 20).
template <int D>
struct PairSmem {
  static constexpr int P = D + 4;
  static constexpr int R = 0, K = R + C * P, V = K + C * P, DO = V + C * P;
  static constexpr int W = DO + C * P, QT = W + C * P, KI = QT + C * P;
  static constexpr int U = KI + C * P;
  static constexpr int DA = U + D, DAT = DA + C * 20;
  static constexpr int BYTES = (DAT + C * 20) * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(PT, 3) wkv_bwd_pairs_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const T* __restrict__ dout,
    float* __restrict__ pairs, float* __restrict__ sfree, int S, int H) {
  using L = PairSmem<D>;
  constexpr int P = L::P;
  extern __shared__ float pm[];
  const int ch = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const size_t base = ((static_cast<size_t>(b) * S + ch * C) * H + h) * D;
  for (int e = tid; e < C * D / 4; e += PT) {
    const int t = 4 * e / D, d = 4 * e % D;
    const size_t g = base + static_cast<size_t>(t) * H * D + d;
    put4(pm + L::R + t * P + d, ld4(r + g));
    put4(pm + L::K + t * P + d, ld4(k + g));
    put4(pm + L::V + t * P + d, ld4(v + g));
    put4(pm + L::DO + t * P + d, ld4(dout + g));
    put4(pm + L::W + t * P + d, ld4(logw + g));
  }
  if (tid < D) pm[L::U + tid] = u[h * D + tid];
  __syncthreads();
  // the cumulative log-decays of each key dim in token order: Lp into W,
  // Lc into QT
  if (tid < D) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float w = pm[L::W + t * P + tid];
      acc += w;
      pm[L::W + t * P + tid] = acc - w;
      pm[L::QT + t * P + tid] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < C * D; e += PT) {
    const int t = e / D, d = e % D;
    const float lc = pm[L::QT + t * P + d];
    pm[L::QT + t * P + d] = pm[L::R + t * P + d] * expf(pm[L::W + t * P + d]);
    pm[L::KI + t * P + d] = pm[L::K + t * P + d] * expf(-lc);
  }
  __syncthreads();
  // every pair (t, j) as 4 x 4 tiles: thread: product p (0: A from qt
  // and ki, 1: dA from do and v), tile (t0, j0), and the float4 columns
  // 4 kq + 32 s of its lane kq, summed over the eight lanes by halving
  // shuffles; kept below the diagonal (dA's diagonal is dbonus)
  const int p = tid >> 7, kq = tid & 7;
  const int t0 = 4 * ((tid >> 5) & 3), j0 = 4 * ((tid >> 3) & 3);
  const float* ra = pm + (p ? L::DO : L::QT);
  const float* rb = pm + (p ? L::V : L::KI);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int d = 4 * kq; d < D; d += 32) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = ld4(ra + (t0 + i) * P + d);
      y[i] = ld4(rb + (j0 + i) * P + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += dot4(x[i], y[j]);
  }
  // lane bit 2 keeps rows t0 + 2, 3 (else 0, 1), bit 1 the odd row of the
  // pair, bit 0 columns j0 + 2, 3 (else 0, 1)
  const bool b2 = kq & 4, b1 = kq & 2, b0 = kq & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float send = b2 ? acc[i][j] : acc[i + 2][j];
      const float keep = b2 ? acc[i + 2][j] : acc[i][j];
      acc[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = b1 ? acc[0][j] : acc[1][j];
    const float keep = b1 ? acc[1][j] : acc[0][j];
    acc[0][j] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = b0 ? acc[0][j] : acc[0][j + 2];
    const float keep = b0 ? acc[0][j + 2] : acc[0][j];
    acc[0][j] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
  }
  const size_t chunk = static_cast<size_t>(bh) * (S / C) + ch;
  float* out = pairs + chunk * PAIR;
  const int t = t0 + 2 * b2 + b1;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = j0 + 2 * b0 + jj;
    const float x = j < t ? acc[0][jj] : 0.f;
    if (p == 0) {
      out[t * C + j] = x;
    } else {
      pm[L::DA + t * 20 + j] = x;
      pm[L::DAT + j * 20 + t] = x;
      if (j == t) out[P_DBON + t] = acc[0][jj];
    }
  }
  if (tid < C) {
    float bon = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 x = ld4(pm + L::R + tid * P + d);
      const float4 y = ld4(pm + L::U + d);
      const float4 z = ld4(pm + L::K + tid * P + d);
      bon += x.x * y.x * z.x + x.y * y.y * z.y + x.z * y.z * z.z
             + x.w * y.w * z.w;
    }
    out[P_BON + tid] = bon;
  }
  __syncthreads();
  // dA's shares of dqt and dki, for every key dim: sf[0][t][d] =
  // sum_j dA_tj ki_j[d], sf[1][t][d] = sum_s dA_st qt_s[d]; thread: one of
  // the two, tokens 4 tg .. 4 tg + 3, key dims 2 dp, 2 dp + 1
  {
    const int tg = (tid >> 5) & 3;
    const float* w = pm + (p ? L::DA : L::DAT);
    const float* m = pm + (p ? L::QT : L::KI);
    float* sf = sfree + (2 * chunk + p) * C * D;
    for (int dp = tid & 31; dp < D / 2; dp += 32) {
      float a[4][2] = {};
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float4 w4 = ld4(w + j * 20 + 4 * tg);
        const float2 m2 = *reinterpret_cast<const float2*>(m + j * P + 2 * dp);
        a[0][0] += w4.x * m2.x; a[0][1] += w4.x * m2.y;
        a[1][0] += w4.y * m2.x; a[1][1] += w4.y * m2.y;
        a[2][0] += w4.z * m2.x; a[2][1] += w4.z * m2.y;
        a[3][0] += w4.w * m2.x; a[3][1] += w4.w * m2.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float2*>(sf + (4 * tg + i) * D + 2 * dp) =
            make_float2(a[i][0], a[i][1]);
    }
  }
}

// ---- launch 2: the split sweep --------------------------------------------

// Shared memory: two stages of the ring (bytes), then the chunk's derived
// arrays (floats).  f32 rows of D are padded to D + 4 and rows of 16 to 20,
// so that the threads of a warp reading a column or a float4 of several
// rows hit distinct banks; ko is kept both token-major and key-dim-major,
// so that every product reads whole float4s.  v and do do not
// pass through the ring: each thread prefetches its EPT values of the next
// chunk into registers, and they stay in the inputs' type (bf16 rows are
// half the bytes to read).  At rwkv6-3b's shape (D = 64, bf16) a block
// takes 43 904 bytes.
template <typename T, int D>
struct Sweep {
  static constexpr int NB = D / KD;                   // blocks a head
  static constexpr int CW = D / 32;                   // columns a thread
  static constexpr int PD = D + 4;
  static constexpr int P16 = 20;
  static constexpr int ES = static_cast<int>(sizeof(T));
  static constexpr int EPT = C * D / NT;              // prefetched values
  static constexpr int WORDS = EPT * ES / 4;
  static constexpr int PDV = D + 16 / ES;             // a row of v or do
  static constexpr int VW = C * PDV * ES / 4;         // floats of v or do
  // a stage: logw, r, k [C][KD]; the entry rows [KD][PD] (f32); the pair
  // terms; dA's shares of dqt and dki for this block's key dims [2][C][P16]
  static constexpr int LW = 0;
  static constexpr int R = LW + C * KD * 4;
  static constexpr int K = R + C * KD * ES;
  static constexpr int ST = K + C * KD * ES;
  static constexpr int PR = ST + KD * PD * 4;
  static constexpr int SF = PR + PAIR * 4;
  static constexpr int STAGE = SF + 2 * C * P16 * 4;
  // floats after the ring: v and do in T [C][PDV], dS' of the slice; qt
  // and ko [C][P16]; ko [KD][P16]; dko, the state's share of dqt, and
  // dS' . S of each key dim; e^{Ll}; this block's share of dv (two
  // buffers: chunk parity)
  static constexpr int VF = 0;
  static constexpr int DOF = VF + VW;
  static constexpr int DSP = DOF + VW;
  static constexpr int QT = DSP + KD * PD;
  static constexpr int KO = QT + C * P16;
  static constexpr int KOT = KO + C * P16;
  static constexpr int DKO = KOT + KD * P16;          // dko, dqs [C][P16]
  static constexpr int DQS = DKO + C * P16;
  static constexpr int DLL = DQS + C * P16;           // dS'.S [KD]
  static constexpr int DEC = DLL + KD;
  static constexpr int X = DEC + KD;
  static constexpr int FLOATS = X + 2 * C * D;
  static constexpr int BYTES = 2 * STAGE + FLOATS * 4;
};

// N consecutive floats of shared or global memory to and from registers
template <int N>
__device__ __forceinline__ void load_row(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = ld4(p + i);
      x[i] = a.x; x[i + 1] = a.y; x[i + 2] = a.z; x[i + 3] = a.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 a = *reinterpret_cast<const float2*>(p + i);
      x[i] = a.x; x[i + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<float2*>(p + i) = make_float2(x[i], x[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = x[i];
  }
}
__device__ __forceinline__ float at(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// N consecutive values of T in shared memory as floats
template <int N>
__device__ __forceinline__ void load_vals(float (&x)[N], const float* p) {
  load_row(x, p);
}
template <int N>
__device__ __forceinline__ void load_vals(float (&x)[N],
                                          const __nv_bfloat16* p) {
  if constexpr (N == 1) {
    x[0] = __bfloat162float(*p);
  } else if constexpr (N == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    x[0] = __uint_as_float(w << 16);
    x[1] = __uint_as_float(w & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = ld4(p + i);
      x[i] = a.x; x[i + 1] = a.y; x[i + 2] = a.z; x[i + 3] = a.w;
    }
  }
}

// W 32-bit words between global or shared memory and registers, 16 or 8
// bytes an access
template <int W>
__device__ __forceinline__ void load_words(uint32_t (&w)[W], const void* p) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[i / 4];
      w[i] = a.x; w[i + 1] = a.y; w[i + 2] = a.z; w[i + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const uint2 a = reinterpret_cast<const uint2*>(p)[i / 2];
      w[i] = a.x; w[i + 1] = a.y;
    }
  }
}

template <int W>
__device__ __forceinline__ void store_words(void* p, const uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      reinterpret_cast<uint4*>(p)[i / 4] =
          make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 2)
      reinterpret_cast<uint2*>(p)[i / 2] = make_uint2(w[i], w[i + 1]);
  }
}

// Threads take four roles over the chunk's arrays:
//   tile (g, cg): rows 4 g .. 4 g + 3 (key dims of the state and dS, or
//     tokens of this slice's share of dv) and columns CW cg .. CW cg +
//     CW; a warp holds two row groups and 16 column groups, so that a
//     product step reads one float4 (two addresses) and 16 CW neighbouring
//     floats.  The state (forward) and dS (reverse) live in the tile's
//     registers;
//   row (rd = tid / 8, rt = tid % 8): key dim rd, tokens rt and rt + 8 (the
//     eight threads of a key dim are neighbouring lanes of one warp);
//   product (warp w: key dims 4 w ..; lane: tokens tq and tq + 8 with
//     tq = lane % 8, and float4 columns lane / 8 + 4 s): dko and the
//     state's share of dqt as 4 x 2 tiles over a quarter of the columns,
//     summed over the four lanes by halving shuffles;
//   copy: values [EPT tid, EPT tid + EPT) of the chunk's C x D v and do.
// The D/16 blocks of a head form a cluster (launched with the cluster
// attribute); the block's rank is its slice.
template <typename T, int D>
__global__ void __launch_bounds__(NT, 3) wkv_bwd_sweep_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ s0,
    const T* __restrict__ dout, const float* __restrict__ ds_final,
    const float* __restrict__ pairs, const float* __restrict__ sfree,
    T* __restrict__ dr, T* __restrict__ dk,
    T* __restrict__ dv, float* __restrict__ dlogw,
    float* __restrict__ du_part, float* __restrict__ ds0,
    float* __restrict__ states, int S, int H) {
  using L = Sweep<T, D>;
  constexpr int NB = L::NB, CW = L::CW, PD = L::PD, P16 = L::P16;
  constexpr int EPT = L::EPT, PDV = L::PDV;
  extern __shared__ __align__(16) unsigned char sm[];
  float* f = reinterpret_cast<float*>(sm + 2 * L::STAGE);
  T* vf = reinterpret_cast<T*>(f + L::VF);
  T* dof = reinterpret_cast<T*>(f + L::DOF);
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int d0 = KD * q;                       // this block's key dims
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int nch = S / C;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head = static_cast<size_t>(b) * S * row_stride
                      + static_cast<size_t>(h) * D;
  const size_t dd = static_cast<size_t>(D) * D;
  float* rows = states + (static_cast<size_t>(bh) * NB + q) * nch * KD * D;
  const float* pr_bh = pairs + static_cast<size_t>(bh) * nch * PAIR;
  const float* sf_bh = sfree + static_cast<size_t>(bh) * nch * 2 * C * D;

  const int warp = tid >> 5, lane = tid & 31;
  const int g = 2 * (warp & 1) + (lane >> 4);
  const int col = CW * (16 * (warp >> 1) + (lane & 15));
  const int rd = tid >> 3, rt = tid & 7;
  const int et = EPT * tid / D, ec = EPT * tid % D;

  // chunk ch's stage (ch % 2): logw and k, and in reverse also r, the entry
  // rows and the pair terms, in 16-byte copies
  auto stage_in = [&](int ch, bool rev) {
    unsigned char* st = sm + (ch & 1) * L::STAGE;
    const size_t g0 = head + static_cast<size_t>(ch) * C * row_stride;
    if (tid < C * KD / 4) {
      const int t = tid / (KD / 4), j = 4 * (tid % (KD / 4));
      cp_async<16>(st + L::LW + (t * KD + j) * 4,
                   logw + g0 + t * row_stride + d0 + j, true);
    }
    constexpr int TE = 16 / L::ES;             // elements of T a copy
    if (tid < C * KD / TE) {
      const int t = tid / (KD / TE), j = TE * (tid % (KD / TE));
      const size_t gk = g0 + t * row_stride + d0 + j;
      cp_async<16>(st + L::K + (t * KD + j) * L::ES, k + gk, true);
      if (rev) cp_async<16>(st + L::R + (t * KD + j) * L::ES, r + gk, true);
    }
    if (rev) {
      const float* src = rows + static_cast<size_t>(ch) * KD * D;
      for (int e = tid; e < KD * D / 4; e += NT) {
        const int d = e / (D / 4), j = 4 * (e % (D / 4));
        cp_async<16>(st + L::ST + (d * PD + j) * 4, src + d * D + j, true);
      }
      const float* pr = pr_bh + static_cast<size_t>(ch) * PAIR;
      for (int e = tid; e < PAIR / 4; e += NT)
        cp_async<16>(st + L::PR + 16 * e, pr + 4 * e, true);
      // dA's shares of dqt and dki: rows (p, t) of this block's key dims
      const float* sf = sf_bh + static_cast<size_t>(ch) * 2 * C * D + d0;
      const int row = tid >> 2, j = 4 * (tid & 3);
      cp_async<16>(st + L::SF + (row * P16 + j) * 4, sf + row * D + j, true);
    }
  };
  // chunk ch's v (and do) values of this thread into registers
  uint32_t pv[L::WORDS], pdo[L::WORDS];
  auto fetch = [&](int ch, bool rev) {
    const size_t gv = head + static_cast<size_t>(ch * C + et) * row_stride
                      + ec;
    load_words(pv, v + gv);
    if (rev) load_words(pdo, dout + gv);
  };

  // the chunk's derived terms of key dim rd, tokens rt and rt + 8, in
  // registers (index 0, 1) and, for the other roles, in shared memory: ko
  // and e^{Ll} always, qt and ki in reverse; v (and do) in f32
  float e_lp[2], e_lc[2], e_ko[2], kk[2], rr[2];
  float dec_d = 0.f;
  auto derive = [&](const unsigned char* st, bool rev) {
    const float* lw = reinterpret_cast<const float*>(st + L::LW);
    const T* ks = reinterpret_cast<const T*>(st + L::K);
    const T* rs = reinterpret_cast<const T*>(st + L::R);
    float acc = 0.f, lc[2], lp[2];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float w = lw[t * KD + rd];
      acc += w;
      if (t == rt) { lc[0] = acc; lp[0] = acc - w; }
      if (t == rt + 8) { lc[1] = acc; lp[1] = acc - w; }
    }
    dec_d = expf(acc);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = rt + 8 * i;
      kk[i] = to_f(ks[t * KD + rd]);
      e_ko[i] = expf(acc - lc[i]);
      const float ko = kk[i] * e_ko[i];
      f[L::KO + t * P16 + rd] = ko;
      if (rev) {
        rr[i] = to_f(rs[t * KD + rd]);
        e_lp[i] = expf(lp[i]);
        e_lc[i] = expf(-lc[i]);
        f[L::QT + t * P16 + rd] = rr[i] * e_lp[i];
        f[L::KOT + rd * P16 + t] = ko;
      }
    }
    if (rt == 0) f[L::DEC + rd] = dec_d;
    store_words(vf + et * PDV + ec, pv);
    if (rev) store_words(dof + et * PDV + ec, pdo);
  };

  // the tile's rows: state or dS (key dims 4 g + i), columns col ..
  float x[4][CW];
  auto tile_in = [&](const float* src) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c)
        x[i][c] = src ? src[bh * dd + (d0 + 4 * g + i) * D + col + c] : 0.f;
  };
  // x = diag(e^{Ll}) x + sum_t a_t (x) b_t over the chunk's tokens, a (C x
  // 16, token-major) at ``a``, b (C x D, in T) at ``bm``
  auto tile_step = [&](const float* a, const T* bm) {
    const float4 dec = ld4(f + L::DEC + 4 * g);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) x[i][c] *= at(dec, i);
#pragma unroll 4
    for (int t = 0; t < C; ++t) {
      const float4 a4 = ld4(a + t * P16 + 4 * g);
      float bb[CW];
      load_vals(bb, bm + t * PDV + col);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) x[i][c] += at(a4, i) * bb[c];
    }
  };

  // product role (see above): into DKO, DQS and DLL
  auto product_step = [&](const float* srows) {
    const int d4 = 4 * warp, tq = lane & 7, kq = lane >> 3;
    float pk[4][2], pq[4][2], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pl[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) pk[i][j] = pq[i][j] = 0.f;
    }
#pragma unroll
    for (int c = 4 * kq; c < D; c += 16) {
      float4 vv[2], oo[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        vv[j] = ld4(vf + (tq + 8 * j) * PDV + c);
        oo[j] = ld4(dof + (tq + 8 * j) * PDV + c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 a = ld4(f + L::DSP + (d4 + i) * PD + c);
        const float4 sv = ld4(srows + (d4 + i) * PD + c);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          pk[i][j] += dot4(a, vv[j]);
          pq[i][j] += dot4(sv, oo[j]);
        }
        pl[i] += dot4(a, sv);
      }
    }
    // sum over the four lanes kq: lane bit 4 keeps dqs (else dko), bit 3
    // key dims i = 2, 3 (else 0, 1)
    const bool hi4 = lane & 16, hi3 = lane & 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float send = hi4 ? pk[i][j] : pq[i][j];
        const float keep = hi4 ? pq[i][j] : pk[i][j];
        pk[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float send = hi3 ? pk[i][j] : pk[i + 2][j];
        const float keep = hi3 ? pk[i + 2][j] : pk[i][j];
        pk[i][j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
    float* out = f + (hi4 ? L::DQS : L::DKO) + d4 + 2 * hi3;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) out[(tq + 8 * j) * P16 + i] = pk[i][j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pl[i] += __shfl_xor_sync(0xffffffffu, pl[i], 8);
      pl[i] += __shfl_xor_sync(0xffffffffu, pl[i], 16);
    }
    if (lane < 4) f[L::DLL + d4 + lane] = lane == 0 ? pl[0]
                                        : lane == 1 ? pl[1]
                                        : lane == 2 ? pl[2] : pl[3];
  };

  // ---- forward: the slice's entry rows of every chunk to the scratch ----
  tile_in(s0);
  stage_in(0, false);
  cp_async_commit();
  fetch(0, false);
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();                     // chunk ch landed, ch - 1 is done
    if (ch + 1 < nch) stage_in(ch + 1, false);
    cp_async_commit();
    float* dst = rows + static_cast<size_t>(ch) * KD * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) store_row(dst + (4 * g + i) * D + col, x[i]);
    derive(sm + (ch & 1) * L::STAGE, false);
    if (ch + 1 < nch) fetch(ch + 1, false);
    __syncthreads();
    tile_step(f + L::KO, vf);            // S' = e^{Ll} S + sum ko (x) v
  }
  __syncthreads();                       // the ring is free, the rows written

  // ---- reverse ----
  tile_in(ds_final);
  const float ud = u[h * D + d0 + rd];
  float du_acc = 0.f;
  stage_in(nch - 1, true);
  cp_async_commit();
  fetch(nch - 1, true);
  for (int ch = nch - 1; ch >= 0; --ch) {
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store_row(f + L::DSP + (4 * g + i) * PD + col, x[i]);
    __syncthreads();                     // chunk ch landed, dS' shared
    if (ch > 0) stage_in(ch - 1, true);
    cp_async_commit();
    const unsigned char* st = sm + (ch & 1) * L::STAGE;
    derive(st, true);
    if (ch > 0) fetch(ch - 1, true);
    __syncthreads();
    const float* pr = reinterpret_cast<const float*>(st + L::PR);
    const int buf = ch & 1;

    // product role: dko[t][d] = dS'[d] . v_t, dqs[t][d] = S[d] . do_t
    // and dll[d] = dS'[d] . S[d] over this lane's columns, then summed
    product_step(reinterpret_cast<const float*>(st + L::ST));
    // tile role, tokens 4 g ..: this slice's share of dv,
    // sum_{d in slice} ko_t[d] dS'[d, c]
    {
      float xs[4][CW];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) xs[i][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < KD; ++d) {
        const float4 k4 = ld4(f + L::KOT + d * P16 + 4 * g);
        float dsv[CW];
        load_row(dsv, f + L::DSP + d * PD + col);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CW; ++c) xs[i][c] += at(k4, i) * dsv[c];
      }
      float* xb = f + L::X + buf * C * D;
#pragma unroll
      for (int i = 0; i < 4; ++i) store_row(xb + (4 * g + i) * D + col, xs[i]);
    }
    // tile role: dS = diag(e^{Ll}) dS' + sum_t qt_t (x) do_t
    tile_step(f + L::QT, dof);
    __syncthreads();                     // the row products are in
    // row role: dr and dk of key dim rd, tokens rt and rt + 8, and the
    // exponents' gradients
    float dlp[2], dlc[2], koko = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = rt + 8 * i;
      const float* sf = reinterpret_cast<const float*>(st + L::SF);
      const float dqt = sf[t * P16 + rd] + f[L::DQS + t * P16 + rd];
      const float dki = sf[(C + t) * P16 + rd];
      const float dko = f[L::DKO + t * P16 + rd];
      const float dbon = pr[P_DBON + t];
      const size_t gd = head + static_cast<size_t>(ch * C + t) * row_stride
                        + d0 + rd;
      from_f(dr + gd, dqt * e_lp[i] + dbon * ud * kk[i]);
      from_f(dk + gd, dki * e_lc[i] + dko * e_ko[i] + dbon * ud * rr[i]);
      dlp[i] = dqt * (rr[i] * e_lp[i]);
      const float kx = dko * (kk[i] * e_ko[i]);
      koko += kx;
      dlc[i] = dlp[i] - dki * (kk[i] * e_lc[i]) - kx;
      du_acc += dbon * rr[i] * kk[i];
    }
    // dLl, and the suffix sums of dLc over the chunk's tokens (tokens
    // 8..15 in the lanes' second value, 0..7 in the first): dlogw
    koko += __shfl_xor_sync(0xffffffffu, koko, 1);
    koko += __shfl_xor_sync(0xffffffffu, koko, 2);
    koko += __shfl_xor_sync(0xffffffffu, koko, 4);
    const float dl_last = dec_d * f[L::DLL + rd] + koko;
    float sfx[2] = {dlc[0], dlc[1]};
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float y0 = __shfl_down_sync(0xffffffffu, sfx[0], off, 8);
      const float y1 = __shfl_down_sync(0xffffffffu, sfx[1], off, 8);
      if (rt + off < 8) {
        sfx[0] += y0;
        sfx[1] += y1;
      }
    }
    sfx[0] += __shfl_sync(0xffffffffu, sfx[1], 0, 8);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      dlogw[head + static_cast<size_t>(ch * C + rt + 8 * i) * row_stride + d0
            + rd] = sfx[i] - dlp[i] + dl_last;

    // dv of value columns [16 q, 16 q + 16): the state-free terms (before
    // the cluster barrier: they need no other block), then the slices'
    // shares in rank order; thread: token tid / 8, two columns
    const int tv = tid >> 3, cv = KD * q + 2 * (tid & 7);
    float2 acc;
    {
      const int t = tv, c = cv;
      const float bon = pr[P_BON + t];
      float o2[2];
      load_vals(o2, dof + t * PDV + c);
      acc = make_float2(bon * o2[0], bon * o2[1]);
      for (int s = t + 1; s < C; ++s) {
        const float a = pr[s * C + t];
        load_vals(o2, dof + s * PDV + c);
        acc.x += a * o2[0];
        acc.y += a * o2[1];
      }
    }

    cluster.sync();                      // every slice's share of dv is in

    {
      const int t = tv, c = cv;
#pragma unroll
      for (int p = 0; p < NB; ++p) {
        const float* xp = cluster.map_shared_rank(f + L::X + buf * C * D, p);
        const float2 y = *reinterpret_cast<const float2*>(xp + t * D + c);
        acc.x += y.x;
        acc.y += y.y;
      }
      const size_t gv = head + static_cast<size_t>(ch * C + t) * row_stride
                        + c;
      from_f(dv + gv, acc.x);
      from_f(dv + gv + 1, acc.y);
    }
  }
  cluster.sync();                        // no block leaves while read

  if (ds0 != nullptr)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store_row(ds0 + bh * dd + (d0 + 4 * g + i) * D + col, x[i]);
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 1);
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 2);
  du_acc += __shfl_xor_sync(0xffffffffu, du_acc, 4);
  if (rt == 0) du_part[static_cast<size_t>(bh) * D + d0 + rd] = du_acc;
}

// ---- launch 3 -----------------------------------------------------------------

// du (H, D) = sum over b of the per-(b, h) partials, in b order
__global__ void du_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ du, int B, int H,
                                 int D) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= H * D) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[static_cast<size_t>(b) * H * D + e];
  du[e] = acc;
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, const void* s0, const void* dout,
           const void* ds_final, void* dr, void* dk, void* dv, void* dlogw,
           void* du, void* ds0, void* scratch, int B, int S, int H,
           cudaStream_t stream) {
  const int nch = S / C;
  const size_t n = static_cast<size_t>(B) * H * nch;   // chunks
  float* states = static_cast<float*>(scratch);
  float* pairs = states + n * D * D;
  float* sfree = pairs + n * PAIR;
  float* du_part = sfree + n * 2 * C * D;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  const float* wt = static_cast<const float*>(logw);
  const float* ut = static_cast<const float*>(u);

  int err = cma_gen::set_smem<wkv_bwd_pairs_kernel<T, D>>(
      PairSmem<D>::BYTES);
  if (err != 0) return err;
  wkv_bwd_pairs_kernel<T, D><<<dim3(nch, B * H), PT, PairSmem<D>::BYTES,
                               stream>>>(rt, kt, vt, wt, ut, ot, pairs,
                                         sfree, S, H);
  if ((err = cma_gen::launch_status()) != 0) return err;

  err = cma_gen::set_smem<wkv_bwd_sweep_kernel<T, D>>(Sweep<T, D>::BYTES);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D / KD, B * H);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Sweep<T, D>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = D / KD;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, wkv_bwd_sweep_kernel<T, D>, rt, kt, vt, wt, ut,
      static_cast<const float*>(s0), ot, static_cast<const float*>(ds_final),
      static_cast<const float*>(pairs), static_cast<const float*>(sfree),
      static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dlogw),
      du_part, static_cast<float*>(ds0), states, S, H);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((err = cma_gen::launch_status()) != 0) return err;

  du_reduce_kernel<<<(H * D + 127) / 128, 128, 0, stream>>>(
      du_part, static_cast<float*>(du), B, H, D);
  return cma_gen::launch_status();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* logw,
             const void* u, const void* s0, const void* dout,
             const void* ds_final, void* dr, void* dk, void* dv, void* dlogw,
             void* du, void* ds0, void* scratch, int B, int S, int H, int D,
             void* stream) {
  if (B < 1 || H < 1 || S < C || S % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<T, 32>(r, k, v, logw, u, s0, dout, ds_final, dr, dk, dv,
                           dlogw, du, ds0, scratch, B, S, H, st);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, s0, dout, ds_final, dr, dk, dv,
                           dlogw, du, ds0, scratch, B, S, H, st);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, s0, dout, ds_final, dr, dk, dv,
                            dlogw, du, ds0, scratch, B, S, H, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// scratch, f32: the chunks' entry states (B H S/16 D D), the pair terms
// (B H S/16 PAIR), dA's shares of dqt and dki (B H S/16 2 C D) and du's
// per-(b, h) sums (B H D)
#define WKV_BWD_ENTRY(SUFFIX, T)                                              \
  extern "C" int wkv6_backward_##SUFFIX(                                      \
      const void* r, const void* k, const void* v, const void* logw,          \
      const void* u, const void* s0, const void* dout, const void* ds_final,  \
      void* dr, void* dk, void* dv, void* dlogw, void* du, void* ds0,         \
      void* scratch, int B, int S, int H, int D, void* stream) {              \
    return dispatch<T>(r, k, v, logw, u, s0, dout, ds_final, dr, dk, dv,      \
                       dlogw, du, ds0, scratch, B, S, H, D, stream);          \
  }

WKV_BWD_ENTRY(f32, float)
WKV_BWD_ENTRY(bf16, __nv_bfloat16)
