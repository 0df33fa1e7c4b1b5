// Chunked RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces repro/kernels/rwkv6_wkv.py::wkv6_forward (_kernel):
//
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//   o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
//
// in the chunked form of repro/models/rwkv6.py (wkv_chunked), CHUNK = 16
// tokens a step, all in f32.  Per-token log-decays are clamped to
// [-5, -1e-6] by the layer, so with 16 tokens every exponential below
// stays under e^80 < f32's max, as in the TPU kernel.  Beyond the TPU
// kernel (which starts from a zero state and returns o only), this one
// takes an optional initial state (B, H, D, D) f32 and writes the final
// state: the model's prefill caches it.
//
// What bounds it: one pass over r, k, v (bf16 or f32), logw (f32) and o;
// at rwkv6-3b's prefill (B = 4, S = 1024, H = 40, D = 64) 131 MB in bf16,
// 0.039 ms at 3.35 TB/s, against B H S (32 D + 4 D^2) = 3.0 GFLOP of f32
// FMA work, 0.045 ms at 67 TFLOP/s.  The chunks of a (b, h) pair are a
// sequential chain, so what sets the time is the length of one chunk step
// times the number of chunks, and how many chains share an SM.
//
// Layout: one block per (b*h, 16-column slice of the state's value axis):
// the value columns of S evolve independently, so a head is split over
// D/16 blocks (640 at the prefill above, five a SM in one wave).  A block
// has D/32 warps; warp w owns key dims [32 w, 32 w + 32) of the block's
// D x 16 slice of S, and lane (dg, cg) a fixed 4 x 4 piece of it (key
// dims 4 dg.., value columns 4 cg..), in registers for the whole sequence.
// With the chunk's last cumulative log-decay Lc_last as reference, each
// lane first computes, for its key dim d and every token (warp-local, in
// base 2: the layer's log-decays times log2 e, summed in token order),
//
//   qt[t] = r_t 2^{Lc_{t-1} - Lc_last},  ko[t] = k_t 2^{Lc_last - Lc_t},
//   dec = 2^{Lc_last},  and the warp's bonus sum_d r_t u k_t (shuffles),
//
// and then, token by token over its 4 x 4 piece,
//
//   X = dec (.) S;  for t: o_t += qt[t] . X,  X += ko[t] (x) v_t;  S' = X,
//
// which is the chunked form (A = qt ko^T strictly below the diagonal, the
// cross-chunk term r e^{Lc_{t-1}} S, the state update e^{Lc_last} S +
// sum ko (x) v) with no separate A step: the state update is the running
// sum itself.  Each lane's partial o of a chunk is summed over the warp's
// eight key-dim groups by shuffles in a fixed order and goes to shared
// memory; the next chunk's step sums the warps' partials in warp order,
// adds the bonus times v and writes o.  r, k, logw and v of chunk t+1 come
// in by cp.async into the other half of a two-stage ring while chunk t
// computes, so a chunk step passes one block barrier.  No atomics: a
// second launch gives the same bits.
#include <cuda_bf16.h>

#include "cma_gen_common.cuh"

namespace {

using cma_gen::cp_async;
using cma_gen::cp_async_commit;
using cma_gen::cp_async_wait;

constexpr int C = 16;          // tokens per chunk
constexpr int VT = 16;         // value columns of S per block
constexpr int DW = 32;         // key dims per warp: one per lane
constexpr int STAGES = 2;      // cp.async ring depth, in chunks
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
// 8 consecutive values of v as floats
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = ld4(p), b = ld4(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {             // bf16 is f32's upper half
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store4(float* p, float4 x) { st4(p, x); }
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a)))
         | static_cast<unsigned>(
               __bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_pair(x.x, x.y), bf16_pair(x.z, x.w));
}

// Halves the N entries v[0..N) a lane holds: the lanes with MASK set keep
// entries [N/2, N), the others [0, N/2), each moved to v[0..N/2) and summed
// with the partner's (lane ^ MASK) copy of the same entry.
template <int N, int K, int MASK>
__device__ __forceinline__ void halve(float (&v)[C][K], int lane) {
  const bool hi = lane & MASK;
#pragma unroll
  for (int j = 0; j < N / 2; ++j)
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float send = hi ? v[j][c] : v[j + N / 2][c];
      const float keep = hi ? v[j + N / 2][c] : v[j][c];
      v[j][c] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
    }
}

// Shared memory, in bytes: the ring of raw chunks, each warp's derived
// arrays, and what the next chunk step reads: each warp's v in f32, its
// bonus and its partial o (double-buffered across chunk steps).
template <typename T, int D>
struct Smem {
  static constexpr int NW = D / DW;                      // warps
  static constexpr int LW = 0;                           // logw [C][D] f32
  static constexpr int R = LW + C * D * 4;               // r    [C][D]
  static constexpr int K = R + C * D * int(sizeof(T));   // k    [C][D]
  static constexpr int V = K + C * D * int(sizeof(T));   // v    [C][VT]
  static constexpr int STAGE = V + C * VT * int(sizeof(T));
  // per warp, floats: qt, ko [C][DW], dec [DW], then [2] x (v [C][VT],
  // bonus [C], partial o [C][VT])
  static constexpr int QT = 0, KO = C * DW, DEC = 2 * C * DW;
  static constexpr int BUF = DEC + DW, BUF_SIZE = 2 * C * VT + C;
  static constexpr int VF = 0, BONUS = C * VT, OP = C * VT + C;
  static constexpr int WARP = (BUF + 2 * BUF_SIZE) * 4;
  static constexpr int WARPS = STAGES * STAGE;
  static constexpr int SIZE = WARPS + NW * WARP;
};

template <typename T, int D>
__global__ void __launch_bounds__(D) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ s0,
    T* __restrict__ o, float* __restrict__ s_out, int S, int H) {
  using L = Smem<T, D>;
  constexpr int NW = L::NW;
  constexpr int NT = D;
  constexpr int WARP_F = L::WARP / 4;         // floats a warp
  extern __shared__ __align__(16) unsigned char sm[];

  const int col0 = blockIdx.x * VT;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * S * row_stride
                      + static_cast<size_t>(h) * D;
  const size_t s_base = static_cast<size_t>(bh) * D * D;
  float* wsm0 = reinterpret_cast<float*>(sm + L::WARPS);
  float* wsm = wsm0 + warp * WARP_F;

  // chunk ch's logw, r, k and v slice into ring stage ch % STAGES, in
  // 16-byte copies: thread tid takes the copies tid + NT i, C / 4 of logw
  // (4 rows apart), C / TE each of r and k (TE rows apart) and, while
  // tid < C VT / TE, one of v
  constexpr int TE = 16 / int(sizeof(T));     // elements of T a copy
  const size_t lw_off = (tid / (D / 4)) * row_stride + 4 * (tid % (D / 4));
  const size_t rk_off = (tid / (D / TE)) * row_stride + TE * (tid % (D / TE));
  const size_t v_off = (tid / (VT / TE)) * row_stride + col0
                       + TE * (tid % (VT / TE));
  auto issue = [&](int ch) {
    unsigned char* st = sm + (ch % STAGES) * L::STAGE + 16 * tid;
    const size_t g0 = base + static_cast<size_t>(ch) * C * row_stride;
#pragma unroll
    for (int i = 0; i < C / 4; ++i)
      cp_async<16>(st + L::LW + 16 * NT * i,
                   logw + g0 + lw_off + 4 * i * row_stride, true);
#pragma unroll
    for (int i = 0; i < C / TE; ++i) {
      const size_t g = g0 + rk_off + TE * i * row_stride;
      cp_async<16>(st + L::R + 16 * NT * i, r + g, true);
      cp_async<16>(st + L::K + 16 * NT * i, k + g, true);
    }
#pragma unroll
    for (int i = 0; i * NT < C * VT / TE; ++i)
      if (tid + NT * i < C * VT / TE)
        cp_async<16>(st + L::V + 16 * NT * i,
                     v + g0 + v_off + (NT / (VT / TE)) * i * row_stride, true);
  };

  // decays: this lane's key dim
  const int dk = warp * DW + lane;
  const float ud = u[static_cast<size_t>(h) * D + dk];
  // state: lane (dg, cg) owns key dims dw0.. of the warp and columns
  // c0..c0 + 3, its slot s holding column c0 + (s ^ m): the column order
  // that lets the sum over key-dim groups halve columns without selects
  const int dg = lane & 7;
  const int dw0 = 4 * dg;
  const int c0 = 4 * (lane >> 3);
  const int m = dg >> 1;
  float X[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int sl = 0; sl < 4; ++sl)
      X[j][sl] = s0 ? s0[s_base + static_cast<size_t>(warp * DW + dw0 + j) * D
                         + col0 + c0 + (sl ^ m)]
                    : 0.f;

  // o of chunk ch: the warps' partials and bonuses summed in warp order,
  // then partial + bonus v; thread q writes token q / 4, columns 4 (q % 4)..
  auto write_o = [&](int ch) {
    const int buf = L::BUF + (ch & 1) * L::BUF_SIZE;
    for (int q = tid; q < C * VT / 4; q += NT) {
      const int t = q >> 2, c = 4 * (q & 3);
      float4 acc = ld4(wsm0 + buf + L::OP + t * VT + c);
      float bonus = wsm0[buf + L::BONUS + t];
#pragma unroll
      for (int w = 1; w < NW; ++w) {
        const float4 x = ld4(wsm0 + w * WARP_F + buf + L::OP + t * VT + c);
        acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
        bonus += wsm0[w * WARP_F + buf + L::BONUS + t];
      }
      const float4 vv = ld4(wsm0 + buf + L::VF + t * VT + c);
      acc.x += bonus * vv.x; acc.y += bonus * vv.y;
      acc.z += bonus * vv.z; acc.w += bonus * vv.w;
      store4(o + base + (static_cast<size_t>(ch) * C + t) * row_stride
                 + col0 + c,
             acc);
    }
  };

  const int nch = S / C;
  if (nch > 0) issue(0);
  cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    // chunk ch has landed, every warp is done with chunk ch - 1's stage,
    // and chunk ch - 1's partial o are in shared memory
    cp_async_wait<0>();
    __syncthreads();
    if (ch + 1 < nch) issue(ch + 1);
    cp_async_commit();
    if (ch > 0) write_o(ch - 1);

    const unsigned char* st = sm + (ch % STAGES) * L::STAGE;
    const float* lw = reinterpret_cast<const float*>(st + L::LW);
    const T* rs = reinterpret_cast<const T*>(st + L::R);
    const T* ks = reinterpret_cast<const T*>(st + L::K);
    const T* vs = reinterpret_cast<const T*>(st + L::V);
    float* buf = wsm + L::BUF + (ch & 1) * L::BUF_SIZE;

    // cumulative log-decays of key dim dk in base 2, in token order
    float lc[C], lp[C];
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float w = lw[t * D + dk] * LOG2E;
      acc += w;
      lc[t] = acc;
      lp[t] = acc - w;
    }
    const float last = acc;
    float bonus[C][1];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float rr = to_f(rs[t * D + dk]);
      const float kk = to_f(ks[t * D + dk]);
      wsm[L::QT + t * DW + lane] = rr * ex2(lp[t] - last);
      wsm[L::KO + t * DW + lane] = kk * ex2(last - lc[t]);
      bonus[t][0] = rr * ud * kk;
    }
    wsm[L::DEC + lane] = ex2(last);
    // the warp's bonus of each token: the lanes' terms summed by halving
    // (lane pair 2 t, 2 t + 1 ends with token t), then the pair
    halve<16, 1, 16>(bonus, lane);
    halve<8, 1, 8>(bonus, lane);
    halve<4, 1, 4>(bonus, lane);
    halve<2, 1, 2>(bonus, lane);
    const float pair = __shfl_xor_sync(0xffffffffu, bonus[0][0], 1);
    if (!(lane & 1)) buf[L::BONUS + (lane >> 1)] = bonus[0][0] + pair;
    // this chunk's v slice in f32, the warp's own copy: lane takes token
    // lane / 2, columns 8 (lane % 2)..
    {
      float x[8];
      load8(vs + (lane >> 1) * VT + 8 * (lane & 1), x);
      float* dst = buf + L::VF + (lane >> 1) * VT + 8 * (lane & 1);
      st4(dst, make_float4(x[0], x[1], x[2], x[3]));
      st4(dst + 4, make_float4(x[4], x[5], x[6], x[7]));
    }
    __syncwarp();

    // the state's chunk step over this lane's 4 x 4 piece
    {
      const float4 d4 = ld4(wsm + L::DEC + dw0);
      const float dec[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) X[j][c] *= dec[j];
    }
    float ot[C][4];
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float4 q4 = ld4(wsm + L::QT + t * DW + dw0);
      const float4 k4 = ld4(wsm + L::KO + t * DW + dw0);
      const float q[4] = {q4.x, q4.y, q4.z, q4.w};
      const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
      float vv[4];
#pragma unroll
      for (int sl = 0; sl < 4; ++sl)
        vv[sl] = buf[L::VF + t * VT + c0 + (sl ^ m)];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = q[0] * X[0][c];
#pragma unroll
        for (int j = 1; j < 4; ++j) a += q[j] * X[j][c];
        ot[t][c] = a;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) X[j][c] += kv[j] * vv[c];
    }

    // sum the eight key-dim groups of each (t, column): across dg bit 2
    // the partners hold slots 0, 1 and 2, 3 of the same columns, across
    // bit 1 slots 0 and 1, so each lane keeps its first slots; then bit 0
    // halves the tokens.  Lane (dg, cg) ends with column c0 + m, tokens
    // 8 (dg & 1)..
#pragma unroll
    for (int t = 0; t < C; ++t) {
      ot[t][0] += __shfl_xor_sync(0xffffffffu, ot[t][2], 4);
      ot[t][1] += __shfl_xor_sync(0xffffffffu, ot[t][3], 4);
      ot[t][0] += __shfl_xor_sync(0xffffffffu, ot[t][1], 2);
    }
    float col[C][1];
#pragma unroll
    for (int t = 0; t < C; ++t) col[t][0] = ot[t][0];
    halve<16, 1, 1>(col, lane);
#pragma unroll
    for (int j = 0; j < C / 2; ++j)
      buf[L::OP + (8 * (dg & 1) + j) * VT + c0 + m] = col[j][0];
  }
  __syncthreads();
  if (nch > 0) write_o(nch - 1);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int sl = 0; sl < 4; ++sl)
      s_out[s_base + static_cast<size_t>(warp * DW + dw0 + j) * D + col0 + c0
            + (sl ^ m)] = X[j][sl];
}

template <typename T, int D>
int launch_wkv(const T* r, const T* k, const T* v, const float* logw,
               const float* u, const float* s0, T* o, float* s_out, int B,
               int S, int H, cudaStream_t stream) {
  constexpr int smem = Smem<T, D>::SIZE;
  int err = cma_gen::set_smem<wkv6_kernel<T, D>>(smem);
  if (err != 0) return err;
  const dim3 grid(D / VT, B * H);
  wkv6_kernel<T, D><<<grid, D, smem, stream>>>(r, k, v, logw, u, s0, o,
                                               s_out, S, H);
  return cma_gen::launch_status();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* logw,
             const void* u, const void* s0, void* o, void* s_out, int B,
             int S, int H, int D, void* stream) {
  if (B < 1 || H < 1 || S < 0 || S % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* wt = static_cast<const float*>(logw);
  const float* ut = static_cast<const float*>(u);
  const float* st = static_cast<const float*>(s0);
  T* ot = static_cast<T*>(o);
  float* so = static_cast<float*>(s_out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_wkv<T, 32>(rt, kt, vt, wt, ut, st, ot, so, B, S, H, cs);
    case 64:
      return launch_wkv<T, 64>(rt, kt, vt, wt, ut, st, ot, so, B, S, H, cs);
    case 128:
      return launch_wkv<T, 128>(rt, kt, vt, wt, ut, st, ot, so, B, S, H, cs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define WKV_ENTRY(SUFFIX, T)                                                  \
  extern "C" int wkv6_forward_##SUFFIX(                                       \
      const void* r, const void* k, const void* v, const void* logw,          \
      const void* u, const void* s0, void* o, void* s_out, int B, int S,      \
      int H, int D, void* stream) {                                           \
    return dispatch<T>(r, k, v, logw, u, s0, o, s_out, B, S, H, D, stream);   \
  }

WKV_ENTRY(f32, float)
WKV_ENTRY(bf16, __nv_bfloat16)
