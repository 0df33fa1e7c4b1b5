// Chunked RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Replaces repro/kernels/rwkv6_wkv.py::wkv6_forward (_kernel):
//
//   S_t = diag(w_t) S_{t-1} + k_t (x) v_t
//   o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
//
// in the chunked form of repro/models/rwkv6.py (wkv_chunked), CHUNK = 16
// tokens a step, all in f32: the cumulative log-decays Lc of the chunk, the
// strictly lower-triangular (16 x 16) A[t, j] = (r_t e^{Lc_{t-1}}) .
// (k_j e^{-Lc_j}), the diagonal bonus r_t . (u (.) k_t), the cross-chunk
// term r_t e^{Lc_{t-1}} . S and the state update S <- e^{Lc_last} (.) S +
// sum_j (k_j e^{Lc_last - Lc_j}) (x) v_j.  Per-token log-decays are clamped
// to [-5, -1e-6] by the layer, so with 16 tokens every exponential stays
// below e^80 < f32's max, as in the TPU kernel.
//
// Beyond the TPU kernel (which starts from a zero state and returns o
// only), this one takes an optional initial state (B, H, D, D) f32 and
// writes the final state: the model's prefill caches it.
//
// Layout: one block per (b*h, 32-column tile of the state's value axis):
// the value columns of S evolve independently, so a (b, h) pair is split
// over D/32 blocks, each holding its (D x 32) f32 slice of S in shared
// memory for the whole sequence; the chunks are a loop inside the block,
// where the TPU carried S in VMEM across its sequential grid axis.  Each
// block recomputes the chunk's decays and A (they do not depend on the
// value columns).  r, k, v, logw and o are read and written in place in
// their (B, S, H, D) layout.
//
// What bounds it: one pass over r, k, v (bf16 or f32), logw (f32) and o; at
// rwkv6-3b's prefill (B = 4, S = 1024, H = 40, D = 64) about 126 MB in bf16,
// 0.04 ms at 3.35 TB/s, against about 3.4 GFLOP.  The chunk loop is
// sequential within a block, so the kernel is bound by the latency of a
// chunk step (five barriers) times the number of chunks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 16;          // tokens per chunk
constexpr int VT = 32;         // value columns of S per block
constexpr int NT = 256;        // threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// shared-memory layout (floats), rows of the (C x D) arrays padded by one
template <int D>
struct Smem {
  static constexpr int DP = D + 1;
  static constexpr int R = 0;                  // r            [C][DP]
  static constexpr int K = R + C * DP;         // k            [C][DP]
  static constexpr int L = K + C * DP;         // w, then Lc   [C][DP]
  static constexpr int QT = L + C * DP;        // r e^{Lc_prev}
  static constexpr int KI = QT + C * DP;       // k e^{-Lc}
  static constexpr int KO = KI + C * DP;       // k e^{Lc_last - Lc}
  static constexpr int V = KO + C * DP;        // v tile       [C][VT]
  static constexpr int A = V + C * VT;         // A            [C][C]
  static constexpr int U = A + C * C;          // u            [D]
  static constexpr int DEC = U + D;            // e^{Lc_last}  [D]
  static constexpr int ST = DEC + D;           // S slice      [D][VT]
  static constexpr int SIZE = ST + D * VT;
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ s0,
    T* __restrict__ o, float* __restrict__ s_out, int S, int H) {
  using L = Smem<D>;
  constexpr int DP = L::DP;
  extern __shared__ float sm[];
  float* Rs = sm + L::R;
  float* Ks = sm + L::K;
  float* Ls = sm + L::L;
  float* Qt = sm + L::QT;
  float* Ki = sm + L::KI;
  float* Ko = sm + L::KO;
  float* Vs = sm + L::V;
  float* As = sm + L::A;
  float* Us = sm + L::U;
  float* Dec = sm + L::DEC;
  float* St = sm + L::ST;

  const int col0 = blockIdx.x * VT;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t base = static_cast<size_t>(b) * S * row_stride
                      + static_cast<size_t>(h) * D;
  const size_t s_base = static_cast<size_t>(bh) * D * D;

  for (int i = tid; i < D; i += NT) Us[i] = u[h * D + i];
  for (int i = tid; i < D * VT; i += NT) {
    const int d = i / VT, c = i % VT;
    St[i] = s0 ? s0[s_base + static_cast<size_t>(d) * D + col0 + c] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += C) {
    __syncthreads();                 // the previous chunk is consumed
    for (int i = tid; i < C * D; i += NT) {
      const int t = i / D, d = i % D;
      const size_t g = base + static_cast<size_t>(t0 + t) * row_stride + d;
      Rs[t * DP + d] = to_f(r[g]);
      Ks[t * DP + d] = to_f(k[g]);
      Ls[t * DP + d] = logw[g];
    }
    for (int i = tid; i < C * VT; i += NT) {
      const int t = i / VT, c = i % VT;
      Vs[i] = to_f(v[base + static_cast<size_t>(t0 + t) * row_stride + col0
                     + c]);
    }
    __syncthreads();

    // cumulative log-decays, one key dim per thread, in token order
    for (int d = tid; d < D; d += NT) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const float w = Ls[t * DP + d];
        acc += w;                                    // Lc_t
        Qt[t * DP + d] = Rs[t * DP + d] * expf(acc - w);
        Ki[t * DP + d] = Ks[t * DP + d] * expf(-acc);
        Ls[t * DP + d] = acc;
      }
      Dec[d] = expf(acc);
#pragma unroll
      for (int t = 0; t < C; ++t)
        Ko[t * DP + d] = Ks[t * DP + d] * expf(acc - Ls[t * DP + d]);
    }
    __syncthreads();

    // A: strict lower triangle, the bonus on the diagonal
    {
      const int t = tid / C, j = tid % C;
      float a = 0.f;
      if (j < t) {
        for (int d = 0; d < D; ++d) a += Qt[t * DP + d] * Ki[j * DP + d];
      } else if (j == t) {
        for (int d = 0; d < D; ++d)
          a += Rs[t * DP + d] * Us[d] * Ks[t * DP + d];
      }
      As[t * C + j] = a;
    }
    __syncthreads();

    // o = A v + (r e^{Lc_prev}) S for this block's value columns
    for (int i = tid; i < C * VT; i += NT) {
      const int t = i / VT, c = i % VT;
      float acc = 0.f;
      for (int j = 0; j <= t; ++j) acc += As[t * C + j] * Vs[j * VT + c];
      float cross = 0.f;
      for (int d = 0; d < D; ++d) cross += Qt[t * DP + d] * St[d * VT + c];
      o[base + static_cast<size_t>(t0 + t) * row_stride + col0 + c] =
          from_f<T>(acc + cross);
    }
    __syncthreads();

    // S <- e^{Lc_last} (.) S + sum_t (k_t e^{Lc_last - Lc_t}) (x) v_t
    for (int i = tid; i < D * VT; i += NT) {
      const int d = i / VT, c = i % VT;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < C; ++t) acc += Ko[t * DP + d] * Vs[t * VT + c];
      St[i] = Dec[d] * St[i] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < D * VT; i += NT) {
    const int d = i / VT, c = i % VT;
    s_out[s_base + static_cast<size_t>(d) * D + col0 + c] = St[i];
  }
}

template <typename T, int D>
int launch_wkv(const T* r, const T* k, const T* v, const float* logw,
               const float* u, const float* s0, T* o, float* s_out, int B,
               int S, int H, cudaStream_t stream) {
  const int smem = Smem<D>::SIZE * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(D / VT, B * H);
  wkv6_kernel<T, D><<<grid, NT, smem, stream>>>(r, k, v, logw, u, s0, o,
                                                s_out, S, H);
  return static_cast<int>(cudaGetLastError());
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
