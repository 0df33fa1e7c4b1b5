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
// exponents (dLc_t = dLp_t - dki_t ki_t - dko_t ko_t, plus dLl on the last
// token; dlogw_t = sum_{s>=t} dLc_s - dLp_t).
//
// The reverse sweep needs each chunk's entry state.  They are recomputed
// here, not saved by the forward: the launch first runs the state
// recurrence forward from the initial state and writes every chunk's
// entry state to a scratch buffer of (B H, S/16, D, D) f32 that the
// wrapper allocates for the call and frees after it (168 MB at rwkv6-3b's
// training shape, B = 4, S = 1024, H = 40, D = 64, one layer's backward at
// a time).  The forward keeps nothing beyond its inputs.
//
// What bounds it: one read of r, k, v, do (bf16 or f32) and logw (f32)
// and one write of the gradients; at the shape above 231 MB in bf16,
// 0.069 ms at 3.35 TB/s (the scratch's write and read are not counted),
// against, per token, the state recurrence again (2 D^2 FLOP), the S and
// dS products of dqt, dko, dv and dS (8 D^2) and the chunk's pair terms
// (160 D): 8.4 GFLOP of f32 FMA work, 0.125 ms at 67 TFLOP/s.  The chunks
// of a (b, h) pair are a sequential chain, so the time is the length of
// one chunk step times the number of chunks.
//
// Layout (simple and right first): one block of 256 threads per (b, h)
// holds S and dS (D x D f32) and the chunk's rows in shared memory, rows
// padded to D + 1 floats so that threads walking a column hit distinct
// banks.  An element pass gives thread tid the (token, dim) elements
// tid + 256 i; the 16 x 16 pair pass (A, dA) one pair each.  du is summed
// per (b, h) over the chunks and then over b by a second, small launch in
// b order.  Every sum runs in a fixed order and nothing is atomic: a
// second launch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 16;          // tokens per chunk
constexpr int NT = 256;        // threads per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared memory, in floats: S and dS (D rows of D + 1), nine chunk arrays
// (16 rows of D + 1), the pair arrays and the per-dim vectors.
template <int D>
struct Smem {
  static constexpr int P = D + 1;                  // padded row
  static constexpr int S = 0, DS = S + D * P;
  static constexpr int R = DS + D * P, K = R + C * P, V = K + C * P;
  static constexpr int DO = V + C * P, W = DO + C * P, LC = W + C * P;
  static constexpr int QT = LC + C * P, KI = QT + C * P, KO = KI + C * P;
  static constexpr int A = KO + C * P, DA = A + C * C;
  static constexpr int BON = DA + C * C, DBON = BON + C;
  static constexpr int U = DBON + C, DEC = U + D, LL = DEC + D;
  static constexpr int PART = LL + D;
  static constexpr int FLOATS = PART + NT;
  static constexpr int BYTES = FLOATS * 4;
};

// the chunk's rows [t0, t0 + 16) of a (B, S, H, D) tensor, as f32
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t base, int H, int tid) {
  for (int e = tid; e < C * D; e += NT) {
    const int t = e / D, d = e % D;
    dst[t * (D + 1) + d] = to_f(src[base + static_cast<size_t>(t) * H * D + d]);
  }
}

// Lc (cumulative log-decay), Ll, e^{Ll}, qt, ki and ko of the chunk in
// shared memory; r is read only when ``with_r``
template <int D>
__device__ __forceinline__ void chunk_terms(float* sm, int tid, bool with_r) {
  using L = Smem<D>;
  constexpr int P = L::P;
  if (tid < D) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      acc += sm[L::W + t * P + tid];
      sm[L::LC + t * P + tid] = acc;
    }
    sm[L::LL + tid] = acc;
    sm[L::DEC + tid] = expf(acc);
  }
  __syncthreads();
  for (int e = tid; e < C * D; e += NT) {
    const int t = e / D, d = e % D;
    const float lc = sm[L::LC + t * P + d];
    const float lp = lc - sm[L::W + t * P + d];
    const float ll = sm[L::LL + d];
    const float kk = sm[L::K + t * P + d];
    if (with_r) sm[L::QT + t * P + d] = sm[L::R + t * P + d] * expf(lp);
    sm[L::KI + t * P + d] = kk * expf(-lc);
    sm[L::KO + t * P + d] = kk * expf(ll - lc);
  }
  __syncthreads();
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) wkv_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ s0,
    const T* __restrict__ dout, const float* __restrict__ ds_final,
    T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ dlogw, float* __restrict__ du_part,
    float* __restrict__ ds0, float* __restrict__ states, int S, int H) {
  using L = Smem<D>;
  constexpr int P = L::P;
  extern __shared__ float sm[];
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const int n_chunks = S / C;
  const size_t dd = static_cast<size_t>(D) * D;
  float* st = states + static_cast<size_t>(bh) * n_chunks * dd;

  for (int e = tid; e < D * D; e += NT) {
    const int d = e / D, c = e % D;
    sm[L::S + d * P + c] = s0 != nullptr ? s0[bh * dd + e] : 0.f;
    sm[L::DS + d * P + c] = ds_final != nullptr ? ds_final[bh * dd + e] : 0.f;
  }
  if (tid < D) sm[L::U + tid] = u[h * D + tid];

  // forward sweep: every chunk's entry state to the scratch
  for (int i = 0; i < n_chunks; ++i) {
    const size_t base = ((static_cast<size_t>(b) * S + i * C) * H + h) * D;
    __syncthreads();                       // S of the previous chunk is done
    load_rows<T, D>(sm + L::K, k, base, H, tid);
    load_rows<T, D>(sm + L::V, v, base, H, tid);
    load_rows<float, D>(sm + L::W, logw, base, H, tid);
    for (int e = tid; e < D * D; e += NT)
      st[i * dd + e] = sm[L::S + (e / D) * P + e % D];
    __syncthreads();
    chunk_terms<D>(sm, tid, false);
    for (int e = tid; e < D * D; e += NT) {
      const int d = e / D, c = e % D;
      float x = sm[L::DEC + d] * sm[L::S + d * P + c];
#pragma unroll
      for (int j = 0; j < C; ++j)
        x += sm[L::KO + j * P + d] * sm[L::V + j * P + c];
      sm[L::S + d * P + c] = x;
    }
  }

  float du_acc = 0.f;                      // thread tid < D: du[tid]
  for (int i = n_chunks - 1; i >= 0; --i) {
    const size_t base = ((static_cast<size_t>(b) * S + i * C) * H + h) * D;
    __syncthreads();                       // dS of the later chunk is done
    load_rows<T, D>(sm + L::R, r, base, H, tid);
    load_rows<T, D>(sm + L::K, k, base, H, tid);
    load_rows<T, D>(sm + L::V, v, base, H, tid);
    load_rows<T, D>(sm + L::DO, dout, base, H, tid);
    load_rows<float, D>(sm + L::W, logw, base, H, tid);
    for (int e = tid; e < D * D; e += NT)
      sm[L::S + (e / D) * P + e % D] = st[i * dd + e];
    __syncthreads();
    chunk_terms<D>(sm, tid, true);

    // pairs (t, j): A, dA, and on the diagonal the bonus and its gradient
    {
      const int t = tid / C, j = tid % C;
      float a = 0.f, da = 0.f;
      if (j <= t) {
        for (int d = 0; d < D; ++d)
          da += sm[L::DO + t * P + d] * sm[L::V + j * P + d];
        if (j < t)
          for (int d = 0; d < D; ++d)
            a += sm[L::QT + t * P + d] * sm[L::KI + j * P + d];
      }
      sm[L::A + t * C + j] = a;
      sm[L::DA + t * C + j] = j < t ? da : 0.f;
      if (j == t) {
        float bon = 0.f;
        for (int d = 0; d < D; ++d)
          bon += sm[L::R + t * P + d] * sm[L::U + d] * sm[L::K + t * P + d];
        sm[L::BON + t] = bon;
        sm[L::DBON + t] = da;
      }
    }
    __syncthreads();

    // elements (t, d): dr, dk and the exponents' gradients (into LC, W);
    // elements (t, c): dv.  Both read dS' (not yet updated).
    float dll_part = 0.f;
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, d = e % D;
      float dqt = 0.f, dki = 0.f, dko = 0.f;
      for (int j = 0; j < t; ++j)
        dqt += sm[L::DA + t * C + j] * sm[L::KI + j * P + d];
      for (int c = 0; c < D; ++c) {
        dqt += sm[L::DO + t * P + c] * sm[L::S + d * P + c];
        dko += sm[L::DS + d * P + c] * sm[L::V + t * P + c];
      }
      for (int s = t + 1; s < C; ++s)
        dki += sm[L::DA + s * C + t] * sm[L::QT + s * P + d];
      const float lc = sm[L::LC + t * P + d];
      const float lp = lc - sm[L::W + t * P + d];
      const float ll = sm[L::LL + d];
      const float rr = sm[L::R + t * P + d];
      const float kk = sm[L::K + t * P + d];
      const float ud = sm[L::U + d];
      const float dbon = sm[L::DBON + t];
      const size_t g = base + static_cast<size_t>(t) * H * D + d;
      from_f(dr + g, dqt * expf(lp) + dbon * ud * kk);
      from_f(dk + g, dki * expf(-lc) + dko * expf(ll - lc) + dbon * ud * rr);
      const float qt = sm[L::QT + t * P + d];
      const float ki = sm[L::KI + t * P + d];
      const float ko = sm[L::KO + t * P + d];
      const float dlp = dqt * qt;
      const float koko = dko * ko;
      dll_part += koko;
      sm[L::LC + t * P + d] = dlp - dki * ki - koko;   // dLc, no dLl yet
      sm[L::W + t * P + d] = dlp;                      // dLp
    }
    for (int e = tid; e < C * D; e += NT) {
      const int t = e / D, c = e % D;
      float x = sm[L::BON + t] * sm[L::DO + t * P + c];
      for (int s = t + 1; s < C; ++s)
        x += sm[L::A + s * C + t] * sm[L::DO + s * P + c];
      for (int d = 0; d < D; ++d)
        x += sm[L::KO + t * P + d] * sm[L::DS + d * P + c];
      from_f(dv + base + static_cast<size_t>(t) * H * D + c, x);
    }
    sm[L::PART + tid] = dll_part;
    __syncthreads();

    // per dim: dLl, dlogw by the reverse cumulative sum, du
    if (tid < D) {
      const int d = tid;
      float dll = 0.f;
      for (int c = 0; c < D; ++c)
        dll += sm[L::DS + d * P + c] * sm[L::S + d * P + c];
      dll *= sm[L::DEC + d];
      for (int p = d; p < NT; p += D) dll += sm[L::PART + p];
      float acc = dll;
      for (int t = C - 1; t >= 0; --t) {
        acc += sm[L::LC + t * P + d];
        dlogw[base + static_cast<size_t>(t) * H * D + d] =
            acc - sm[L::W + t * P + d];
        du_acc += sm[L::DBON + t] * sm[L::R + t * P + d] * sm[L::K + t * P + d];
      }
    }
    __syncthreads();

    // dS = diag(e^{Ll}) dS' + sum_t qt_t (x) do_t
    for (int e = tid; e < D * D; e += NT) {
      const int d = e / D, c = e % D;
      float x = sm[L::DEC + d] * sm[L::DS + d * P + c];
#pragma unroll
      for (int t = 0; t < C; ++t)
        x += sm[L::QT + t * P + d] * sm[L::DO + t * P + c];
      sm[L::DS + d * P + c] = x;
    }
  }
  __syncthreads();
  if (ds0 != nullptr)
    for (int e = tid; e < D * D; e += NT)
      ds0[bh * dd + e] = sm[L::DS + (e / D) * P + e % D];
  if (tid < D) du_part[static_cast<size_t>(bh) * D + tid] = du_acc;
}

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
           void* du, void* ds0, void* du_part, void* states, int B, int S,
           int H, cudaStream_t stream) {
  const int smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_bwd_kernel<T, D><<<B * H, NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<const T*>(dout), static_cast<const float*>(ds_final),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dlogw), static_cast<float*>(du_part),
      static_cast<float*>(ds0), static_cast<float*>(states), S, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  du_reduce_kernel<<<(H * D + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), B, H, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* logw,
             const void* u, const void* s0, const void* dout,
             const void* ds_final, void* dr, void* dk, void* dv, void* dlogw,
             void* du, void* ds0, void* du_part, void* states, int B, int S,
             int H, int D, void* stream) {
  if (B < 1 || H < 1 || S < C || S % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<T, 32>(r, k, v, logw, u, s0, dout, ds_final, dr, dk, dv,
                           dlogw, du, ds0, du_part, states, B, S, H, st);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, s0, dout, ds_final, dr, dk, dv,
                           dlogw, du, ds0, du_part, states, B, S, H, st);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, s0, dout, ds_final, dr, dk, dv,
                            dlogw, du, ds0, du_part, states, B, S, H, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define WKV_BWD_ENTRY(SUFFIX, T)                                              \
  extern "C" int wkv6_backward_##SUFFIX(                                      \
      const void* r, const void* k, const void* v, const void* logw,          \
      const void* u, const void* s0, const void* dout, const void* ds_final,  \
      void* dr, void* dk, void* dv, void* dlogw, void* du, void* ds0,         \
      void* du_part, void* states, int B, int S, int H, int D,                \
      void* stream) {                                                         \
    return dispatch<T>(r, k, v, logw, u, s0, dout, ds_final, dr, dk, dv,      \
                       dlogw, du, ds0, du_part, states, B, S, H, D, stream);  \
  }

WKV_BWD_ENTRY(f32, float)
WKV_BWD_ENTRY(bf16, __nv_bfloat16)
