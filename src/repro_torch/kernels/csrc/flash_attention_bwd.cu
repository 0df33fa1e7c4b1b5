// GQA flash attention backward for Hopper (sm_90a): dQ, dK and dV.
//
// Replaces no TPU kernel.  The JAX package takes the flash path's gradient
// from repro/models/flash_xla.py::_flash_bwd_impl, two blockwise passes
// in jnp that recompute the probabilities from the forward's row
// statistics.  The port's forward is a CUDA kernel (flash_attention.cu),
// so its gradient is one too; this file is that pair of passes:
//
//   p_ij  = exp(scale q_i . k_j - lse_i)          (masked pairs: 0)
//   dp_ij = do_i . v_j,   delta_i = do_i . o_i,   ds_ij = p_ij (dp_ij - delta_i)
//   dq_i  = scale sum_j ds_ij k_j
//   dk_j  = scale sum_i ds_ij q_i,   dv_j = sum_i p_ij do_i
//
// with lse the forward's log-sum-exp of the scaled logits (its stats
// output), GQA (query head h reads KV head h / (H / Hk); dk and dv of a
// KV head sum over its query group) and the forward's masks in index
// order: causal keeps keys j <= i, a window keeps keys j > i - window,
// keys j >= S_kv are never read.
//
// What bounds it: at qwen2-0.5b's training shape (B = 4, S = 1024,
// H = 14, Hk = 2, D = 64, causal) the 29.4 M unmasked pairs need 10 D
// FLOP each (s and dp again, then dq, dk and dv): 18.8 GFLOP against
// 4 x 7.3 MB of q, o, do and dq, 4 x 1 MB of k, v, dk and dv in bf16 and
// 0.2 MB of lse: bound by arithmetic, 19 us at the 989 TFLOP/s bf16
// tensor-core rate (34 MB is 10 us at 3.35 TB/s).  This first form runs
// on scalar f32 FMAs (67 TFLOP/s, 0.28 ms at best): it is simple and
// right first; wgmma tiles are later work.
//
// Pass 1 (flash_bwd_dq_kernel): one block per (b*h, 64-row q tile), a q
// row over D/32 neighbouring threads (32 dims each, in float4 groups as
// the forward's f32 kernel), K and V tiles of 64 rows staged in shared
// memory as f32.  Each row first sums delta = do . o (written to scratch
// for pass 2), then walks the keys it may see in index order.
// Pass 2 (flash_bwd_dkv_kernel): one block per (b*hk, 64-row KV tile), a
// key row over D/32 threads holding k, v, dk and dv in registers; the
// block walks the query group's heads and, for each, the q rows that may
// see its keys, 64 at a time, with q, do, lse and delta staged in shared
// memory.  Every sum runs in a fixed order and nothing is atomic: a
// second launch gives the same bits.  bf16 inputs are widened to f32 on
// load; the gradients are rounded to the inputs' type once, at the end.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;       // q rows per pass-1 block and per pass-2 stage
constexpr int BK = 64;       // K/V rows per pass-1 stage and pass-2 block
constexpr int G4 = 8;        // float4 groups per thread (32 dims)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a)))
         | static_cast<unsigned>(
               __bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_pair(x.x, x.y), bf16_pair(x.z, x.w));
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void axpy4(float4& acc, float a, float4 x) {
  acc.x += a * x.x;
  acc.y += a * x.y;
  acc.z += a * x.z;
  acc.w += a * x.w;
}

// The sum of a row's partial over its TPR neighbouring threads.
template <int TPR>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  return part;
}

__device__ __forceinline__ bool visible(int qi, int kj, int S, int Skv,
                                        int causal, int window) {
  return qi < S && kj < Skv && (!causal || kj <= qi) &&
         (window <= 0 || kj > qi - window);
}

// rows [r0, r0 + 64) of a (B, seq, heads, D) tensor's head ``head`` as f32
// rows of D in shared memory; rows past ``seq`` are zero
template <typename T, int D, int NT>
__device__ __forceinline__ void stage(float* dst, const T* src, int b,
                                      int seq, int heads, int head, int r0,
                                      int tid) {
  for (int idx = tid; idx < 64 * (D / 4); idx += NT) {
    const int r = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < seq)
      x = ld4(src + ((static_cast<size_t>(b) * seq + r0 + r) * heads + head)
                        * D + c);
    st4(dst + r * D + c, x);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ * (D / 32)) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const float* __restrict__ lse, const T* __restrict__ dout,
    T* __restrict__ dq, float* __restrict__ delta_out, int S, int Skv,
    int H, int Hk, int causal, int window, float scale) {
  constexpr int TPR = D / 32;
  constexpr int NT = BQ * TPR;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [BK][D]
  float* Vs = Ks + BK * D;                       // [BK][D]

  const int q_start = blockIdx.y * BQ;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int qi = q_start + row;
  const bool q_ok = qi < S;

  const size_t q_off =
      ((static_cast<size_t>(b) * S + (q_ok ? qi : 0)) * H + h) * D;
  float4 qr[G4], dor[G4], acc[G4];
  float part = 0.f;
#pragma unroll
  for (int g = 0; g < G4; ++g) {
    const int c = 4 * (g * TPR + sub);
    qr[g] = ld4(q + q_off + c);
    dor[g] = ld4(dout + q_off + c);
    part += dot4(dor[g], ld4(o + q_off + c));
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float delta = row_sum<TPR>(part);
  const size_t stat = (static_cast<size_t>(b) * S + (q_ok ? qi : 0)) * H + h;
  const float lse_i = lse[stat];
  if (q_ok && sub == 0) delta_out[stat] = delta;

  const int q_last = min(q_start + BQ, S) - 1;
  const int key_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int key_lo = window > 0 ? max(0, q_start - window + 1) : 0;

  for (int k0 = (key_lo / BK) * BK; k0 < key_hi; k0 += BK) {
    __syncthreads();                     // the previous stage is consumed
    stage<T, D, NT>(Ks, k, b, Skv, Hk, hk, k0, tid);
    stage<T, D, NT>(Vs, v, b, Skv, Hk, hk, k0, tid);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < BK; ++j) {
      const float* kr = Ks + j * D;
      const float* vr = Vs + j * D;
      float4 kx[G4];
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        const int c = 4 * (g * TPR + sub);
        kx[g] = ld4(kr + c);
        sp += dot4(qr[g], kx[g]);
        dpp += dot4(dor[g], ld4(vr + c));
      }
      const float s = row_sum<TPR>(sp);
      const float dp = row_sum<TPR>(dpp);
      const float p = visible(qi, k0 + j, S, Skv, causal, window)
                          ? expf(s * scale - lse_i) : 0.f;
      const float ds = p * (dp - delta);
#pragma unroll
      for (int g = 0; g < G4; ++g) axpy4(acc[g], ds, kx[g]);
    }
  }

  if (q_ok) {
#pragma unroll
    for (int g = 0; g < G4; ++g)
      st4(dq + q_off + 4 * (g * TPR + sub),
          make_float4(acc[g].x * scale, acc[g].y * scale, acc[g].z * scale,
                      acc[g].w * scale));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BK * (D / 32)) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const T* __restrict__ dout,
    T* __restrict__ dk, T* __restrict__ dv, int S, int Skv, int H, int Hk,
    int causal, int window, float scale) {
  constexpr int TPR = D / 32;
  constexpr int NT = BK * TPR;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][D]
  float* Os = Qs + BQ * D;                       // [BQ][D] (do)
  float* Ls = Os + BQ * D;                       // [BQ] lse
  float* Ds = Ls + BQ;                           // [BQ] delta

  const int k_start = blockIdx.y * BK;
  const int bhk = blockIdx.x;
  const int b = bhk / Hk;
  const int hk = bhk % Hk;
  const int rep = H / Hk;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int kj = k_start + row;
  const bool k_ok = kj < Skv;

  const size_t k_off =
      ((static_cast<size_t>(b) * Skv + (k_ok ? kj : 0)) * Hk + hk) * D;
  float4 kr[G4], vr[G4], dka[G4], dva[G4];
#pragma unroll
  for (int g = 0; g < G4; ++g) {
    const int c = 4 * (g * TPR + sub);
    kr[g] = ld4(k + k_off + c);
    vr[g] = ld4(v + k_off + c);
    dka[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    dva[g] = dka[g];
  }

  // the q rows some key of this tile may be seen by: [q_lo, q_hi)
  const int k_last = min(k_start + BK, Skv) - 1;
  const int q_lo = causal ? k_start : 0;
  const int q_hi = window > 0 ? min(S, k_last + window) : S;

  for (int r = 0; r < rep; ++r) {
    const int h = hk * rep + r;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();                   // the previous stage is consumed
      stage<T, D, NT>(Qs, q, b, S, H, h, q0, tid);
      stage<T, D, NT>(Os, dout, b, S, H, h, q0, tid);
      for (int i = tid; i < BQ; i += NT) {
        const bool ok = q0 + i < S;
        const size_t st = (static_cast<size_t>(b) * S + (ok ? q0 + i : 0))
                          * H + h;
        Ls[i] = ok ? lse[st] : 0.f;
        Ds[i] = ok ? delta[st] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int i = 0; i < BQ; ++i) {
        const float* qrow = Qs + i * D;
        const float* orow = Os + i * D;
        float4 qx[G4], ox[G4];
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          const int c = 4 * (g * TPR + sub);
          qx[g] = ld4(qrow + c);
          ox[g] = ld4(orow + c);
          sp += dot4(kr[g], qx[g]);
          dpp += dot4(vr[g], ox[g]);
        }
        const float s = row_sum<TPR>(sp);
        const float dp = row_sum<TPR>(dpp);
        const float p = visible(q0 + i, kj, S, Skv, causal, window)
                            ? expf(s * scale - Ls[i]) : 0.f;
        const float ds = p * (dp - Ds[i]);
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          axpy4(dva[g], p, ox[g]);
          axpy4(dka[g], ds, qx[g]);
        }
      }
    }
  }

  if (k_ok) {
#pragma unroll
    for (int g = 0; g < G4; ++g) {
      const int c = 4 * (g * TPR + sub);
      st4(dk + k_off + c,
          make_float4(dka[g].x * scale, dka[g].y * scale, dka[g].z * scale,
                      dka[g].w * scale));
      st4(dv + k_off + c, dva[g]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, int B, int S, int Skv, int H, int Hk, int causal,
           int window, float scale, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int smem1 = 2 * BK * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, D>
      <<<dim3(B * H, (S + BQ - 1) / BQ), BQ * (D / 32), smem1, stream>>>(
          qt, kt, vt, static_cast<const T*>(o), lse, dot,
          static_cast<T*>(dq), delta, S, Skv, H, Hk, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem2 = (2 * BQ * D + 2 * BQ) * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<T, D>
      <<<dim3(B * Hk, (Skv + BK - 1) / BK), BK * (D / 32), smem2, stream>>>(
          qt, kt, vt, lse, delta, dot, static_cast<T*>(dk),
          static_cast<T*>(dv), S, Skv, H, Hk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* lse, const void* dout, void* dq, void* dk, void* dv,
             void* delta, int B, int S, int Skv, int H, int Hk, int D,
             int causal, int window, float scale, void* stream) {
  if (B < 1 || S < 1 || Skv < 1 || Hk < 1 || H % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, l, dout, dq, dk, dv, dl, B, S, Skv, H,
                           Hk, causal, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, l, dout, dq, dk, dv, dl, B, S, Skv, H,
                           Hk, causal, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, l, dout, dq, dk, dv, dl, B, S, Skv,
                            H, Hk, causal, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define FLASH_BWD_ENTRY(SUFFIX, T)                                            \
  extern "C" int flash_attention_bwd_##SUFFIX(                                \
      const void* q, const void* k, const void* v, const void* o,             \
      const void* lse, const void* dout, void* dq, void* dk, void* dv,        \
      void* delta, int B, int S, int Skv, int H, int Hk, int D, int causal,   \
      int window, float scale, void* stream) {                                \
    return dispatch<T>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, S, Skv,   \
                       H, Hk, D, causal, window, scale, stream);              \
  }

FLASH_BWD_ENTRY(f32, float)
FLASH_BWD_ENTRY(bf16, __nv_bfloat16)
