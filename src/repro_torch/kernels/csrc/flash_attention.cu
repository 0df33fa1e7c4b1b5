// GQA flash attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention (_kernel):
//
//   o[b, i, h] = sum_j softmax_j(scale q[b, i, h] . k[b, j, hk]) v[b, j, hk]
//
// with hk = h / (H / Hk) (grouped-query heads share a KV head), scale =
// D^-1/2 and the masks of the TPU kernel in index order: causal keeps keys
// j <= i, a window keeps keys j > i - window, and keys j >= S_kv are never
// read.  q, k, v and o are read and written in place in their (B, S, H, D)
// layout: no transposes and no padding on the host.
//
// Layout: one block per (b*h, 64-row q tile), heaviest (latest) q tiles
// first.  A q row belongs to D/32 neighbouring threads, each holding 32 of
// its D dims (eight float4 groups interleaved with its neighbours', so a
// warp's shared-memory reads are conflict-free broadcasts) for q, scaled
// once, and for the f32 accumulator.  K and V tiles of 64 rows are staged
// in shared memory as f32; the logits of 16 keys at a time are partial dot
// products summed over the row's threads with shuffles, and the running
// max, sum and accumulator take them online (Dao et al.).  The TPU kernel
// upcasts to f32 before both products and keeps P in f32; so does this
// one, with scalar f32 FMAs: no tensor cores, so bf16 inputs give the same
// products as the plain version up to summation order.  KV tiles that no
// row of the q tile may see (above the causal diagonal, left of the window)
// are never loaded, as pl.when(relevant) skips them.
//
// What bounds it: at qwen2-0.5b's prefill (B = 4, S = 2048, H = 14, Hk = 2,
// D = 64, causal) the unmasked pairs need about 30 GFLOP against 18 MB of
// q, k, v and o, so it is bound by arithmetic; as scalar f32 FMAs its
// ceiling is the card's 67 TFLOP/s f32 rate, not the 989 TFLOP/s bf16
// tensor-core rate.  mma/wgmma tiles and TMA staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // q rows per block
constexpr int BKV = 64;      // K/V rows per shared-memory stage
constexpr int KC = 16;       // keys per online-softmax step
constexpr int G4 = 8;        // float4 groups per thread (32 dims)
constexpr float NEG = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&a);
  raw.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ * (D / 32)) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int Skv, int H,
    int Hk, int causal, int window, float scale) {
  constexpr int TPR = D / 32;            // threads per q row
  constexpr int NT = BQ * TPR;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // [BKV][D]
  float* Vs = Ks + BKV * D;                      // [BKV][D]

  const int n_q = (S + BQ - 1) / BQ;
  const int q_start = (n_q - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int qi = q_start + row;
  const bool q_ok = qi < S;

  const size_t q_stride = static_cast<size_t>(H) * D;
  const size_t kv_stride = static_cast<size_t>(Hk) * D;
  const T* qp = q + (static_cast<size_t>(b) * S + (q_ok ? qi : 0)) * q_stride
                + static_cast<size_t>(h) * D;
  float4 qr[G4], acc[G4];
#pragma unroll
  for (int g = 0; g < G4; ++g) {
    const float4 x = load4(qp + 4 * (g * TPR + sub));
    qr[g] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG;
  float l = 0.f;

  // the keys some row of this tile may see: [key_lo, key_hi)
  const int q_last = min(q_start + BQ, S) - 1;
  const int key_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int key_lo = window > 0 ? max(0, q_start - window + 1) : 0;
  const T* kb = k + static_cast<size_t>(b) * Skv * kv_stride
                + static_cast<size_t>(hk) * D;
  const T* vb = v + static_cast<size_t>(b) * Skv * kv_stride
                + static_cast<size_t>(hk) * D;

  for (int k0 = (key_lo / BKV) * BKV; k0 < key_hi; k0 += BKV) {
    __syncthreads();                     // the previous stage is consumed
    for (int idx = tid; idx < BKV * (D / 4); idx += NT) {
      const int r = idx / (D / 4);
      const int c = (idx % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < Skv) {
        kx = load4(kb + static_cast<size_t>(k0 + r) * kv_stride + c);
        vx = load4(vb + static_cast<size_t>(k0 + r) * kv_stride + c);
      }
      store4(Ks + r * D + c, kx);
      store4(Vs + r * D + c, vx);
    }
    __syncthreads();

    for (int j0 = 0; j0 < BKV; j0 += KC) {
      float s[KC];
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const float* kr = Ks + (j0 + jj) * D;
        float part = 0.f;
#pragma unroll
        for (int g = 0; g < G4; ++g)
          part += dot4(qr[g], load4(kr + 4 * (g * TPR + sub)));
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[jj] = part;
      }
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const int kj = k0 + j0 + jj;
        const bool ok = kj < Skv && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        s[jj] = ok ? s[jj] : NEG;
        mx = fmaxf(mx, s[jj]);
      }
      const float corr = expf(m - mx);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const float p = s[jj] > 0.5f * NEG ? expf(s[jj] - mx) : 0.f;
        s[jj] = p;
        psum += p;
      }
      l = l * corr + psum;
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        acc[g].x *= corr;
        acc[g].y *= corr;
        acc[g].z *= corr;
        acc[g].w *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < KC; ++jj) {
        const float* vr = Vs + (j0 + jj) * D;
        const float p = s[jj];
#pragma unroll
        for (int g = 0; g < G4; ++g) {
          const float4 vv = load4(vr + 4 * (g * TPR + sub));
          acc[g].x += p * vv.x;
          acc[g].y += p * vv.y;
          acc[g].z += p * vv.z;
          acc[g].w += p * vv.w;
        }
      }
      m = mx;
    }
  }

  if (q_ok) {
    const float den = fmaxf(l, 1e-30f);
    T* op = o + (static_cast<size_t>(b) * S + qi) * q_stride
            + static_cast<size_t>(h) * D;
#pragma unroll
    for (int g = 0; g < G4; ++g)
      store4(op + 4 * (g * TPR + sub),
             make_float4(acc[g].x / den, acc[g].y / den, acc[g].z / den,
                         acc[g].w / den));
  }
}

template <typename T, int D>
int launch_flash(const T* q, const T* k, const T* v, T* o, int B, int S,
                 int Skv, int H, int Hk, int causal, int window, float scale,
                 cudaStream_t stream) {
  const int smem = 2 * BKV * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, BQ * (D / 32), smem, stream>>>(
      q, k, v, o, S, Skv, H, Hk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Skv, int H, int Hk, int D, int causal, int window,
             float scale, void* stream) {
  if (B < 1 || S < 1 || Skv < 1 || Hk < 1 || H % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_flash<T, 32>(qt, kt, vt, ot, B, S, Skv, H, Hk, causal,
                                 window, scale, st);
    case 64:
      return launch_flash<T, 64>(qt, kt, vt, ot, B, S, Skv, H, Hk, causal,
                                 window, scale, st);
    case 128:
      return launch_flash<T, 128>(qt, kt, vt, ot, B, S, Skv, H, Hk, causal,
                                  window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define FLASH_ENTRY(SUFFIX, T)                                                \
  extern "C" int flash_attention_##SUFFIX(                                    \
      const void* q, const void* k, const void* v, void* o, int B, int S,     \
      int Skv, int H, int Hk, int D, int causal, int window, float scale,     \
      void* stream) {                                                         \
    return dispatch<T>(q, k, v, o, B, S, Skv, H, Hk, D, causal, window,       \
                       scale, stream);                                        \
  }

FLASH_ENTRY(f32, float)
FLASH_ENTRY(bf16, __nv_bfloat16)
