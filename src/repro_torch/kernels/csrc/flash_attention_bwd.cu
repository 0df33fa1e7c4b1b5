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
// H = 14, Hk = 2, D = 64, causal) the 29.4 M unmasked pairs need 14 D
// FLOP each as the passes below run them (s and dp in both passes, dq,
// dk and dv): 26.3 GFLOP against 4 x 7.3 MB of q, o, do and dq, 4 x 1 MB
// of k, v, dk and dv in bf16 and 0.2 MB of lse: bound by arithmetic, 27 us
// at the 989 TFLOP/s bf16 tensor-core rate (10 D a pair, the least the
// function needs, 19 us; 34 MB is 10 us at 3.35 TB/s).
//
// bf16 runs on the tensor cores, four launches a call:
//
// 1. flash_bwd_prep_kernel: per (b, h) a table of S rounded up to 128
//    rows of (lse log2 e, delta = do . o) in f32, rows past S (+inf, 0)
//    so that they add nothing; 8 lanes a row, summed by shuffles.
// 2. flash_bwd_dq_tc_kernel, the forward's shape: one block per (b*h,
//    128-row q tile), heaviest (latest) tiles first.  A producer warp
//    brings Q and dO (two 64-row tiles each) once and K and V tiles of 64
//    rows through a three-stage ring by TMA (the forward's 4-d tensor
//    maps, swizzled bf16, mbarriers); two consumer warpgroups of 64 q rows
//    each run S = Q K^T and dP = dO V^T by wgmma (both operands from
//    shared memory, f32 accumulators), P = 2^(S scale log2 e - lse log2 e)
//    and dS = P (dP - delta) in registers, then dQ += dS K with dS from
//    registers and K read through the transpose bit, as O += P V in the
//    forward.
// 3. flash_bwd_dkv_tc_kernel: one block per (b*h, 128-row KV tile),
//    earliest (heaviest under the causal mask) tiles first.  The producer
//    brings K and V once and, per 64-row q step, Q, dO and the table's 64
//    rows (a bulk copy); each consumer warpgroup owns 64 KV rows: S^T =
//    K Q^T and dP^T = V dO^T from shared memory, P^T and dS^T in
//    registers (each thread reads the table for its 16 q columns), then
//    dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers and dO
//    and Q through the transpose bit.
// 4. flash_bwd_sum_kernel: dK and dV of a KV head are the query group's
//    per-head partials, summed in head order.
//
// Why pass 3 splits the query group over blocks: one block per (b*hk, KV
// tile) walking the group's heads gave 128 blocks on 132 SMs at the
// training shape, each walking 7 heads and, under the causal mask, from
// 16 q tiles (the first KV tile) down to 1; a block per (b*h, KV tile)
// gives 448 blocks whose lengths the heaviest-first order evens out, at
// the price of f32 partials of (B, S_kv, H, D) for dK and dV (29 MB at the
// training shape, about 10 us of traffic written and read once).
//
// P, dS and their transposes enter their products as two bf16 operands,
// the bf16 head and the bf16 rounding of the rest (split_frags, as P in
// the forward): bf16 alone rounds each weight by up to 2^-9, which put
// gradient elements near zero past the element-wise bf16 check on an
// H100.  Every
// sum runs in a fixed order and nothing is atomic: a second launch gives
// the same bits.
//
// float32 keeps the scalar body (its only path is at S = 64, where it is
// faster than SDPA's backward), two launches:
// Pass 1 (flash_bwd_dq_kernel): one block per (b*h, 64-row q tile), a q
// row over D/32 neighbouring threads (32 dims each, in float4 groups as
// the forward's f32 kernel), K and V tiles of 64 rows staged in shared
// memory.  Each row first sums delta = do . o (written to scratch for pass
// 2), then walks the keys it may see in index order.
// Pass 2 (flash_bwd_dkv_kernel): one block per (b*hk, 64-row KV tile), a
// key row over D/32 threads holding k, v, dk and dv in registers; the
// block walks the query group's heads and, for each, the q rows that may
// see its keys, 64 at a time, with q, do, lse and delta staged in shared
// memory.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tma.cuh"

namespace {

// ---- float32: the scalar kernels --------------------------------------------


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
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* dout, void* dq, void* dk,
               void* dv, float* delta, int B, int S, int Skv, int H, int Hk,
               int causal, int window, float scale, cudaStream_t stream) {
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


// ---- bfloat16: TMA and wgmma ------------------------------------------------

using namespace tc;

constexpr int WG_ROWS = 64;                 // rows per consumer warpgroup
constexpr int CONSUMERS = 2;                // consumer warpgroups per block
constexpr int BROWS = WG_ROWS * CONSUMERS;  // q (pass 2) or KV (3) rows a block
constexpr int BSTEP = 64;                   // rows a ring stage
constexpr int STAGES = 3;
constexpr int TC_THREADS = CONSUMERS * 128 + 32;
constexpr int LD_BYTES = BSTEP * 8;         // a stage's rows of the table

// rows of a (b, h)'s table: S rounded up to a block's rows
inline int table_rows(int S) { return (S + BROWS - 1) / BROWS * BROWS; }

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// table[(b H + h) Sp + i] = (lse_i log2 e, do_i . o_i), (+inf, 0) past S
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_prep_kernel(
    const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float2* __restrict__ table, int n_rows, int S, int Sp, int H) {
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gt / 8;
  const int l8 = gt % 8;
  if (row >= n_rows) return;              // whole warps: n_rows % 4 == 0
  const int i = row % Sp;
  const int bh = row / Sp;
  const int b = bh / H;
  const int h = bh % H;
  float part = 0.f;
  const size_t stat = (static_cast<size_t>(b) * S + i) * H + h;
  if (i < S)
    for (int c = 4 * l8; c < D; c += 32)
      part += dot4(ld4(dout + stat * D + c), ld4(o + stat * D + c));
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  part += __shfl_xor_sync(0xffffffffu, part, 4);
  if (l8 == 0)
    table[row] = i < S ? make_float2(lse[stat] * LOG2E, part)
                       : make_float2(__int_as_float(0x7f800000), 0.f);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_bwd_dq_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo,
    const float2* __restrict__ table, __nv_bfloat16* __restrict__ dq, int S,
    int Sp, int Skv, int H, int Hk, int causal, int window, float scale) {
  using Tl = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = smem_u32(&bars[0]);
  auto k_full = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto v_full = [&](int st) { return smem_u32(&bars[1 + STAGES + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + 2 * STAGES + st]); };
  auto q_tile = [&](int w) { return base + w * Tl::BYTES; };
  auto do_tile = [&](int w) { return base + (CONSUMERS + w) * Tl::BYTES; };
  auto k_tile = [&](int st) {
    return base + (2 * CONSUMERS + st) * Tl::BYTES;
  };
  auto v_tile = [&](int st) {
    return base + (2 * CONSUMERS + STAGES + st) * Tl::BYTES;
  };

  const int n_q = cdiv(S, BROWS);
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * BROWS;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  // the keys some row of this block may see: tiles from kv_first
  const int q_last = min(q0 + BROWS, S) - 1;
  const int key_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_first = key_lo / BSTEP * BSTEP;
  const int n_kv = key_hi > kv_first ? cdiv(key_hi - kv_first, BSTEP) : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == CONSUMERS * 4) {                       // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * CONSUMERS * Tl::BYTES);
      for (int w = 0; w < CONSUMERS; ++w) {
        tma_tile<D>(q_tile(w), &tq, h, q0 + w * WG_ROWS, b, q_full);
        tma_tile<D>(do_tile(w), &tdo, h, q0 + w * WG_ROWS, b, q_full);
      }
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(st), ((it / STAGES) - 1) & 1);
        const int kv0 = kv_first + it * BSTEP;
        mbar_expect_tx(k_full(st), Tl::BYTES);
        tma_tile<D>(k_tile(st), &tk, hk, kv0, b, k_full(st));
        mbar_expect_tx(v_full(st), Tl::BYTES);
        tma_tile<D>(v_tile(st), &tv, hk, kv0, b, v_full(st));
      }
    }
    return;
  }

  // a consumer warpgroup: rows q0w + 16 * (warp % 4) + lane / 4 (+ 8)
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0w = q0 + wg * WG_ROWS;
  const int row0 = q0w + 16 * (warp % 4) + g;
  const int q_last_w = min(q0w + WG_ROWS, S) - 1;
  const int hi_w = q0w >= S ? 0 : (causal ? min(Skv, q_last_w + 1) : Skv);
  const int lo_w = window > 0 ? max(0, q0w - window + 1) : 0;
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float2 x = table[static_cast<size_t>(bh) * Sp + row0 + 8 * r];
    lse2[r] = x.x;
    dl[r] = x.y;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_kv; ++it) {
    const int st = it % STAGES;
    const int ph = (it / STAGES) & 1;
    const int kv0 = kv_first + it * BSTEP;
    mbar_wait(k_full(st), ph);
    mbar_wait(v_full(st), ph);
    if (kv0 < hi_w && kv0 + BSTEP > lo_w) {
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64(s, desc_k<D>(q_tile(wg), kk),
                        desc_k<D>(k_tile(st), kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64(dp, desc_k<D>(do_tile(wg), kk),
                        desc_k<D>(v_tile(st), kk), kk > 0);
      wgmma_commit_wait();
      fence_regs(s);
      fence_regs(dp);

      const bool masked = (causal && kv0 + BSTEP - 1 > q0w) ||
                          (window > 0 && kv0 <= q0w + WG_ROWS - 1 - window) ||
                          kv0 + BSTEP > Skv;
      // rows past S have lse = +inf: p = 0 there without a mask
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        float p = ex2(fmaf(s[i], sl2, -lse2[r]));
        if (masked && !visible(row0 + 8 * r, kv0 + 8 * (i / 4) + 2 * t + i % 2,
                               S, Skv, causal, window))
          p = 0.f;
        s[i] = p * (dp[i] - dl[r]);                  // dS
      }
      uint32_t sa[4][4], sl[4][4];
      split_frags(s, sa, sl);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t dk = desc_t<D>(k_tile(st), j);
        rs_mma<D>(acc, sa[j], dk);
        rs_mma<D>(acc, sl[j], dk);
      }
      wgmma_commit_wait();
      fence_regs(acc);
    }
    mbar_arrive(empty(st));
  }

  const size_t q_stride = static_cast<size_t>(H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    __nv_bfloat16* dp = dq + (static_cast<size_t>(b) * S + qi) * q_stride +
                        static_cast<size_t>(h) * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(dp + 8 * nb + 2 * t) = pack_bf16(
          acc[4 * nb + 2 * r] * scale, acc[4 * nb + 2 * r + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_bwd_dkv_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo,
    const float2* __restrict__ table, float* __restrict__ dkp,
    float* __restrict__ dvp, int S, int Sp, int Skv, int H, int Hk,
    int causal, int window, float scale) {
  using Tl = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t kv_full = smem_u32(&bars[0]);
  auto q_full = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + STAGES + st]); };
  auto k_tile = [&](int w) { return base + w * Tl::BYTES; };
  auto v_tile = [&](int w) { return base + (CONSUMERS + w) * Tl::BYTES; };
  auto q_tile = [&](int st) {
    return base + (2 * CONSUMERS + st) * Tl::BYTES;
  };
  auto do_tile = [&](int st) {
    return base + (2 * CONSUMERS + STAGES + st) * Tl::BYTES;
  };
  auto ld_tile = [&](int st) {
    return base + (2 * CONSUMERS + 2 * STAGES) * Tl::BYTES + st * LD_BYTES;
  };

  const int k0 = static_cast<int>(blockIdx.y) * BROWS;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  // the q rows some key of this block may be seen by: tiles from q_first
  const int k_last = min(k0 + BROWS, Skv) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k_last + window) : S;
  const int q_first = q_lo / BSTEP * BSTEP;
  const int n_q = q_hi > q_first ? cdiv(q_hi - q_first, BSTEP) : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(q_full(st), 1);
      mbar_init(empty(st), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp == CONSUMERS * 4) {                       // the producer warp
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * CONSUMERS * Tl::BYTES);
      for (int w = 0; w < CONSUMERS; ++w) {
        tma_tile<D>(k_tile(w), &tk, hk, k0 + w * WG_ROWS, b, kv_full);
        tma_tile<D>(v_tile(w), &tv, hk, k0 + w * WG_ROWS, b, kv_full);
      }
      for (int it = 0; it < n_q; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(st), ((it / STAGES) - 1) & 1);
        const int qs = q_first + it * BSTEP;
        mbar_expect_tx(q_full(st), 2 * Tl::BYTES + LD_BYTES);
        tma_tile<D>(q_tile(st), &tq, h, qs, b, q_full(st));
        tma_tile<D>(do_tile(st), &tdo, h, qs, b, q_full(st));
        bulk_load(ld_tile(st), table + static_cast<size_t>(bh) * Sp + qs,
                  LD_BYTES, q_full(st));
      }
    }
    return;
  }

  // a consumer warpgroup: KV rows kvw0 + 16 * (warp % 4) + lane / 4 (+ 8);
  // its accumulators' columns are the q rows of the step
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t = lane % 4;
  const int kvw0 = k0 + wg * WG_ROWS;
  const int row0 = kvw0 + 16 * (warp % 4) + g;
  const int kv_last_w = min(kvw0 + WG_ROWS, Skv) - 1;
  const float sl2 = scale * LOG2E;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_q; ++it) {
    const int st = it % STAGES;
    const int ph = (it / STAGES) & 1;
    const int qs = q_first + it * BSTEP;
    mbar_wait(q_full(st), ph);
    // some pair of this warpgroup's KV rows and the step's q rows is seen
    if (kvw0 < Skv && (!causal || qs + BSTEP - 1 >= kvw0) &&
        (window <= 0 || qs <= kv_last_w + window - 1)) {
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64(s, desc_k<D>(k_tile(wg), kk),
                        desc_k<D>(q_tile(st), kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n64(dp, desc_k<D>(v_tile(wg), kk),
                        desc_k<D>(do_tile(st), kk), kk > 0);
      wgmma_commit_wait();
      fence_regs(s);
      fence_regs(dp);

      const bool masked = (causal && qs < kvw0 + WG_ROWS - 1) ||
                          (window > 0 && qs + BSTEP - 1 >= kvw0 + window) ||
                          qs + BSTEP > S || kvw0 + WG_ROWS > Skv;
      // the table's rows of this thread's columns 8 nb + 2 t and + 1
      const float4* tab = reinterpret_cast<const float4*>(
          smem_raw + (ld_tile(st) - raw));
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float4 x = tab[4 * nb + t];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * nb + e;
          const int c = e % 2;
          float p = ex2(fmaf(s[i], sl2, -(c ? x.z : x.x)));
          if (masked && !visible(qs + 8 * nb + 2 * t + c, row0 + 8 * (e / 2),
                                 S, Skv, causal, window))
            p = 0.f;
          dp[i] = p * (dp[i] - (c ? x.w : x.y));     // dS^T
          s[i] = p;                                  // P^T
        }
      }
      uint32_t pa[4][4], pl[4][4], sa[4][4], sl[4][4];
      split_frags(s, pa, pl);
      split_frags(dp, sa, sl);
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t ddo = desc_t<D>(do_tile(st), j);
        rs_mma<D>(dva, pa[j], ddo);
        rs_mma<D>(dva, pl[j], ddo);
        const uint64_t dq = desc_t<D>(q_tile(st), j);
        rs_mma<D>(dka, sa[j], dq);
        rs_mma<D>(dka, sl[j], dq);
      }
      wgmma_commit_wait();
      fence_regs(dva);
      fence_regs(dka);
    }
    mbar_arrive(empty(st));
  }

  // this head's partials, f32 (B, S_kv, H, D)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = row0 + 8 * r;
    if (kj >= Skv) continue;
    const size_t off = ((static_cast<size_t>(b) * Skv + kj) * H + h) * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      const int c = 8 * nb + 2 * t;
      *reinterpret_cast<float2*>(dkp + off + c) = make_float2(
          dka[4 * nb + 2 * r] * scale, dka[4 * nb + 2 * r + 1] * scale);
      *reinterpret_cast<float2*>(dvp + off + c) =
          make_float2(dva[4 * nb + 2 * r], dva[4 * nb + 2 * r + 1]);
    }
  }
}

// dk, dv (B, S_kv, Hk, D) in bf16: the query group's per-head partials
// (B, S_kv, H, D) summed in head order; thread e takes 4 elements
__global__ void __launch_bounds__(256) flash_bwd_sum_kernel(
    const float4* __restrict__ dkp, const float4* __restrict__ dvp,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n,
    int rep, int D4) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  // (b, j, hk) row e / D4 holds heads hk rep .. hk rep + rep - 1
  const size_t src = static_cast<size_t>(e / D4) * rep * D4 + e % D4;
  float4 sk = dkp[src], sv = dvp[src];
  for (int r = 1; r < rep; ++r) {
    const float4 a = dkp[src + static_cast<size_t>(r) * D4];
    const float4 c = dvp[src + static_cast<size_t>(r) * D4];
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  st4(dk + 4 * static_cast<size_t>(e), sk);
  st4(dv + 4 * static_cast<size_t>(e), sv);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, void* dq, void* dk,
                void* dv, float* scratch, int B, int S, int Skv, int H,
                int Hk, int causal, int window, float scale,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = tensor_map<D>(&tq, q, B, S, H)) != 0) return err;
  if ((err = tensor_map<D>(&tk, k, B, Skv, Hk)) != 0) return err;
  if ((err = tensor_map<D>(&tv, v, B, Skv, Hk)) != 0) return err;
  if ((err = tensor_map<D>(&tdo, dout, B, S, H)) != 0) return err;
  const int Sp = table_rows(S);
  float2* table = reinterpret_cast<float2*>(scratch);
  float* dkp = scratch + 2 * static_cast<size_t>(B) * H * Sp;
  float* dvp = dkp + static_cast<size_t>(B) * Skv * H * D;
  using bf = __nv_bfloat16;

  const int n_rows = B * H * Sp;
  flash_bwd_prep_kernel<D><<<(8 * n_rows + 255) / 256, 256, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), lse, table,
      n_rows, S, Sp, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int smem_dq = (2 * CONSUMERS + 2 * STAGES) * Tile<D>::BYTES + 1024;
  e = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_dq);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_tc_kernel<D>
      <<<dim3(B * H, (S + BROWS - 1) / BROWS), TC_THREADS, smem_dq,
         stream>>>(tq, tk, tv, tdo, table, static_cast<bf*>(dq), S, Sp, Skv,
                   H, Hk, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int smem_dkv = (2 * CONSUMERS + 2 * STAGES) * Tile<D>::BYTES +
                       STAGES * LD_BYTES + 1024;
  e = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_dkv);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_tc_kernel<D>
      <<<dim3(B * H, (Skv + BROWS - 1) / BROWS), TC_THREADS, smem_dkv,
         stream>>>(tq, tk, tv, tdo, table, dkp, dvp, S, Sp, Skv, H, Hk,
                   causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int n = B * Skv * Hk * (D / 4);
  flash_bwd_sum_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(dkp),
      reinterpret_cast<const float4*>(dvp), static_cast<bf*>(dk),
      static_cast<bf*>(dv), n, H / Hk, D / 4);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(bool bf16, const void* q, const void* k, const void* v,
           const void* o, const float* lse, const void* dout, void* dq,
           void* dk, void* dv, float* scratch, int B, int S, int Skv, int H,
           int Hk, int causal, int window, float scale, cudaStream_t stream) {
  if (bf16)
    return launch_bf16<D>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B, S,
                          Skv, H, Hk, causal, window, scale, stream);
  return launch_f32<float, D>(q, k, v, o, lse, dout, dq, dk, dv, scratch, B,
                              S, Skv, H, Hk, causal, window, scale, stream);
}

int dispatch(bool bf16, const void* q, const void* k, const void* v,
             const void* o, const void* lse, const void* dout, void* dq,
             void* dk, void* dv, void* scratch, int B, int S, int Skv, int H,
             int Hk, int D, int causal, int window, float scale,
             void* stream) {
  if (B < 1 || S < 1 || Skv < 1 || Hk < 1 || H % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* sc = static_cast<float*>(scratch);
  switch (D) {
    case 32:
      return launch<32>(bf16, q, k, v, o, l, dout, dq, dk, dv, sc, B, S, Skv,
                        H, Hk, causal, window, scale, st);
    case 64:
      return launch<64>(bf16, q, k, v, o, l, dout, dq, dk, dv, sc, B, S, Skv,
                        H, Hk, causal, window, scale, st);
    case 128:
      return launch<128>(bf16, q, k, v, o, l, dout, dq, dk, dv, sc, B, S,
                         Skv, H, Hk, causal, window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// scratch: float32, B S H floats (delta); bfloat16, the table (2 B H Sp
// floats, Sp = S rounded up to 128) and the f32 partials of dK and dV
// (2 B S_kv H D floats)
#define FLASH_BWD_ENTRY(SUFFIX, BF16)                                         \
  extern "C" int flash_attention_bwd_##SUFFIX(                                \
      const void* q, const void* k, const void* v, const void* o,             \
      const void* lse, const void* dout, void* dq, void* dk, void* dv,        \
      void* scratch, int B, int S, int Skv, int H, int Hk, int D, int causal, \
      int window, float scale, void* stream) {                                \
    return dispatch(BF16, q, k, v, o, lse, dout, dq, dk, dv, scratch, B, S,   \
                    Skv, H, Hk, D, causal, window, scale, stream);            \
  }

FLASH_BWD_ENTRY(f32, false)
FLASH_BWD_ENTRY(bf16, true)
