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
// What bounds it: at qwen2-0.5b's prefill (B = 4, S = 2048, H = 14, Hk = 2,
// D = 64, causal, bf16) the unmasked pairs need 30 GFLOP against 18 MB of
// q, k, v and o: bound by arithmetic, 30 us at the 989 TFLOP/s bf16
// tensor-core rate.  Scalar f32 FMAs (this kernel's first form) cap it at
// the 67 TFLOP/s f32 rate, so the bf16 instantiation runs on the tensor
// cores:
//
// bf16 (flash_bf16_kernel): one block per (b*h, 128-row q tile), heaviest
// (latest) tiles first; three roles.  One producer warp keeps K and V
// tiles of 64 rows coming by TMA (4-d tensor maps over (D, heads, S, B),
// so rows past S or S_kv arrive as zeros) into a three-stage ring in
// shared memory, bf16 with the 128-byte (D = 32: 64-byte) swizzle, each
// tile reported to an mbarrier; Q comes the same way once.  Two consumer
// warpgroups each own 64 q rows: S = Q K^T by wgmma (m64n64k16, both
// operands from shared memory, f32 accumulators), the online softmax with
// (m, l) in f32 registers, then O += P V by wgmma with P from registers
// and V read in its (kv, D) layout through the transpose bit.  P goes in
// as two bf16 products, its bf16 head and the bf16 rounding of the rest,
// with f32 accumulation; each consumer thread arrives on
// the stage's "empty" barrier when its products are done.  Up to D = 64
// two blocks share an SM.  The softmax is the next limit after the
// tensor cores: its work per logit is one max, one FMA folding the scale
// into the exponent, one SFU exp2 and one add; the masks are applied only
// on tiles that cross the causal diagonal, the window's edge or S_kv.  KV
// tiles that no row of a warpgroup may see are skipped by it (and never
// loaded when no row of the block sees them, as pl.when(relevant) skips
// them).
//
// Head dims 96, 112 and 256 (phi3-mini, zamba2's shared block, gemma3-4b):
// the same kernel, its tiles laid in panels of the widest swizzle row that
// divides D (wgmma_tma.cuh: three 64-byte panels a row at D = 96, seven
// 32-byte ones at 112, four 128-byte ones at 256), one TMA box a panel, so
// that no box is wider than its swizzle; S = Q K^T steps through D by k16
// as before, and O += P V runs as products over column ranges of whole
// panels (96 = 64 + 32, 112 = 64 + 32 + 16, 256 = 128 + 128) into the
// matching registers of the one accumulator.  At D = 256 the O accumulator
// is 128 f32 registers a thread, so a block has one consumer warpgroup
// (64 q rows; 210 registers a thread, no spill) and a two-stage K/V ring
// (161 KB of shared memory).  Bounds: gemma3-4b's prefill (B = 4, S =
// 2048, H = 8, Hk = 4, D = 256) needs 68.8 GFLOP causal, 51.6 with its
// 1024 window, against 101 MB: 0.070 and 0.052 ms at 989 TFLOP/s;
// zamba2's shared block (4, 2048, 32, 32, 112) 120 GFLOP, 0.122 ms.  The
// float32 body takes them with 4 threads a q row (D = 96, 112) or 8
// (D = 256).
//
// For training, each kernel also writes the row statistic the backward
// (flash_attention_bwd.cu) recomputes the probabilities from: the
// log-sum-exp of the row's scaled logits, f32 (B, S, H), when the caller
// passes a buffer for it (the serving call passes none).
//
// float32 (flash_f32_kernel) keeps the scalar body: one block per (b*h,
// 64-row q tile), a q row over D/32 neighbouring threads, K and V staged
// in shared memory as f32 and the logits of 16 keys at a time summed over
// the row's threads with shuffles.  Its only path is at S = 50, where it
// is faster than one SDPA call.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma_tma.cuh"

namespace {

using namespace tc;

// ---- float32: the scalar kernel --------------------------------------------

constexpr int BQ = 64;       // q rows per block
constexpr int BKV = 64;      // K/V rows per shared-memory stage
constexpr int KC = 16;       // keys per online-softmax step
constexpr float NEG = -1e30f;

// Threads per q row (a power of two, so that a row's partial dots sum by
// xor shuffles inside a warp) and the float4 groups each holds: 32 dims a
// thread at D = 32, 64, 128 and 256, 24 at D = 96, 28 at D = 112
template <int D>
constexpr int kTPR = D <= 32 ? 1 : (D <= 64 ? 2 : (D <= 128 ? 4 : 8));
template <int D>
constexpr int kG4 = D / (4 * kTPR<D>);

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ * kTPR<D>) flash_f32_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int S, int Skv, int H, int Hk, int causal, int window, float scale) {
  constexpr int TPR = kTPR<D>;            // threads per q row
  constexpr int G4 = kG4<D>;
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
    // m is in units of the scaled logits (q was scaled on load)
    if (lse != nullptr && sub == 0)
      lse[(static_cast<size_t>(b) * S + qi) * H + h] = m + logf(den);
  }
}

template <typename T, int D>
int launch_f32(const T* q, const T* k, const T* v, T* o, float* lse, int B,
               int S, int Skv, int H, int Hk, int causal, int window,
               float scale, cudaStream_t stream) {
  const int smem = 2 * BKV * D * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  flash_f32_kernel<T, D><<<grid, BQ * kTPR<D>, smem, stream>>>(
      q, k, v, o, lse, S, Skv, H, Hk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}


// ---- bfloat16: TMA and wgmma ------------------------------------------------

constexpr int WG_ROWS = 64;                 // q rows per consumer warpgroup
constexpr int BKV16 = 64;                   // K/V rows per stage

// A block's plan at head dim D: two consumer warpgroups and a three-stage
// K/V ring up to D = 128; at D = 256 one warpgroup (its O accumulator
// alone is 128 f32 registers a thread, so two would not fit the SM's
// register file beside their logits and P) and two stages (a 64-row tile
// is 32 KB: Q, two K and two V tiles take 161 KB of the 227)
template <int D>
struct Plan {
  static constexpr int CONSUMERS = D > 128 ? 1 : 2;
  static constexpr int KV_STAGES = D > 128 ? 2 : 3;
  static constexpr int BQ = WG_ROWS * CONSUMERS;         // q rows a block
  static constexpr int THREADS = CONSUMERS * 128 + 32;
  // the consumers' Q tiles and the K and V rings, and 1 KB to align the
  // first tile for the 128-byte swizzle
  static constexpr int SMEM =
      (CONSUMERS + 2 * KV_STAGES) * Tile<D>::BYTES + 1024;
};

template <int D>
__global__ void __launch_bounds__(Plan<D>::THREADS, D <= 64 ? 2 : 1)
    flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int Skv, int H, int Hk, int causal,
    int window, float scale) {
  using Tl = Tile<D>;
  constexpr int CONSUMERS = Plan<D>::CONSUMERS;
  constexpr int KV_STAGES = Plan<D>::KV_STAGES;
  constexpr int BQ16 = Plan<D>::BQ;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * KV_STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = smem_u32(&bars[0]);
  auto k_full = [&](int st) { return smem_u32(&bars[1 + st]); };
  auto v_full = [&](int st) { return smem_u32(&bars[1 + KV_STAGES + st]); };
  auto empty = [&](int st) { return smem_u32(&bars[1 + 2 * KV_STAGES + st]); };
  auto q_tile = [&](int w) { return base + w * Tl::BYTES; };
  auto k_tile = [&](int st) { return base + (CONSUMERS + st) * Tl::BYTES; };
  auto v_tile = [&](int st) {
    return base + (CONSUMERS + KV_STAGES + st) * Tl::BYTES;
  };

  const int n_q = (S + BQ16 - 1) / BQ16;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * BQ16;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hk);
  // the keys some row of this block may see: tiles from kv_first
  const int q_last = min(q0 + BQ16, S) - 1;
  const int key_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int key_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_first = (key_lo / BKV16) * BKV16;
  const int n_kv = key_hi > kv_first ? (key_hi - kv_first + BKV16 - 1) / BKV16
                                     : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < KV_STAGES; ++st) {
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
      mbar_expect_tx(q_full, CONSUMERS * Tl::BYTES);
      for (int w = 0; w < CONSUMERS; ++w)
        tma_tile<D>(q_tile(w), &tq, h, q0 + w * WG_ROWS, b, q_full);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % KV_STAGES;
        if (it >= KV_STAGES) mbar_wait(empty(st), ((it / KV_STAGES) - 1) & 1);
        const int kv0 = kv_first + it * BKV16;
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

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_kv; ++it) {
    const int st = it % KV_STAGES;
    const int ph = (it / KV_STAGES) & 1;
    const int kv0 = kv_first + it * BKV16;
    mbar_wait(k_full(st), ph);
    if (kv0 < hi_w && kv0 + BKV16 > lo_w) {
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_m64n64(s, desc_k<D>(q_tile(wg), kk),
                        desc_k<D>(k_tile(st), kk), kk > 0);
      }
      wgmma_commit_wait();
      fence_regs(s);

      const bool masked = (causal && kv0 + BKV16 - 1 > q0w) ||
                          (window > 0 && kv0 <= q0w + WG_ROWS - 1 - window) ||
                          kv0 + BKV16 > Skv;
      if (masked) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qi = row0 + 8 * ((i / 2) % 2);
          const int kj = kv0 + 8 * (i / 4) + 2 * t + i % 2;
          const bool ok = kj < Skv && (!causal || kj <= qi) &&
                          (window <= 0 || kj > qi - window);
          s[i] = ok ? s[i] : NEG;
        }
      }
      // (m, l) are kept in units of the raw logits; the scale enters once,
      // inside the exponent
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      float corr[2], ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        l[r] *= corr[r];
        // a row that has seen only masked keys keeps m = NEG; its masked
        // logits then give exp2(NEG * sl2) = 0
        ms[r] = mx[r] > 0.5f * NEG ? mx[r] * sl2 : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i / 2) % 2;
        s[i] = ex2(fmaf(s[i], sl2, -ms[r]));
        l[r] += s[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];
      // P as the A operand of four k16 steps, split into a bf16 head and
      // the bf16 rounding of the rest (split_frags): bf16 P alone rounds
      // each weight by up to 2^-9, which puts elements of o near zero past
      // the element-wise bf16 check (|got - want| <= 2e-2 |want| + 1e-3 of
      // the row's largest)
      uint32_t pa[4][4], pl[4][4];
      split_frags(s, pa, pl);

      mbar_wait(v_full(st), ph);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t dv = desc_t<D>(v_tile(st), j);
        rs_mma<D>(acc, pa[j], dv);
        rs_mma<D>(acc, pl[j], dv);
      }
      wgmma_commit_wait();
      fence_regs(acc);
    } else {
      mbar_wait(v_full(st), ph);
    }
    mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // (m, l) are in units of the raw logits: lse = scale m + ln l
    if (lse != nullptr && t == 0 && row0 + 8 * r < S)
      lse[(static_cast<size_t>(b) * S + row0 + 8 * r) * H + h] =
          m[r] * scale + logf(fmaxf(l[r], 1e-30f));
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const size_t q_stride = static_cast<size_t>(H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    __nv_bfloat16* op = o + (static_cast<size_t>(b) * S + qi) * q_stride +
                        static_cast<size_t>(h) * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<uint32_t*>(op + 8 * nb + 2 * t) = pack_bf16(
          acc[4 * nb + 2 * r] * l[r], acc[4 * nb + 2 * r + 1] * l[r]);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int Skv, int H, int Hk, int causal,
                int window, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err;
  if ((err = tensor_map<D>(&tq, q, B, S, H)) != 0) return err;
  if ((err = tensor_map<D>(&tk, k, B, Skv, Hk)) != 0) return err;
  if ((err = tensor_map<D>(&tv, v, B, Skv, Hk)) != 0) return err;
  const int smem = Plan<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + Plan<D>::BQ - 1) / Plan<D>::BQ);
  flash_bf16_kernel<D><<<grid, Plan<D>::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, Skv, H, Hk, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(bool bf16, const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int S, int Skv, int H, int Hk, int causal,
           int window, float scale, cudaStream_t stream) {
  if (bf16)
    return launch_bf16<D>(q, k, v, o, lse, B, S, Skv, H, Hk, causal, window,
                          scale, stream);
  return launch_f32<float, D>(static_cast<const float*>(q),
                              static_cast<const float*>(k),
                              static_cast<const float*>(v),
                              static_cast<float*>(o), lse, B, S, Skv, H, Hk,
                              causal, window, scale, stream);
}

int dispatch(bool bf16, const void* q, const void* k, const void* v, void* o,
             void* lse_out, int B, int S, int Skv, int H, int Hk, int D,
             int causal, int window, float scale, void* stream) {
  if (B < 1 || S < 1 || Skv < 1 || Hk < 1 || H % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  switch (D) {
    case 32:
      return launch<32>(bf16, q, k, v, o, lse, B, S, Skv, H, Hk, causal,
                        window, scale, st);
    case 64:
      return launch<64>(bf16, q, k, v, o, lse, B, S, Skv, H, Hk, causal,
                        window, scale, st);
    case 96:
      return launch<96>(bf16, q, k, v, o, lse, B, S, Skv, H, Hk, causal,
                        window, scale, st);
    case 112:
      return launch<112>(bf16, q, k, v, o, lse, B, S, Skv, H, Hk, causal,
                         window, scale, st);
    case 128:
      return launch<128>(bf16, q, k, v, o, lse, B, S, Skv, H, Hk, causal,
                         window, scale, st);
    case 256:
      return launch<256>(bf16, q, k, v, o, lse, B, S, Skv, H, Hk, causal,
                         window, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

#define FLASH_ENTRY(SUFFIX, BF16)                                             \
  extern "C" int flash_attention_##SUFFIX(                                    \
      const void* q, const void* k, const void* v, void* o, void* lse, int B, \
      int S, int Skv, int H, int Hk, int D, int causal, int window,           \
      float scale, void* stream) {                                            \
    return dispatch(BF16, q, k, v, o, lse, B, S, Skv, H, Hk, D, causal,       \
                    window, scale, stream);                                   \
  }

FLASH_ENTRY(f32, false)
FLASH_ENTRY(bf16, true)
