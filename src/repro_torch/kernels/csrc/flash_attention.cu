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

namespace {

// ---- float32: the scalar kernel --------------------------------------------

constexpr int BQ = 64;       // q rows per block
constexpr int BKV = 64;      // K/V rows per shared-memory stage
constexpr int KC = 16;       // keys per online-softmax step
constexpr int G4 = 8;        // float4 groups per thread (32 dims)
constexpr float NEG = -1e30f;

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
__global__ void __launch_bounds__(BQ * (D / 32)) flash_f32_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int S, int Skv, int H, int Hk, int causal, int window, float scale) {
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
  flash_f32_kernel<T, D><<<grid, BQ * (D / 32), smem, stream>>>(
      q, k, v, o, lse, S, Skv, H, Hk, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}


// ---- bfloat16: TMA and wgmma ------------------------------------------------

constexpr int WG_ROWS = 64;                 // q rows per consumer warpgroup
constexpr int CONSUMERS = 2;                // consumer warpgroups per block
constexpr int BQ16 = WG_ROWS * CONSUMERS;   // q rows per block
constexpr int BKV16 = 64;                   // K/V rows per stage
constexpr int KV_STAGES = 3;
constexpr int TC_THREADS = CONSUMERS * 128 + 32;
constexpr float LOG2E = 1.4426950408889634f;

// A tile of 64 rows of D bf16 in shared memory: D/PW panels of 64 rows of
// PW elements (one swizzle row each), as one TMA box per panel lays them.
template <int D>
struct Tile {
  static constexpr int PW = D < 64 ? D : 64;
  static constexpr int PANELS = D / PW;
  static constexpr int ROW_BYTES = PW * 2;                  // 64 or 128
  static constexpr int PANEL_BYTES = 64 * ROW_BYTES;
  static constexpr int BYTES = PANELS * PANEL_BYTES;
  static constexpr int LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // wgmma swizzle
  static constexpr int SMEM = (CONSUMERS + 2 * KV_STAGES) * BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the phase of parity ``parity`` has completed; a phase that
// never completes (a lost arrival) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long spins = 0;
  do {
    if (++spins > (1ll << 32)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets
// (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void pv_mma(float (&o)[D / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_m64n32(o, a, db, 1);
  } else if constexpr (D == 64) {
    wgmma_rs_m64n64(o, a, db, 1);
  } else {
    wgmma_rs_m64n128(o, a, db, 1);
  }
}

// 2^x by the SFU (2 ulp; subnormal results flush to 0, as P's do anyway
// once rounded to bf16)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, D <= 64 ? 2 : 1)
    flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int Skv, int H, int Hk, int causal,
    int window, float scale) {
  using Tl = Tile<D>;
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
        for (int p = 0; p < Tl::PANELS; ++p)
          tma_load_4d(q_tile(w) + p * Tl::PANEL_BYTES, &tq, p * Tl::PW, h,
                      q0 + w * WG_ROWS, b, q_full);
      for (int it = 0; it < n_kv; ++it) {
        const int st = it % KV_STAGES;
        if (it >= KV_STAGES) mbar_wait(empty(st), ((it / KV_STAGES) - 1) & 1);
        const int kv0 = kv_first + it * BKV16;
        mbar_expect_tx(k_full(st), Tl::BYTES);
        for (int p = 0; p < Tl::PANELS; ++p)
          tma_load_4d(k_tile(st) + p * Tl::PANEL_BYTES, &tk, p * Tl::PW, hk,
                      kv0, b, k_full(st));
        mbar_expect_tx(v_full(st), Tl::BYTES);
        for (int p = 0; p < Tl::PANELS; ++p)
          tma_load_4d(v_tile(st) + p * Tl::PANEL_BYTES, &tv, p * Tl::PW, hk,
                      kv0, b, v_full(st));
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
  constexpr uint32_t SBO = 8 * Tl::ROW_BYTES;

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
        const uint32_t off = (kk * 16) / Tl::PW * Tl::PANEL_BYTES +
                             (kk * 16) % Tl::PW * 2;
        wgmma_ss_m64n64(s, desc(q_tile(wg) + off, 16, SBO, Tl::LAYOUT),
                        desc(k_tile(st) + off, 16, SBO, Tl::LAYOUT), kk > 0);
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
      // P as the A operand of four k16 steps (the accumulator layout of
      // two n8 blocks is the A fragment of one k16 step), split into a bf16
      // head and the bf16 rounding of what the head leaves: bf16 P alone
      // rounds each weight by up to 2^-9, which puts elements of o near
      // zero past the element-wise bf16 check (|got - want| <= 2e-2 |want|
      // + 1e-3 of the row's largest); the pair carries P to about 2^-17
      uint32_t pa[4][4], pl[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x0 = s[8 * j + 2 * q];
          const float x1 = s[8 * j + 2 * q + 1];
          pa[j][q] = pack_bf16(x0, x1);
          const float2 hd = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&pa[j][q]));
          pl[j][q] = pack_bf16(x0 - hd.x, x1 - hd.y);
        }

      mbar_wait(v_full(st), ph);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t dv = desc(v_tile(st) + j * 16 * Tl::ROW_BYTES,
                                 Tl::PANEL_BYTES, SBO, Tl::LAYOUT);
        pv_mma<D>(acc, pa[j], dv);
        pv_mma<D>(acc, pl[j], dv);
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

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-d map (D, heads, seq, B) of a (B, seq, heads, D) bf16 tensor, one
// box = 64 rows of one head's panel of PW elements.
template <int D>
int tensor_map(CUtensorMap* map, const void* ptr, int B, int seq,
               int heads) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  using Tl = Tile<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 2,
      static_cast<cuuint64_t>(heads) * D * 2,
      static_cast<cuuint64_t>(seq) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(Tl::PW), 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      Tl::ROW_BYTES == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
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
  const int smem = Tile<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (S + BQ16 - 1) / BQ16);
  flash_bf16_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
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
    case 128:
      return launch<128>(bf16, q, k, v, o, lse, B, S, Skv, H, Hk, causal,
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
