// Shared pieces of the bf16 flash attention kernels (flash_attention.cu's
// forward, flash_attention_bwd.cu's backward): bf16 tiles of 64 rows laid
// out by TMA in panels of the widest swizzle row that divides D (128 bytes
// at D = 64, 128, 256; 64 at D = 32, 96; 32 at D = 112), the mbarriers
// that report them, the 4-d tensor maps over (D, heads, S, B), wgmma's
// shared-memory descriptors and products, and the SFU's exp2.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

constexpr float LOG2E = 1.4426950408889634f;

// A tile of 64 rows of D bf16 in shared memory: D/PW panels of 64 rows of
// PW elements (one swizzle row each), as one TMA box per panel lays them.
// PW is the widest of 64, 32 and 16 that divides D: a TMA box is at most
// one swizzle row wide, so D = 96 and 112 (192 and 224 bytes a row) are
// three 64-byte and seven 32-byte panels.
template <int D>
struct Tile {
  static_assert(D % 16 == 0 && D <= 256, "head dim: a multiple of 16 to 256");
  static constexpr int PW = D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
  static constexpr int PANELS = D / PW;
  static constexpr int ROW_BYTES = PW * 2;                  // 128, 64 or 32
  static constexpr int PANEL_BYTES = 64 * ROW_BYTES;
  static constexpr int BYTES = PANELS * PANEL_BYTES;
  // wgmma's swizzle mode: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  static constexpr int LAYOUT = ROW_BYTES == 128 ? 1 : (ROW_BYTES == 64 ? 2 : 3);
  static constexpr uint32_t SBO = 8 * ROW_BYTES;
  // byte offset of the k16 step over columns [16 kk, 16 kk + 16), the
  // tile read as a K-major operand
  __host__ __device__ static constexpr uint32_t k_off(int kk) {
    return (kk * 16) / PW * PANEL_BYTES + (kk * 16) % PW * 2;
  }
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

// One tile: rows [row, row + 64) of head ``head`` of batch ``b`` through
// the tensor map, a TMA box per panel, reported to ``bar``
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int head, int row, int b,
                                         uint32_t bar) {
  using Tl = Tile<D>;
#pragma unroll
  for (int p = 0; p < Tl::PANELS; ++p)
    tma_load_4d(dst + p * Tl::PANEL_BYTES, map, p * Tl::PW, head, row, b,
                bar);
}

// ``bytes`` (a multiple of 16) contiguous bytes global -> shared, reported
// to ``bar``; both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
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

// A tile read as a K-major operand (rows along M or N, D along K) at k16
// step kk, and read through the transpose bit as the N-major B operand of
// a product over its rows (rows along K, D along N) at k16 step j.
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using Tl = Tile<D>;
  return desc(tile + Tl::k_off(kk), 16, Tl::SBO, Tl::LAYOUT);
}
template <int D>
__device__ __forceinline__ uint64_t desc_t(uint32_t tile, int j) {
  using Tl = Tile<D>;
  return desc(tile + j * 16 * Tl::ROW_BYTES, Tl::PANEL_BYTES, Tl::SBO,
              Tl::LAYOUT);
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

// d (64 x 64, f32) += A B^T over one k16 step, A and B K-major in shared
// memory; scale_d = 0 overwrites d
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

// d (64 x N, f32) += A B over one k16 step, A from registers (the
// accumulator layout of a 64 x 16 block, packed in bf16 pairs), B N-major
// in shared memory through the transpose bit
__device__ __forceinline__ void wgmma_rs_m64n16(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
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

// The accumulator's columns [c, c + N) as an m64nN accumulator of its own:
// wgmma keeps 4 registers per 8 columns, so they are acc[c/2 .. c/2 + N/2)
template <int N, int M>
__device__ __forceinline__ float (&cols(float (&acc)[M], int c))[N / 2] {
  return *reinterpret_cast<float(*)[N / 2]>(&acc[c / 2]);
}

// The descriptor ``db`` of a tile read through the transpose bit, moved to
// its column c (a multiple of the panel width): c / PW panels further on,
// in the descriptor's 16-byte units
template <int D>
__device__ __forceinline__ uint64_t at_col(uint64_t db, int c) {
  using Tl = Tile<D>;
  return db + static_cast<uint64_t>((c / Tl::PW) * Tl::PANEL_BYTES >> 4);
}

// acc (64 x D) += A B with B (16 x D) N-major: one product where an N of
// D's width is at hand, else products over column ranges of the panels
// (96 = 64 + 32, 112 = 64 + 32 + 16, 256 = 128 + 128)
template <int D>
__device__ __forceinline__ void rs_mma(float (&acc)[D / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) {
    wgmma_rs_m64n32(acc, a, db, 1);
  } else if constexpr (D == 64) {
    wgmma_rs_m64n64(acc, a, db, 1);
  } else if constexpr (D == 128) {
    wgmma_rs_m64n128(acc, a, db, 1);
  } else if constexpr (D == 96) {
    wgmma_rs_m64n64(cols<64>(acc, 0), a, db, 1);
    wgmma_rs_m64n32(cols<32>(acc, 64), a, at_col<D>(db, 64), 1);
  } else if constexpr (D == 112) {
    wgmma_rs_m64n64(cols<64>(acc, 0), a, db, 1);
    wgmma_rs_m64n32(cols<32>(acc, 64), a, at_col<D>(db, 64), 1);
    wgmma_rs_m64n16(cols<16>(acc, 96), a, at_col<D>(db, 96), 1);
  } else {
    static_assert(D == 256, "rs_mma: head dims 32, 64, 96, 112, 128, 256");
    wgmma_rs_m64n128(cols<128>(acc, 0), a, db, 1);
    wgmma_rs_m64n128(cols<128>(acc, 128), a, at_col<D>(db, 128), 1);
  }
}

// 2^x by the SFU (2 ulp; subnormal results flush to 0, as they do anyway
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

// The 64 x 64 accumulator x (wgmma's layout) as the A operands of four k16
// steps (the accumulator of two n8 blocks is the A fragment of one k16
// step), split into a bf16 head and the bf16 rounding of what the head
// leaves: bf16 alone rounds each element by up to 2^-9, the pair carries it
// to about 2^-17 (with f32 accumulation)
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hd)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x0 = x[8 * j + 2 * q];
      const float x1 = x[8 * j + 2 * q + 1];
      hd[j][q] = pack_bf16(x0, x1);
      const float2 h = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hd[j][q]));
      lo[j][q] = pack_bf16(x0 - h.x, x1 - h.y);
    }
}

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

inline EncodeTiled encode_tiled() {
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
// box = 64 rows of one head's panel of PW elements; rows past seq arrive
// as zeros.
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
      Tl::ROW_BYTES == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : Tl::ROW_BYTES == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc
