// The counter stream of the in-kernel RNG tier, drawn into the sample
// kernels' Z slabs by their draw policy (sample_gemm.cuh, rows 3-4 where
// one column block spans the row) and alone by z_rng_kernel
// (cma_gen_sample.cu, row 5, which rows 3-4 launch first on wider rows).
//
// Port of repro/kernels/ref.py:80-136 (_threefry2x32, _bits_to_unit,
// threefry_normal): Z[s, r, c] = sqrt(-2 log1p(-u1)) cos(2 pi u2), where
// (u1, u2) are the two output words of threefry2x32-20 under the slot's
// seed words for the counter ((r << 16) | c, 0), each mapped to [0, 1) by
// its top 23 bits.  One normal per counter (the sine partner is dropped),
// so each element depends on (seed, row, col) alone: the stream does not
// depend on tiling, padding or how many rows are drawn.
//
// The words and the uniforms are bit-exact against the plain version
// (kernels/ref.py).  log1p and cos are CUDA's accurate library functions
// (the build does not use --use_fast_math; float uses log1pf/cosf, never
// __cosf), so z agrees with the CPU's to a few ulp, not bit for bit.
#pragma once

#include <cstdint>

namespace cma_rng {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Four rounds of threefry2x32 with the rotation constants a..d.
__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1, int a,
                                        int b, int c, int d) {
  x0 += x1; x1 = rotl32(x1, a) ^ x0;
  x0 += x1; x1 = rotl32(x1, b) ^ x0;
  x0 += x1; x1 = rotl32(x1, c) ^ x0;
  x0 += x1; x1 = rotl32(x1, d) ^ x0;
}

// Threefry-2x32 with 20 rounds: key (k0, k1), counter (c0, c1) -> (o0, o1).
__device__ __forceinline__ void threefry2x32_20(uint32_t k0, uint32_t k1,
                                                uint32_t c0, uint32_t c1,
                                                uint32_t& o0, uint32_t& o1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}

// uint32 -> [0, 1): the top 23 bits as a float mantissa in [1, 2), minus 1.
__device__ __forceinline__ float bits_to_unit(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ double log1p_t(double x) { return log1p(x); }
__device__ __forceinline__ float log1p_t(float x) { return log1pf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }

// Z at (row, col) of the slot with seed words (k0, k1), computed in T.
template <typename T>
__device__ __forceinline__ T threefry_normal(uint32_t k0, uint32_t k1,
                                             uint32_t row, uint32_t col) {
  uint32_t b0, b1;
  threefry2x32_20(k0, k1, (row << 16) | col, 0u, b0, b1);
  const T u1 = static_cast<T>(bits_to_unit(b0));
  const T u2 = static_cast<T>(bits_to_unit(b1));
  const T two_pi = static_cast<T>(2.0 * 3.14159265358979323846);
  return sqrt_t(T(-2) * log1p_t(-u1)) * cos_t(two_pi * u2);
}

}  // namespace cma_rng
