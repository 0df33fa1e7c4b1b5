// Shared pieces of the CMA-ES kernels (cma_gen_sample.cu, cma_sample.cu,
// cma_gen_update.cu): launch-error reporting, ceil division, cp.async
// staging, the FP64 tensor-core tile (DMMA) and the dynamic shared-memory
// limit.
#pragma once

#include <cuda_runtime.h>

namespace cma_gen {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Each C entry point returns the launch error of its last kernel (0 when
// every launch was accepted); the Python wrapper raises on anything else.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// BYTES (4, 8 or 16) global -> shared, zero-filled where !ok.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a * b for one 16 x 8 x 16 FP64 tensor-core tile (an sm_90 shape).
// Fragments, g = lane / 4, t = lane % 4:
//   a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[i] = B[t + 4 i][g],
//   d[i] = D[g + 8 (i / 2)][2 t + i % 2].
constexpr int DMMA_K = 16;
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8],
                                     const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// Raises a kernel's dynamic shared-memory limit past the default 48 KB,
// once per device and size.
template <auto Kernel>
int set_smem(size_t bytes) {
  static size_t done[64] = {};
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < 64) done[dev] = bytes;
  return static_cast<int>(err);
}

}  // namespace cma_gen
