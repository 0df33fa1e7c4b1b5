// Shared pieces of the fused generation kernels (cma_gen_sample.cu,
// cma_gen_update.cu): launch-error reporting and ceil division.
#pragma once

#include <cuda_runtime.h>

namespace cma_gen {

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Each C entry point returns the launch error of its last kernel (0 when
// every launch was accepted); the Python wrapper raises on anything else.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace cma_gen
