// Shared helpers for the port's CUDA kernels: element-type conversion and
// the dtype codes the ctypes wrappers pass (0 = float32, 1 = bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gt {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to T and widened back: the value a T-typed matmul operand holds.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

}  // namespace gt
