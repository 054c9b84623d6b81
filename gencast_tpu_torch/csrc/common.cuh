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

// Elements of T in one 16-byte vector (a lane's widest load): 4 float, 8
// bfloat16.
template <typename T>
constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));

// The kVec16<T> elements of a 16-byte vector, widened to float (exactly:
// bfloat16 -> float only appends zero bits).
__device__ __forceinline__ void unpack16(const uint4& v, float* out, float) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack16(const uint4& v, float* out,
                                         __nv_bfloat16) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower half holds the first element
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// kVec16<T> floats rounded to T (to nearest even) in one 16-byte vector.
__device__ __forceinline__ uint4 pack16(const float* in, float) {
  return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                    __float_as_uint(in[2]), __float_as_uint(in[3]));
}
__device__ __forceinline__ uint4 pack16(const float* in, __nv_bfloat16) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace gt
