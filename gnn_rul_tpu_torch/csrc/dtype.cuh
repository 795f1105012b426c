// The kernels' storage types: float, and __nv_bfloat16 for --precision
// bf16. Every kernel computes in fp32; a bf16 instantiation converts each
// operand to float as it reads it and rounds each result once (round to
// nearest even) as it stores it, so its fp32 instantiation is the kernel
// as it was.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dtype {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive outputs: one 16-byte store of floats, four bf16 stores.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  p[0] = __float2bfloat16_rn(v.x);
  p[1] = __float2bfloat16_rn(v.y);
  p[2] = __float2bfloat16_rn(v.z);
  p[3] = __float2bfloat16_rn(v.w);
}

}  // namespace dtype
