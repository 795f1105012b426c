// Staging a block's inputs into shared memory with cp.async (sm_80 and
// later), for the kernels that hold whole graphs in a block
// (fused_gnn_bwd.cu, fused_gat.cu). Every copy of the block is issued
// before any is waited on, so the inputs cost one round trip to device
// memory, where a load into registers followed by a store to shared memory
// costs one round trip per array a thread copies (on an H100 such loads took
// 2.6 us of a 6.2 us attention launch at B=100, N=14, D=64).
//
// A bf16 source is staged by plain loads, converted to float and stored
// into the same fp32 layout, so a kernel's plan and its reads of shared
// memory are the same at either dtype (bf16 staging by cp.async, into a
// bf16 layout, is later work).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace stage {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Waits for every copy this thread issued; a barrier after it makes all of
// the block's copies visible to the block.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Issues the copy of `rows` rows of `width` floats from `src` (row stride
// `src_stride`) to `dst` (row stride `dst_stride`), spread over the block's
// threads; rows * width fits an int (it fits shared memory). 16-byte copies
// where the layout allows them (both blocks contiguous and equally aligned
// modulo 16 bytes, or rows whose width and strides are multiples of 4
// floats on 16-byte boundaries), else 4 bytes, a thread keeping its column.
__device__ __forceinline__ void rows(float* dst, int dst_stride,
                                     const float* src, long long src_stride,
                                     int rows, int width) {
  const int total = rows * width;
  const int t = threadIdx.x, nt = blockDim.x;
  const uintptr_t sa = reinterpret_cast<uintptr_t>(src);
  const unsigned da = smem_addr(dst);
  if (dst_stride == width && src_stride == width && ((sa ^ da) & 15) == 0) {
    const int head = min(total, static_cast<int>(((16 - (sa & 15)) & 15) / 4));
    const int quads = (total - head) / 4;
    for (int e = t; e < head; e += nt) copy4(dst + e, src + e);
    for (int q = t; q < quads; q += nt)
      copy16(dst + head + 4 * q, src + head + 4 * q);
    for (int e = head + 4 * quads + t; e < total; e += nt)
      copy4(dst + e, src + e);
    return;
  }
  const bool wide = width % 4 == 0 && dst_stride % 4 == 0 &&
                    src_stride % 4 == 0 && (sa & 15) == 0 && (da & 15) == 0;
  const int step = wide ? 4 : 1, cols = width / step;
  if (cols <= nt) {
    const int per = nt / cols, c = step * (t % cols);
    if (t >= per * cols) return;
    for (int r = t / cols; r < rows; r += per) {
      if (wide)
        copy16(dst + r * dst_stride + c, src + r * src_stride + c);
      else
        copy4(dst + r * dst_stride + c, src + r * src_stride + c);
    }
    return;
  }
  for (int r = 0; r < rows; ++r)
    for (int c = step * t; c < width; c += step * nt) {
      if (wide)
        copy16(dst + r * dst_stride + c, src + r * src_stride + c);
      else
        copy4(dst + r * dst_stride + c, src + r * src_stride + c);
    }
}

// The same copy from a bf16 source, converted: synchronous stores to
// shared memory, made visible to the block by the barrier after
// wait_all() as the asynchronous ones are.
__device__ __forceinline__ void rows(float* dst, int dst_stride,
                                     const dtype::bf16* src,
                                     long long src_stride, int rows,
                                     int width) {
  const int total = rows * width;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / width, c = e - r * width;
    dst[r * dst_stride + c] = dtype::to_float(src[r * src_stride + c]);
  }
}

}  // namespace stage
