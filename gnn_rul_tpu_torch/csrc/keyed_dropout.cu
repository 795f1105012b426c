// Keyed dropout for Hopper (sm_90a): the mask and the scale in one pass.
//
//   k_g    = mix(key[g] + call * golden)            one key a group
//   bits_e = mix(k_g + (offset + e) * golden)       e the element's index in
//                                                   its group, offset that of
//                                                   the first (a rank's first
//                                                   element in the global
//                                                   batch under the data axis,
//                                                   else 0)
//   out    = bits_e >> 40 >= threshold ? x / q : 0  q = 1 - p as a float
//
//   x (G * n) contiguous, key G int64 values in device memory (G = 1 for a
//   plain forward, one a seed for seed-parallel runs: group g's n elements
//   are the g-th slice of x), out like x; fp32, or bf16 (the _bf16 entry:
//   x read as bf16, the division in fp32, out rounded once to bf16).
//   mix is splitmix64's finaliser on unsigned 64-bit words, so the bits are
//   those of gnn_rul_tpu_torch/ops/kernels/keyed_dropout.py::keep_mask,
//   which computes them in int64 tensor ops with the right shifts masked.
//
// No TPU kernel: the JAX package draws its dropout masks with jax.random
// inside XLA's fused program (flax.linen.Dropout, at the dropout sites of
// gnn_rul_tpu/nn/encoders.py, nn/attention.py and the models). The port's
// plain version takes some 13 int64 launches a dropout call; this kernel
// takes one, and the backward is the same kernel on the gradient.
//
// Bound on an H100 SXM: bytes. Each element is read once and written once,
// 8 bytes in fp32 (4 in bf16), against some 20 integer operations (two
// 64-bit products of the finaliser are several 32-bit ones each), well
// under the rate that would bind first.
//
// Design: one thread an element, grid-stride, 256 threads a block; the key
// of the element's group is recomputed by each thread (one finaliser,
// cheaper than a second pass); the division is the accurate one, as the
// plain version divides: no fast math.

#include <cstdint>

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ull;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // an H100's SMs, 16 blocks each

__device__ __forceinline__ unsigned long long mix(unsigned long long z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    keyed_dropout_kernel(const T* __restrict__ x,
                         const long long* __restrict__ key, long long call,
                         float q, unsigned threshold, T* __restrict__ out,
                         long long n, long long total, long long offset) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const long long g = i / n;
    const long long e = i - g * n;
    const unsigned long long k =
        mix(static_cast<unsigned long long>(key[g]) +
            static_cast<unsigned long long>(call) * kGolden);
    const unsigned long long bits =
        mix(k + static_cast<unsigned long long>(offset + e) * kGolden);
    const float v = dtype::to_float(x[i]);
    out[i] = dtype::from_float<T>((bits >> 40) >= threshold ? v / q : 0.0f);
  }
}

template <typename T>
int launch(const T* x, const long long* key, long long call, float q,
           unsigned threshold, T* out, long long n, long long groups,
           long long offset, void* stream) {
  if (n <= 0 || groups <= 0 || offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = n * groups;
  const long long blocks =
      (total + kThreads - 1) / kThreads < kMaxBlocks
          ? (total + kThreads - 1) / kThreads
          : kMaxBlocks;
  keyed_dropout_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, key, call, q, threshold, out, n, total, offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(): nonzero when the launch
// was refused. x and out hold `groups` slices of n elements, key `groups`
// int64 values; `threshold` is round(p * 2^24), q is 1 - p; element e of a
// group draws the bits of index offset + e. Does not synchronise and
// allocates nothing.
int keyed_dropout_fwd(const float* x, const long long* key, long long call,
                      float q, unsigned threshold, float* out, long long n,
                      long long groups, long long offset, void* stream) {
  return launch(x, key, call, q, threshold, out, n, groups, offset, stream);
}

int keyed_dropout_fwd_bf16(const dtype::bf16* x, const long long* key,
                           long long call, float q, unsigned threshold,
                           dtype::bf16* out, long long n, long long groups,
                           long long offset, void* stream) {
  return launch(x, key, call, q, threshold, out, n, groups, offset, stream);
}

const char* keyed_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
