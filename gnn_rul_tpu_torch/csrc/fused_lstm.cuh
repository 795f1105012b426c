// Device helpers shared by the LSTM recurrence's forward (fused_lstm.cu) and
// backward (fused_lstm_bwd.cu).
//
// W_hh (H, 4H), gates [i, f, g, o] in column blocks of H, is kept in shared
// memory as one float4 per (row k, unit j): (W[k][j], W[k][H + j],
// W[k][2H + j], W[k][3H + j]), rows and units zero-padded to hp8, the next
// multiple of 8. Slot (k, j) sits at k * hp8 + (j ^ (k & 7)): the XOR
// swizzle permutes each aligned group of 8 slots (128 bytes), so that both
// reads the kernels make are free of bank conflicts: a row k for
// consecutive j (the gate product), and a column m for consecutive rows j
// (the backward's dh = dgates @ W^T).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lstm {

constexpr int kWarp = 32;
constexpr int kMaxHidden = 1024;  // one thread per hidden unit

__host__ __device__ __forceinline__ int pad8(int h) { return (h + 7) & ~7; }

// Bytes of W_hh in the swizzled shared-memory layout.
inline size_t w_smem_bytes(int h) {
  return static_cast<size_t>(pad8(h)) * pad8(h) * sizeof(float4);
}

// 1 / (1 + e^-x), correctly rounded reciprocal (as 1.f / y), accurate expf.
__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(1.f + expf(-x));
}

// Copies one direction's W_hh (H, 4H) into the swizzled layout.
__device__ __forceinline__ void stage_w(float4* ws, const float* w, int h) {
  const int g = 4 * h, hp8 = pad8(h);
  for (int i = threadIdx.x; i < hp8 * hp8; i += blockDim.x) {
    const int k = i / hp8, j = i % hp8;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < h && j < h) {
      const float* row = w + static_cast<size_t>(k) * g + j;
      v = make_float4(row[0], row[h], row[2 * h], row[3 * h]);
    }
    ws[k * hp8 + (j ^ (k & 7))] = v;
  }
}

// a += sum_k hprev[k] * W[k][q*H + j] for the four gates q, W swizzled in
// shared memory; hprev holds hp8 values, zero beyond H.
__device__ __forceinline__ void gates_shared(const float4* ws,
                                             const float* hprev, int j,
                                             int hp8, float4& a) {
  for (int k8 = 0; k8 < hp8; k8 += 8) {
    const float4* rows = ws + k8 * hp8;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float hv = hprev[k8 + u];
      const float4 wv = rows[u * hp8 + (j ^ u)];
      a.x = fmaf(hv, wv.x, a.x);
      a.y = fmaf(hv, wv.y, a.y);
      a.z = fmaf(hv, wv.z, a.z);
      a.w = fmaf(hv, wv.w, a.w);
    }
  }
}

// The same product with W_hh (H, 4H) read from global memory (the L2),
// coalesced across j.
__device__ __forceinline__ void gates_global(const float* w,
                                             const float* hprev, int j, int h,
                                             float4& a) {
  const int g = 4 * h;
  const float* col = w + j;
#pragma unroll 4
  for (int k = 0; k < h; ++k) {
    const float hv = hprev[k];
    const float* wr = col + k * g;
    a.x = fmaf(hv, __ldg(wr), a.x);
    a.y = fmaf(hv, __ldg(wr + h), a.y);
    a.z = fmaf(hv, __ldg(wr + 2 * h), a.z);
    a.w = fmaf(hv, __ldg(wr + 3 * h), a.w);
  }
}

inline int smem_optin_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return limit;
}

// Raises `kernel`'s dynamic shared memory limit to `bytes` on the current
// device, once per device and size, so that a launch inside a CUDA graph
// capture makes no attribute call. `allowed` is the caller's per-kernel
// record, indexed by device.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = bytes;
  return err;
}

}  // namespace lstm
