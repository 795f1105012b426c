// Fused dot-graph chain for Hopper (sm_90a), forward only:
//
//   out = ((softmax(leaky_relu(h h^T - 1e8 I, 0.01)) + I) * mask) @ x
//
//   h (B, N, D), x (B, N, F), mask (N, N), out (B, N, F); all fp32, contiguous.
//
// Replaces gnn_rul_tpu/ops/pallas/fused_gnn.py::_kernel,_packed_kernel (the
// per-graph and the block-diagonally packed TPU forward). Neither the TPU's
// 128-lane padding nor its packing carries over: one block owns one graph and
// a tile of kRowsPerBlock rows (one warp per row), and streams 32-column tiles
// of h and x through shared memory. Per row it keeps an online softmax (running
// max and normaliser) and a mask-weighted numerator, so no (N, N) tile is ever
// held and any N works. The mask multiplies after the softmax, so the
// normaliser Z_i = sum_j exp(z_ij - max) is unmasked while the numerator is
// sum_j exp(z_ij - max) mask_ij x_j; then out_i = num_i / Z_i + mask_ii x_i.
// The -1e8 diagonal shift is kept as it is (not -inf), so N = 1 and rows whose
// other logits all underflow agree with the plain version.
//
// Bound on an H100 SXM at the FC_STGNN/FD001 serving shape (B=100, N=28,
// D=F=16, per scale): it moves h + x + out = 3*100*28*16*4 B = 537,600 B plus a
// 3,136 B mask, 0.16 us at 3.35 TB/s, and does 2*B*N^2*(D+F) = 5.0 MFLOP. So it
// is launch/latency bound; the design keeps one launch per scale and every
// intermediate on chip. Tensor cores, TMA and packing several graphs per block
// are left for the work that makes it fast.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;                    // one warp per output row
constexpr int kMaxFeat = 128;                       // limit on D and on F
constexpr int kFeatPerLane = kMaxFeat / kWarp;      // F columns owned per lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
fused_dot_graph_spmm_kernel(const float* __restrict__ h,
                            const float* __restrict__ x,
                            const float* __restrict__ mask,
                            float* __restrict__ out, int n, int d, int f) {
  // Shared memory: the block's rows of h, then one column tile of h (odd row
  // stride, so lanes reading different rows hit different banks) and of x.
  extern __shared__ float smem[];
  const int hs_stride = d | 1;
  float* hi = smem;                              // [kRowsPerBlock][d]
  float* hs = hi + kRowsPerBlock * d;            // [kWarp][hs_stride]
  float* xs = hs + kWarp * hs_stride;            // [kWarp][f]

  const int b = blockIdx.x;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int i = row0 + warp;
  const bool row_valid = i < n;

  const float* hb = h + static_cast<size_t>(b) * n * d;
  const float* xb = x + static_cast<size_t>(b) * n * f;

  for (int idx = threadIdx.x; idx < kRowsPerBlock * d; idx += blockDim.x) {
    const int row = row0 + idx / d;
    hi[idx] = row < n ? hb[static_cast<size_t>(row) * d + idx % d] : 0.f;
  }

  float run_max = -INFINITY;
  float run_sum = 0.f;
  float acc[kFeatPerLane];
#pragma unroll
  for (int k = 0; k < kFeatPerLane; ++k) acc[k] = 0.f;

  for (int j0 = 0; j0 < n; j0 += kWarp) {
    __syncthreads();  // the previous tile has been consumed
    for (int idx = threadIdx.x; idx < kWarp * d; idx += blockDim.x) {
      const int r = idx / d, c = idx % d, j = j0 + r;
      hs[r * hs_stride + c] = j < n ? hb[static_cast<size_t>(j) * d + c] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kWarp * f; idx += blockDim.x) {
      const int j = j0 + idx / f;
      xs[idx] = j < n ? xb[static_cast<size_t>(j) * f + idx % f] : 0.f;
    }
    __syncthreads();
    if (!row_valid) continue;  // whole warp: no shuffle is split

    // Lane `lane` scores column j of this row.
    const int j = j0 + lane;
    const bool col_valid = j < n;
    const float* hrow = hi + warp * d;
    const float* hcol = hs + lane * hs_stride;
    float s = 0.f;
    for (int c = 0; c < d; ++c) s = fmaf(hrow[c], hcol[c], s);
    if (j == i) s -= 1e8f;
    float z = s >= 0.f ? s : 0.01f * s;
    if (!col_valid) z = -INFINITY;

    const float new_max = fmaxf(run_max, warp_max(z));
    const float scale = expf(run_max - new_max);  // 0 on the first tile
    const float p = col_valid ? expf(z - new_max) : 0.f;
    run_sum = run_sum * scale + warp_sum(p);
    run_max = new_max;
    const float w = col_valid ? p * mask[static_cast<size_t>(i) * n + j] : 0.f;

#pragma unroll
    for (int k = 0; k < kFeatPerLane; ++k) acc[k] *= scale;
    const int cols = min(kWarp, n - j0);
    for (int jj = 0; jj < cols; ++jj) {
      const float wj = __shfl_sync(kFull, w, jj);
      const float* xr = xs + jj * f;
#pragma unroll
      for (int k = 0; k < kFeatPerLane; ++k) {
        const int c = lane + k * kWarp;
        if (c < f) acc[k] = fmaf(wj, xr[c], acc[k]);
      }
    }
  }
  if (!row_valid) return;

  const float self_w = mask[static_cast<size_t>(i) * n + i];
  const float* xi = xb + static_cast<size_t>(i) * f;
  float* oi = out + (static_cast<size_t>(b) * n + i) * f;
#pragma unroll
  for (int k = 0; k < kFeatPerLane; ++k) {
    const int c = lane + k * kWarp;
    if (c < f) oi[c] = acc[k] / run_sum + self_w * xi[c];
  }
}

}  // namespace

extern "C" {

int fused_dot_graph_spmm_max_feat() { return kMaxFeat; }

// Launches on `stream` and returns cudaGetLastError(): nonzero when the launch
// was refused. Does not synchronise and allocates nothing.
int fused_dot_graph_spmm_fwd(const float* h, const float* x, const float* mask,
                             float* out, int b, int n, int d, int f,
                             void* stream) {
  if (b <= 0 || n <= 0 || d <= 0 || f <= 0 || d > kMaxFeat || f > kMaxFeat ||
      (n + kRowsPerBlock - 1) / kRowsPerBlock > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, (n + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem =
      sizeof(float) * (kRowsPerBlock * d + kWarp * (d | 1) + kWarp * f);
  fused_dot_graph_spmm_kernel<<<grid, kWarp * kRowsPerBlock, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      h, x, mask, out, n, d, f);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_dot_graph_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
