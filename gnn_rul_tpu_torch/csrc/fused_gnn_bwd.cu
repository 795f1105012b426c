// Backward of the fused dot-graph chain for Hopper (sm_90a):
//
//   S = h h^T - 1e8 I;  P = softmax(leaky_relu(S, 0.01));  A = (P + I) * mask
//   out = A @ x                                   (the forward, fused_gnn.cu)
//
//   dx    = A^T g
//   dA    = g x^T;        dmask = (P + I) * dA;   dP = dA * mask
//   dZ    = P * (dP - rowsum(dP * P))             (softmax VJP, per row)
//   dS    = dZ * leaky'(S)                        (0.01 below zero: the
//                                                  diagonal takes 0.01)
//   dh    = dS h + dS^T h
//
//   h (B, N, D), x (B, N, F), mask (N, N), g (B, N, F); dh (B, N, D),
//   dx (B, N, F), dmask per sample (B, N, N) when asked for; all fp32,
//   contiguous.
//
// Replaces gnn_rul_tpu/ops/pallas/fused_gnn.py::_bwd_kernel, which recomputes
// S/P/A for one graph in VMEM and runs the whole chain there. A block here
// cannot hold an (N, N) tile for every N the forward takes (at N=384,
// D=F=128 one fp32 tile plus h, x and g exceed 227 KB), so the backward is
// the forward's design run twice, with nothing (N, N) kept and no atomics
// (every output element has one writer, so gradients are deterministic):
//
//   row pass, a warp per row i, 32-column tiles of h and x in shared memory.
//     Sweep 1 keeps the online softmax max m_i, normaliser l_i and the
//     rescaled sum_j e_ij dP_ij, which gives inner_i = rowsum(dP * P)_i;
//     (m_i, l_i, inner_i) go to a (B, N, 3) scratch. Sweep 2 rebuilds P_ij,
//     forms dS_ij, accumulates the row term sum_j dS_ij h_j into dh_i and
//     writes the dmask row when asked for.
//   column pass, a warp per column j, 32-row tiles of h and g. It rebuilds
//     P_ij from the stored statistics and A_ij = (P_ij + d_ij) mask_ij, then
//     accumulates dx_j = sum_i A_ij g_i and the column term sum_i dS_ij h_i,
//     which it adds to the row term already in dh_j.
//
// S_ij and dA_ij are computed with the same fmaf order in both passes and in
// the forward, so both passes see the same P.
//
// Bound on an H100 SXM at the FC_STGNN/FD001 training shape (B=100, N=28,
// D=F=16, per scale, no dmask): h, x and g read and dh and dx written,
// 5*100*28*16*4 B, plus a 3,136 B mask: 899,136 B, 0.27 us at 3.35 TB/s;
// 2*B*N^2*(3D + 2F) = 12.5 MFLOP, 0.19 us at 67 TFLOP/s fp32. Like the
// forward it is launch and latency bound; the design keeps two launches per
// backward and every (N, N) intermediate on chip. Tensor cores and packing
// several graphs per block are left for the work that makes it fast.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;                    // one warp per row/column
constexpr int kMaxFeat = 128;                       // limit on D and on F
constexpr int kFeatPerLane = kMaxFeat / kWarp;      // columns owned per lane
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

__device__ __forceinline__ float dot(const float* a, const float* b, int len) {
  float s = 0.f;
  for (int c = 0; c < len; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

__device__ __forceinline__ float leaky(float s) {
  return s >= 0.f ? s : 0.01f * s;
}

__device__ __forceinline__ float leaky_slope(float s) {
  return s >= 0.f ? 1.f : 0.01f;
}

// Copies rows [r0, r0 + rows) of a (n, width) matrix into shared memory at
// row stride `stride`, zero past row n.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int rows, int n, int width,
                                          int stride) {
  for (int idx = threadIdx.x; idx < rows * width; idx += blockDim.x) {
    const int r = idx / width, c = idx % width;
    dst[r * stride + c] =
        r0 + r < n ? src[static_cast<size_t>(r0 + r) * width + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
bwd_rows_kernel(const float* __restrict__ h, const float* __restrict__ x,
                const float* __restrict__ mask, const float* __restrict__ g,
                float* __restrict__ dh, float* __restrict__ dmask,
                float* __restrict__ stats, int n, int d, int f) {
  // The block's rows of h and g, then one column tile of h and of x (odd
  // row strides, so lanes reading different rows hit different banks).
  extern __shared__ float smem[];
  const int hs_stride = d | 1, xs_stride = f | 1;
  float* hi = smem;                              // [kRowsPerBlock][d]
  float* gi = hi + kRowsPerBlock * d;            // [kRowsPerBlock][f]
  float* hs = gi + kRowsPerBlock * f;            // [kWarp][hs_stride]
  float* xs = hs + kWarp * hs_stride;            // [kWarp][xs_stride]

  const int b = blockIdx.x;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int i = row0 + warp;
  const bool row_valid = i < n;

  const float* hb = h + static_cast<size_t>(b) * n * d;
  const float* xb = x + static_cast<size_t>(b) * n * f;
  load_rows(hi, hb, row0, kRowsPerBlock, n, d, d);
  load_rows(gi, g + static_cast<size_t>(b) * n * f, row0, kRowsPerBlock, n, f,
            f);
  const float* hrow = hi + warp * d;
  const float* grow = gi + warp * f;
  const float* mrow = mask + static_cast<size_t>(i) * n;

  // Sweep 1: online softmax statistics and rowsum(dP * P).
  float run_max = -INFINITY, run_sum = 0.f, run_t = 0.f;
  for (int j0 = 0; j0 < n; j0 += kWarp) {
    __syncthreads();  // the previous tile has been consumed
    load_rows(hs, hb, j0, kWarp, n, d, hs_stride);
    load_rows(xs, xb, j0, kWarp, n, f, xs_stride);
    __syncthreads();
    if (!row_valid) continue;  // whole warp: no shuffle is split

    const int j = j0 + lane;
    const bool col_valid = j < n;
    float s = dot(hrow, hs + lane * hs_stride, d);
    if (j == i) s -= 1e8f;
    const float z = col_valid ? leaky(s) : -INFINITY;
    const float dp =
        col_valid ? dot(grow, xs + lane * xs_stride, f) * mrow[j] : 0.f;

    const float new_max = fmaxf(run_max, warp_max(z));
    const float scale = expf(run_max - new_max);  // 0 on the first tile
    const float e = col_valid ? expf(z - new_max) : 0.f;
    run_sum = run_sum * scale + warp_sum(e);
    run_t = run_t * scale + warp_sum(e * dp);
    run_max = new_max;
  }
  const float inner = run_t / run_sum;

  // Sweep 2: dS row i, the row term sum_j dS_ij h_j, the dmask row.
  float acc[kFeatPerLane];
#pragma unroll
  for (int k = 0; k < kFeatPerLane; ++k) acc[k] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kWarp) {
    __syncthreads();
    load_rows(hs, hb, j0, kWarp, n, d, hs_stride);
    load_rows(xs, xb, j0, kWarp, n, f, xs_stride);
    __syncthreads();
    if (!row_valid) continue;

    const int j = j0 + lane;
    float ds = 0.f;
    if (j < n) {
      float s = dot(hrow, hs + lane * hs_stride, d);
      if (j == i) s -= 1e8f;
      const float p = expf(leaky(s) - run_max) / run_sum;
      const float da = dot(grow, xs + lane * xs_stride, f);
      ds = p * (da * mrow[j] - inner) * leaky_slope(s);
      if (dmask != nullptr)
        dmask[(static_cast<size_t>(b) * n + i) * n + j] =
            (p + (j == i ? 1.f : 0.f)) * da;
    }
    const int cols = min(kWarp, n - j0);
    for (int jj = 0; jj < cols; ++jj) {
      const float dsj = __shfl_sync(kFull, ds, jj);
      const float* hr = hs + jj * hs_stride;
#pragma unroll
      for (int k = 0; k < kFeatPerLane; ++k) {
        const int c = lane + k * kWarp;
        if (c < d) acc[k] = fmaf(dsj, hr[c], acc[k]);
      }
    }
  }
  if (!row_valid) return;

  float* dhi = dh + (static_cast<size_t>(b) * n + i) * d;
#pragma unroll
  for (int k = 0; k < kFeatPerLane; ++k) {
    const int c = lane + k * kWarp;
    if (c < d) dhi[c] = acc[k];
  }
  if (lane == 0) {
    float* st = stats + (static_cast<size_t>(b) * n + i) * 3;
    st[0] = run_max;
    st[1] = run_sum;
    st[2] = inner;
  }
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
bwd_cols_kernel(const float* __restrict__ h, const float* __restrict__ x,
                const float* __restrict__ mask, const float* __restrict__ g,
                const float* __restrict__ stats, float* __restrict__ dh,
                float* __restrict__ dx, int n, int d, int f) {
  // The block's columns of h and x, then one row tile of h, of g and of the
  // row statistics.
  extern __shared__ float smem[];
  const int hs_stride = d | 1, gs_stride = f | 1;
  float* hj = smem;                              // [kRowsPerBlock][d]
  float* xj = hj + kRowsPerBlock * d;            // [kRowsPerBlock][f]
  float* hs = xj + kRowsPerBlock * f;            // [kWarp][hs_stride]
  float* gs = hs + kWarp * hs_stride;            // [kWarp][gs_stride]
  float* st = gs + kWarp * gs_stride;            // [kWarp][3]

  const int b = blockIdx.x;
  const int col0 = blockIdx.y * kRowsPerBlock;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int j = col0 + warp;
  const bool col_valid = j < n;

  const float* hb = h + static_cast<size_t>(b) * n * d;
  const float* gb = g + static_cast<size_t>(b) * n * f;
  const float* sb = stats + static_cast<size_t>(b) * n * 3;
  load_rows(hj, hb, col0, kRowsPerBlock, n, d, d);
  load_rows(xj, x + static_cast<size_t>(b) * n * f, col0, kRowsPerBlock, n, f,
            f);
  const float* hcol = hj + warp * d;
  const float* xcol = xj + warp * f;

  float acc_x[kFeatPerLane], acc_h[kFeatPerLane];
#pragma unroll
  for (int k = 0; k < kFeatPerLane; ++k) acc_x[k] = acc_h[k] = 0.f;

  for (int i0 = 0; i0 < n; i0 += kWarp) {
    __syncthreads();
    load_rows(hs, hb, i0, kWarp, n, d, hs_stride);
    load_rows(gs, gb, i0, kWarp, n, f, gs_stride);
    load_rows(st, sb, i0, kWarp, n, 3, 3);
    __syncthreads();
    if (!col_valid) continue;

    // Lane `lane` takes row i of this column.
    const int i = i0 + lane;
    float a = 0.f, ds = 0.f;
    if (i < n) {
      float s = dot(hs + lane * hs_stride, hcol, d);
      if (i == j) s -= 1e8f;
      const float* sti = st + lane * 3;
      const float p = expf(leaky(s) - sti[0]) / sti[1];
      const float mk = mask[static_cast<size_t>(i) * n + j];
      const float da = dot(gs + lane * gs_stride, xcol, f);
      a = (p + (i == j ? 1.f : 0.f)) * mk;
      ds = p * (da * mk - sti[2]) * leaky_slope(s);
    }
    const int rows = min(kWarp, n - i0);
    for (int ii = 0; ii < rows; ++ii) {
      const float ai = __shfl_sync(kFull, a, ii);
      const float dsi = __shfl_sync(kFull, ds, ii);
      const float* gr = gs + ii * gs_stride;
      const float* hr = hs + ii * hs_stride;
#pragma unroll
      for (int k = 0; k < kFeatPerLane; ++k) {
        const int c = lane + k * kWarp;
        if (c < f) acc_x[k] = fmaf(ai, gr[c], acc_x[k]);
        if (c < d) acc_h[k] = fmaf(dsi, hr[c], acc_h[k]);
      }
    }
  }
  if (!col_valid) return;

  float* dxj = dx + (static_cast<size_t>(b) * n + j) * f;
  float* dhj = dh + (static_cast<size_t>(b) * n + j) * d;
#pragma unroll
  for (int k = 0; k < kFeatPerLane; ++k) {
    const int c = lane + k * kWarp;
    if (c < f) dxj[c] = acc_x[k];
    if (c < d) dhj[c] += acc_h[k];  // the row pass wrote the row term
  }
}

bool bad_shape(int b, int n, int d, int f) {
  return b <= 0 || n <= 0 || d <= 0 || f <= 0 || d > kMaxFeat ||
         f > kMaxFeat || (n + kRowsPerBlock - 1) / kRowsPerBlock > 65535;
}

size_t smem_bytes(int d, int f) {
  return sizeof(float) *
         (kRowsPerBlock * (d + f) + kWarp * ((d | 1) + (f | 1) + 3));
}

}  // namespace

extern "C" {

int fused_dot_graph_spmm_bwd_max_feat() { return kMaxFeat; }

// Both launch on `stream` and return cudaGetLastError(): nonzero when the
// launch was refused. Neither synchronises nor allocates. The row pass
// writes the row term into dh, the (B, N, 3) statistics into `stats` and,
// when `dmask` is not null, the per-sample dmask; the column pass, launched
// after it on the same stream, reads the statistics, writes dx and adds the
// column term into dh.
int fused_dot_graph_spmm_bwd_rows(const float* h, const float* x,
                                  const float* mask, const float* g,
                                  float* dh, float* dmask, float* stats,
                                  int b, int n, int d, int f, void* stream) {
  if (bad_shape(b, n, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, (n + kRowsPerBlock - 1) / kRowsPerBlock);
  bwd_rows_kernel<<<grid, kWarp * kRowsPerBlock, smem_bytes(d, f),
                    static_cast<cudaStream_t>(stream)>>>(
      h, x, mask, g, dh, dmask, stats, n, d, f);
  return static_cast<int>(cudaGetLastError());
}

int fused_dot_graph_spmm_bwd_cols(const float* h, const float* x,
                                  const float* mask, const float* g,
                                  const float* stats, float* dh, float* dx,
                                  int b, int n, int d, int f, void* stream) {
  if (bad_shape(b, n, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, (n + kRowsPerBlock - 1) / kRowsPerBlock);
  bwd_cols_kernel<<<grid, kWarp * kRowsPerBlock, smem_bytes(d, f),
                    static_cast<cudaStream_t>(stream)>>>(
      h, x, mask, g, stats, dh, dx, n, d, f);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_dot_graph_spmm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
