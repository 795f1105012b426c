// Fused dense graph attention for Hopper (sm_90a), forward only:
//
//   e_ij = leaky_relu(f1_i + f2_j + bias, slope)
//   out  = (softmax_j(e) * adj) @ wh
//
//   wh (B, N, D), f1 and f2 (B, N), adj (B, N, N) or one (N, N) shared by every
//   graph, bias one float in device memory, slope a float; out (B, N, D); all
//   fp32, contiguous.
//
// Replaces gnn_rul_tpu/ops/pallas/fused_gat.py::_kernel. The TPU kernel pads N
// and D to 128 lanes and materialises the (Np, Np) panel in VMEM, one graph per
// grid step; none of that carries over. The logits of a row are rank-1
// (f1_i + f2_j), so they are recomputed from f1 and f2 wherever needed and
// nothing (N, N) exists, in memory or in registers.
//
// The graphs this kernel serves are small (N = 14 at C-MAPSS, 17 for the
// bearing models) and many (STFA: 25 patch graphs per window, 25,000 in a
// request of 1000), so it is bound by latency, not by bytes: a first version
// with a block per (graph, tile of 8 rows), one warp per row, wh staged in
// shared memory and two barriers per tile took 237 us for 25,000 graphs of
// N = 14, D = 5 on an H100 (PERF.md), with 2 of 16 warps idle and every
// block waiting on a chain of dependent loads. So rows are flattened over the
// graphs, (graph, row) = r, and each row gets a segment of S lanes, S the
// power of 2 that covers N up to 32 (S = 16 at N = 14: two rows per warp); no
// shared memory, no barrier, each warp independent. A row takes two passes
// over its columns, S at a time, lane = column:
//   1. statistics: the row's max m and unmasked normaliser Z = sum_j exp(e_ij-m)
//      (the adjacency multiplies after the softmax, as in the TPU kernel), read
//      from f2 alone;
//   2. aggregation: w_ij = (exp(e_ij - m) / Z) * adj_ij, in the plain version's
//      order, then out_i += w_ij wh_j, j in order; wh rows are read straight
//      from global memory (the L1 serves the rows of one graph to all of its
//      N rows), D in chunks of 4S columns (4 per lane).
// Any N (columns in tiles of S = 32 beyond 32) and any D work; at a few
// graphs of large N or D (B = 2, N = 130) the first version's shared-memory
// tiles were faster, since few warps then walk long loops of global loads.
// adj is read
// through a per-graph stride that is 0 for the shared (N, N). expf and the
// division are the accurate ones: no fast math. A segment past the last row
// shadows the last row, so every shuffle runs on all 32 lanes, and stores
// nothing.
//
// Bound on an H100 SXM: bytes. At STAGNN's (B, N, D) = (100, 14, 64) with
// per-graph adj it must move wh + f1 + f2 + adj + bias + out = 806,404 B,
// 0.24 us at 3.35 TB/s, for 2*B*N^2*D = 2.5 MFLOP (0.04 us at 67 TFLOP/s
// fp32); at STFA's (2500, 14, 5) with the shared adj 1,680,788 B, 0.50 us.
// Both are far below a launch's latency, so the design keeps one launch per
// attention head and every intermediate on chip. Vector loads, tensor cores
// at large N, and more than one output column per lane at STFA's D = 5 (5 of
// 16 lanes accumulate) are left for the work that makes it fast.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kPerLane = 4;  // output columns per lane in one pass over D
constexpr unsigned kFull = 0xffffffffu;

// Reductions within aligned segments of S lanes.
template <int S>
__device__ __forceinline__ float seg_max(float v) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <int S>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The plain version's order: (f1_i + f2_j) + bias, then leaky_relu.
__device__ __forceinline__ float logit(float f1i, float f2j, float bias,
                                       float slope) {
  const float e = (f1i + f2j) + bias;
  return e >= 0.f ? e : e * slope;
}

struct Args {
  const float* wh;
  const float* f1;
  const float* f2;
  const float* adj;
  const float* bias;
  float slope;
  float* out;
  long long rows;        // B * N
  int n;
  int d;
  long long adj_stride;  // N * N, or 0 for the shared (N, N)
};

template <int S>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
fused_gat_kernel(const Args a) {
  const float* __restrict__ wh = a.wh;
  const float* __restrict__ f2 = a.f2;
  const float slope = a.slope;
  const long long rows = a.rows;
  const int n = a.n;
  const int d = a.d;
  const int lane = threadIdx.x % kWarp;
  const int sl = lane % S;  // this lane's column within the row's segment
  const long long warp_id =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  const long long r_own = warp_id * (kWarp / S) + lane / S;
  const bool valid = r_own < rows;
  const long long r = valid ? r_own : rows - 1;
  const long long b = r / n;
  const int i = static_cast<int>(r - b * n);

  const float bias = *a.bias;
  const float f1i = a.f1[r];
  const float* f2b = f2 + b * n;
  const float* whb = wh + b * n * d;
  const float* adj_row =
      a.adj + b * a.adj_stride + static_cast<long long>(i) * n;

  // Pass 1: the row's max, then its unmasked normaliser.
  float m = -INFINITY;
  for (int j0 = 0; j0 < n; j0 += S) {
    const int j = j0 + sl;
    const float e = j < n ? logit(f1i, f2b[j], bias, slope) : -INFINITY;
    m = fmaxf(m, seg_max<S>(e));
  }
  float z = 0.f;
  for (int j0 = 0; j0 < n; j0 += S) {
    const int j = j0 + sl;
    const float p = j < n ? expf(logit(f1i, f2b[j], bias, slope) - m) : 0.f;
    z += seg_sum<S>(p);
  }

  // Pass 2: out_i = sum_j w_ij wh_j, a chunk of 4S columns of D at a time.
  for (int c0 = 0; c0 < d; c0 += S * kPerLane) {
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    for (int j0 = 0; j0 < n; j0 += S) {
      const int j = j0 + sl;
      float w = 0.f;
      if (j < n)
        w = (expf(logit(f1i, f2b[j], bias, slope) - m) / z) * adj_row[j];
      const int cols = min(S, n - j0);
#pragma unroll 4
      for (int jj = 0; jj < cols; ++jj) {
        const float wj = __shfl_sync(kFull, w, jj, S);
        const float* whr = whb + static_cast<long long>(j0 + jj) * d + c0;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int c = sl + k * S;
          if (c0 + c < d) acc[k] = fmaf(wj, whr[c], acc[k]);
        }
      }
    }
    if (valid) {
      float* oi = a.out + r * d + c0;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = sl + k * S;
        if (c0 + c < d) oi[c] = acc[k];
      }
    }
  }
}

template <int S>
int launch(const Args& a, cudaStream_t stream) {
  const long long rows_per_block = kWarpsPerBlock * (kWarp / S);
  const long long blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  fused_gat_kernel<S><<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock,
                        0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError(): nonzero when the launch
// was refused. `shared_adj` nonzero: adj is one (N, N) for every graph. Does
// not synchronise and allocates nothing.
int fused_gat_fwd(const float* wh, const float* f1, const float* f2,
                  const float* adj, const float* bias, float slope, float* out,
                  int b, int n, int d, int shared_adj, void* stream) {
  if (b <= 0 || n <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{wh, f1, f2, adj, bias, slope, out,
               static_cast<long long>(b) * n, n, d,
               shared_adj ? 0LL : static_cast<long long>(n) * n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 1) return launch<1>(a, s);
  if (n <= 2) return launch<2>(a, s);
  if (n <= 4) return launch<4>(a, s);
  if (n <= 8) return launch<8>(a, s);
  if (n <= 16) return launch<16>(a, s);
  return launch<32>(a, s);
}

const char* fused_gat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
