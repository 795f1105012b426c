// Fused dense graph attention for Hopper (sm_90a), forward only:
//
//   e_ij = leaky_relu(f1_i + f2_j + bias, slope)
//   out  = (softmax_j(e) * adj) @ wh
//
//   wh (B, N, D), f1 and f2 (B, N), adj (B, N, N) or one (N, N) shared by every
//   graph, bias one float in device memory, slope a float; out (B, N, D); all
//   fp32, or all bf16 (the _bf16 entry: read as bf16 and staged into the
//   fp32 layout, the softmax and the products in fp32, out rounded once to
//   bf16; slope a float either way), contiguous.
//
//   Or groups (seed-parallel runs, all seeds in one launch): adj (A, N, N),
//   graph b on adj[b / (B/A)], and bias G floats, graph b with
//   bias[b / (B/G)], A and G dividing B (A = B is the per-graph adj, A = 1
//   the shared one). A block of whole graphs holds graphs of one part only:
//   the consecutive graphs that share a bias and, for 1 < A < B, an adj
//   (the caller's `part`, B at A = G = 1): the plan takes the most graphs
//   a block, up to the ungrouped plan's, that divide a part's. The
//   arithmetic of a graph is the same at every grouping.
//
// Replaces gnn_rul_tpu/ops/pallas/fused_gat.py::_kernel. The TPU kernel pads N
// and D to 128 lanes and materialises the (Np, Np) panel in VMEM, one graph per
// grid step; the padding does not carry over, the one panel per graph does.
//
// Bound on an H100 SXM: bytes. At STAGNN's (B, N, D) = (100, 14, 64) with
// per-graph adj it must move wh + f1 + f2 + adj + bias + out = 806,404 B,
// 0.24 us at 3.35 TB/s, for 2*B*N^2*D = 2.5 MFLOP (0.04 us at 67 TFLOP/s
// fp32); at STFA's (25000, 14, 5) with the shared adj 16,800,788 B, 5.0 us.
// The graphs are small (N = 14 at C-MAPSS, 17 for the bearing models) and,
// at STFA, many (25 patch graphs a window: 25,000 in a request of 1000), so
// below a few thousand graphs a launch's latency and the chain of steps
// inside one graph set the time.
//
// Design: a graph's data is read once and shared by its rows; each weight
// w_ij is formed once; every thread owns output elements. A block of 256
// threads holds whole graphs, or a tile of one graph's rows, in shared
// memory, in three phases with a barrier between them:
//   1. staging: f1, f2, adj (per graph, or the shared (N, N)'s rows) and wh
//      of the block's graphs are contiguous in device memory; all of them
//      are issued together by cp.async (stage.cuh), 16 bytes where the
//      alignment allows;
//   2. weights: a segment of S lanes a row (S the power of 2 that covers N,
//      up to 32), lane j: the row's max m_i and unmasked normaliser Z_i by
//      shuffles (the adjacency multiplies after the softmax, as in the TPU
//      kernel), then w_ij = (exp(e_ij - m_i) / Z_i) * adj_ij once, in the
//      plain version's order, into a tile at a stride of 4-float groups;
//   3. outputs: where D is a multiple of 4, a thread takes 4 columns of 2
//      rows of one graph, reading weights and wh 16 bytes at a time (one
//      graph's wh rows then sit round4(N) apart, zero past N); else a thread
//      keeps one column and takes 2 rows, so no lane idles at D = 5.
// The plan (fused_gat_plan), chosen from (B, N, D) alone: at B >= 132 (an
// H100's SMs) whole graphs, as many a block as bring its pairs or outputs
// to about 2,048 (10 at STFA's N = 14, D = 5; 2 at STAGNN's D = 64) while
// keeping B / 132 blocks or more; below 132 graphs, or where a graph does
// not fit 48 KB, each graph's rows are tiled over ceil(132 / B) blocks, so a
// few large graphs ((2, 130, 16), (3, 17, 300)) still spread over the SMs,
// and wh goes in column chunks where even one row does not fit. N is at
// most 3,069. expf and the division are the accurate ones: no fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

using dtype::from_float;
using dtype::to_float;

constexpr int kThreads = 256;
constexpr long long kTargetBlocks = 132;   // an H100's SMs
constexpr long long kWorkPerBlock = 2048;  // pairs or outputs a block
constexpr long long kBudget = 48 * 1024 / 4;  // shared floats a block

// The plain version's order: (f1_i + f2_j) + bias, then leaky_relu.
__device__ __forceinline__ float logit(float f1i, float f2j, float bias,
                                       float slope) {
  const float e = (f1i + f2j) + bias;
  return e >= 0.f ? e : e * slope;
}

struct Plan {
  int graphs;      // whole graphs a block (1 when rows < N)
  int rows;        // rows of a graph a block
  int cols;        // columns of wh a chunk
  int row_tiles;   // blocks a graph
  long long blocks;
  long long smem;  // bytes
};

// n rounded up to a multiple of 4.
__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Row stride of the weight tile: n rounded up to 4 floats, then an odd
// number of 4-float groups, so 16-byte reads of different rows spread
// over the banks.
__host__ __device__ __forceinline__ int quad_stride(int n) {
  return 4 * (((n + 3) / 4) | 1);
}

// Shared floats of a block holding `g` graphs of `r` rows, wh in chunks of
// `c` columns: f2, then f1 of each row, the (r, quad_stride(N)) weight
// tile, the (r, N) adj rows and the (round4(N), c) wh chunk.
long long floats(int n, int g, int r, int c) {
  return static_cast<long long>(g) *
         (n + r + static_cast<long long>(r) * (quad_stride(n) + n) +
          static_cast<long long>(round4(n)) * c);
}

bool make_plan(long long b, int n, int d, long long part, Plan* p) {
  if (b <= 0 || n <= 0 || d <= 0 || part <= 0 || b % part != 0) return false;
  const long long work = static_cast<long long>(n) * (n > d ? n : d);
  if (b >= kTargetBlocks && floats(n, 1, n, d) <= kBudget) {
    long long g = kWorkPerBlock / work;
    if (g > kBudget / floats(n, 1, n, d)) g = kBudget / floats(n, 1, n, d);
    if (g > b / kTargetBlocks) g = b / kTargetBlocks;
    if (g < 1) g = 1;
    while (part < b && part % g != 0) --g;  // no block straddles parts
    *p = {static_cast<int>(g), n, d, 1, (b + g - 1) / g,
          4 * floats(n, static_cast<int>(g), n, d)};
    return true;
  }
  long long tiles = (kTargetBlocks + b - 1) / b;
  if (tiles > n) tiles = n;
  int rows = static_cast<int>((n + tiles - 1) / tiles);
  int cols = d;
  while (rows > 1 && floats(n, 1, rows, cols) > kBudget) rows = (rows + 1) / 2;
  if (floats(n, 1, rows, cols) > kBudget) {
    long long fit = (kBudget - floats(n, 1, rows, 0)) / round4(n);
    if (fit >= 4) fit &= ~3LL;  // keeps 4-column steps where D allows
    if (fit < 1) return false;
    cols = static_cast<int>(fit);
  }
  const int row_tiles = (n + rows - 1) / rows;
  *p = {1, rows, cols, row_tiles, b * row_tiles,
        4 * floats(n, 1, rows, cols)};
  return p->blocks <= 2147483647LL;
}

template <typename T>
struct Args {
  const T* wh;
  const T* f1;
  const T* f2;
  const T* adj;
  const T* bias;
  float slope;
  T* out;
  long long b;
  int n;
  int d;
  long long adj_stride;  // N * N per graph, or 0 for a shared (N, N)
  int adj_group;         // graphs on one shared (N, N): B / A
  int bias_group;        // graphs on one bias: B / G
  Plan plan;
};

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// Reductions within aligned segments of S lanes; `lanes` names the lanes
// of the warp that take part (whole segments).
template <int S>
__device__ __forceinline__ float seg_max(float v, unsigned lanes) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(lanes, v, off));
  return v;
}

template <int S>
__device__ __forceinline__ float seg_sum(float v, unsigned lanes) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(lanes, v, off);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float a, float4 b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

template <typename T, int S>
__global__ void __launch_bounds__(kThreads) fused_gat_kernel(const Args<T> a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = a.n, d = a.d, n4 = round4(n), ps = quad_stride(n);
  const Plan& p = a.plan;
  // The block's graphs [gb0, gb0 + gn) and, of each, rows [i0, i0 + rn).
  long long gb0;
  int gn, i0, rn;
  if (p.row_tiles == 1) {
    gb0 = static_cast<long long>(blockIdx.x) * p.graphs;
    gn = static_cast<int>(min(static_cast<long long>(p.graphs), a.b - gb0));
    i0 = 0;
    rn = n;
  } else {
    gb0 = blockIdx.x / p.row_tiles;
    gn = 1;
    i0 = (blockIdx.x % p.row_tiles) * p.rows;
    rn = min(p.rows, n - i0);
  }
  const int rows = gn * rn;  // the block's rows, k = graph * rn + row
  const int cap = p.graphs * p.rows;
  // Columns 4 at a time where every chunk of D allows; a graph's wh rows
  // then sit n4 apart, zero past n.
  const bool quads = d % 4 == 0 && p.cols % 4 == 0;
  const int nr = quads ? n4 : n;
  float* ws = smem;                     // [rows][ps], zero past n
  float* whs = ws + cap * ps;           // [gn][nr][cn]
  float* f2s = whs + p.graphs * n4 * p.cols;  // [gn][n]
  float* f1s = f2s + p.graphs * n;      // [rows]
  float* adjs = f1s + cap;              // [rows, or rn when shared][n]

  const bool shared_adj = a.adj_stride == 0;
  int cn = min(p.cols, d);
  if (nr == n || gn == 1) {
    stage::rows(whs, cn, a.wh + gb0 * n * d, d, gn * n, cn);
  } else {
    for (int g = 0; g < gn; ++g)
      stage::rows(whs + g * nr * cn, cn, a.wh + (gb0 + g) * n * d, d, n, cn);
  }
  for (int g = 0; g < gn && nr != n; ++g)
    for (int e = threadIdx.x; e < (nr - n) * cn; e += kThreads)
      whs[(g * nr + n) * cn + e] = 0.f;  // rows n..n4-1
  stage::rows(f2s, gn * n, a.f2 + gb0 * n, gn * n, 1, gn * n);
  stage::rows(f1s, rows, a.f1 + gb0 * n + i0, rows, 1, rows);
  const int adj_rows = shared_adj ? rn : rows;
  // One group (the call of before) reads the first adj and bias.
  const int g0 = static_cast<int>(gb0);
  const T* adj =
      a.adj + (!shared_adj ? gb0 * a.adj_stride
               : a.adj_group == a.b
                   ? 0LL
                   : static_cast<long long>(g0 / a.adj_group) * n * n);
  stage::rows(adjs, adj_rows * n, adj + static_cast<long long>(i0) * n,
              adj_rows * n, 1, adj_rows * n);
  const float bias =
      to_float(a.bias[a.bias_group == a.b ? 0 : g0 / a.bias_group]);
  const float slope = a.slope;
  stage::wait_all();
  __syncthreads();
  // A segment of S lanes a row, lane j: the row's max and normaliser by
  // shuffles, each w_ij = (exp(e_ij - m_i) / Z_i) * adj_ij once; zero for
  // j in [n, n4).
  const int segs = kThreads / S, seg = threadIdx.x / S, sl = threadIdx.x % S;
  int g = seg / rn, r = seg - g * rn;  // row k = g * rn + r of the block
  for (int k0 = 0; k0 < rows; k0 += segs) {
    const int k = k0 + seg;
    if (k0 > 0) {
      for (r += segs; r >= rn; r -= rn) ++g;
    }
    const unsigned lanes = __ballot_sync(kFull, k < rows);
    if (k >= rows) continue;
    const float f1i = f1s[k];
    const float* f2g = f2s + g * n;
    const float* arow = adjs + (shared_adj ? r : k) * n;
    float* wrow = ws + k * ps;
    if (S < kWarp || n <= kWarp) {  // one column a lane
      const bool col = sl < n;
      const float e = col ? logit(f1i, f2g[sl], bias, slope) : -INFINITY;
      const float m = seg_max<S>(e, lanes);
      const float x = col ? expf(e - m) : 0.f;
      const float z = seg_sum<S>(x, lanes);
      if (col) wrow[sl] = (x / z) * arow[sl];
      for (int j = n + sl; j < n4; j += S) wrow[j] = 0.f;
      continue;
    }
    float m = -INFINITY;
    for (int j = sl; j < n; j += S)
      m = fmaxf(m, logit(f1i, f2g[j], bias, slope));
    m = seg_max<S>(m, lanes);
    float z = 0.f;
    for (int j = sl; j < n; j += S) {
      const float e = expf(logit(f1i, f2g[j], bias, slope) - m);
      wrow[j] = e;
      z += e;
    }
    z = seg_sum<S>(z, lanes);
    for (int j = sl; j < n4; j += S)
      wrow[j] = j < n ? (wrow[j] / z) * arow[j] : 0.f;
  }
  __syncthreads();

  // Outputs. Where D allows, a thread takes 4 columns of 2 rows of one
  // graph, reading the weights and wh 16 bytes at a time, 4 columns j a
  // step; else a thread keeps one column c and takes 2 rows at a time.
  T* out = a.out + (gb0 * n + i0) * d;
  for (int c0 = 0;;) {
    if (quads) {
      const int cq = cn / 4, pairs = (rn + 1) / 2;
      for (int u = threadIdx.x; u < gn * pairs * cq; u += kThreads) {
        const int kq = u / cq, c = 4 * (u - kq * cq);
        const int g = kq / pairs, r0 = 2 * (kq - g * pairs);
        const int k = g * rn + r0, k2 = r0 + 1 < rn ? k + 1 : k;
        const float* w0 = ws + k * ps;
        const float* w1 = ws + k2 * ps;
        const float* hg = whs + g * nr * cn + c;
        float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f), acc1 = acc0;
        for (int j = 0; j < n4; j += 4) {
          const float4 a0 = ld4(w0 + j), a1 = ld4(w1 + j);
          const float4 h0 = ld4(hg + j * cn), h1 = ld4(hg + (j + 1) * cn);
          const float4 h2 = ld4(hg + (j + 2) * cn);
          const float4 h3 = ld4(hg + (j + 3) * cn);
          fma4(a0.x, h0, acc0);
          fma4(a1.x, h0, acc1);
          fma4(a0.y, h1, acc0);
          fma4(a1.y, h1, acc1);
          fma4(a0.z, h2, acc0);
          fma4(a1.z, h2, acc1);
          fma4(a0.w, h3, acc0);
          fma4(a1.w, h3, acc1);
        }
        T* o0 = out + static_cast<long long>(k) * d + c0 + c;
        dtype::store4(o0, acc0);
        if (k2 != k)
          dtype::store4(o0 + d, acc1);
      }
    } else if (cn <= kThreads) {
      const int per = kThreads / cn, c = threadIdx.x % cn;
      if (threadIdx.x < per * cn) {
        for (int k = threadIdx.x / cn; k < rows; k += 2 * per) {
          const int k2 = min(k + per, rows - 1);
          const float* w0 = ws + k * ps;
          const float* w1 = ws + k2 * ps;
          const float* h0 = whs + (k / rn) * nr * cn + c;
          const float* h1 = whs + (k2 / rn) * nr * cn + c;
          float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 7
          for (int j = 0; j < n; ++j) {
            acc0 = fmaf(w0[j], h0[j * cn], acc0);
            acc1 = fmaf(w1[j], h1[j * cn], acc1);
          }
          out[static_cast<long long>(k) * d + c0 + c] = from_float<T>(acc0);
          if (k + per < rows)
            out[static_cast<long long>(k2) * d + c0 + c] =
                from_float<T>(acc1);
        }
      }
    } else {
      for (int k = 0; k < rows; ++k) {
        const float* wr = ws + k * ps;
        const float* hg = whs + (k / rn) * nr * cn;
        for (int c = threadIdx.x; c < cn; c += kThreads) {
          float acc = 0.f;
#pragma unroll 7
          for (int j = 0; j < n; ++j) acc = fmaf(wr[j], hg[j * cn + c], acc);
          out[static_cast<long long>(k) * d + c0 + c] = from_float<T>(acc);
        }
      }
    }
    c0 += cn;
    if (c0 >= d) break;
    cn = min(p.cols, d - c0);
    __syncthreads();  // the chunk has been consumed
    stage::rows(whs, cn, a.wh + gb0 * n * d + c0, d, n, cn);
    for (int e = threadIdx.x; e < (nr - n) * cn; e += kThreads)
      whs[n * cn + e] = 0.f;
    stage::wait_all();
    __syncthreads();
  }
}

template <typename T, int S>
int launch(const Args<T>& a, cudaStream_t stream) {
  fused_gat_kernel<T, S><<<static_cast<unsigned>(a.plan.blocks), kThreads,
                           static_cast<size_t>(a.plan.smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

long long gcd(long long x, long long y) {
  while (y != 0) {
    const long long r = x % y;
    x = y;
    y = r;
  }
  return x;
}

template <typename T>
int fwd(const T* wh, const T* f1, const T* f2, const T* adj, const T* bias,
        float slope, T* out, int b, int n, int d, int adj_groups,
        int bias_groups, void* stream) {
  if (b <= 0 || adj_groups <= 0 || bias_groups <= 0 || b % adj_groups != 0 ||
      b % bias_groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool per_graph = adj_groups == b && b > 1;
  const int bias_group = b / bias_groups, adj_group = b / adj_groups;
  const int part = adj_groups > 1 && !per_graph
                       ? static_cast<int>(gcd(bias_group, adj_group))
                       : bias_group;
  Plan p;
  if (!make_plan(b, n, d, part, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{wh, f1, f2, adj, bias, slope, out, b, n, d,
                  per_graph ? static_cast<long long>(n) * n : 0LL, adj_group,
                  bias_group, p};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // A row's segment: the power of 2 that covers N, up to a warp.
  if (n <= 1) return launch<T, 1>(a, s);
  if (n <= 2) return launch<T, 2>(a, s);
  if (n <= 4) return launch<T, 4>(a, s);
  if (n <= 8) return launch<T, 8>(a, s);
  if (n <= 16) return launch<T, 16>(a, s);
  return launch<T, 32>(a, s);
}

}  // namespace

extern "C" {

// The plan for (B, N, D) with blocks of whole graphs kept within parts of
// `part` graphs into out[0..5]: graphs a block, rows a block, columns of wh
// a chunk, blocks a graph, blocks, shared bytes a block. Returns 0, or
// cudaErrorInvalidValue where no plan exists (N > 3069: one row's weights
// and one column of wh no longer fit kBudget; part not dividing B).
int fused_gat_plan(int b, int n, int d, int part, long long* out) {
  Plan p;
  if (!make_plan(b, n, d, part, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.graphs;
  out[1] = p.rows;
  out[2] = p.cols;
  out[3] = p.row_tiles;
  out[4] = p.blocks;
  out[5] = p.smem;
  return 0;
}

// Launches on `stream` and returns cudaGetLastError(): nonzero when the launch
// was refused. adj holds `adj_groups` (N, N) (A: 1 shared by every graph, B
// one a graph), bias `bias_groups` floats (G); A and G divide B. Does not
// synchronise and allocates nothing.
int fused_gat_fwd(const float* wh, const float* f1, const float* f2,
                  const float* adj, const float* bias, float slope, float* out,
                  int b, int n, int d, int adj_groups, int bias_groups,
                  void* stream) {
  return fwd(wh, f1, f2, adj, bias, slope, out, b, n, d, adj_groups,
             bias_groups, stream);
}

// The same on bf16 tensors (slope a float), on the same plan.
int fused_gat_fwd_bf16(const dtype::bf16* wh, const dtype::bf16* f1,
                       const dtype::bf16* f2, const dtype::bf16* adj,
                       const dtype::bf16* bias, float slope,
                       dtype::bf16* out, int b, int n, int d, int adj_groups,
                       int bias_groups, void* stream) {
  return fwd(wh, f1, f2, adj, bias, slope, out, b, n, d, adj_groups,
             bias_groups, stream);
}

const char* fused_gat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
