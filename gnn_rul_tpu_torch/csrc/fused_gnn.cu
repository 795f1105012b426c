// Fused dot-graph chain for Hopper (sm_90a), forward only:
//
//   out = ((softmax(leaky_relu(h h^T - 1e8 I, 0.01)) + I) * mask) @ x
//
//   h (B, N, D), x (B, N, F), mask (N, N), out (B, N, F); all fp32, contiguous.
//
// Replaces gnn_rul_tpu/ops/pallas/fused_gnn.py::_kernel (one graph per grid
// step) and ::_packed_kernel (small graphs packed block-diagonally into one
// step). Like them it keeps S, P and A out of device memory; the TPU's
// 128-lane padding and its block-diagonal packing do not carry over.
//
// Bound on an H100 SXM: bytes. At FC_STGNN/FD001's per-scale shape (B=100,
// N=28, D=F=16) it must move h + x + out = 3*100*28*16*4 B plus the 3,136 B
// mask, 540,736 B, 0.16 us at 3.35 TB/s, for 2*B*N^2*(D+F) = 5.0 MFLOP
// (0.075 us at 67 TFLOP/s fp32); at a request of 1000 (B=1000) 5,379,136 B,
// 1.61 us, for 50.2 MFLOP (0.75 us). A graph is small, so below a few
// thousand graphs a launch's latency and the chain of dependent steps
// inside one graph set the time, not bytes or FMAs.
//
// Plan, chosen in fused_dot_graph_spmm_fwd from (B, N, D, F) alone
// (fused_dot_graph_spmm_fwd_plan reports it):
//
// * whole graphs (fwd_graph_kernel), wherever one graph fits a block's
//   shared memory: 4*(N*qs(D) + N*qs(N) + round4(N)*F + N^2) B <= 232,448 B,
//   qs(w) = w rounded up to 4 floats and then to an odd number of 4-float
//   groups (N <= 160 at D=F=16, N <= 116 at D=F=128; 10,304 B a graph at
//   FC_STGNN's N=28, D=F=16, and 17,472 B for 2 graphs).
//   A block of 256 threads holds G graphs: their h at stride qs(D), their x,
//   an (N, qs(N)) tile for A and one copy of the mask, all issued together
//   by cp.async (stage.cuh) and waited on once, so each graph is read from
//   device memory once. From B = 132 (an H100's SMs) G brings a block's
//   pairs or outputs, N*max(N, F), to about 2,048 while keeping B/132 blocks
//   or more (G = 1 at B=100, 2 at B=1000 at FC_STGNN's shape). Below 132
//   graphs a graph of more than 32 rows (what the block's 8 warps take in
//   one round) has its rows tiled over min(ceil(132/B), ceil(N/32)) blocks,
//   a multiple of 4 rows each, each staging the whole h and x and its rows
//   of the mask.
//   Then, one barrier apart:
//   1. a warp takes 4 rows of a graph at a time, lane j (and j + 32, ...):
//      S_ij is formed once, h_j read once for the 4 rows, 16 bytes at a
//      time; the rows' max and normaliser by shuffles; then
//      A_ij = (e_ij / Z_i + delta_ij) * mask_ij into the tile;
//   2. out = A @ x: where F % 4 == 0 a thread takes 4 columns of 2 rows,
//      reading A and x 16 bytes at a time (6 shared loads for 32 FMAs),
//      else a column of 2 rows, and writes whole 32-byte sectors of out.
// * above that, the row-tile stream (fwd_rows_kernel): a block of 8
//   warps takes 8 rows of one graph, a warp a row, streaming 32-column
//   tiles of h and x through shared memory with an online softmax, so no
//   (N, N) tile is held and any N works (N = 384 at D = F = 128).
//
// Why S keeps the backward's order: fused_gnn_bwd.cu recomputes P from h
// and assumes it is the P of this forward. Both form S_ij as
// s = fmaf(h_i[c], h_j[c], s) for c = 0, 1, ... from s = 0 over rows staged
// at qs(D) and zero past D (fma4 over 16-byte reads), then subtract 1e8 on
// the diagonal, and both take the row max, the per-lane sums of e_ij over
// j = lane, lane + 32, ... and the same shuffle tree for Z_i. So the whole-
// graph plans of the two directions give the same P bit for bit; another
// summation order would move P near leaky's kink and in the exponent. The
// -1e8 shift is kept (not -inf), so N = 1 and rows whose other logits all
// underflow agree with the plain version. fp32 FMAs, accurate expf and
// division; no TF32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;                    // the stream: a warp a row
constexpr int kMaxFeat = 128;                       // limit on D and on F
constexpr int kFeatPerLane = kMaxFeat / kWarp;      // F columns owned per lane
constexpr int kThreads = 256;                       // whole-graph block
constexpr int kWarps = kThreads / kWarp;
constexpr int kRowGroup = 4;                        // rows a warp at a time
constexpr int kTileRows = kWarps * kRowGroup;       // rows a block a round
constexpr long long kTargetBlocks = 132;            // an H100's SMs
constexpr long long kWorkPerBlock = 2048;           // pairs or outputs a block
constexpr long long kMaxSmem = 232448;              // a block's limit, H100
constexpr long long kDefaultSmem = 48 * 1024;       // above: opt in
constexpr int kMaxDevices = 64;
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

__device__ __forceinline__ float leaky(float s) {
  return s >= 0.f ? s : 0.01f * s;
}

// Row stride, in floats, of a row staged for 16-byte reads: width rounded
// up to 4, then an odd number of 4-float groups, so that 8 lanes reading 16
// bytes of 8 different rows hit 32 different banks.
__host__ __device__ __forceinline__ int quad_stride(int width) {
  const int quads = (width + 3) / 4;
  return 4 * (quads | 1);
}

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s = fmaf(a[c], b[c], s) for c = 0, 1, 2, 3 in order.
__device__ __forceinline__ float fma4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void fma4(float a, float4 b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

struct Plan {
  int whole;       // 1: fwd_graph_kernel; 0: the row-tile stream
  int graphs;      // whole graphs a block (1 when rows < N)
  int rows;        // rows of a graph a block
  int row_tiles;   // blocks a graph
  long long blocks;
  long long smem;  // bytes a block
};

// Shared floats of a whole-graph block holding g graphs, r rows of each:
// h at qs(D), the (r, qs(N)) tile of A, x at round4(N) rows, the mask's r
// rows.
long long graph_floats(int n, int d, int f, long long g, int r) {
  return g * (static_cast<long long>(n) * quad_stride(d) +
              static_cast<long long>(r) * quad_stride(n) +
              static_cast<long long>(round4(n)) * f) +
         static_cast<long long>(r) * n;
}

// Shared bytes of a row-tile stream block.
long long stream_smem_bytes(int d, int f) {
  return sizeof(float) *
         static_cast<long long>(kRowsPerBlock * d + kWarp * (d | 1) +
                                kWarp * f);
}

bool make_plan(int b, int n, int d, int f, Plan* p) {
  if (b <= 0 || n <= 0 || d <= 0 || f <= 0 || d > kMaxFeat || f > kMaxFeat)
    return false;
  const long long one = graph_floats(n, d, f, 1, n);
  if (4 * one > kMaxSmem) {
    const int tiles = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    *p = {0, 1, kRowsPerBlock, tiles, static_cast<long long>(b) * tiles,
          stream_smem_bytes(d, f)};
    return tiles <= 65535;
  }
  if (b >= kTargetBlocks) {
    const long long work = static_cast<long long>(n) * (n > f ? n : f);
    const long long mask = static_cast<long long>(n) * n;
    long long g = kWorkPerBlock / work;
    if (g > (kMaxSmem / 4 - mask) / (one - mask))
      g = (kMaxSmem / 4 - mask) / (one - mask);
    if (g > b / kTargetBlocks) g = b / kTargetBlocks;
    if (g < 1) g = 1;
    *p = {1, static_cast<int>(g), n, 1, (b + g - 1) / g,
          4 * graph_floats(n, d, f, g, n)};
    return true;
  }
  long long tiles = (kTargetBlocks + b - 1) / b;
  if (tiles > (n + kTileRows - 1) / kTileRows)
    tiles = (n + kTileRows - 1) / kTileRows;
  int rows = round4(static_cast<int>((n + tiles - 1) / tiles));
  if (rows > n) rows = n;
  const int row_tiles = (n + rows - 1) / rows;
  *p = {1, 1, rows, row_tiles, static_cast<long long>(b) * row_tiles,
        4 * graph_floats(n, d, f, 1, rows)};
  return true;
}

struct Args {
  const float* h;
  const float* x;
  const float* mask;
  float* out;
  long long b;
  int n;
  int d;
  int f;
  Plan plan;
};

// JPL: columns j a lane takes per row, a power of 2 covering N / 32.
template <int JPL>
__global__ void __launch_bounds__(kThreads) fwd_graph_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = a.n, d = a.d, f = a.f;
  const int hst = quad_stride(d), ts = quad_stride(n), n4 = round4(n);
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
  float* hs = smem;                          // [graphs][n][hst], zero past d
  float* at = hs + p.graphs * n * hst;       // [graphs][rows][ts]: A
  float* xs = at + p.graphs * p.rows * ts;   // [graphs][n4][f], zero past n
  float* ms = xs + p.graphs * n4 * f;        // [rn][n]: rows i0.. of mask

  stage::rows(hs, hst, a.h + gb0 * n * d, d, gn * n, d);
  if (n4 == n || gn == 1) {
    stage::rows(xs, f, a.x + gb0 * n * f, f, gn * n, f);
  } else {
    for (int g = 0; g < gn; ++g)
      stage::rows(xs + g * n4 * f, f, a.x + (gb0 + g) * n * f, f, n, f);
  }
  stage::rows(ms, n, a.mask + static_cast<long long>(i0) * n, n, rn, n);
  const int pad = hst - d;
  for (int e = threadIdx.x; e < gn * n * pad; e += kThreads)
    hs[(e / pad) * hst + d + e % pad] = 0.f;
  for (int e = threadIdx.x; e < gn * (n4 - n) * f; e += kThreads) {
    const int g = e / ((n4 - n) * f);
    xs[(g * n4 + n) * f + e - g * (n4 - n) * f] = 0.f;  // rows n..n4-1
  }
  stage::wait_all();
  __syncthreads();

  // A warp takes kRowGroup rows of one graph at a time, lane j: S_ij once
  // in the backward's fmaf order (h_j read once for the group's rows), the
  // rows' max and normaliser by shuffles, then the rows of A.
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int groups = (rn + kRowGroup - 1) / kRowGroup;
  for (int u = warp; u < gn * groups; u += kWarps) {
    const int g = u / groups, r0 = (u - g * groups) * kRowGroup;
    const float* hg = hs + g * n * hst;
    int rows[kRowGroup];
    bool valid[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      valid[r] = r0 + r < rn;
      rows[r] = i0 + (valid[r] ? r0 + r : r0);  // past rn: stores nothing
    }
    float sv[JPL][kRowGroup];
#pragma unroll
    for (int t = 0; t < JPL; ++t)
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) sv[t][r] = 0.f;
    for (int c = 0; c < d; c += 4) {
      float4 hi[kRowGroup];
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) hi[r] = ld4(hg + rows[r] * hst + c);
#pragma unroll
      for (int t = 0; t < JPL; ++t) {
        if (t * kWarp >= n) break;
        const float4 b4 = ld4(hg + min(lane + t * kWarp, n - 1) * hst + c);
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r)
          sv[t][r] = fma4(hi[r], b4, sv[t][r]);
      }
    }
    float m[kRowGroup], l[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) m[r] = -INFINITY;
#pragma unroll
    for (int t = 0; t < JPL; ++t) {
      const int j = lane + t * kWarp;
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        if (j == rows[r]) sv[t][r] -= 1e8f;
        if (j < n) m[r] = fmaxf(m[r], leaky(sv[t][r]));
      }
    }
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      m[r] = warp_max(m[r]);
      l[r] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < JPL; ++t) {
      if (lane + t * kWarp >= n) break;
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        sv[t][r] = expf(leaky(sv[t][r]) - m[r]);
        l[r] += sv[t][r];
      }
    }
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) l[r] = warp_sum(l[r]);
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      if (!valid[r]) continue;
      const int i = rows[r];
      float* arow = at + (g * p.rows + i - i0) * ts;
      const float* mrow = ms + (i - i0) * n;
#pragma unroll
      for (int t = 0; t < JPL; ++t) {
        const int j = lane + t * kWarp;
        if (j >= n) break;
        const float pe = sv[t][r] / l[r] + (j == i ? 1.f : 0.f);
        arow[j] = pe * mrow[j];
      }
      for (int j = n + lane; j < n4; j += kWarp) arow[j] = 0.f;
    }
  }
  __syncthreads();

  // out = A @ x. Where F allows, a thread takes 4 columns of 2 rows of one
  // graph, reading A and x 16 bytes at a time, 4 columns j a step; else a
  // thread keeps one column c and takes 2 rows at a time.
  float* out = a.out + (gb0 * n + i0) * f;
  if (f % 4 == 0) {
    const int cq = f / 4, pairs = (rn + 1) / 2;
    for (int u = threadIdx.x; u < gn * pairs * cq; u += kThreads) {
      const int kq = u / cq, c = 4 * (u - kq * cq);
      const int g = kq / pairs, r0 = 2 * (kq - g * pairs);
      const bool two = r0 + 1 < rn;
      const float* w0 = at + (g * p.rows + r0) * ts;
      const float* w1 = two ? w0 + ts : w0;
      const float* xg = xs + g * n4 * f + c;
      float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f), acc1 = acc0;
      for (int j = 0; j < n4; j += 4) {
        const float4 a0 = ld4(w0 + j), a1 = ld4(w1 + j);
        const float4 x0 = ld4(xg + j * f), x1 = ld4(xg + (j + 1) * f);
        const float4 x2 = ld4(xg + (j + 2) * f), x3 = ld4(xg + (j + 3) * f);
        fma4(a0.x, x0, acc0);
        fma4(a1.x, x0, acc1);
        fma4(a0.y, x1, acc0);
        fma4(a1.y, x1, acc1);
        fma4(a0.z, x2, acc0);
        fma4(a1.z, x2, acc1);
        fma4(a0.w, x3, acc0);
        fma4(a1.w, x3, acc1);
      }
      float* o = out + (g * n + r0) * f + c;
      *reinterpret_cast<float4*>(o) = acc0;
      if (two) *reinterpret_cast<float4*>(o + f) = acc1;
    }
  } else {
    // Block row k: graph k / rn, its row k % rn; with several graphs rn = N,
    // so k is both the tile row and the output row past the block's first.
    const int rows = gn * rn, per = kThreads / f, c = threadIdx.x % f;
    if (threadIdx.x < per * f) {
      for (int k = threadIdx.x / f; k < rows; k += 2 * per) {
        const int k2 = min(k + per, rows - 1);
        const float* w0 = at + k * ts;
        const float* w1 = at + k2 * ts;
        const float* x0 = xs + (k / rn) * n4 * f + c;
        const float* x1 = xs + (k2 / rn) * n4 * f + c;
        float acc0 = 0.f, acc1 = 0.f;
        for (int j = 0; j < n; ++j) {
          acc0 = fmaf(w0[j], x0[j * f], acc0);
          acc1 = fmaf(w1[j], x1[j * f], acc1);
        }
        out[k * f + c] = acc0;
        if (k + per < rows) out[k2 * f + c] = acc1;
      }
    }
  }
}

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
fwd_rows_kernel(const float* __restrict__ h, const float* __restrict__ x,
                const float* __restrict__ mask, float* __restrict__ out,
                int n, int d, int f) {
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
    float z = leaky(s);
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

// Raises fwd_graph_kernel<JPL>'s dynamic shared memory limit to kMaxSmem
// once per device, so that a launch inside a CUDA graph capture makes no
// attribute call.
template <int JPL>
int allow_graph_smem() {
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (raised[dev]) return 0;
  err = cudaFuncSetAttribute(fwd_graph_kernel<JPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  raised[dev] = true;
  return 0;
}

template <int JPL>
int launch_graph(const Args& a, cudaStream_t stream) {
  if (a.plan.smem > kDefaultSmem) {
    const int code = allow_graph_smem<JPL>();
    if (code != 0) return code;
  }
  fwd_graph_kernel<JPL><<<static_cast<unsigned>(a.plan.blocks), kThreads,
                          static_cast<size_t>(a.plan.smem), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fused_dot_graph_spmm_max_feat() { return kMaxFeat; }

// The plan for (B, N, D, F) into out[0..5]: whole graphs (1) or the row-tile
// stream (0), graphs a block, rows of a graph a block, blocks a graph,
// blocks, shared bytes a block. Returns 0, or cudaErrorInvalidValue where
// no plan exists (a bad shape, or more than 65,535 row tiles a graph).
int fused_dot_graph_spmm_fwd_plan(int b, int n, int d, int f,
                                  long long* out) {
  Plan p;
  if (!make_plan(b, n, d, f, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = p.whole;
  out[1] = p.graphs;
  out[2] = p.rows;
  out[3] = p.row_tiles;
  out[4] = p.blocks;
  out[5] = p.smem;
  return 0;
}

// Launches the plan for (B, N, D, F) on `stream` and returns
// cudaGetLastError(): nonzero when the launch was refused. *launched is set
// to the number of kernels this call launched (1 when it returns 0). Does
// not synchronise and allocates nothing.
int fused_dot_graph_spmm_fwd(const float* h, const float* x, const float* mask,
                             float* out, int b, int n, int d, int f,
                             void* stream, int* launched) {
  *launched = 0;
  Plan p;
  if (!make_plan(b, n, d, f, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (p.whole) {
    const Args a{h, x, mask, out, b, n, d, f, p};
    if (n <= kWarp)
      err = launch_graph<1>(a, s);
    else if (n <= 2 * kWarp)
      err = launch_graph<2>(a, s);
    else if (n <= 4 * kWarp)
      err = launch_graph<4>(a, s);
    else if (n <= 8 * kWarp)
      err = launch_graph<8>(a, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);  // not a whole plan
  } else {
    const dim3 grid(b, p.row_tiles);
    fwd_rows_kernel<<<grid, kWarp * kRowsPerBlock,
                      static_cast<size_t>(p.smem), s>>>(h, x, mask, out, n, d,
                                                        f);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err == 0) *launched = 1;
  return err;
}

const char* fused_dot_graph_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
