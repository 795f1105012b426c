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
// S/P/A for one graph in VMEM and runs the whole chain there.
//
// Bound on an H100 SXM at the FC_STGNN/FD001 training shape (B=100, N=28,
// D=F=16, per scale, no dmask): h, x and g read and dh and dx written,
// 5*100*28*16*4 B, plus a 3,136 B mask: 899,136 B, 0.27 us at 3.35 TB/s;
// 2*B*N^2*(3D + 2F) = 12.5 MFLOP, 0.19 us at 67 TFLOP/s fp32. At B=1000,
// 8,963,136 B, 2.7 us. So it is bound by a launch's latency and by the
// chain of dependent steps inside one graph, not by bytes or FMAs.
//
// Plan, chosen in fused_dot_graph_spmm_bwd from (N, D, F) alone:
//
// * one launch (bwd_graph_kernel) wherever a graph fits in a block's shared
//   memory: 4*(N*qs(D) + 2N*qs(F) + N^2 + 2N(N|1)) B <= 232,448 B, qs(w) =
//   w rounded up to 4 floats and then to an odd number of 4-float groups
//   (N <= 129 at D=F=16, N <= 87 at D=F=128; 16,352 B at FC_STGNN, so 14
//   blocks fit an SM's shared memory and 4 its registers). A block of 256
//   threads owns one graph and reads it once: h, x, g and the mask are
//   issued together by cp.async (stage.cuh), h, x and g at stride qs, so
//   that 16-byte reads of 8 rows hit 32 banks. Two (N, N) tiles at stride
//   N|1 hold S (then e_ij carrying the sign of S_ij, then A) and dA (then
//   dS). A warp takes 4 rows at a time, lane j: S_ij and dA_ij are formed
//   once (S in the forward's fmaf order, so the backward's P is the
//   forward's), h_j and x_j read once for the 4 rows, 16 bytes at a time;
//   then the rows' max, normaliser and rowsum(dP * P) by shuffles, and A,
//   dS and the dmask rows. One barrier later each thread takes 4 columns of
//   one row of dx = A^T g or of dh = (dS + dS^T) h, N(F + D) / 4 such units
//   (224 at FC_STGNN), reading g and h 16 bytes at a time.
// * above that, the two-launch plan kept from the first port: a row pass
//   (a warp per row, 32-column tiles of h and x; online softmax statistics
//   and rowsum(dP * P) into a (B, N, 3) scratch, then dS and the row term of
//   dh and the dmask row) and a column pass (a warp per column; dx and the
//   column term of dh). It covers N = 384, D = F = 128.
//
// Fixed-order sums and no atomics: every output element has one writer, so
// gradients are deterministic. fp32 FMAs, accurate expf and division.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "stage.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;                    // one warp per row/column
constexpr int kMaxFeat = 128;                       // limit on D and on F
constexpr int kFeatPerLane = kMaxFeat / kWarp;      // columns owned per lane
constexpr int kGraphThreads = 256;                  // one-launch plan's block
constexpr int kGraphWarps = kGraphThreads / kWarp;
constexpr int kRowGroup = 4;                        // rows a warp at a time
constexpr size_t kMaxSmem = 232448;                 // a block's limit, H100
constexpr size_t kDefaultSmem = 48 * 1024;          // above: opt in
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

// Row stride, in floats, of an (n, width) matrix staged for 16-byte reads:
// width rounded up to 4, then an odd number of 4-float groups, so that 8
// lanes reading 16 bytes of 8 different rows hit 32 different banks.
__host__ __device__ __forceinline__ int quad_stride(int width) {
  const int quads = (width + 3) / 4;
  return 4 * (quads | 1);
}

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

// Zeroes columns [width, stride) of `rows` staged rows.
__device__ __forceinline__ void zero_pad(float* dst, int rows, int width,
                                         int stride) {
  const int pad = stride - width;
  for (int e = threadIdx.x; e < rows * pad; e += blockDim.x)
    dst[(e / pad) * stride + width + e % pad] = 0.f;
}

__global__ void __launch_bounds__(kGraphThreads)
bwd_graph_kernel(const float* __restrict__ h, const float* __restrict__ x,
                 const float* __restrict__ mask, const float* __restrict__ g,
                 float* __restrict__ dh, float* __restrict__ dx,
                 float* __restrict__ dmask, int n, int d, int f) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hst = quad_stride(d), xst = quad_stride(f), ts = n | 1;
  float* hs = smem;                    // [n][hst], zero past d
  float* xs = hs + n * hst;            // [n][xst], zero past f
  float* gs = xs + n * xst;            // [n][xst], zero past f
  float* ms = gs + n * xst;            // [n][n]: the mask
  float* et = ms + n * n;              // [n][ts]: S, then +-e, then A
  float* dt = et + n * ts;             // [n][ts]: dA, then dS

  const size_t b = blockIdx.x;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  stage::rows(hs, hst, h + b * n * d, d, n, d);
  stage::rows(xs, xst, x + b * n * f, f, n, f);
  stage::rows(gs, xst, g + b * n * f, f, n, f);
  stage::rows(ms, n, mask, n, n, n);
  zero_pad(hs, n, d, hst);
  zero_pad(xs, n, f, xst);
  zero_pad(gs, n, f, xst);
  stage::wait_all();
  __syncthreads();

  // A warp takes kRowGroup rows i at a time, lane j: S_ij and dA_ij once
  // (h_j and x_j read once for the group's rows), the rows' statistics by
  // shuffles, then A_ij, dS_ij and the dmask rows.
  for (int i0 = warp; i0 < n; i0 += kGraphWarps * kRowGroup) {
    int rows[kRowGroup];
    bool valid[kRowGroup];
    float m[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      const int i = i0 + r * kGraphWarps;
      valid[r] = i < n;
      rows[r] = valid[r] ? i : i0;  // a row past n repeats i0, stores nothing
      m[r] = -INFINITY;
    }
    for (int j = lane; j < n; j += kWarp) {
      float sv[kRowGroup] = {}, av[kRowGroup] = {};
      const float* hj = hs + j * hst;
      const float* xj = xs + j * xst;
      for (int c = 0; c < d; c += 4) {
        const float4 b4 = ld4(hj + c);
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r)
          sv[r] = fma4(ld4(hs + rows[r] * hst + c), b4, sv[r]);
      }
      for (int c = 0; c < f; c += 4) {
        const float4 b4 = ld4(xj + c);
#pragma unroll
        for (int r = 0; r < kRowGroup; ++r)
          av[r] = fma4(ld4(gs + rows[r] * xst + c), b4, av[r]);
      }
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        if (j == rows[r]) sv[r] -= 1e8f;
        m[r] = fmaxf(m[r], leaky(sv[r]));
        if (!valid[r]) continue;
        et[rows[r] * ts + j] = sv[r];
        dt[rows[r] * ts + j] = av[r];
      }
    }
    float l[kRowGroup], t[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      m[r] = warp_max(m[r]);
      l[r] = t[r] = 0.f;
    }
    for (int j = lane; j < n; j += kWarp) {
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        float* ev = et + rows[r] * ts + j;
        const float sv = *ev;
        const float e = expf(leaky(sv) - m[r]);
        l[r] += e;
        t[r] += e * (dt[rows[r] * ts + j] * ms[rows[r] * n + j]);
        if (valid[r]) *ev = sv >= 0.f ? e : -e;  // the sign of S: leaky'(S)
      }
    }
    float inner[kRowGroup];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      l[r] = warp_sum(l[r]);
      inner[r] = warp_sum(t[r]) / l[r];
    }
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      const int i = rows[r];
      if (!valid[r]) continue;
      const float* mrow = ms + i * n;
      float* erow = et + i * ts;
      float* drow = dt + i * ts;
      for (int j = lane; j < n; j += kWarp) {
        const float v = erow[j];
        const float p = fabsf(v) / l[r];
        const float da = drow[j], mk = mrow[j];
        const float pe = p + (j == i ? 1.f : 0.f);
        drow[j] = p * (da * mk - inner[r]) * (signbit(v) ? 0.01f : 1.f);
        erow[j] = pe * mk;
        if (dmask != nullptr) dmask[(b * n + i) * n + j] = pe * da;
      }
    }
  }
  __syncthreads();

  // Every thread 4 consecutive columns of one row of dx = A^T g, then of
  // dh = (dS + dS^T) h, read 16 bytes at a time.
  const int fq = (f + 3) / 4, dq = (d + 3) / 4;
  for (int o = threadIdx.x; o < n * (fq + dq); o += kGraphThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float* dst;
    int width, c;
    if (o < n * fq) {
      const int j = o / fq;
      c = 4 * (o - j * fq);
      for (int i = 0; i < n; ++i)
        fma4(et[i * ts + j], ld4(gs + i * xst + c), acc);
      dst = dx + (b * n + j) * f;
      width = f;
    } else {
      const int i = (o - n * fq) / dq;
      c = 4 * (o - n * fq - i * dq);
      for (int j = 0; j < n; ++j)
        fma4(dt[i * ts + j] + dt[j * ts + i], ld4(hs + j * hst + c), acc);
      dst = dh + (b * n + i) * d;
      width = d;
    }
    const float vals[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (c + k < width) dst[c + k] = vals[k];
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

// Shared memory of the one-launch plan: h, x and g at quad_stride and the
// two (N, N) tiles.
size_t graph_smem_bytes(int n, int d, int f) {
  const size_t rows = static_cast<size_t>(n);
  return sizeof(float) * (rows * quad_stride(d) + 2 * rows * quad_stride(f) +
                          rows * n + 2 * rows * (n | 1));
}

// Shared memory of each pass of the two-launch plan.
size_t pass_smem_bytes(int d, int f) {
  return sizeof(float) *
         (kRowsPerBlock * (d + f) + kWarp * ((d | 1) + (f | 1) + 3));
}

bool one_launch(int n, int d, int f) {
  return graph_smem_bytes(n, d, f) <= kMaxSmem;
}

// Raises bwd_graph_kernel's dynamic shared memory limit to kMaxSmem once per
// device, so that a launch inside a CUDA graph capture makes no attribute
// call.
int allow_graph_smem() {
  static bool raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (raised[dev]) return 0;
  err = cudaFuncSetAttribute(bwd_graph_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  raised[dev] = true;
  return 0;
}

}  // namespace

extern "C" {

int fused_dot_graph_spmm_bwd_max_feat() { return kMaxFeat; }

// The plan for (N, D, F): its launches per call (1 or 2) and, in *smem, the
// shared memory of its block in bytes.
int fused_dot_graph_spmm_bwd_plan(int n, int d, int f, long long* smem) {
  const bool one = one_launch(n, d, f);
  *smem = static_cast<long long>(one ? graph_smem_bytes(n, d, f)
                                     : pass_smem_bytes(d, f));
  return one ? 1 : 2;
}

// Launches the plan for (N, D, F) on `stream` and returns cudaGetLastError():
// nonzero when a launch was refused. *launched is set to the number of
// kernels this call launched (1 or 2 when it returns 0). Neither synchronises
// nor allocates. `dmask` may be null (no mask gradient). `stats` is the
// two-launch plan's (B, N, 3) scratch, written by the row pass and read by the
// column pass; it may be null on the one-launch plan.
int fused_dot_graph_spmm_bwd(const float* h, const float* x,
                             const float* mask, const float* g, float* dh,
                             float* dx, float* dmask, float* stats, int b,
                             int n, int d, int f, void* stream,
                             int* launched) {
  *launched = 0;
  if (bad_shape(b, n, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (one_launch(n, d, f)) {
    const size_t smem = graph_smem_bytes(n, d, f);
    if (smem > kDefaultSmem) {
      const int code = allow_graph_smem();
      if (code != 0) return code;
    }
    bwd_graph_kernel<<<b, kGraphThreads, smem, s>>>(h, x, mask, g, dh, dx,
                                                    dmask, n, d, f);
    err = cudaGetLastError();
    if (err == cudaSuccess) *launched = 1;
    return static_cast<int>(err);
  }
  if (stats == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, (n + kRowsPerBlock - 1) / kRowsPerBlock);
  const size_t smem = pass_smem_bytes(d, f);
  bwd_rows_kernel<<<grid, kWarp * kRowsPerBlock, smem, s>>>(
      h, x, mask, g, dh, dmask, stats, n, d, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 1;
  bwd_cols_kernel<<<grid, kWarp * kRowsPerBlock, smem, s>>>(
      h, x, mask, g, stats, dh, dx, n, d, f);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return static_cast<int>(err);
}

const char* fused_dot_graph_spmm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
