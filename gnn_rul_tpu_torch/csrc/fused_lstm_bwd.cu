// Backward of the whole bidirectional LSTM recurrence for Hopper (sm_90a).
// The forward (fused_lstm.cu) saved ys and the c trajectory cs; step t
// consumed h_prev = ys[t-1] and c_prev = cs[t-1] (zero at t = 0):
//
//   gates = act(xg[t] + h_prev @ w_hh)             (recomputed, [i, f, g, o])
//   dh    = dh_carry + dys[t];   tc = tanh(cs[t])
//   dc    = dh * o * (1 - tc^2) + dc_carry         (dc_carry seeded by dc_fin)
//   di = dc * g * i (1 - i);  df = dc * c_prev * f (1 - f)
//   dg = dc * i (1 - g^2);    do = dh * tc * o (1 - o)
//   dxg[t]   = [di, df, dg, do]
//   dh_carry = dxg[t] @ w_hh^T;   dc_carry = dc * f
//   dw_hh   += h_prev^T dxg[t]                     (summed over B and T)
//
//   xg (T, 2, B, 4H), w_hh (2, H, 4H), ys and cs (T, 2, B, H), dys
//   (T, 2, B, H), dc_fin (2, B, H) -> dxg (T, 2, B, 4H), dw_hh (2, H, 4H).
//   All fp32, contiguous.
//
// Replaces gnn_rul_tpu/ops/pallas/fused_lstm.py::_bwd_kernel, which walks
// the TPU's sequential grid in reverse with dh, dc and dW_hh in VMEM scratch,
// recomputes the gates inside each step and emits dW_hh at the last grid
// step. On Hopper the blocks run in parallel and carry nothing between them,
// and only dh_carry is truly serial, so the work is four launches:
//
//   gates: the recomputed gates depend on the saved h_prev, not on the
//     carry, so one parallel pass computes act(xg[t] + ys[t-1] @ w_hh) over
//     all T*B rows of each direction: a tiled fp32 product (64 x 64 tiles, a
//     4 x 4 register tile per thread) with the sigmoid/tanh epilogue. It
//     writes the activated gates into dxg, which has their shape.
//   sweep: the reverse recurrence (fused_lstm.cuh), one CTA or one cluster
//     per (batch column, direction). Each step thread j, for unit j, reads
//     its gates, c, c_prev and dys (copied to shared memory a step ahead),
//     overwrites the gates in dxg with the dgates and stores them in shared
//     memory (in every CTA of a cluster); after a barrier, a group of S
//     lanes per unit forms dh_carry = dgates @ W_hh^T, split over the rows,
//     and stores it for thread j; a CTA barrier ends the step (one dgates
//     buffer in a single CTA, two and a cluster barrier in a cluster).
//   dW partials: dW_hh is a product over the T*B rows, h_prev^T dxg. Each
//     block takes a 64 (h) x 64 (gate) tile of dW for one direction and one
//     chunk of rows, a 4 x 4 register tile per thread, staging 64 rows of
//     h_prev and dxg at a time in shared memory, and writes its partial sum
//     to a scratch (2, chunks, H, 4H). A 64-row tile is summed in fp32 and
//     the tiles in fp64: an fp32 sum over the 70,000 rows of a T=1000 call
//     drifts by ~1e-4, more than the check against the plain version
//     allows.
//   dW reduce: one thread per dW element adds the chunks' partials in chunk
//     order, in fp64, and rounds once to fp32.
//
// No atomics: every output element has one writer, and the partials are
// added in a fixed order, so the gradients are deterministic.
//
// Bound on an H100 SXM at LOGO's training shape (T=100, B=70, H=48): xg,
// ys, cs, dys, W_hh and dc_fin read, dxg and dW_hh written, 29.7 MB,
// 8.9 us at 3.35 TB/s; the three recurrent products (gates, dh, dW) 774
// MFLOP, 11.6 us at 67 TFLOP/s fp32. The T dependent steps of the sweep set
// the time; the design leaves one product per step in them, with a chain of
// H/S FMAs, and runs the other two as parallel passes. No fast-math
// intrinsics.

#include "fused_lstm.cuh"

namespace {

using namespace lstm;

// The cell thread's inputs of a step, copied one step ahead: the four
// activated gates, c, c_prev and dys.
constexpr int kInputs = 7;

// The dgates (float4; one buffer in a single CTA, two in a cluster), the dh
// sums handed to the cell threads, [U] floats, and the cell threads' inputs
// of two steps, [2][kInputs][U] floats.
constexpr VecSpec kVec = {sizeof(float4), 1, 2,
                          (1 + 2 * kInputs) * sizeof(float), 0};

constexpr int kGateTile = 64;     // gate pass: 64 rows by 64 gate columns
constexpr int kGateK = 16;        // ... in steps of 16 along H
constexpr int kGateThreads = 256; // 16 x 16 threads, a 4 x 4 tile each

constexpr int kDwTile = 64;       // dW tile: 64 rows of W_hh by 64 gates
constexpr int kRowTile = 64;      // rows of h_prev and dxg staged at a time
constexpr int kDwThreads = 256;   // 16 x 16 threads, a 4 x 4 tile each
constexpr int kTargetBlocks = 132;  // dW blocks per direction: one per SM

// Rows r in [0, T*B) of one direction are (t, b) = (r / B, r % B); row r's
// h_prev is ys[t-1, dir, b] (zero at t = 0). Writes act(xg + h_prev @ W) of
// every row into `gates` (T, 2, B, 4H).
__global__ void __launch_bounds__(kGateThreads)
lstm_gates_kernel(const float* __restrict__ xg, const float* __restrict__ w,
                  const float* __restrict__ ys, float* __restrict__ gates,
                  int t_len, int b_len, int h) {
  // h_prev transposed, [k][row], padded so that its stores spread over the
  // banks and each 4-row read stays 16-byte aligned; W, [k][column].
  __shared__ __align__(16) float as[kGateK][kGateTile + 4];
  __shared__ __align__(16) float bs[kGateK][kGateTile];
  const int g = 4 * h, rows = t_len * b_len;
  const int r0 = blockIdx.x * kGateTile, c0 = blockIdx.y * kGateTile;
  const int dir = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* wk = w + static_cast<size_t>(dir) * h * g;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < h; k0 += kGateK) {
    __syncthreads();  // the previous tiles have been consumed
    for (int e = threadIdx.x; e < kGateK * kGateTile; e += kGateThreads) {
      const int rr = e / kGateK, ka = e % kGateK;
      const int r = r0 + rr, k = k0 + ka;
      float v = 0.f;
      if (r < rows && k < h) {
        const int t = r / b_len, b = r - t * b_len;
        if (t > 0)
          v = ys[((static_cast<size_t>(t - 1) * 2 + dir) * b_len + b) * h + k];
      }
      as[ka][rr] = v;
      const int kb = e / kGateTile, cc = e % kGateTile;
      bs[kb][cc] = (k0 + kb < h && c0 + cc < g)
                       ? wk[static_cast<size_t>(k0 + kb) * g + c0 + cc]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGateK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= rows) continue;
    const int t = r / b_len, b = r - t * b_len;
    const size_t o = ((static_cast<size_t>(t) * 2 + dir) * b_len + b) * g;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int cidx = c0 + tx * 4 + q;
      if (cidx >= g) continue;
      const float pre = xg[o + cidx] + acc[i][q];
      gates[o + cidx] = cidx / h == 2 ? tanhf(pre) : sigmoid(pre);
    }
  }
}

// dxg holds the activated gates on entry and the dgates on exit. kW: -1
// W_hh read from global memory, 0 in shared memory, 8 or 16 rows a lane in
// registers.
template <bool kCluster, int kW>
__global__ void __launch_bounds__(kW > 0 ? kRegThreads : kMaxThreads)
lstm_sweep_kernel(const float* __restrict__ w, const float* __restrict__ cs,
                  const float* __restrict__ dys,
                  const float* __restrict__ dc_fin, float* __restrict__ dxg,
                  int t_len, int b_len, int h, Plan p) {
  extern __shared__ float4 smem[];
  const int g = 4 * h, tid = threadIdx.x, sl = p.lanes;
  const int rank =
      kCluster ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int col = blockIdx.x / p.cluster, dir = blockIdx.y;
  const int u0 = rank * p.units;
  // Product lane: local unit u, lane s. Cell thread: local unit tid.
  const int u = tid / sl, s = tid % sl, jc = u0 + tid;
  const bool cell = tid < p.units && jc < h;
  const int nv = p.iters * sl;  // dgates entries, zero beyond H
  const int nbuf = kCluster ? 2 : 1;
  float4* ws = smem;  // [iters][threads] when in shared memory
  // [nbuf][nv]: the step's dgates of every unit; then [U] dh sums; then
  // [2][kInputs][U] step inputs.
  float4* dbuf =
      smem + (kW == 0 ? static_cast<size_t>(p.iters) * p.threads : 0);
  float* dhsum = reinterpret_cast<float*>(dbuf + nbuf * nv);
  float* in = dhsum + p.units;
  const float* wk = w + static_cast<size_t>(dir) * h * g;
  float4 wr[kW > 0 ? kW : 1];
  if constexpr (kW > 0)
    load_w_regs(wr, wk, h, p, u0, u, s, true);
  else if constexpr (kW == 0)
    stage_w(ws, wk, h, p, u0, true);
  for (int i = tid; i < nbuf * nv; i += p.threads)
    dbuf[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < p.units; i += p.threads) dhsum[i] = 0.f;

  const size_t xstep = static_cast<size_t>(2) * b_len * g;
  const size_t hstep = static_cast<size_t>(2) * b_len * h;
  const size_t row = static_cast<size_t>(dir) * b_len + col;
  float* xrow = dxg + row * g + jc;
  const size_t hrow = row * h + jc;

  // Copies step t's inputs into buffer t & 1 (cell threads only).
  const auto fetch = [&](int t) {
    float* d = in + (t & 1) * kInputs * p.units + tid;
    const float* x = xrow + t * xstep;
#pragma unroll
    for (int q = 0; q < 4; ++q) cp_async4(d + q * p.units, x + q * h);
    cp_async4(d + 4 * p.units, cs + t * hstep + hrow);
    cp_async4(d + 5 * p.units, cs + (t > 0 ? t - 1 : 0) * hstep + hrow,
              t > 0);
    cp_async4(d + 6 * p.units, dys + t * hstep + hrow);
  };
  const int last = t_len - 1;
  if (cell) fetch(last);
  cp_async_commit();
  float dc = cell ? dc_fin[hrow] : 0.f;
  if (kCluster)
    cluster_barrier();  // every CTA's buffers are zero before any store
  else
    __syncthreads();

  for (int t = last; t >= 0; --t) {
    float4* dcur = dbuf + (kCluster ? (t & 1) * nv : 0);
    if (cell && t > 0) fetch(t - 1);
    cp_async_commit();
    if (cell) {
      cp_async_wait_prior();  // this step's inputs have arrived
      const float* v = in + (t & 1) * kInputs * p.units + tid;
      const float ig = v[0], fg = v[p.units], gg = v[2 * p.units];
      const float og = v[3 * p.units], c = v[4 * p.units];
      const float c_prev = v[5 * p.units], dy = v[6 * p.units];
      const float dhv = dhsum[tid] + dy;
      const float tc = tanhf(c);
      const float dcv = dhv * og * (1.f - tc * tc) + dc;
      const float4 d = make_float4(dcv * gg * ig * (1.f - ig),
                                   dcv * c_prev * fg * (1.f - fg),
                                   dcv * ig * (1.f - gg * gg),
                                   dhv * tc * og * (1.f - og));
      dc = dcv * fg;
      float* dx = xrow + t * xstep;
      dx[0] = d.x;
      dx[h] = d.y;
      dx[2 * h] = d.z;
      dx[3 * h] = d.w;
      if (kCluster)
        store_to_cluster(dcur, jc, d, p.cluster);
      else
        dcur[jc] = d;
    }
    // The step's dgates are complete, in every CTA.
    if (kCluster)
      cluster_barrier();
    else
      __syncthreads();
    // sum_m dg[m] . W[j][q*H + m] over this lane's rows m = i*S + s.
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kW > 0)
      a = reg_product(wr, dcur + s, sl);
    else if constexpr (kW == 0)
      a = lane_product(dcur + s, ws + tid, p);
    else if (u0 + u < h)
      a = lane_product_global(dcur, wk + static_cast<size_t>(u0 + u) * g, 1,
                              h, s, sl);
    const float dh = group_sum((a.x + a.y) + (a.z + a.w), sl);
    if (s == 0 && u < p.units) dhsum[u] = dh;
    // dh is complete, and the dgates have been read before the next step
    // stores them (a single CTA keeps one buffer).
    __syncthreads();
  }
}

template <bool kCluster, int kW, typename... Args>
int run_sweep(const Plan& p, dim3 grid, cudaStream_t s, Args... args) {
  static Prepared done = {};
  return run(lstm_sweep_kernel<kCluster, kW>, done, p, grid, s, args...);
}

template <bool kCluster, typename... Args>
int dispatch(const Plan& p, dim3 grid, cudaStream_t s, Args... args) {
  if (p.w_mode == kWRegisters)
    return p.iters == kRegRows
               ? run_sweep<kCluster, kRegRows>(p, grid, s, args...)
               : run_sweep<kCluster, kRegRows / 2>(p, grid, s, args...);
  if (p.w_mode == kWShared)
    return run_sweep<kCluster, 0>(p, grid, s, args...);
  if constexpr (kCluster)
    return static_cast<int>(cudaErrorInvalidValue);  // no plan asks this
  else
    return run_sweep<false, -1>(p, grid, s, args...);
}

// Rows r in [0, T*B) of one direction are (t, b) = (r / B, r % B); row r's
// h_prev is ys[t-1, dir, b] (zero at t = 0) and its dgates dxg[t, dir, b].
// A block sums h_prev^T dgates over one chunk of rows into one 64 x 64 tile
// of dW, a 4 x 4 register tile per thread.
__global__ void __launch_bounds__(kDwThreads)
lstm_dw_partial_kernel(const float* __restrict__ ys,
                       const float* __restrict__ dxg,
                       double* __restrict__ partial, int t_len, int b_len,
                       int h, int rows_per_chunk, int chunks) {
  __shared__ __align__(16) float hs[kRowTile][kDwTile];  // [row][h]
  __shared__ __align__(16) float gs[kRowTile][kDwTile];  // [row][gate]
  const int g = 4 * h;
  const int g_tiles = (g + kDwTile - 1) / kDwTile;
  const int h0 = (blockIdx.x / g_tiles) * kDwTile;
  const int g0 = (blockIdx.x % g_tiles) * kDwTile;
  const int chunk = blockIdx.y, dir = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int rows = t_len * b_len;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(rows, r_begin + rows_per_chunk);

  double acc[4][4] = {};
  for (int r0 = r_begin; r0 < r_end; r0 += kRowTile) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = threadIdx.x; e < kRowTile * kDwTile; e += kDwThreads) {
      const int rr = e / kDwTile, cc = e % kDwTile;
      const int r = r0 + rr, t = r / b_len, b = r - t * b_len;
      float hv = 0.f, gv = 0.f;
      if (r < r_end) {
        if (t > 0 && h0 + cc < h)
          hv = ys[((static_cast<size_t>(t - 1) * 2 + dir) * b_len + b) * h +
                  h0 + cc];
        if (g0 + cc < g)
          gv = dxg[((static_cast<size_t>(t) * 2 + dir) * b_len + b) * g + g0 +
                   cc];
      }
      hs[rr][cc] = hv;
      gs[rr][cc] = gv;
    }
    __syncthreads();
    float tile[4][4] = {};
#pragma unroll 4
    for (int rr = 0; rr < kRowTile; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&hs[rr][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[rr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) tile[i][q] = fmaf(av[i], bv[q], tile[i][q]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] += tile[i][q];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int hh = h0 + ty * 4 + i;
    if (hh >= h) continue;
    double* out =
        partial + ((static_cast<size_t>(dir) * chunks + chunk) * h + hh) * g;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int gg = g0 + tx * 4 + q;
      if (gg < g) out[gg] = acc[i][q];
    }
  }
}

__global__ void lstm_dw_reduce_kernel(const double* __restrict__ partial,
                                      float* __restrict__ dw, int h,
                                      int chunks) {
  const size_t per_dir = static_cast<size_t>(h) * 4 * h;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= 2 * per_dir) return;
  const size_t dir = idx / per_dir, o = idx % per_dir;
  const double* p = partial + dir * chunks * per_dir + o;
  double s = 0.0;
  for (int c = 0; c < chunks; ++c) s += p[c * per_dir];
  dw[idx] = static_cast<float>(s);
}

bool bad_args(int t, int b, int h) {
  return bad_shape(t, b) || h <= 0 || h > kMaxHidden;
}

int tiles(int h) {
  return ((h + kDwTile - 1) / kDwTile) * ((4 * h + kDwTile - 1) / kDwTile);
}

// Rows per chunk: a multiple of kRowTile, so that about kTargetBlocks
// blocks share one direction's rows.
int rows_per_chunk(int t, int b, int h) {
  const int rows = t * b;
  int want = (kTargetBlocks + tiles(h) - 1) / tiles(h);
  const int max_chunks = (rows + kRowTile - 1) / kRowTile;
  want = want < 1 ? 1 : (want > max_chunks ? max_chunks : want);
  const int per = (rows + want - 1) / want;
  return (per + kRowTile - 1) / kRowTile * kRowTile;
}

}  // namespace

extern "C" {

int fused_lstm_bwd_max_hidden() { return kMaxHidden; }

// The sweep's plan at hidden size h and B columns as 7 ints: lanes,
// cluster, units, threads, iters, w_mode (0 global memory, 1 shared memory,
// 2 registers), smem bytes. Returns 0, or cudaErrorInvalidValue where no
// plan fits.
int fused_lstm_bwd_plan(int h, int b, int* out) {
  Plan p;
  if (!pick_plan(h, b, kVec, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  plan_fields(p, out);
  return 0;
}

// Chunks of rows per direction in the dW pass: the scratch the caller
// allocates for it is (2, chunks, H, 4H) doubles.
int fused_lstm_bwd_dw_chunks(int t, int b, int h) {
  if (bad_args(t, b, h)) return 0;
  const int per = rows_per_chunk(t, b, h);
  return (t * b + per - 1) / per;
}

// All launch on `stream` and return the launch's error or
// cudaGetLastError(): nonzero when the launch was refused. None
// synchronises or allocates. In stream order: the gate pass writes the
// activated gates into dxg; the sweep overwrites them with the dgates; the
// dW pass reads ys and dxg, writes its partials to `partial` and reduces
// them into dw.
int fused_lstm_bwd_gates(const float* xg, const float* w_hh, const float* ys,
                         float* dxg, int t, int b, int h, void* stream) {
  if (bad_args(t, b, h)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((t * b + kGateTile - 1) / kGateTile,
                  (4 * h + kGateTile - 1) / kGateTile, 2);
  lstm_gates_kernel<<<grid, kGateThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(xg, w_hh, ys, dxg,
                                                           t, b, h);
  return static_cast<int>(cudaGetLastError());
}

// On the plan of fused_lstm_bwd_plan.
int fused_lstm_bwd_sweep(const float* w_hh, const float* cs, const float* dys,
                         const float* dc_fin, float* dxg, int t, int b, int h,
                         void* stream) {
  Plan p;
  if (bad_args(t, b, h) || !pick_plan(h, b, kVec, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b * p.cluster, 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.cluster > 1
             ? dispatch<true>(p, grid, s, w_hh, cs, dys, dc_fin, dxg, t, b, h,
                              p)
             : dispatch<false>(p, grid, s, w_hh, cs, dys, dc_fin, dxg, t, b,
                               h, p);
}

int fused_lstm_bwd_dw_partial(const float* ys, const float* dxg,
                              double* partial, int t, int b, int h,
                              void* stream) {
  if (bad_args(t, b, h)) return static_cast<int>(cudaErrorInvalidValue);
  const int per = rows_per_chunk(t, b, h);
  const int chunks = (t * b + per - 1) / per;
  const dim3 grid(tiles(h), chunks, 2);
  lstm_dw_partial_kernel<<<grid, kDwThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      ys, dxg, partial, t, b, h, per, chunks);
  return static_cast<int>(cudaGetLastError());
}

int fused_lstm_bwd_dw_reduce(const double* partial, float* dw, int t, int b,
                             int h, void* stream) {
  if (bad_args(t, b, h)) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = fused_lstm_bwd_dw_chunks(t, b, h);
  const long long n = 2LL * h * 4 * h;
  const int threads = 256;
  lstm_dw_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                          threads, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, dw, h, chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_lstm_bwd_error_string(int code) {
  return error_string(code);
}

}  // extern "C"
