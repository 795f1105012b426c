// Backward of the whole bidirectional LSTM recurrence for Hopper (sm_90a).
// The forward (fused_lstm.cu) saved ys and the c trajectory cs; step t
// consumed h_prev = ys[t-1] and c_prev = cs[t-1] (zero at t = 0):
//
//   gates = xg[t] + h_prev @ w_hh                  (recomputed, [i, f, g, o])
//   dh    = dh_carry + dys[t];   tc = tanh(cs[t])
//   dc    = dh * o * (1 - tc^2) + dc_carry         (dc_carry seeded by dc_fin)
//   di = dc * g * i (1 - i);  df = dc * c_prev * f (1 - f)
//   dg = dc * i (1 - g^2);    do = dh * tc * o (1 - o)
//   dxg[t]   = [di, df, dg, do]
//   dh_carry = dxg[t] @ w_hh^T;   dc_carry = dc * f
//   dw_hh   += h_prev^T dxg[t]                     (summed over B and T)
//
//   xg (T, 2, B, 4H), w_hh (2, H, 4H) and, where w_hh does not fit in
//   shared memory, its transpose (2, 4H, H); ys and cs (T, 2, B, H), dys
//   (T, 2, B, H), dc_fin (2, B, H) -> dxg (T, 2, B, 4H), dw_hh (2, H, 4H).
//   All fp32, contiguous.
//
// Replaces gnn_rul_tpu/ops/pallas/fused_lstm.py::_bwd_kernel, which walks
// the TPU's sequential grid in reverse with dh, dc and dW_hh in VMEM scratch
// and emits dW_hh at the last grid step. On Hopper the blocks run in
// parallel and carry nothing between them, so the work is three launches:
//
//   recurrence: one block per (batch column, direction), thread j owns
//     hidden unit j, reverse time loop with dh and dc in registers; it
//     recomputes the gates from the saved h_prev (staged in shared memory),
//     writes dxg and forms dh_carry from the step's dgates (shared memory,
//     one float4 per unit) and W_hh. The step's loads (h_prev, c, c_prev,
//     dys, xg) are issued one step ahead. W_hh stays in shared memory, in
//     the swizzled float4 layout of fused_lstm.cuh, whose column reads for
//     dh_carry are as free of bank conflicts as its row reads, up to
//     H = 120 (HAGCN); h_prev and the dgates share one buffer, at the price
//     of a fourth barrier per step, so that H = 120 fits the 227 KB limit.
//     Above it W_hh and its transpose are read from global memory (L2),
//     coalesced.
//   dW partials: dW_hh is a product over the T*B rows, h_prev^T dxg. Each
//     block takes a 16 (h) x 64 (gate) tile of dW for one direction and one
//     chunk of rows, staging 32 rows of h_prev and dxg at a time in shared
//     memory, and writes its partial sum to a scratch (2, chunks, H, 4H).
//     A 32-row tile is summed in fp32 and the tiles in fp64: an fp32 sum
//     over the 70,000 rows of a T=1000 call drifts by ~1e-4, more than the
//     check against the plain version allows.
//   dW reduce: one thread per dW element adds the chunks' partials in chunk
//     order, in fp64, and rounds once to fp32.
//
// No atomics: every output element has one writer, and the partials are
// added in a fixed order, so the gradients are deterministic.
//
// Bound on an H100 SXM at LOGO's training shape (T=100, B=70, H=48): xg,
// ys, cs, dys, W_hh and dc_fin read, dxg and dW_hh written, 29.7 MB,
// 8.9 us at 3.35 TB/s; the three recurrent products (gates, dh, dW) 774
// MFLOP, 11.6 us at 67 TFLOP/s fp32. As in the forward, the T dependent
// steps set the time: the recurrence launch does twice the forward's chain
// per step (the gate product and the dh product) with four barriers, while
// the dW product, which does not depend on the recurrence, runs as a
// parallel pass over all rows after it. No fast-math intrinsics.

#include "fused_lstm.cuh"

namespace {

using namespace lstm;

constexpr int kTileH = 16;        // dW tile: 16 rows of W_hh ...
constexpr int kTileG = 64;        // ... by 64 gate columns
constexpr int kRowTile = 32;      // rows of h_prev and dxg staged at a time
constexpr int kDwThreads = 256;   // 16 x 16 threads, 4 gate columns each
constexpr int kTargetBlocks = 132;  // dW blocks per direction: one per SM

// sum_q sum_m dg[m].q * W[j][q*H + m], W swizzled in shared memory, dg zero
// beyond H: row j of the layout, read column by column.
__device__ __forceinline__ float dh_shared(const float4* ws, const float4* dg,
                                           int j, int hp8) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* row = ws + j * hp8;
  const int jl = j & 7;
  for (int m8 = 0; m8 < hp8; m8 += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float4 d = dg[m8 + u];
      const float4 wv = row[m8 + (u ^ jl)];  // column m8 + u, swizzled
      s.x = fmaf(d.x, wv.x, s.x);
      s.y = fmaf(d.y, wv.y, s.y);
      s.z = fmaf(d.z, wv.z, s.z);
      s.w = fmaf(d.w, wv.w, s.w);
    }
  }
  return (s.x + s.y) + (s.z + s.w);
}

// The same with W_hh^T (4H, H) read from global memory, coalesced across j.
__device__ __forceinline__ float dh_global(const float* wt, const float4* dg,
                                           int j, int h) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* col = wt + j;
  const int qs = h * h;  // gate block stride
#pragma unroll 4
  for (int m = 0; m < h; ++m) {
    const float4 d = dg[m];
    const float* wr = col + m * h;
    s.x = fmaf(d.x, __ldg(wr), s.x);
    s.y = fmaf(d.y, __ldg(wr + qs), s.y);
    s.z = fmaf(d.z, __ldg(wr + 2 * qs), s.z);
    s.w = fmaf(d.w, __ldg(wr + 3 * qs), s.w);
  }
  return (s.x + s.y) + (s.z + s.w);
}

template <bool kWShared>
__global__ void __launch_bounds__(kMaxHidden)
lstm_bwd_kernel(const float* __restrict__ xg, const float* __restrict__ w,
                const float* __restrict__ wt, const float* __restrict__ ys,
                const float* __restrict__ cs, const float* __restrict__ dys,
                const float* __restrict__ dc_fin, float* __restrict__ dxg,
                int t_len, int b_len, int h) {
  extern __shared__ float4 smem[];
  const int g = 4 * h, hp8 = pad8(h);
  const int col = blockIdx.x, dir = blockIdx.y, j = threadIdx.x;
  const bool active = j < h;
  float4* ws = smem;  // [hp8][hp8], swizzled, when kWShared
  // [hp8] float4: the step's dgates per unit, zero beyond H. Its first hp8
  // floats hold h_prev while the gates are recomputed (zero beyond H).
  float4* dg = smem + (kWShared ? hp8 * hp8 : 0);
  float* hprev = reinterpret_cast<float*>(dg);
  const float* wk = w + static_cast<size_t>(dir) * h * g;
  const float* wtk = wt + static_cast<size_t>(dir) * g * h;
  if (kWShared) stage_w(ws, wk, h);
  for (int i = threadIdx.x; i < hp8; i += blockDim.x)
    dg[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t xstep = static_cast<size_t>(2) * b_len * g;
  const size_t hstep = static_cast<size_t>(2) * b_len * h;
  const float* xrow = xg + (static_cast<size_t>(dir) * b_len + col) * g + j;
  const size_t hrow = (static_cast<size_t>(dir) * b_len + col) * h + j;

  // The loads of step t, issued during step t + 1.
  const int last = t_len - 1;
  float n_hp = 0.f, n_c = 0.f, n_cp = 0.f, n_dy = 0.f;
  float4 n_x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
    n_hp = last > 0 ? ys[(last - 1) * hstep + hrow] : 0.f;
    n_c = cs[last * hstep + hrow];
    n_cp = last > 0 ? cs[(last - 1) * hstep + hrow] : 0.f;
    n_dy = dys[last * hstep + hrow];
    const float* p = xrow + last * xstep;
    n_x = make_float4(p[0], p[h], p[2 * h], p[3 * h]);
  }
  float dh = 0.f;
  float dc = active ? dc_fin[hrow] : 0.f;
  for (int t = last; t >= 0; --t) {
    const float hp = n_hp, c = n_c, c_prev = n_cp, dy = n_dy;
    const float4 x = n_x;
    __syncthreads();  // the step after has finished its dh product
    if (j < hp8) hprev[j] = active ? hp : 0.f;
    __syncthreads();
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) {
      if (t > 0) {
        n_hp = t > 1 ? ys[(t - 2) * hstep + hrow] : 0.f;
        n_c = c_prev;
        n_cp = t > 1 ? cs[(t - 2) * hstep + hrow] : 0.f;
        n_dy = dys[(t - 1) * hstep + hrow];
        const float* p = xrow + (t - 1) * xstep;
        n_x = make_float4(p[0], p[h], p[2 * h], p[3 * h]);
      }
      if (kWShared)
        gates_shared(ws, hprev, j, hp8, a);
      else
        gates_global(wk, hprev, j, h, a);
    }
    __syncthreads();  // h_prev has been read; its buffer takes the dgates
    if (active) {
      const float ig = sigmoid(x.x + a.x);
      const float fg = sigmoid(x.y + a.y);
      const float gg = tanhf(x.z + a.z);
      const float og = sigmoid(x.w + a.w);
      const float dhv = dh + dy;
      const float tc = tanhf(c);
      const float dcv = dhv * og * (1.f - tc * tc) + dc;
      const float di = dcv * gg * ig * (1.f - ig);
      const float df = dcv * c_prev * fg * (1.f - fg);
      const float dgg = dcv * ig * (1.f - gg * gg);
      const float dog = dhv * tc * og * (1.f - og);
      float* dx = dxg + t * xstep + (xrow - xg);
      dx[0] = di;
      dx[h] = df;
      dx[2 * h] = dgg;
      dx[3 * h] = dog;
      dg[j] = make_float4(di, df, dgg, dog);
      dc = dcv * fg;
    }
    __syncthreads();  // the step's dgates are complete
    if (active)
      dh = kWShared ? dh_shared(ws, dg, j, hp8) : dh_global(wtk, dg, j, h);
  }
}

// Rows r in [0, T*B) of one direction are (t, b) = (r / B, r % B); row r's
// h_prev is ys[t-1, dir, b] (zero at t = 0) and its dgates dxg[t, dir, b].
__global__ void __launch_bounds__(kDwThreads)
lstm_dw_partial_kernel(const float* __restrict__ ys,
                       const float* __restrict__ dxg,
                       double* __restrict__ partial, int t_len, int b_len,
                       int h, int rows_per_chunk, int chunks) {
  __shared__ float hs[kRowTile][kTileH];
  __shared__ float gs[kRowTile][kTileG];
  const int g = 4 * h;
  const int g_tiles = (g + kTileG - 1) / kTileG;
  const int h0 = (blockIdx.x / g_tiles) * kTileH;
  const int g0 = (blockIdx.x % g_tiles) * kTileG;
  const int chunk = blockIdx.y, dir = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int rows = t_len * b_len;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(rows, r_begin + rows_per_chunk);

  double acc[kTileG / 16] = {0.0, 0.0, 0.0, 0.0};
  for (int r0 = r_begin; r0 < r_end; r0 += kRowTile) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = threadIdx.x; e < kRowTile * kTileH; e += kDwThreads) {
      const int rr = e / kTileH, hh = e % kTileH;
      const int r = r0 + rr, t = r / b_len, b = r % b_len;
      float v = 0.f;
      if (r < r_end && t > 0 && h0 + hh < h)
        v = ys[((static_cast<size_t>(t - 1) * 2 + dir) * b_len + b) * h + h0 +
               hh];
      hs[rr][hh] = v;
    }
    for (int e = threadIdx.x; e < kRowTile * kTileG; e += kDwThreads) {
      const int rr = e / kTileG, gg = e % kTileG;
      const int r = r0 + rr, t = r / b_len, b = r % b_len;
      float v = 0.f;
      if (r < r_end && g0 + gg < g)
        v = dxg[((static_cast<size_t>(t) * 2 + dir) * b_len + b) * g + g0 +
                gg];
      gs[rr][gg] = v;
    }
    __syncthreads();
    float tile[kTileG / 16] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int rr = 0; rr < kRowTile; ++rr) {
      const float hv = hs[rr][ty];
#pragma unroll
      for (int i = 0; i < kTileG / 16; ++i)
        tile[i] = fmaf(hv, gs[rr][tx + 16 * i], tile[i]);
    }
#pragma unroll
    for (int i = 0; i < kTileG / 16; ++i) acc[i] += tile[i];
  }
  const int hh = h0 + ty;
  if (hh >= h) return;
  double* out =
      partial + ((static_cast<size_t>(dir) * chunks + chunk) * h + hh) * g;
#pragma unroll
  for (int i = 0; i < kTileG / 16; ++i) {
    const int gg = g0 + tx + 16 * i;
    if (gg < g) out[gg] = acc[i];
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

size_t smem_bytes(int h, bool w_shared) {
  return (w_shared ? w_smem_bytes(h) : 0) + pad8(h) * sizeof(float4);
}

size_t allowed_smem[kMaxDevices] = {};

bool bad_shape(int t, int b, int h) {
  return t <= 0 || b <= 0 || h <= 0 || h > kMaxHidden ||
         static_cast<long long>(t) * b > (1LL << 30);
}

int tiles(int h) {
  return ((h + kTileH - 1) / kTileH) * ((4 * h + kTileG - 1) / kTileG);
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

// 1 when the recurrence keeps W_hh in shared memory at this H, else 0.
int fused_lstm_bwd_w_shared(int h) {
  return smem_bytes(h, true) <= static_cast<size_t>(smem_optin_limit());
}

// Chunks of rows per direction in the dW pass: the scratch the caller
// allocates for it is (2, chunks, H, 4H) doubles.
int fused_lstm_bwd_dw_chunks(int t, int b, int h) {
  if (bad_shape(t, b, h)) return 0;
  const int per = rows_per_chunk(t, b, h);
  return (t * b + per - 1) / per;
}

// All launch on `stream` and return cudaGetLastError(): nonzero when the
// launch was refused. None synchronises or allocates. The recurrence
// writes dxg; the dW pass, launched after it on the same stream, reads ys
// and dxg, writes its partials to `partial` and reduces them into dw.
int fused_lstm_bwd_recurrence(const float* xg, const float* w_hh,
                              const float* w_hh_t, const float* ys,
                              const float* cs, const float* dys,
                              const float* dc_fin, float* dxg, int t, int b,
                              int h, void* stream) {
  if (bad_shape(t, b, h)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, 2);
  const int threads = (h + kWarp - 1) / kWarp * kWarp;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused_lstm_bwd_w_shared(h)) {
    const size_t bytes = smem_bytes(h, true);
    const cudaError_t err =
        allow_smem(lstm_bwd_kernel<true>, bytes, allowed_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    lstm_bwd_kernel<true><<<grid, threads, bytes, s>>>(
        xg, w_hh, w_hh_t, ys, cs, dys, dc_fin, dxg, t, b, h);
  } else {
    lstm_bwd_kernel<false><<<grid, threads, smem_bytes(h, false), s>>>(
        xg, w_hh, w_hh_t, ys, cs, dys, dc_fin, dxg, t, b, h);
  }
  return static_cast<int>(cudaGetLastError());
}

int fused_lstm_bwd_dw_partial(const float* ys, const float* dxg,
                              double* partial, int t, int b, int h,
                              void* stream) {
  if (bad_shape(t, b, h)) return static_cast<int>(cudaErrorInvalidValue);
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
  if (bad_shape(t, b, h)) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = fused_lstm_bwd_dw_chunks(t, b, h);
  const long long n = 2LL * h * 4 * h;
  const int threads = 256;
  lstm_dw_reduce_kernel<<<static_cast<unsigned>((n + threads - 1) / threads),
                          threads, 0, static_cast<cudaStream_t>(stream)>>>(
      partial, dw, h, chunks);
  return static_cast<int>(cudaGetLastError());
}

const char* fused_lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
