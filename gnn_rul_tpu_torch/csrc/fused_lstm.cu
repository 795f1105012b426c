// Whole bidirectional LSTM recurrence, forward, for Hopper (sm_90a):
//
//   for t in 0..T-1, for each direction k and batch column b:
//     gates = xg[t, k, b] + h[k, b] @ w_hh[k]         gates [i, f, g, o]
//     c[k, b] = sig(f) * c[k, b] + sig(i) * tanh(g)
//     h[k, b] = sig(o) * tanh(c[k, b])
//     ys[t, k, b] = h[k, b];  cs[t, k, b] = c[k, b]
//
//   xg (T, 2, B, 4H) the projected gate inputs, direction 1 already flipped
//   in time; w_hh (2, H, 4H); ys and the whole c trajectory cs (T, 2, B, H);
//   c_fin (2, B, H) = cs[T-1]. h and c start at zero. All fp32, contiguous.
//
// Replaces gnn_rul_tpu/ops/pallas/fused_lstm.py::_fwd_kernel, which walks
// time on the TPU's sequential grid with h, c and W_hh resident in VMEM,
// features in sublanes and the batch in lanes (H padded to a multiple of 8).
// None of that layout carries over. Here the recurrence is independent per
// (direction, batch column), so one block owns one column of one direction
// and loops over all T steps itself, holding h (shared memory, double
// buffered: one __syncthreads per step) and c (a register) on chip. Thread
// j owns hidden unit j: it computes the four gate pre-activations of unit
// j and updates c_j and h_j. Any H up to 1024 (one thread per unit), any
// T >= 1 and B >= 1.
//
// W_hh[k] is 4H*H*4 bytes: 36,864 B at H=48 (LOGO FD001), 230,400 B at
// H=120 (HAGCN), 589,824 B at H=192 (LOGO FD003). It is kept in shared
// memory, as one float4 of the four gates' weights per (row, unit) with an
// XOR swizzle (fused_lstm.cuh), when it fits the per-block opt-in limit (up
// to H = 120), and is otherwise read from global memory, where the L2
// (50 MB) holds it across steps, coalesced across the units.
//
// Bound on an H100 SXM at LOGO's training shape (T=100, B=70, H=48): xg
// and W_hh read, ys and cs written, 16.2 MB, 4.84 us at 3.35 TB/s; the
// recurrent products 2*T*2*B*8H^2 = 258 MFLOP, 3.9 us at 67 TFLOP/s fp32.
// The kernel cannot approach either: its time is set by the T dependent
// steps, each a chain of H fused multiply-adds per gate, the cell's
// transcendentals and a block barrier. The design keeps every step on chip
// and off the host (one launch for all T steps and both directions), runs
// the 2B independent recurrences as 2B blocks in parallel, reads each
// (row, unit)'s four weights as one float4 in an unrolled product so that
// loads overlap, and prefetches the next step's gate inputs during the
// product. No fast-math intrinsics: expf, tanhf and a correctly rounded
// reciprocal, since errors compound over up to 1,400 dependent steps.

#include "fused_lstm.cuh"

namespace {

using namespace lstm;

template <bool kWShared>
__global__ void __launch_bounds__(kMaxHidden)
lstm_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ w,
                float* __restrict__ ys, float* __restrict__ cs,
                float* __restrict__ c_fin, int t_len, int b_len, int h) {
  extern __shared__ float4 smem[];
  const int g = 4 * h, hp8 = pad8(h);
  const int col = blockIdx.x, dir = blockIdx.y, j = threadIdx.x;
  const bool active = j < h;
  float4* ws = smem;  // [hp8][hp8], swizzled, when kWShared
  // [2][hp8]: h of the step before, double-buffered, zero beyond H.
  float* hbuf = reinterpret_cast<float*>(smem + (kWShared ? hp8 * hp8 : 0));
  const float* wk = w + static_cast<size_t>(dir) * h * g;
  if (kWShared) stage_w(ws, wk, h);
  for (int i = threadIdx.x; i < 2 * hp8; i += blockDim.x) hbuf[i] = 0.f;
  __syncthreads();

  // Step t of this (direction, column) lives at t * step from the row base.
  const size_t xstep = static_cast<size_t>(2) * b_len * g;
  const size_t hstep = static_cast<size_t>(2) * b_len * h;
  const float* xrow = xg + (static_cast<size_t>(dir) * b_len + col) * g + j;
  const size_t hrow = (static_cast<size_t>(dir) * b_len + col) * h + j;

  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) x = make_float4(xrow[0], xrow[h], xrow[2 * h], xrow[3 * h]);
  float c = 0.f;
  for (int t = 0; t < t_len; ++t) {
    const float* hprev = hbuf + (t & 1) * hp8;
    float* hnext = hbuf + ((t + 1) & 1) * hp8;
    if (active) {
      // The next step's gate inputs, in flight during this step's product.
      float4 xn = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t + 1 < t_len) {
        const float* p = xrow + (t + 1) * xstep;
        xn = make_float4(p[0], p[h], p[2 * h], p[3 * h]);
      }
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kWShared)
        gates_shared(ws, hprev, j, hp8, a);
      else
        gates_global(wk, hprev, j, h, a);
      const float ig = sigmoid(x.x + a.x);
      const float fg = sigmoid(x.y + a.y);
      const float gg = tanhf(x.z + a.z);
      const float og = sigmoid(x.w + a.w);
      c = fg * c + ig * gg;
      const float hn = og * tanhf(c);
      ys[t * hstep + hrow] = hn;
      cs[t * hstep + hrow] = c;
      hnext[j] = hn;
      x = xn;
    }
    __syncthreads();  // h of step t is complete before step t + 1 reads it
  }
  if (active) c_fin[hrow] = c;
}

size_t smem_bytes(int h, bool w_shared) {
  return (w_shared ? w_smem_bytes(h) : 0) + 2 * pad8(h) * sizeof(float);
}

size_t allowed_smem[kMaxDevices] = {};

}  // namespace

extern "C" {

int fused_lstm_max_hidden() { return kMaxHidden; }

// 1 when the forward keeps W_hh in shared memory at this H, else 0.
int fused_lstm_fwd_w_shared(int h) {
  return smem_bytes(h, true) <= static_cast<size_t>(smem_optin_limit());
}

// Launches on `stream` and returns cudaGetLastError(): nonzero when the
// launch was refused. Neither synchronises nor allocates. Writes ys, cs
// (the c trajectory) and c_fin.
int fused_lstm_fwd(const float* xg, const float* w_hh, float* ys, float* cs,
                   float* c_fin, int t, int b, int h, void* stream) {
  if (t <= 0 || b <= 0 || h <= 0 || h > kMaxHidden)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b, 2);
  const int threads = (h + kWarp - 1) / kWarp * kWarp;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fused_lstm_fwd_w_shared(h)) {
    const size_t bytes = smem_bytes(h, true);
    const cudaError_t err =
        allow_smem(lstm_fwd_kernel<true>, bytes, allowed_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    lstm_fwd_kernel<true><<<grid, threads, bytes, s>>>(xg, w_hh, ys, cs,
                                                        c_fin, t, b, h);
  } else {
    lstm_fwd_kernel<false><<<grid, threads, smem_bytes(h, false), s>>>(
        xg, w_hh, ys, cs, c_fin, t, b, h);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* fused_lstm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
