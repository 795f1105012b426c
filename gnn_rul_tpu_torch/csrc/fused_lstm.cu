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
// features in sublanes and the batch in lanes. None of that layout carries
// over. Here the recurrence is independent per (direction, batch column), so
// one CTA, or one cluster of C CTAs, owns one column of one direction and
// loops over all T steps itself, with h in shared memory (double-buffered)
// and c in a register. Each step a group of S lanes per hidden unit splits
// the product over the rows of W_hh and stores the unit's four gate sums;
// after a CTA barrier, one thread per (unit, gate) adds the gate input and
// applies the gate's activation; after another, thread j updates c and h of
// unit j; a CTA (or cluster) barrier ends the step (fused_lstm.cuh: the
// plan, where W_hh lives, the cluster exchange). Any H up to 1024, any
// T >= 1 and B >= 1.
//
// W_hh[k] is 16*H^2 bytes: 36,864 B at H=48 (LOGO FD001), 230,400 B at
// H=120 (HAGCN), 589,824 B at H=192 (LOGO FD003). A lane keeps its rows in
// registers up to H = 64 in one CTA; one CTA holds W_hh in shared memory up
// to H ~ 116; clusters of 2, 4 or 8 CTAs hold it (in registers or shared
// memory) up to H ~ 336 (fused_lstm.cuh, pick_plan; chip_smoke.py prints
// each plan); above, one CTA reads it from the L2.
//
// Bound on an H100 SXM at LOGO's training shape (T=100, B=70, H=48): xg
// and W_hh read, ys and cs written, 16.2 MB, 4.84 us at 3.35 TB/s; the
// recurrent products 2*T*2*B*8H^2 = 258 MFLOP, 3.9 us at 67 TFLOP/s fp32.
// The kernel cannot approach either: the T dependent steps set its time,
// each a product, a reduction, the cell's transcendentals and three
// barriers. The design shortens the product's dependent chain from H to
// H/S FMAs per gate, gives the SM S times the warps to hide latency with
// (6 at H=48), keeps W_hh in registers where it fits, runs each
// transcendental once per unit and gate, and copies the next step's gate
// inputs during the product. No fast-math intrinsics: expf, tanhf and a
// correctly rounded reciprocal, since errors compound over up to 1,400
// dependent steps.

#include "fused_lstm.cuh"

namespace {

using namespace lstm;

// h (floats, double-buffered); the gate sums handed on to the activation
// threads, which overwrite them with the activated gates, [4][U + 1] floats
// (the odd stride spreads the stores over the banks); the gate inputs of
// two steps, [2][4U] floats.
constexpr VecSpec kVec = {sizeof(float), 2, 2, 12 * sizeof(float),
                          4 * sizeof(float)};

// Finishes the group's four gate sums and stores gate q's total at
// gsum[q * stride]. S >= 4: a reduce-scatter (two exchanges leave lane s
// with gate s & 3 summed over four lanes), then a butterfly over the rest;
// lanes 0-3 store. S <= 2: a butterfly; lane s stores the gates q = s mod S.
__device__ __forceinline__ void store_gate_sums(float4 a, int s, int lanes,
                                                float* gsum, int stride,
                                                bool store) {
  constexpr unsigned kAll = 0xffffffffu;
  if (lanes >= 4) {
    const bool hi = s & 2, odd = s & 1;
    float k0 = hi ? a.z : a.x, k1 = hi ? a.w : a.y;
    k0 += __shfl_xor_sync(kAll, hi ? a.x : a.z, 2);
    k1 += __shfl_xor_sync(kAll, hi ? a.y : a.w, 2);
    float v = odd ? k1 : k0;
    v += __shfl_xor_sync(kAll, odd ? k0 : k1, 1);
    v = group_sum(v, lanes, 4);
    if (store && s < 4) gsum[s * stride] = v;
    return;
  }
  a = group_sum4(a, lanes);
  const float q4[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (store && (q & (lanes - 1)) == s) gsum[q * stride] = q4[q];
}

// Activation slots: the 4U (gate q, local unit u) pairs of the CTA, slot
// k = q*U + u, on thread k mod threads (at most 4 a thread, since threads
// >= U). Consecutive slots share q, so a warp's branch on q is uniform.
constexpr int kSlots = 4;

// kW: -1 W_hh read from global memory, 0 in shared memory, 8 or 16 rows a
// lane in registers.
template <bool kCluster, int kW>
__global__ void __launch_bounds__(kW > 0 ? kRegThreads : kMaxThreads)
lstm_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ w,
                float* __restrict__ ys, float* __restrict__ cs,
                float* __restrict__ c_fin, int t_len, int b_len, int h,
                Plan p) {
  extern __shared__ float4 smem[];
  const int g = 4 * h, tid = threadIdx.x, sl = p.lanes;
  const int rank =
      kCluster ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int col = blockIdx.x / p.cluster, dir = blockIdx.y;
  const int u0 = rank * p.units;
  // Product lane: local unit u, lane s. Cell thread: local unit tid.
  const int u = tid / sl, s = tid % sl, jc = u0 + tid;
  const bool cell = tid < p.units && jc < h;
  const int nv = p.iters * sl;  // h entries, zero beyond H
  const int stride = p.units + 1, nslot = 4 * p.units;
  float4* ws = smem;  // [iters][threads] when in shared memory
  // [2][nv]: h of the step before, double-buffered; the gates; the inputs.
  float* hbuf = reinterpret_cast<float*>(
      smem + (kW == 0 ? static_cast<size_t>(p.iters) * p.threads : 0));
  float* gate = hbuf + 2 * nv;
  float* xin = gate + 4 * stride;
  const float* wk = w + static_cast<size_t>(dir) * h * g;
  float4 wr[kW > 0 ? kW : 1];
  if constexpr (kW > 0)
    load_w_regs(wr, wk, h, p, u0, u, s, false);
  else if constexpr (kW == 0)
    stage_w(ws, wk, h, p, u0, false);
  for (int i = tid; i < 2 * nv; i += p.threads) hbuf[i] = 0.f;

  // Step t of this (direction, column) lives at t * step from the row base.
  const size_t xstep = static_cast<size_t>(2) * b_len * g;
  const size_t hstep = static_cast<size_t>(2) * b_len * h;
  const size_t row = static_cast<size_t>(dir) * b_len + col;
  const size_t hrow = row * h + jc;
  const float* xrow = xg + row * g;

  // This thread's activation slots; slot k's gate input of step t is
  // copied to xin[(t & 1) * nslot + k] during step t - 1.
  int x_off[kSlots], g_off[kSlots];
  bool tanh_slot[kSlots], live[kSlots];
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int k = tid + m * p.threads, q = k / p.units, uu = k % p.units;
    live[m] = k < nslot && u0 + uu < h;
    tanh_slot[m] = q == 2;
    x_off[m] = q * h + u0 + uu;
    g_off[m] = q * stride + uu;
    if (live[m]) cp_async4(xin + k, xrow + x_off[m]);
  }
  cp_async_commit();
  if (kCluster)
    cluster_barrier();  // every CTA's buffers are zero before any store
  else
    __syncthreads();

  float c = 0.f;
  for (int t = 0; t < t_len; ++t) {
    const float* hprev = hbuf + (t & 1) * nv;
    float* hnext = hbuf + ((t + 1) & 1) * nv;
    if (t + 1 < t_len) {
      float* next = xin + ((t + 1) & 1) * nslot;
#pragma unroll
      for (int m = 0; m < kSlots; ++m)
        if (live[m])
          cp_async4(next + tid + m * p.threads,
                    xrow + (t + 1) * xstep + x_off[m]);
    }
    cp_async_commit();
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kW > 0)
      a = reg_product(wr, hprev + s, sl);
    else if constexpr (kW == 0)
      a = lane_product(hprev + s, ws + tid, p);
    else if (u0 + u < h)
      a = lane_product_global(hprev, wk + u0 + u, g, h, s, sl);
    store_gate_sums(a, s, sl, gate + u, stride, u < p.units);
    cp_async_wait_prior();  // this step's gate inputs have arrived
    __syncthreads();        // the gate sums are complete
    const float* x = xin + (t & 1) * nslot;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      if (live[m]) {
        const float pre = x[tid + m * p.threads] + gate[g_off[m]];
        gate[g_off[m]] = tanh_slot[m] ? tanhf(pre) : sigmoid(pre);
      }
    }
    __syncthreads();  // the gates are activated
    if (cell) {
      const float ig = gate[tid], fg = gate[stride + tid];
      const float gg = gate[2 * stride + tid], og = gate[3 * stride + tid];
      c = fg * c + ig * gg;
      const float hn = og * tanhf(c);
      ys[t * hstep + hrow] = hn;
      cs[t * hstep + hrow] = c;
      if (kCluster)
        store_to_cluster(hnext, jc, hn, p.cluster);
      else
        hnext[jc] = hn;
    }
    // h of step t is complete, in every CTA, before step t + 1 reads it,
    // and the gates have been read before step t + 1 stores its sums.
    if (kCluster)
      cluster_barrier();
    else
      __syncthreads();
  }
  if (cell) c_fin[hrow] = c;
}

template <bool kCluster, int kW, typename... Args>
int run_fwd(const Plan& p, dim3 grid, cudaStream_t s, Args... args) {
  static Prepared done = {};
  return run(lstm_fwd_kernel<kCluster, kW>, done, p, grid, s, args...);
}

template <bool kCluster, typename... Args>
int dispatch(const Plan& p, dim3 grid, cudaStream_t s, Args... args) {
  if (p.w_mode == kWRegisters)
    return p.iters == kRegRows
               ? run_fwd<kCluster, kRegRows>(p, grid, s, args...)
               : run_fwd<kCluster, kRegRows / 2>(p, grid, s, args...);
  if (p.w_mode == kWShared) return run_fwd<kCluster, 0>(p, grid, s, args...);
  if constexpr (kCluster)
    return static_cast<int>(cudaErrorInvalidValue);  // no plan asks this
  else
    return run_fwd<false, -1>(p, grid, s, args...);
}

}  // namespace

extern "C" {

int fused_lstm_max_hidden() { return kMaxHidden; }

// The plan at hidden size h and B columns as 7 ints: lanes, cluster,
// units, threads, iters, w_mode (0 global memory, 1 shared memory, 2
// registers), smem bytes. Returns 0, or cudaErrorInvalidValue where no
// plan fits.
int fused_lstm_fwd_plan(int h, int b, int* out) {
  Plan p;
  if (!pick_plan(h, b, kVec, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  plan_fields(p, out);
  return 0;
}

// Launches on `stream` and returns the launch's error or
// cudaGetLastError(): nonzero when the launch was refused. Neither
// synchronises nor allocates. Writes ys, cs (the c trajectory) and c_fin,
// on the plan of fused_lstm_fwd_plan.
int fused_lstm_fwd(const float* xg, const float* w_hh, float* ys, float* cs,
                   float* c_fin, int t, int b, int h, void* stream) {
  Plan p;
  if (bad_shape(t, b) || !pick_plan(h, b, kVec, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(b * p.cluster, 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.cluster > 1
             ? dispatch<true>(p, grid, s, xg, w_hh, ys, cs, c_fin, t, b, h, p)
             : dispatch<false>(p, grid, s, xg, w_hh, ys, cs, c_fin, t, b, h,
                               p);
}

const char* fused_lstm_error_string(int code) { return error_string(code); }

}  // extern "C"
