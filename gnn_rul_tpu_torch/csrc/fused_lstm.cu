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
//   c_fin (2, B, H) = cs[T-1]. h and c start at zero. All fp32, or all bf16
//   (the _bf16 entry: h and c carried in fp32, ys, cs and c_fin stored
//   rounded to bf16 each step, W_hh held in fp32), contiguous.
//   Or G groups (seed-parallel runs, all seeds in one launch): w_hh (G, 2,
//   H, 4H), batch column b run with w_hh[b / (B/G)]; each CTA (or cluster)
//   serves one column, so it reads its group's W_hh and nothing else
//   changes. The plan is chosen from H and the whole B.
//
// Replaces gnn_rul_tpu/ops/pallas/fused_lstm.py::_fwd_kernel, which walks
// time on the TPU's sequential grid with h, c and W_hh resident in VMEM,
// features in sublanes and the batch in lanes. None of that layout carries
// over. Here the recurrence is independent per (direction, batch column), so
// one CTA, or one cluster of C CTAs, owns one column of one direction and
// loops over all T steps itself, with h in shared memory (double-buffered)
// and c in a register. Each step a group of S lanes per hidden unit splits
// the product over the rows of W_hh (fused_lstm.cuh: the plan, where W_hh
// lives). Any H up to 1024, any T >= 1 and B >= 1.
//
// Two steps share that cut; the plan picks one from H, B and the SM count
// (pick_fwd_plan), never from the model:
//
//   ring, where the 2*B*C CTAs have an SM each (HAGCN's B = 5 and its
//   five seeds' B = 25: the time is T steps' latency), and for one CTA a
//   column where an SM holds several of its CTAs and they all run in two
//   waves (LOGO's B = 70 at H = 48, LOGO_bearing's B = 200 and XJTU-SY's
//   544 at H = 30). The step keeps everything it can off its chain. A warp
//   of its own copies kBlock steps' gate inputs at a time into a ring in
//   shared memory with bulk
//   copies (a row of 4H values of one (column, direction) is contiguous),
//   each half of the ring completing on an mbarrier that the product warps
//   wait on once per kBlock steps, so no product lane issues a global
//   load. The lanes that hold a unit's gate totals after the
//   reduce-scatter add the gate input and activate them, and shuffles
//   give the unit's lanes the four gates, each keeping c: one hand-off, by
//   registers, and one barrier a step. In a cluster each CTA pushes its
//   units' h to every other CTA with st.async, one other CTA per lane of
//   the group, completing on the receiver's mbarrier; one warp waits for
//   the others' h, and the CTA's barrier ends the step, in place of a
//   cluster barrier.
//   classic, elsewhere (LOGO_bearing's B = 200 at H = 60, whose ring CTAs
//   an SM holds one at a time, and more than two waves): the lanes hand
//   the gate sums on through shared memory to one thread per (unit, gate)
//   for its activation, then to one thread per unit for the cell, with CTA
//   barriers between; each thread copies its next gate inputs with
//   cp.async; remote stores and a cluster barrier exchange h. Its CTAs are
//   smaller, so more of them share an SM (pick_fwd_plan; both steps at
//   those shapes: PERF.md §6, PR 21).
//
// W_hh[k] is 16*H^2 bytes: 36,864 B at H=48 (LOGO FD001), 230,400 B at
// H=120 (HAGCN), 589,824 B at H=192 (LOGO FD003). A lane keeps its rows in
// registers up to H = 64 in one CTA; one CTA holds W_hh in shared memory up
// to H ~ 116; clusters of 2, 4 or 8 CTAs hold it (in registers or shared
// memory) up to H ~ 336 (fused_lstm.cuh, pick_plan; chip_smoke.py prints
// each plan); above, one CTA reads it from the L2 (classic step only).
//
// Bound on an H100 SXM at LOGO's training shape (T=100, B=70, H=48): xg
// and W_hh read, ys and cs written, 16.2 MB, 4.84 us at 3.35 TB/s; the
// recurrent products 2*T*2*B*8H^2 = 258 MFLOP, 3.9 us at 67 TFLOP/s fp32.
// At HAGCN's (T=1400, B=5, H=60) the bound is 6 us against ~0.7 ms. The
// kernel cannot approach either: the T dependent steps set its time, each
// a product, a reduction, the gates' and the cell's transcendentals and
// the hand-off of h. The design shortens the product's dependent chain from
// H to H/S FMAs per gate, keeps W_hh in registers where it fits, and (the
// ring step) keeps the copies, the hand-offs through shared memory and all
// but one barrier off a step's chain. What is left at H = 60 is the
// product, the activations and the cell on one SM, whose 8 warps issue
// them (chip_smoke.py's step-phase stamps, PERF.md). No
// fast-math intrinsics: expf, tanhf and a correctly rounded reciprocal,
// since errors compound over up to 14,000 dependent steps.

#include <cstdint>

#include "fused_lstm.cuh"

namespace {

using namespace lstm;

// Step-phase stamps. Built with -DLSTM_STAMPS (a library of its own,
// ops/kernels/build.py::build_variant, which only chip_smoke.py loads),
// thread 0 of the CTA at grid (0, 0) adds clock64's advance over each phase
// of every step to a counter of its own, then writes the kStampPhases
// counters, the loop's clocks and T to `stamps`. Without the macro STAMP()
// is empty, and the kernels hold no stamp code.
constexpr int kStampPhases = 10;
#ifdef LSTM_STAMPS
struct StampClock {
  long long acc[kStampPhases];
  long long first, last;
  bool on;
  __device__ __forceinline__ void start(const long long* out) {
    on = out != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
         threadIdx.x == 0;
#pragma unroll
    for (int k = 0; k < kStampPhases; ++k) acc[k] = 0;
    first = last = clock64();
  }
  __device__ __forceinline__ void mark(int k) {
    const long long now = clock64();
    acc[k] += now - last;
    last = now;
  }
  __device__ __forceinline__ void finish(long long* out, int steps) {
    if (!on) return;
#pragma unroll
    for (int k = 0; k < kStampPhases; ++k) out[k] = acc[k];
    out[kStampPhases] = last - first;
    out[kStampPhases + 1] = steps;
  }
};
#define STAMP_START(out) \
  StampClock clk;        \
  clk.start(out)
#define STAMP(k) clk.mark(k)
#define STAMP_END(out, steps) clk.finish(out, steps)
#else
#define STAMP_START(out) ((void)0)
#define STAMP(k) ((void)0)
#define STAMP_END(out, steps) ((void)0)
#endif

// h (floats, double-buffered); the gate sums handed on to the activation
// threads, which overwrite them with the activated gates, [4][U + 1] floats
// (the odd stride spreads the stores over the banks); the gate inputs of
// two steps, [2][4U] floats.
constexpr VecSpec kVec = {sizeof(float), 2, 2, 12 * sizeof(float),
                          4 * sizeof(float)};

// Finishes the group's four gate sums. scatter_gate_sums (S >= 4): a
// reduce-scatter (two exchanges leave lane s with gate s & 3 summed over
// four lanes), then a butterfly over the rest; every lane s returns gate
// s & 3's total. store_gate_sums stores gate q's total at gsum[q * stride]:
// for S >= 4 lanes 0-3; for S <= 2 after a butterfly, lane s the gates q =
// s mod S.
__device__ __forceinline__ float scatter_gate_sums(float4 a, int s,
                                                  int lanes) {
  constexpr unsigned kAll = 0xffffffffu;
  const bool hi = s & 2, odd = s & 1;
  float k0 = hi ? a.z : a.x, k1 = hi ? a.w : a.y;
  k0 += __shfl_xor_sync(kAll, hi ? a.x : a.z, 2);
  k1 += __shfl_xor_sync(kAll, hi ? a.y : a.w, 2);
  float v = odd ? k1 : k0;
  v += __shfl_xor_sync(kAll, odd ? k0 : k1, 1);
  return group_sum(v, lanes, 4);
}

__device__ __forceinline__ void store_gate_sums(float4 a, int s, int lanes,
                                                float* gsum, int stride,
                                                bool store) {
  if (lanes >= 4) {
    const float v = scatter_gate_sums(a, s, lanes);
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
// T: the storage type. A bf16 call reads its gate inputs into registers one
// step ahead (cp.async copies no conversion) and stores each step's h and
// c rounded; h and c are carried in fp32, as the Pallas kernel's VMEM
// scratch carries them.
template <typename T, bool kCluster, int kW>
__global__ void __launch_bounds__(kW > 0 ? kRegThreads : kMaxThreads)
lstm_fwd_kernel(const T* __restrict__ xg, const T* __restrict__ w,
                T* __restrict__ ys, T* __restrict__ cs,
                T* __restrict__ c_fin, int t_len, int b_len, int h,
                int per, Plan p, long long* stamps) {
  constexpr bool kF32 = std::is_same<T, float>::value;
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
  // This column's group's W_hh, this direction's.
  const T* wk = w + (static_cast<size_t>(col / per) * 2 + dir) * h * g;
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
  const T* xrow = xg + row * g;

  // This thread's activation slots; slot k's gate input of step t is
  // copied to xin[(t & 1) * nslot + k] during step t - 1.
  int x_off[kSlots], g_off[kSlots];
  bool tanh_slot[kSlots], live[kSlots];
  float xr[kSlots];  // bf16: this step's gate inputs
#pragma unroll
  for (int m = 0; m < kSlots; ++m) {
    const int k = tid + m * p.threads, q = k / p.units, uu = k % p.units;
    live[m] = k < nslot && u0 + uu < h;
    tanh_slot[m] = q == 2;
    x_off[m] = q * h + u0 + uu;
    g_off[m] = q * stride + uu;
    if constexpr (kF32) {
      if (live[m]) cp_async4(xin + k, xrow + x_off[m]);
    } else {
      xr[m] = live[m] ? dtype::to_float(xrow[x_off[m]]) : 0.f;
    }
  }
  cp_async_commit();
  if (kCluster)
    cluster_barrier();  // every CTA's buffers are zero before any store
  else
    __syncthreads();

  float c = 0.f;
  STAMP_START(stamps);
  for (int t = 0; t < t_len; ++t) {
    const float* hprev = hbuf + (t & 1) * nv;
    float* hnext = hbuf + ((t + 1) & 1) * nv;
    float xn[kSlots];  // bf16: the next step's gate inputs
    if (t + 1 < t_len) {
      float* next = xin + ((t + 1) & 1) * nslot;
#pragma unroll
      for (int m = 0; m < kSlots; ++m)
        if (live[m]) {
          if constexpr (kF32)
            cp_async4(next + tid + m * p.threads,
                      xrow + (t + 1) * xstep + x_off[m]);
          else
            xn[m] = dtype::to_float(xrow[(t + 1) * xstep + x_off[m]]);
        }
    }
    cp_async_commit();
    STAMP(0);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kW > 0)
      a = reg_product(wr, hprev + s, sl);
    else if constexpr (kW == 0)
      a = lane_product(hprev + s, ws + tid, p);
    else if (u0 + u < h)
      a = lane_product_global(hprev, wk + u0 + u, g, h, s, sl);
    STAMP(1);
    store_gate_sums(a, s, sl, gate + u, stride, u < p.units);
    STAMP(2);
    cp_async_wait_prior();  // this step's gate inputs have arrived
    __syncthreads();        // the gate sums are complete
    STAMP(3);
    const float* x = xin + (t & 1) * nslot;
#pragma unroll
    for (int m = 0; m < kSlots; ++m) {
      if (live[m]) {
        const float pre =
            (kF32 ? x[tid + m * p.threads] : xr[m]) + gate[g_off[m]];
        gate[g_off[m]] = tanh_slot[m] ? tanhf(pre) : sigmoid(pre);
      }
    }
    STAMP(4);
    __syncthreads();  // the gates are activated
    STAMP(5);
    if (cell) {
      const float ig = gate[tid], fg = gate[stride + tid];
      const float gg = gate[2 * stride + tid], og = gate[3 * stride + tid];
      c = fg * c + ig * gg;
      const float hn = og * tanhf(c);
      STAMP(6);
      ys[t * hstep + hrow] = dtype::from_float<T>(hn);
      cs[t * hstep + hrow] = dtype::from_float<T>(c);
      STAMP(7);
      if (kCluster)
        store_to_cluster(hnext, jc, hn, p.cluster);
      else
        hnext[jc] = hn;
      STAMP(8);
    }
    // h of step t is complete, in every CTA, before step t + 1 reads it,
    // and the gates have been read before step t + 1 stores its sums.
    if (kCluster)
      cluster_barrier();
    else
      __syncthreads();
    if constexpr (!kF32) {
#pragma unroll
      for (int m = 0; m < kSlots; ++m) xr[m] = xn[m];
    }
    STAMP(9);
  }
  STAMP_END(stamps, t_len);
  if (cell) c_fin[hrow] = dtype::from_float<T>(c);
}

// The ring step's register product. Lane s of a group sums the rows r =
// 4 * (s + S * i) + k, i < kW / 4, k < 4, of W_hh, held in wr[4i + k], so
// that it reads h as kW / 4 float4 (the group's lanes read consecutive
// ones): a quarter of the shared-memory loads of reg_product, whose lane
// reads one float a row. The rows are the same set, zero beyond H.
template <int kW, typename TW>
__device__ __forceinline__ void load_w_regs4(float4 (&wr)[kW], const TW* w,
                                             int h, const Plan& p, int u0,
                                             int u, int s) {
  const int g = 4 * h, j = u0 + u;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const int r = 4 * (s + p.lanes * (i / 4)) + i % 4;
    wr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < p.units && j < h && r < h)
      wr[i] = ldg4(w + static_cast<size_t>(r) * g + j, h);
  }
}

template <int kW>
__device__ __forceinline__ float4 reg_product4(const float4 (&wr)[kW],
                                               const float4* v, int lanes) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < kW; i += 4) {
    const float4 x = v[(i / 4) * lanes];
    fma4(a, x.x, wr[i]);
    fma4(a, x.y, wr[i + 1]);
    fma4(a, x.z, wr[i + 2]);
    fma4(a, x.w, wr[i + 3]);
  }
  return a;
}

// The ring step's shared memory: the mbarriers (the ring's two halves,
// full and empty, then, in a cluster, h's two buffers; 64 bytes, so what
// follows is 16-byte aligned), W_hh where the plan holds it there,
// the ring of gate inputs, [2 * kBlock][4H] floats, and h double-buffered.
constexpr int kBlock = 16;  // steps of gate inputs a half of the ring holds
static_assert((kBlock & (kBlock - 1)) == 0, "a power of two");
constexpr size_t kBarBytes = 6 * sizeof(unsigned long long) + 16;

inline size_t ring_smem(const Plan& p, int h) {
  return kBarBytes +
         (p.w_mode == kWShared
              ? static_cast<size_t>(p.iters) * p.threads * sizeof(float4)
              : 0) +
         static_cast<size_t>(2 * kBlock) * 4 * h * sizeof(float) +
         static_cast<size_t>(2) * p.iters * p.lanes * sizeof(float);
}

// kW as lstm_fwd_kernel's, on chip only (0, 8 or 16). The CTA's last warp
// copies the gate inputs (fp32): kBlock steps at a time into a half of a
// ring in shared memory, one bulk copy a step's row, completing on the
// half's "full" mbarrier; it refills a half once every product warp has
// arrived on the half's "empty" mbarrier after its last step. So no warp
// of the step's chain issues a copy. One step, for a product lane (unit u,
// lane s) of a CTA of the cluster:
//   this step's gate inputs from the ring (fp32; the full mbarrier waited
//   on at a block's first step), or from registers loaded a step ahead
//   (bf16);
//   the product, reading h as float4 (reg_product4);
//   the group's totals (S >= 4: lane s holds gate s & 3's and takes both
//   activations of it, keeping its gate's, then shuffles give every lane
//   of the group the four gates; S <= 2: every lane takes all four), so no
//   branch splits the warp;
//   every lane of the group updates its copy of c and h (the same values);
//   the cell lane (s = 0) writes h into this CTA's buffer, and in a cluster
//   lanes 1..C-1 each store it into one other CTA's buffer (st.async,
//   completing on that CTA's mbarrier), so no lane that stores to global
//   memory releases at the cluster's scope; the cell lane stores ys, cs;
//   in a cluster warp 0 waits for the other CTAs' h on the mbarrier; one
//   barrier of the product warps ends the step.
template <typename T, bool kCluster, int kW>
__global__ void __launch_bounds__(kW > 0 ? kRegThreads : kMaxThreads)
lstm_fwd_kernel_ring(const T* __restrict__ xg, const T* __restrict__ w,
                     T* __restrict__ ys, T* __restrict__ cs,
                     T* __restrict__ c_fin, int t_len, int b_len, int h,
                     int per, Plan p, long long* stamps) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 smem[];
  const int g = 4 * h, tid = threadIdx.x, sl = p.lanes;
  const int rank =
      kCluster ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int col = blockIdx.x / p.cluster, dir = blockIdx.y;
  const int u0 = rank * p.units;
  const int u = tid / sl, s = tid % sl, j = u0 + u;
  const int warp = tid / kWarp, lane = tid % kWarp, per_warp = kWarp / sl;
  // Live units are a prefix of the CTA's; a warp with none only keeps the
  // barriers.
  const int live_units = min(p.units, h - u0);
  const int live_warps = (live_units + per_warp - 1) / per_warp;
  const bool copier = tid >= p.threads;  // the copying warp
  const bool live = !copier && u < live_units, cell = live && s == 0;
  const bool warp_live = warp < live_warps;
  const bool one = sl >= 4;  // one gate a lane
  const int q1 = s & 3, base = lane & ~(sl - 1);  // base: the group's lane 0
  const int nv = p.iters * sl;
  float4* ws = smem + kBarBytes / sizeof(float4);
  float* xring = reinterpret_cast<float*>(
      ws + (kW == 0 ? static_cast<size_t>(p.iters) * p.threads : 0));
  float* hbuf = xring + 2 * kBlock * g;
  // mbarrier addresses: ring half k full at xbar + 8k and empty at xbar +
  // 16 + 8k, h's buffer b at hbar + 8b.
  const unsigned xbar = smem_u32(smem), hbar = xbar + 32;
  const T* wk = w + (static_cast<size_t>(col / per) * 2 + dir) * h * g;
  float4 wr[kW > 0 ? kW : 1];
  if constexpr (kW > 0)
    load_w_regs4(wr, wk, h, p, u0, u, s);
  else
    stage_w(ws, wk, h, p, u0, false);
  for (int i = tid; i < 2 * nv; i += p.threads) hbuf[i] = 0.f;
  if (tid == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(xbar + 8 * k, 1);
      mbar_init(xbar + 16 + 8 * k, live_warps);
    }
    if (kCluster)
      for (int k = 0; k < 2; ++k) mbar_init(hbar + 8 * k, 1);
    mbar_init_fence();
  }

  const size_t xstep = static_cast<size_t>(2) * b_len * g;
  const size_t hstep = static_cast<size_t>(2) * b_len * h;
  const size_t row = static_cast<size_t>(dir) * b_len + col;
  const size_t hrow = row * h + j;
  const T* xrow = xg + row * g;
  // h entries each CTA receives from the others a step.
  const unsigned remote_bytes = 4u * static_cast<unsigned>(h - live_units);
  // Every lane of a live warp reads gate inputs, a lane of a unit beyond H
  // those of the CTA's first unit: no branch on the unit splits the warp.
  const int jx = live ? j : u0;
  float xr[4] = {0.f, 0.f, 0.f, 0.f};  // bf16: this step's gate inputs
  if constexpr (!kF32) {
    if (!copier) {
      if (one)
        xr[0] = dtype::to_float(xrow[q1 * h + jx]);
      else
#pragma unroll
        for (int q = 0; q < 4; ++q) xr[q] = dtype::to_float(xrow[q * h + jx]);
    }
  }
  if (kCluster)
    cluster_barrier();  // every CTA's buffers and mbarriers are ready
  else
    __syncthreads();

  if (copier) {
    // Block m of kBlock steps into ring half m & 1, once the product warps
    // have left block m - 2 (the empty mbarrier's phase (m - 2) / 2).
    if constexpr (kF32) {
      if (lane == 0) {
        const unsigned xbytes = static_cast<unsigned>(g * sizeof(float));
        for (int m = 0; m * kBlock < t_len; ++m) {
          const int half = m & 1, t0 = m * kBlock;
          const int n = min(kBlock, t_len - t0);
          if (m >= 2) mbar_wait(xbar + 16 + 8 * half, ((m - 2) >> 1) & 1);
          mbar_arrive_tx(xbar + 8 * half, n * xbytes);
          for (int r = 0; r < n; ++r)
            bulk_load(smem_u32(xring + (half * kBlock + r) * g),
                      xrow + (t0 + r) * xstep, xbytes, xbar + 8 * half);
        }
      }
    }
  } else {
    if (kCluster && tid == 1 && t_len > 1)
      mbar_arrive_tx(hbar + 8, remote_bytes);  // h of step 0's phase
    // Addresses that do not change from step to step: this lane's gate
    // inputs in the ring's row 0 (one gate, or all four at stride H), its
    // ys and cs at step 0.
    const float* xlane = xring + jx + (one ? q1 * h : 0);
    T* ysp = ys + hrow;
    T* csp = cs + hrow;
    const T* xnext = xrow + jx + (one ? q1 * h : 0);
    float c = 0.f;
    STAMP_START(stamps);
    for (int t = 0; t < t_len; ++t) {
      const int b = t & 1;
      if (warp_live) {
        // h of step t - 1 in buffer b; this lane's entry of step t's.
        const float* hread = hbuf + b * nv;
        float* hwrite = hbuf + (b ^ 1) * nv + j;
        float xv[4];
        if constexpr (kF32) {
          if (t % kBlock == 0)
            mbar_wait(xbar + 8 * ((t / kBlock) & 1), (t / (2 * kBlock)) & 1);
          const float* xs = xlane + (t & (2 * kBlock - 1)) * g;
          if (one)
            xv[0] = xs[0];
          else
#pragma unroll
            for (int q = 0; q < 4; ++q) xv[q] = xs[q * h];
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = xr[q];
          if (t + 1 < t_len) {
            xnext += xstep;
            if (one)
              xr[0] = dtype::to_float(xnext[0]);
            else
#pragma unroll
              for (int q = 0; q < 4; ++q) xr[q] = dtype::to_float(xnext[q * h]);
          }
        }
        STAMP(0);
        float4 a;
        if constexpr (kW > 0)
          a = reg_product4(wr, reinterpret_cast<const float4*>(hread) + s, sl);
        else
          a = lane_product(hread + s, ws + tid, p);
        STAMP(1);
        float ig, fg, gg, og;
        if (one) {
          const float pre = scatter_gate_sums(a, s, sl) + xv[0];
          STAMP(2);
          const float sg = sigmoid(pre), th = tanhf(pre);
          const float act = q1 == 2 ? th : sg;
          STAMP(3);
          ig = __shfl_sync(kAll, act, base);
          fg = __shfl_sync(kAll, act, base + 1);
          gg = __shfl_sync(kAll, act, base + 2);
          og = __shfl_sync(kAll, act, base + 3);
        } else {
          a = group_sum4(a, sl);
          STAMP(2);
          ig = sigmoid(a.x + xv[0]);
          fg = sigmoid(a.y + xv[1]);
          gg = tanhf(a.z + xv[2]);
          og = sigmoid(a.w + xv[3]);
          STAMP(3);
        }
        STAMP(4);
        // Every lane of the group has the four gates, so each updates its
        // own copy of c and h, the same values, and no branch splits the
        // warp; the cell lane stores them. h of the last step is read by
        // no step.
        const bool publish = t + 1 < t_len;
        c = fg * c + ig * gg;
        const float hn = og * tanhf(c);
        STAMP(5);
        if (publish && cell) *hwrite = hn;
        if (kCluster && publish && live && s >= 1 && s < p.cluster) {
          const int q = rank + s - (rank + s >= p.cluster ? p.cluster : 0);
          store_async(map_rank(smem_u32(hwrite), q), hn,
                      map_rank(hbar + 8 * (b ^ 1), q));
        }
        STAMP(6);
        if (cell) {
          *ysp = dtype::from_float<T>(hn);
          *csp = dtype::from_float<T>(c);
        }
        ysp += hstep;
        csp += hstep;
        STAMP(7);
        // The warp has read the last row of its block's half.
        if (kF32 && t % kBlock == kBlock - 1) {
          __syncwarp();
          if (lane == 0) mbar_arrive(xbar + 16 + 8 * ((t / kBlock) & 1));
        }
        STAMP(8);
        // h of step t from the other CTAs, then this phase's buffer armed
        // for step t + 2's h.
        if (kCluster && warp == 0 && t + 1 < t_len) {
          mbar_wait(hbar + 8 * (b ^ 1), (t >> 1) & 1);
          if (tid == 1 && t + 2 < t_len)
            mbar_arrive_tx(hbar + 8 * b, remote_bytes);
        }
      }
      // The product warps' barrier (the copying warp keeps out of it).
      asm volatile("bar.sync 1, %0;\n" ::"r"(p.threads) : "memory");
      STAMP(9);
    }
    STAMP_END(stamps, t_len);
    if (cell) c_fin[hrow] = dtype::from_float<T>(c);
  }
  // No CTA leaves while another may still address its shared memory.
  if (kCluster) cluster_barrier();
}

// The ring step on plan p's cut, where its shared memory fits, the copying
// warp fits the CTA, every CTA of a cluster has units and a group has a
// lane for each other CTA.
inline bool to_ring(int h, Plan* p) {
  const int most = p->w_mode == kWRegisters ? kRegThreads : kMaxThreads;
  if (p->w_mode == kWGlobal || (p->cluster - 1) * p->units >= h ||
      (p->cluster > 1 && p->cluster > p->lanes) || p->threads + kWarp > most)
    return false;
  const size_t smem = ring_smem(*p, h);
  if (smem > static_cast<size_t>(smem_optin_limit())) return false;
  p->smem = smem;
  p->step = kStepRing;
  return true;
}

template <typename T, bool kCluster, int kW, typename... Args>
int run_fwd(const Plan& p, dim3 grid, cudaStream_t s, Args... args) {
  if (p.step == kStepRing) {
    if constexpr (kW >= 0) {
      static Prepared ring_done = {};
      return run(lstm_fwd_kernel_ring<T, kCluster, kW>, ring_done, p, grid, s,
                 args...);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);  // no plan asks this
    }
  }
  static Prepared done = {};
  return run(lstm_fwd_kernel<T, kCluster, kW>, done, p, grid, s, args...);
}

template <typename T, bool kCluster, typename... Args>
int dispatch(const Plan& p, dim3 grid, cudaStream_t s, Args... args) {
  if (p.w_mode == kWRegisters)
    return p.iters == kRegRows
               ? run_fwd<T, kCluster, kRegRows>(p, grid, s, args...)
               : run_fwd<T, kCluster, kRegRows / 2>(p, grid, s, args...);
  if (p.w_mode == kWShared)
    return run_fwd<T, kCluster, 0>(p, grid, s, args...);
  if constexpr (kCluster)
    return static_cast<int>(cudaErrorInvalidValue);  // no plan asks this
  else
    return run_fwd<T, false, -1>(p, grid, s, args...);
}

template <typename T>
int fwd_on(const Plan& p, const T* xg, const T* w_hh, T* ys, T* cs, T* c_fin,
           int t, int b, int h, int groups, void* stream,
           long long* stamps = nullptr) {
  const dim3 grid(b * p.cluster, 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = b / groups;
  return p.cluster > 1
             ? dispatch<T, true>(p, grid, s, xg, w_hh, ys, cs, c_fin, t, b, h,
                                 per, p, stamps)
             : dispatch<T, false>(p, grid, s, xg, w_hh, ys, cs, c_fin, t, b,
                                  h, per, p, stamps);
}

// The ring kernel's CTAs an SM holds at plan p, by the occupancy
// calculator (the fp32 kernel; bf16's takes the same plan); 0 where it
// cannot tell.
inline int ring_ctas_per_sm(const Plan& p) {
  const auto kernel =
      p.w_mode == kWShared
          ? lstm_fwd_kernel_ring<float, false, 0>
          : (p.iters == kRegRows ? lstm_fwd_kernel_ring<float, false, kRegRows>
                                 : lstm_fwd_kernel_ring<float, false,
                                                        kRegRows / 2>);
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &n, kernel, block_threads(p), p.smem) == cudaSuccess
             ? n
             : 0;
}

// The forward's plan: pick_plan's cut, on the ring step
//   where the 2*B*C CTAs have an SM each (one wave: the time is T steps'
//   latency), or
//   for one CTA a column, where an SM holds two or more of the ring's CTAs
//   and all of them run in at most two waves;
// else on the classic step. On an H100 (PERF.md §6, PR 21) the ring step
// took 15-36% less than the classic one at H = 24, 30 and 48 with B = 70
// to 544, and 6-10% more at H = 60 with B > 66 (one ring CTA an SM) and at
// H = 30 with 2,000 CTAs.
inline bool pick_fwd_plan(int h, int b, Plan* p) {
  if (!pick_plan(h, b, kVec, p)) return false;
  Plan ring = *p;
  if (!to_ring(h, &ring)) return true;
  const long long ctas = 2LL * b * p->cluster, sms = sm_count();
  if (ctas <= sms) {
    *p = ring;
  } else if (p->cluster == 1) {
    const int per_sm = ring_ctas_per_sm(ring);
    if (per_sm >= 2 && ctas <= 2LL * per_sm * sms) *p = ring;
  }
  return true;
}

template <typename T>
int fwd(const T* xg, const T* w_hh, T* ys, T* cs, T* c_fin, int t, int b,
        int h, int groups, void* stream, int* step) {
  Plan p;
  if (bad_shape(t, b) || bad_groups(b, groups) || !pick_fwd_plan(h, b, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  // The ring copies whole 16-byte-aligned rows of an fp32 xg.
  if (p.step == kStepRing && std::is_same<T, float>::value &&
      reinterpret_cast<uintptr_t>(xg) % 16 != 0)
    pick_plan(h, b, kVec, &p);
  *step = p.step;
  return fwd_on(p, xg, w_hh, ys, cs, c_fin, t, b, h, groups, stream);
}

}  // namespace

extern "C" {

int fused_lstm_max_hidden() { return kMaxHidden; }

// The plan at hidden size h and B columns as 8 ints: lanes, cluster,
// units, threads, iters, w_mode (0 global memory, 1 shared memory, 2
// registers), smem bytes, step (0 classic, 1 ring). Returns 0, or
// cudaErrorInvalidValue where no plan fits.
int fused_lstm_fwd_plan(int h, int b, int* out) {
  Plan p;
  if (!pick_fwd_plan(h, b, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  plan_fields(p, out);
  out[7] = p.step;
  return 0;
}

// Launches on `stream` and returns the launch's error or
// cudaGetLastError(): nonzero when the launch was refused. Neither
// synchronises nor allocates. Writes ys, cs (the c trajectory) and c_fin,
// on the plan of fused_lstm_fwd_plan, for B columns in G groups (w_hh (G, 2,
// H, 4H)), and the step it launched to *step: the plan's, or the classic
// step where the plan's ring would copy from an fp32 xg that is not 16-byte
// aligned.
int fused_lstm_fwd(const float* xg, const float* w_hh, float* ys, float* cs,
                   float* c_fin, int t, int b, int h, int groups,
                   void* stream, int* step) {
  return fwd(xg, w_hh, ys, cs, c_fin, t, b, h, groups, stream, step);
}

// The same on bf16 tensors, on the same plan (the ring step reads the gate
// inputs into registers a step ahead: a copy converts nothing).
int fused_lstm_fwd_bf16(const dtype::bf16* xg, const dtype::bf16* w_hh,
                        dtype::bf16* ys, dtype::bf16* cs, dtype::bf16* c_fin,
                        int t, int b, int h, int groups, void* stream,
                        int* step) {
  return fwd(xg, w_hh, ys, cs, c_fin, t, b, h, groups, stream, step);
}

const char* fused_lstm_error_string(int code) { return error_string(code); }

#ifdef LSTM_STAMPS
// The fp32 forward with its step-phase stamps (kStampPhases + 2 values
// written to the device buffer `stamps`), on the plan of
// fused_lstm_fwd_plan, or, where `cluster` > 0, on the on-chip plan with
// that many CTAs a cluster; `step` -1 the plan's step, else that step.
int fused_lstm_fwd_stamped(const float* xg, const float* w_hh, float* ys,
                           float* cs, float* c_fin, int t, int b, int h,
                           int step, int cluster, long long* stamps,
                           void* stream) {
  Plan p;
  bool ok = cluster > 0
                ? on_chip_plan(h, cluster, kVec,
                               static_cast<size_t>(smem_optin_limit()), &p)
                : pick_fwd_plan(h, b, &p);
  if (ok && step >= 0 && step != p.step) {
    if (step == kStepRing) {
      ok = to_ring(h, &p);
    } else {
      const int c = p.cluster;
      ok = on_chip_plan(h, c, kVec, static_cast<size_t>(smem_optin_limit()),
                        &p) ||
           (c == 1 && pick_plan(h, b, kVec, &p));
    }
  }
  if (bad_shape(t, b) || !ok || reinterpret_cast<uintptr_t>(xg) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return fwd_on(p, xg, w_hh, ys, cs, c_fin, t, b, h, 1, stream, stamps);
}

int fused_lstm_stamp_phases() { return kStampPhases; }
#endif

}  // extern "C"
