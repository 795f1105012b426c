// Device and host helpers shared by the LSTM recurrence's forward
// (fused_lstm.cu) and backward sweep (fused_lstm_bwd.cu).
//
// Both sweeps have one shape. Each step, for one (batch column, direction),
// a vector v of the H units (the forward's h, the backward's dgates) is
// multiplied by W_hh (H, 4H), gates [i, f, g, o] in column blocks of H, and
// hidden unit j needs all of v:
//
//   forward   gates_j = sum_k h[k] * (W[k][j], W[k][H+j], W[k][2H+j], W[k][3H+j])
//   backward  dh_j    = sum_m dg[m] . (W[j][m], W[j][H+m], W[j][2H+m], W[j][3H+m])
//
// Split-K lanes. A group of S lanes (S a power of two, groups aligned in a
// warp) owns one unit's product; lane s sums the rows r = i*S + s, i < I =
// ceil(H/S), and __shfl_xor_sync butterflies finish the sums in a fixed
// order. S is the least power of two with H/S <= kChain (a dependent chain
// of at most 16 FMAs per gate), halved while the CTA would exceed 1024
// threads.
//
// Cell threads. The per-unit work after the product (the forward's
// activations and cell, the backward's dgates) runs once per unit, on
// threads 0..U-1 of the CTA (the forward's four activations of a unit on
// four threads), not on every lane of the groups: S lanes doing it for one
// unit cost S times the issue slots and, with the branches of the accurate
// expf/tanhf/__frcp_rn, ran three sigmoids in series, which measured as the
// bulk of a step. The product lanes hand their sums on through shared
// memory, at the cost of CTA barriers (~10 clocks each on an H100,
// clock64).
//
// Where W_hh lives. In registers where a lane's rows fit (at most 16,
// rounded up to 8 or 16 with zero rows, in CTAs of at most 512 threads so
// that 128 registers a thread remain): the product then reads only the
// vector from shared memory. With clock64 stamps on an H100 at H=48, a
// step's product took 515 clocks with W_hh streamed from shared memory (128
// bytes a clock) and 218 from registers, both without the step's global
// copies. Otherwise in shared memory, in read order.
//
// Layout in read order. A CTA stages its slice of W_hh in shared memory as
// one float4 per (row r, unit j) above, at slot i * threads + tid for lane
// tid = u*S + s. At each i a warp reads 32 consecutive float4 (512 bytes,
// four 128-byte wavefronts of 8 lanes each), the least a 16-byte load can
// take: no bank conflict and no swizzle. The vector is read at v[i*S + s]:
// the S lanes of a group read S consecutive entries and the groups of a
// warp the same ones (a broadcast), one wavefront for floats and for up to
// 8 float4. An XOR-swizzled layout shared by both kernels would have to
// serve two read patterns (rows for the forward's product, columns for the
// backward's); each kernel reads W_hh one way, so each stages its own order.
//
// Step inputs. Each step's global inputs (the forward's gate inputs, the
// backward's gates, c, c_prev and dys) are copied one step ahead into
// shared memory with cp.async by the threads that consume them. A warp
// that issues global loads or copies stalls ~250 clocks a step (clock64),
// wherever in the step it issues them and whether it issues them one step
// or eight ahead; one extra warp issuing all of them took longer still, so
// the copies stay spread, one per consuming thread.
//
// Clusters. Where one CTA's shared memory cannot hold W_hh, a cluster of C
// CTAs owns one (column, direction):
// CTA rank q holds the units [q*U, q*U + U), U = ceil(H/C), and every CTA
// keeps the whole vector. Each step each CTA writes its units' entries into
// every CTA's copy (cooperative_groups::cluster_group::map_shared_rank),
// then one cluster barrier (barrier.cluster.arrive.release, wait.acquire)
// orders the step. The vector is double-buffered, so no CTA overwrites
// entries that another still reads. Above what C <= 8 CTAs can hold, one
// CTA reads W_hh from global memory (the L2 keeps it across steps).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace lstm {

namespace cg = cooperative_groups;

constexpr int kWarp = 32;
constexpr int kMaxHidden = 1024;
constexpr int kMaxThreads = 1024;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kChain = 16;      // most rows a lane sums, where S allows
constexpr int kMaxDevices = 64;
// Returned where no cluster of the plan's CTAs fits on the device.
constexpr int kErrClusterUnplaced = -1;

// Where a plan keeps W_hh.
constexpr int kWGlobal = 0, kWShared = 1, kWRegisters = 2;
constexpr int kRegRows = 16;      // most rows a lane keeps in registers
constexpr int kRegThreads = 512;  // most threads of a CTA that does

// How a sweep is cut. Passed to the kernel by value.
struct Plan {
  int lanes;      // S, lanes per unit
  int cluster;    // C, CTAs per (batch column, direction)
  int units;      // U = ceil(H / C), units per CTA
  int threads;    // U rounded up to whole warps, times S
  int iters;      // I = ceil(H / S), rows each lane sums (8 or 16 in
                  // registers, zero rows beyond H)
  int w_mode;     // kWGlobal, kWShared or kWRegisters
  size_t smem;    // dynamic shared memory bytes
};

// A sweep's shared memory beside W_hh: the vector's entries and buffers
// (the forward keeps h as floats, double-buffered; the backward the dgates
// as float4, one buffer in a single CTA and two in a cluster), and what is
// handed to or loaded for the cell threads (unit_bytes a unit plus
// fixed_bytes).
struct VecSpec {
  size_t entry_bytes;
  int single_buffers;
  int cluster_buffers;
  size_t unit_bytes;
  size_t fixed_bytes;
};

inline Plan make_plan(int h, int c, int w_mode, const VecSpec& v) {
  Plan p;
  p.cluster = c;
  p.units = (h + c - 1) / c;
  const auto threads_for = [&](int s) {
    const int per_warp = kWarp / s;
    return (p.units + per_warp - 1) / per_warp * per_warp * s;
  };
  int s = 1;
  while (s < kWarp && s * kChain < h) s *= 2;
  while (s > 1 && threads_for(s) > kMaxThreads) s /= 2;
  p.lanes = s;
  p.threads = threads_for(s);
  p.iters = (h + s - 1) / s;
  if (w_mode == kWRegisters) p.iters = p.iters <= kRegRows / 2 ? kRegRows / 2
                                                               : kRegRows;
  p.w_mode = w_mode;
  const int buffers = c > 1 ? v.cluster_buffers : v.single_buffers;
  p.smem = (w_mode == kWShared ? static_cast<size_t>(p.iters) * p.threads *
                                     sizeof(float4)
                               : 0) +
           static_cast<size_t>(buffers) * p.iters * s * v.entry_bytes +
           p.units * v.unit_bytes + v.fixed_bytes;
  return p;
}

// T and B the kernels take: T*B rows index an int, B*C CTAs a grid row.
inline bool bad_shape(int t, int b) {
  return t <= 0 || b <= 0 || b > (1 << 27) ||
         static_cast<long long>(t) * b > (1LL << 30);
}

inline int smem_optin_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return limit;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return sms;
}

// The plan with C CTAs a cluster that holds W_hh on chip: in registers
// where a lane's rows and the CTA fit, else in shared memory.
inline bool on_chip_plan(int h, int c, const VecSpec& v, size_t limit,
                         Plan* out) {
  *out = make_plan(h, c, kWRegisters, v);
  if ((h + out->lanes - 1) / out->lanes <= kRegRows &&
      out->threads <= kRegThreads && out->smem <= limit)
    return true;
  *out = make_plan(h, c, kWShared, v);
  return out->smem <= limit;
}

// The plan for hidden size h and B batch columns: one CTA where it holds
// W_hh on chip; else the least C in 2, 4, 8 whose CTAs do, raised to the
// largest C <= 8 whose 2*B*C CTAs fit the SMs in one wave (a cluster's
// barrier costs about the same at every C, so more CTAs shorten each one's
// share of the step: on an H100 at H=120, T=200 a step forward took 1.271
// us in clusters of 8 at B=5, 1.323 in 4 at B=9, 1.544 in 2 at B=17,
// chip_smoke.py; tuned at B=5 only); else one CTA reading W_hh from global
// memory. False where no plan fits.
inline bool pick_plan(int h, int b, const VecSpec& v, Plan* out) {
  const size_t limit = static_cast<size_t>(smem_optin_limit());
  if (h <= 0 || h > kMaxHidden || b <= 0) return false;
  if (on_chip_plan(h, 1, v, limit, out)) return true;
  for (int c = 2; c <= kMaxCluster; c *= 2) {
    if (!on_chip_plan(h, c, v, limit, out)) continue;
    int wide = c;
    while (wide < kMaxCluster && 2LL * b * wide * 2 <= sm_count()) wide *= 2;
    return wide == c || on_chip_plan(h, wide, v, limit, out) ||
           on_chip_plan(h, c, v, limit, out);
  }
  *out = make_plan(h, 1, kWGlobal, v);
  return out->smem <= limit;
}

inline void plan_fields(const Plan& p, int* out) {
  out[0] = p.lanes;
  out[1] = p.cluster;
  out[2] = p.units;
  out[3] = p.threads;
  out[4] = p.iters;
  out[5] = p.w_mode;
  out[6] = static_cast<int>(p.smem);
}

// 1 / (1 + e^-x), correctly rounded reciprocal (as 1.f / y), accurate expf.
__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(1.f + expf(-x));
}

__device__ __forceinline__ float4 load4(const float* p, int h) {
  return make_float4(p[0], p[h], p[2 * h], p[3 * h]);
}

// Stages this CTA's slice of one direction's W_hh (H, 4H) in read order:
// slot (i, tid) holds, for local unit u = tid / S, lane s and row r = i*S + s,
// the float4 of the four gates at (row, column unit) = (r, u0 + u) in the
// forward and (u0 + u, r) in the backward (`transposed`); zero beyond H.
__device__ __forceinline__ void stage_w(float4* ws, const float* w, int h,
                                        const Plan& p, int u0,
                                        bool transposed) {
  const int n = p.threads, sl = p.lanes, g = 4 * h;
  for (int idx = threadIdx.x; idx < p.iters * n; idx += n) {
    const int i = idx / n, lane = idx - i * n;
    const int u = lane / sl, r = i * sl + lane % sl, j = u0 + u;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < p.units && j < h && r < h)
      v = transposed ? load4(w + static_cast<size_t>(j) * g + r, h)
                     : load4(w + static_cast<size_t>(r) * g + j, h);
    ws[idx] = v;
  }
}

// a += x * w, gate by gate.
__device__ __forceinline__ void fma4(float4& a, float x, const float4& w) {
  a.x = fmaf(x, w.x, a.x);
  a.y = fmaf(x, w.y, a.y);
  a.z = fmaf(x, w.z, a.z);
  a.w = fmaf(x, w.w, a.w);
}

// a += x * w, componentwise.
__device__ __forceinline__ void fma4(float4& a, const float4& x,
                                     const float4& w) {
  a.x = fmaf(x.x, w.x, a.x);
  a.y = fmaf(x.y, w.y, a.y);
  a.z = fmaf(x.z, w.z, a.z);
  a.w = fmaf(x.w, w.w, a.w);
}

// A lane's share of the product in shared memory: sum over i < iters of
// v[i*S] times w[i*threads] (fma4), v and w already offset to the lane's
// first entry and slot. The loads of kBatch rows are issued together, into
// distinct registers, before their FMAs: a plain loop under the 64-register
// cap reuses one set and waits out a shared-memory load every row. The sum
// runs over i in order.
constexpr int kBatch = 4;

template <typename V>
__device__ __forceinline__ float4 lane_product(const V* v, const float4* w,
                                               const Plan& p) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  int i = 0;
  for (; i + kBatch <= p.iters; i += kBatch) {
    V x[kBatch];
    float4 wv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      x[k] = v[(i + k) * p.lanes];
      wv[k] = w[(i + k) * p.threads];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) fma4(a, x[k], wv[k]);
  }
  for (; i < p.iters; ++i) fma4(a, v[i * p.lanes], w[i * p.threads]);
  return a;
}

__device__ __forceinline__ float4 ldg4(const float* p, int h) {
  return make_float4(__ldg(p), __ldg(p + h), __ldg(p + 2 * h),
                     __ldg(p + 3 * h));
}

// The same with W_hh read from global memory: the float4 of row r is
// ldg4(w + r * row_stride), for the lane's rows r = s + i*S < H; v is the
// whole vector.
template <typename V>
__device__ __forceinline__ float4 lane_product_global(const V* v,
                                                      const float* w,
                                                      size_t row_stride,
                                                      int h, int s,
                                                      int lanes) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  int r = s;
  for (; r + (kBatch - 1) * lanes < h; r += kBatch * lanes) {
    V x[kBatch];
    float4 wv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      x[k] = v[r + k * lanes];
      wv[k] = ldg4(w + (r + k * lanes) * row_stride, h);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) fma4(a, x[k], wv[k]);
  }
  for (; r < h; r += lanes) fma4(a, v[r], ldg4(w + r * row_stride, h));
  return a;
}

// W_hh rows of this lane in registers, as stage_w lays them out.
template <int kW>
__device__ __forceinline__ void load_w_regs(float4 (&wr)[kW], const float* w,
                                            int h, const Plan& p, int u0,
                                            int u, int s, bool transposed) {
  const int g = 4 * h, j = u0 + u;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const int r = i * p.lanes + s;
    wr[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < p.units && j < h && r < h)
      wr[i] = transposed ? ldg4(w + static_cast<size_t>(j) * g + r, h)
                         : ldg4(w + static_cast<size_t>(r) * g + j, h);
  }
}

// lane_product with this lane's rows of W_hh in registers.
template <int kW, typename V>
__device__ __forceinline__ float4 reg_product(const float4 (&wr)[kW],
                                              const V* v, int lanes) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i0 = 0; i0 < kW; i0 += kBatch) {
    V x[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) x[k] = v[(i0 + k) * lanes];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) fma4(a, x[k], wr[i0 + k]);
  }
  return a;
}

// A 4-byte copy from global to shared memory, asynchronous; where `valid`
// is false it writes zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one group of this thread's copies is in flight.
// Before a barrier, it makes the older groups visible to the CTA.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The sum of v over the lanes s ^ o, o = from, 2 * from, ... < lanes, on
// every one of them.
__device__ __forceinline__ float group_sum(float v, int lanes, int from = 1) {
  for (int o = from; o < lanes; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 group_sum4(float4 a, int lanes) {
  for (int o = 1; o < lanes; o <<= 1) {
    a.x += __shfl_xor_sync(0xffffffffu, a.x, o);
    a.y += __shfl_xor_sync(0xffffffffu, a.y, o);
    a.z += __shfl_xor_sync(0xffffffffu, a.z, o);
    a.w += __shfl_xor_sync(0xffffffffu, a.w, o);
  }
  return a;
}

// All threads of all CTAs of the cluster: stores before it (to any CTA's
// shared memory) are seen by loads after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Writes x to entry e of the vector buffer `buf` in every CTA of the
// cluster.
template <typename T>
__device__ __forceinline__ void store_to_cluster(T* buf, int e, const T& x,
                                                 int cluster_size) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int q = 0; q < cluster_size; ++q)
    *cluster.map_shared_rank(buf + e, q) = x;
}

// A kernel's record, per device, of the dynamic shared memory limit it was
// given and of the bytes at which a cluster of 2, 4 or 8 was found to fit.
struct Prepared {
  size_t smem[kMaxDevices];
  size_t placed[kMaxDevices][4];
};

// Raises `kernel`'s dynamic shared memory limit to the plan's bytes and, for
// a cluster, checks that one can be placed; each only once per device and
// size, so that a launch inside a CUDA graph capture makes no attribute or
// occupancy call.
template <typename Kernel>
int prepare(Kernel kernel, const Plan& p, dim3 grid, Prepared& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int lc = 0;
  while ((1 << lc) < p.cluster) ++lc;
  if (p.smem > done.smem[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    done.smem[dev] = p.smem;
  }
  if (p.cluster > 1 && p.smem > done.placed[dev][lc]) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = p.cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return kErrClusterUnplaced;
    done.placed[dev][lc] = p.smem;
  }
  return 0;
}

// Launches `kernel` on the plan's grid (a cluster of C CTAs along x where
// C > 1) and returns the launch's error, else cudaGetLastError(). Call
// run(), which prepares the kernel first.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), const Plan& p, dim3 grid,
           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// prepare() then launch(); `done` is the kernel's own record.
template <typename... Params, typename... Args>
int run(void (*kernel)(Params...), Prepared& done, const Plan& p, dim3 grid,
        cudaStream_t stream, Args... args) {
  const int err = prepare(kernel, p, grid, done);
  return err != 0 ? err : launch(kernel, p, grid, stream, args...);
}

inline const char* error_string(int code) {
  if (code == kErrClusterUnplaced)
    return "no cluster of the plan's CTAs can be placed on this device "
           "(cudaOccupancyMaxActiveClusters is 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace lstm
