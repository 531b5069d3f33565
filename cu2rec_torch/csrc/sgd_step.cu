// K0a — one SGD iteration over the packed factor tables, on Hopper.
//
// Semantics: the TPU package's ops/packed.py::packed_step, the body of its
// packed_run_steps loop.  That step has no Pallas kernel there: XLA fuses its
// jnp ops.  Here it is two launches on one stream:
//   1. the user kernel, one row a group of G lanes (packed_rows.cuh; four
//      users a warp at W = 128): draw the counter-hash position in the
//      user's CSR slice, gather the sampled item's packed row, compute the
//      prediction and error, and write the user's updated row; under
//      first_wins, also atomicMin the user's rotated priority into best[item]
//      and store the sampled rating for the item side;
//   2. the item kernel, the same layout over items (only when items train):
//      find the item's partner (the election winner, recovered by inverting
//      the rotated priority, or under twin the item's own sampled rater,
//      drawn from the item-major arrays on the stream offset by the user
//      count), and update the item row from the partner's pre-step row.
//
// Read-before-write: each side reads the other side's pre-step table.  The
// user kernel writes its rows into a second buffer (T_u_out), so the item
// kernel still reads the pre-step T_u; the item kernel also writes into a
// second buffer (T_i_out), which keeps the step functional like its plain
// version.  The wrapper allocates both; the caching allocator recycles the
// previous step's tables, so the double buffer costs no allocation.  A
// kernel launched early (below) writes only after its wait, so it never
// writes a recycled buffer that the kernel before it still reads.
//
// Bit-exact sampling: the hash runs in native uint32 and the position is
// min((int)(u01 * (float)len), len - 1) with __fmul_rn, so no contraction or
// fast-math can move it (the library is built without --use_fast_math).
// The table arithmetic may contract into FMAs and sums in another order: it
// agrees with the plain version within a few float32 roundings per step.
//
// What bounds it: memory bytes.  A step reads and writes T_u (2·U·W·4 B)
// and T_i (2·I·W·4 B), gathers one item row per user and one partner row per
// item, and reads a few int32/float words per row of the sampling arrays:
// about 170 MB at U = 138,000, I = 27,000, W = 128, or ~0.05 ms at
// 3.35 TB/s.  Each row is a chain of dependent loads (indptr → hash →
// indices/data → both rows → reduction → store), so the design overlaps
// chains and kernels:
//   - a warp runs 32 / G chains at once, the rows in float4 registers sized
//     for W at compile time, and loads its window of indptr (or of the
//     election buffer) in one coalesced load shared out by shuffles, with no
//     block barrier to wait on;
//   - the columns of a float4 that holds factors only skip the per-column
//     selects of the bias and padding columns;
//   - each kernel is a programmatic dependent launch: the part of its
//     chain that the kernel before it does not feed (the sampling from the
//     ratings; in the item kernel also its own row and, under twin, the
//     rater's pre-step row) runs while that kernel ends, and the rest
//     waits for it (griddepcontrol.wait, below).
// On an H100 the user kernel then takes about 1.3× a plain copy of T_u: the
// per-row work between a row's load and its store, not the random reads of
// the sampled ratings, holds it above the copy.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_rows.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// At least eight blocks an SM: at most 64 registers a thread.
constexpr int kMinBlocks = 8;
constexpr int kMaxWidth = 512;  // the widest row dispatch_width takes
constexpr int kSentinel = 0x7fffffff;

// The step's arguments, passed by value to both kernels.
struct Step {
  const float* T_u;
  float* T_u_out;
  const float* T_i;
  float* T_i_out;
  const int* indptr;
  const int* indices;
  const float* data;
  const int* row_ids;
  const int* it_indptr;
  const int* it_users;
  const float* it_vals;
  const int* it_order;
  int* best;  // null unless first_wins
  float* w_rating;
  int U, I, F;
  float mu, lr, reg_p, reg_q, reg_ub, reg_ib;
  uint32_t k0, k1, it;
  int start_user;
};

// murmur3 finalizer, in uint32 arithmetic.
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// counter_uniform(key, it, id): 24 high bits of two chained rounds.
__device__ __forceinline__ float draw_u01(uint32_t k0, uint32_t k1,
                                          uint32_t it, uint32_t id) {
  uint32_t h = fmix32(id ^ fmix32(it ^ k1) ^ k0);
  h = fmix32(h + 0x9E3779B9u);
  return __fmul_rn(__uint2float_rn(h >> 8), 5.9604644775390625e-08f);
}

// Offset of the sampled rating in a slice of `len` > 0 ratings.
__device__ __forceinline__ int draw_offset(float u01, int len) {
  const int off = __float2int_rz(__fmul_rn(u01, __int2float_rn(len)));
  return min(off, len - 1);
}

// One column of  self += lr · (err · ô − reg ⊙ self),  ô = [other[:F], 1,
// 0…],  reg = [reg_f…, reg_b, 0…].
__device__ __forceinline__ float step_col(float s, float o, int c, int F,
                                          float err, float lr, float reg_f,
                                          float reg_b) {
  const float hat = c < F ? o : (c == F ? 1.f : 0.f);
  const float reg = c < F ? reg_f : (c == F ? reg_b : 0.f);
  return s + lr * (err * hat - reg * s);
}

// Lane gl's float4s of `self` (the whole row) updated towards `other` (its
// columns up to F), for a pair of rating `rating`.
template <int W>
__device__ __forceinline__ void update_row(float4 (&s)[RowLayout<W>::V],
                                           const float4 (&o)[RowLayout<W>::V],
                                           float rating, int gl, int lane,
                                           int F, float mu, float lr,
                                           float reg_f, float reg_b) {
  constexpr int G = RowLayout<W>::G;
  const float pred = mu + group_sum<G>(row_dot<W>(s, o, gl, F),
                                       group_mask<G>(lane));
  const float err = rating - pred;
#pragma unroll
  for (int k = 0; k < RowLayout<W>::V; ++k) {
    const int c = 4 * (gl + G * k);
    if (c + 3 < F) {  // factors only
      s[k].x += lr * (err * o[k].x - reg_f * s[k].x);
      s[k].y += lr * (err * o[k].y - reg_f * s[k].y);
      s[k].z += lr * (err * o[k].z - reg_f * s[k].z);
      s[k].w += lr * (err * o[k].w - reg_f * s[k].w);
    } else if (c <= F) {  // the float4 that holds the bias column
      s[k].x = step_col(s[k].x, o[k].x, c, F, err, lr, reg_f, reg_b);
      s[k].y = step_col(s[k].y, o[k].y, c + 1, F, err, lr, reg_f, reg_b);
      s[k].z = step_col(s[k].z, o[k].z, c + 2, F, err, lr, reg_f, reg_b);
      s[k].w = step_col(s[k].w, o[k].w, c + 3, F, err, lr, reg_f, reg_b);
    }  // padding only: unchanged
  }
}

// The first row of the calling warp: rows are numbered warp by warp, 32 / G
// rows a warp, group g of the warp taking the warp's row g.
template <int W>
__device__ __forceinline__ int warp_first_row() {
  return (blockIdx.x * kWarps + (threadIdx.x >> 5)) *
         RowLayout<W>::kRowsPerWarp;
}

// A warp's window of an int array in one coalesced load: lane t < n holds
// arr[min(base + t, last)], which __shfl_sync then shares out.
__device__ __forceinline__ int load_window(const int* arr, int base,
                                           int last, int n) {
  const int lane = threadIdx.x & 31;
  return lane < n ? __ldg(arr + min(base + lane, last)) : 0;
}

// Programmatic dependent launch: each kernel of the step loop is launched
// so that it may start while the kernel before it on the stream still runs
// (launch_early).  Until wait_prior_kernel() it reads only the ratings
// arrays, or tables that the kernel before it leaves alone and that were
// complete when that kernel passed its own wait.  The user kernel's early
// reads of indptr/indices/data may overlap whatever kernel precedes the
// step, and only the wait makes that kernel's writes certain to be
// visible: the ratings arrays are written by host-to-device copies
// (data/csr.py::to_device), the contract stated in DeviceRatings and
// sgd_step_cuda.  After the wait a kernel reads at L2 (Read::kL2) what the
// kernels before it wrote.
__device__ __forceinline__ void wait_prior_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Lets the next kernel on the stream start its own prefix.  Called after
// wait_prior_kernel(), so that the prefix of the next kernel never overlaps
// the kernel before this one.
__device__ __forceinline__ void allow_next_kernel() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sgd_user_kernel(const Step a) {
  using L = RowLayout<W>;
  constexpr int G = L::G, NG = L::kRowsPerWarp;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int g = lane / G;
  const int u0 = warp_first_row<W>();
  const int u = u0 + g;
  // The sampling chain reads only the ratings: it runs while the previous
  // kernel ends.
  const int p = load_window(a.indptr, u0, a.U, NG + 1);
  const int start = __shfl_sync(0xffffffffu, p, g);
  const int len = __shfl_sync(0xffffffffu, p, g + 1) - start;
  int item = 0;
  float rating = 0.f;
  if (u < a.U && len > 0) {
    const int pos = start + draw_offset(
        draw_u01(a.k0, a.k1, a.it, static_cast<uint32_t>(u)), len);
    item = __ldg(a.indices + pos);
    rating = __ldg(a.data + pos);
  }
  wait_prior_kernel();
  allow_next_kernel();
  if (u >= a.U) return;
  float4 x[L::V];
  load_row<W, Read::kL2>(a.T_u + static_cast<size_t>(u) * W, gl, W - 1, x);
  if (len > 0) {
    float4 o[L::V];
    load_row<W, Read::kL2>(a.T_i + static_cast<size_t>(item) * W, gl, a.F,
                           o);
    update_row<W>(x, o, rating, gl, lane, a.F, a.mu, a.lr, a.reg_p,
                  a.reg_ub);
    if (a.best != nullptr && gl == 0) {
      int prio = u - a.start_user;
      if (prio < 0) prio += a.U;
      atomicMin(a.best + item, prio);
      a.w_rating[u] = rating;
    }
  }
  store_row<W>(a.T_u_out + static_cast<size_t>(u) * W, gl, x);
}

// kMode: 0 first_wins (election), 1 twin with the item-major mirror,
// 2 twin lean (through the item-major → flat permutation).
template <int W, int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sgd_item_kernel(const Step a) {
  using L = RowLayout<W>;
  constexpr int G = L::G, NG = L::kRowsPerWarp;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int g = lane / G;
  const int i0 = warp_first_row<W>();
  const int i = i0 + g;
  const bool active = i < a.I;
  // Before the user kernel ends: what it does not write.  The own item row
  // and, under twin, the sampled rater from the item-major arrays and the
  // rater's pre-step row (the user kernel writes T_u_out, not T_u).
  float4 x[L::V], o[L::V];
  if (active)
    load_row<W, Read::kL2>(a.T_i + static_cast<size_t>(i) * W, gl, W - 1, x);
  int partner = -1;  // none
  float rating = 0.f;
  if (kMode != 0) {
    const int p = load_window(a.it_indptr, i0, a.I, NG + 1);
    const int start = __shfl_sync(0xffffffffu, p, g);
    const int len = __shfl_sync(0xffffffffu, p, g + 1) - start;
    if (active && len > 0) {
      const int pos = start + draw_offset(
          draw_u01(a.k0, a.k1, a.it, static_cast<uint32_t>(i + a.U)), len);
      if (kMode == 1) {
        partner = __ldg(a.it_users + pos);
        rating = __ldg(a.it_vals + pos);
      } else {
        const int q = __ldg(a.it_order + pos);
        partner = __ldg(a.row_ids + q);
        rating = __ldg(a.data + q);
      }
      load_row<W, Read::kL2>(a.T_u + static_cast<size_t>(partner) * W, gl,
                             a.F, o);
    }
  }
  wait_prior_kernel();
  allow_next_kernel();
  if (kMode == 0) {
    // The warp's window of the election buffer, reset for the next step
    // as it is read.
    int b = kSentinel;
    if (lane < NG && i0 + lane < a.I) {
      b = __ldcg(a.best + i0 + lane);
      if (b != kSentinel) a.best[i0 + lane] = kSentinel;
    }
    b = __shfl_sync(0xffffffffu, b, g);
    if (active && b != kSentinel) {
      partner = b + a.start_user;
      if (partner >= a.U) partner -= a.U;
      rating = __ldcg(a.w_rating + partner);
      load_row<W, Read::kL2>(a.T_u + static_cast<size_t>(partner) * W, gl,
                             a.F, o);
    }
  }
  if (!active) return;
  if (partner >= 0)
    update_row<W>(x, o, rating, gl, lane, a.F, a.mu, a.lr, a.reg_q,
                  a.reg_ib);
  store_row<W>(a.T_i_out + static_cast<size_t>(i) * W, gl, x);
}

// Launches kernel(a) so that it may start before the kernel ahead of it on
// the stream has ended (see wait_prior_kernel).
template <typename Kernel>
cudaError_t launch_early(Kernel kernel, int blocks, cudaStream_t s,
                         const Step& a) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int W>
int launch_step(const Step& a, int mode, cudaStream_t s) {
  constexpr int kRows = kWarps * RowLayout<W>::kRowsPerWarp;
  cudaError_t e = launch_early(sgd_user_kernel<W>,
                               (a.U + kRows - 1) / kRows, s, a);
  if (e != cudaSuccess || mode < 0) return static_cast<int>(e);
  const int blocks = (a.I + kRows - 1) / kRows;
  if (mode == 0)
    e = launch_early(sgd_item_kernel<W, 0>, blocks, s, a);
  else if (mode == 1)
    e = launch_early(sgd_item_kernel<W, 1>, blocks, s, a);
  else
    e = launch_early(sgd_item_kernel<W, 2>, blocks, s, a);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

int sgd_step_max_width() { return kMaxWidth; }

// One step.  Tables (rows, W) float32 contiguous and 16-byte aligned, W one
// of 64, 128, 256, 384, 512; index arrays int32.  mode: -1 users only
// (items frozen), 0 first_wins, 1 twin mirror, 2 twin lean.  `best` (I
// int32, all kSentinel on entry, left so on exit) and `w_rating` (U floats)
// are used by mode 0 only; the item-major arrays by modes 1-2.  Launches on
// `stream`; returns the cudaError_t of the launches.
int sgd_step_launch(const float* T_u, float* T_u_out, const float* T_i,
                    float* T_i_out, const int* indptr, const int* indices,
                    const float* data, const int* row_ids,
                    const int* it_indptr, const int* it_users,
                    const float* it_vals, const int* it_order, int* best,
                    float* w_rating, int U, int I, int W, int F, float mu,
                    float lr, float reg_p, float reg_q, float reg_ub,
                    float reg_ib, unsigned k0, unsigned k1, unsigned it,
                    int start_user, int mode, void* stream) {
  if (U <= 0 || I <= 0 || W <= F || F < 0 || mode < -1 || mode > 2)
    return cudaErrorInvalidValue;
  const Step a{T_u, T_u_out, T_i, T_i_out, indptr, indices, data, row_ids,
               it_indptr, it_users, it_vals, it_order,
               mode == 0 ? best : nullptr, w_rating, U, I, F, mu, lr,
               reg_p, reg_q, reg_ub, reg_ib, k0, k1, it, start_user};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_width(W, [&](auto layout) {
    return launch_step<decltype(layout)::kWidth>(a, mode, s);
  });
}

}  // extern "C"
