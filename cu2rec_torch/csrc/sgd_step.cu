// K0a — one SGD iteration over the packed factor tables, on Hopper.
//
// Semantics: the TPU package's ops/packed.py::packed_step, the body of its
// packed_run_steps loop, on float32 or bf16 tables (rows loaded and
// upcast, float32 arithmetic, stored rounded to nearest even).  That step
// has no Pallas kernel there: XLA fuses its jnp ops.  Here it is two
// launches on one stream (more under mean and sum, below):
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
// Under the mean and sum policies every sampled (user, item) pair adds its
// item delta, and the item side is a deterministic segmented reduction
// instead (see "Collisions" below).
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
// 3.35 TB/s; bf16 rows (2 B an entry) halve the table bytes.  Each row is
// a chain of dependent loads (indptr → hash → indices/data → both rows →
// reduction → store), so the design overlaps chains and kernels:
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
//
// Collisions (mean, sum).  The TPU package adds every pair's delta with
// T_i.at[items].add(di.astype(dt)), which XLA on the CPU applies in the
// order of the pairs, that is in ascending user order, rounding to the
// table type after each add.  A float atomicAdd would add in whatever order
// the pairs arrive, so the kernels here keep that order instead:
//   1. the user kernel writes each user's sampled item (I for none) and
//      its error;
//   2. a stable LSD radix sort of the users by item, 8 bits a pass
//      (per-tile digit histograms with shared-memory integer atomics, one
//      scan, a stable placement that ranks a tile's users in user order);
//   3. the item kernel: each item finds its run of the sorted users by
//      binary search and, in the row layout above, adds the deltas of its
//      users one after the other, rounding after each add.  A run longer
//      than kLong is left to the long-run kernel: a block for each slice
//      of 32 columns of the item, whose warps compute a tile of deltas
//      into shared memory side by side, after which one lane a column adds
//      them in order (a hot item's slices on several SMs at once).
// So the result is a pure function of the step's inputs, and matches the
// plain version (ops/packed.py) up to the float32 rounding of the deltas.
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_rows.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// At least eight blocks an SM: at most 64 registers a thread.
constexpr int kMinBlocks = 8;
constexpr int kMaxWidth = 512;  // the widest row dispatch_row takes
constexpr int kSentinel = 0x7fffffff;
// Collisions: the sort's tile (kSortThreads users a round, kSortRounds
// rounds) and digit, the longest run the item kernel adds itself, and the
// long-run kernel's block.
constexpr int kSortThreads = 256;
constexpr int kSortRounds = 8;
constexpr int kSortTile = kSortThreads * kSortRounds;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;
static_assert(kDigits == kSortThreads, "a thread a digit");
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr int kLong = 32;
constexpr int kLongThreads = 256;
constexpr int kLongBlocks = 132 * 4;  // the long-run kernel's grid at most
constexpr int kLongTile = 256;        // pairs a tile of the long-run kernel
constexpr int kSliceCols = 32;        // columns a long-run block adds
// At least four blocks an SM (at most 128 registers a thread): the
// collision item kernel holds five rows a lane group.
constexpr int kCollideMinBlocks = 4;

// mode of sgd_step_launch.
enum Mode {
  kUsersOnly = -1,
  kFirstWins = 0,
  kTwinMirror = 1,
  kTwinLean = 2,
  kMean = 3,
  kSum = 4
};

// The step's arguments, passed by value to every kernel.  The tables are
// of the element type of the kernel's row layout.
struct Step {
  const void* T_u;
  void* T_u_out;
  const void* T_i;
  void* T_i_out;
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
  int* pair_item;   // mean/sum: each user's sampled item, I for none
  float* pair_err;  // mean/sum: the error of that pair
  int U, I, F;
  float mu, lr, reg_p, reg_q, reg_ub, reg_ib;
  uint32_t k0, k1, it;
  int start_user;
};

template <class L>
__device__ __forceinline__ const typename L::Elem* row_ptr(const void* t,
                                                           int r) {
  return static_cast<const typename L::Elem*>(t) +
         static_cast<size_t>(r) * L::kWidth;
}

template <class L>
__device__ __forceinline__ typename L::Elem* row_ptr(void* t, int r) {
  return static_cast<typename L::Elem*>(t) +
         static_cast<size_t>(r) * L::kWidth;
}

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
// columns up to F), for a pair of rating `rating`; returns the pair's
// error.
template <class L>
__device__ __forceinline__ float update_row(float4 (&s)[L::V],
                                            const float4 (&o)[L::V],
                                            float rating, int gl, int lane,
                                            int F, float mu, float lr,
                                            float reg_f, float reg_b) {
  constexpr int G = L::G;
  const float pred = mu + group_sum<G>(row_dot<L>(s, o, gl, F),
                                       group_mask<G>(lane));
  const float err = rating - pred;
#pragma unroll
  for (int k = 0; k < L::V; ++k) {
    const int c = L::col(gl, k);
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
  return err;
}

// The first row of the calling warp: rows are numbered warp by warp, 32 / G
// rows a warp, group g of the warp taking the warp's row g.
template <class L>
__device__ __forceinline__ int warp_first_row() {
  return (blockIdx.x * kWarps + (threadIdx.x >> 5)) * L::kRowsPerWarp;
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
// kernels before it wrote.  The collision kernels are launched plainly.
__device__ __forceinline__ void wait_prior_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Lets the next kernel on the stream start its own prefix.  Called after
// wait_prior_kernel(), so that the prefix of the next kernel never overlaps
// the kernel before this one.
__device__ __forceinline__ void allow_next_kernel() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// kPairs (mean, sum): also write each user's sampled item and error for
// the collision kernels.
template <class L, bool kPairs>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sgd_user_kernel(const Step a) {
  constexpr int G = L::G, NG = L::kRowsPerWarp, W = L::kWidth;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int g = lane / G;
  const int u0 = warp_first_row<L>();
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
  load_row<L, Read::kL2>(row_ptr<L>(a.T_u, u), gl, W - 1, x);
  if (len > 0) {
    float4 o[L::V];
    load_row<L, Read::kL2>(row_ptr<L>(a.T_i, item), gl, a.F, o);
    const float err = update_row<L>(x, o, rating, gl, lane, a.F, a.mu, a.lr,
                                    a.reg_p, a.reg_ub);
    if constexpr (kPairs) {
      if (gl == 0) {
        a.pair_item[u] = item;
        a.pair_err[u] = err;
      }
    } else if (a.best != nullptr && gl == 0) {
      int prio = u - a.start_user;
      if (prio < 0) prio += a.U;
      atomicMin(a.best + item, prio);
      a.w_rating[u] = rating;
    }
  } else if constexpr (kPairs) {
    if (gl == 0) a.pair_item[u] = a.I;
  }
  store_row<L>(row_ptr<L>(a.T_u_out, u), gl, x);
}

// kMode: 0 first_wins (election), 1 twin with the item-major mirror,
// 2 twin lean (through the item-major → flat permutation).
template <class L, int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sgd_item_kernel(const Step a) {
  constexpr int G = L::G, NG = L::kRowsPerWarp, W = L::kWidth;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int g = lane / G;
  const int i0 = warp_first_row<L>();
  const int i = i0 + g;
  const bool active = i < a.I;
  // Before the user kernel ends: what it does not write.  The own item row
  // and, under twin, the sampled rater from the item-major arrays and the
  // rater's pre-step row (the user kernel writes T_u_out, not T_u).
  float4 x[L::V], o[L::V];
  if (active) load_row<L, Read::kL2>(row_ptr<L>(a.T_i, i), gl, W - 1, x);
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
      load_row<L, Read::kL2>(row_ptr<L>(a.T_u, partner), gl, a.F, o);
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
      load_row<L, Read::kL2>(row_ptr<L>(a.T_u, partner), gl, a.F, o);
    }
  }
  if (!active) return;
  if (partner >= 0)
    update_row<L>(x, o, rating, gl, lane, a.F, a.mu, a.lr, a.reg_q,
                  a.reg_ib);
  store_row<L>(row_ptr<L>(a.T_i_out, i), gl, x);
}

// ---- Collisions: the stable sort of the users by sampled item ----------

// Digit histogram of one tile of the keys, stored digit-major:
// hist[d · tiles + tile].  Block 0 also clears the long-run count.
__global__ void __launch_bounds__(kSortThreads)
sort_hist_kernel(const int* __restrict__ keys, int n, int shift,
                 int* __restrict__ hist, int* long_count) {
  __shared__ int s[kDigits];
  const int t = threadIdx.x;
  s[t] = 0;
  if (long_count != nullptr && blockIdx.x == 0 && t == 0) *long_count = 0;
  __syncthreads();
  const int base = blockIdx.x * kSortTile;
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    const int j = base + r * kSortThreads + t;
    if (j < n) atomicAdd(&s[(keys[j] >> shift) & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[t * gridDim.x + blockIdx.x] = s[t];
}

// Exclusive prefix sum of a[0, m) in place, by one block, kScanItems
// consecutive entries a thread and kScanThreads · kScanItems a round: each
// round's loads are issued together, then scanned in registers, across a
// warp by shuffles and across the warps in shared memory.
__global__ void __launch_bounds__(kScanThreads)
exclusive_scan_kernel(int* a, int m) {
  constexpr int kW = kScanThreads / 32;
  static_assert(kW <= 32, "one warp scans the warps' sums");
  __shared__ int s_warp[kW];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int carry = 0;
  for (int base = 0; base < m; base += kScanThreads * kScanItems) {
    const int lo = base + t * kScanItems;
    int v[kScanItems];
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) v[k] = lo + k < m ? a[lo + k] : 0;
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int x = v[k];
      v[k] = sum;
      sum += x;
    }
    int incl = sum;  // this thread's total, scanned across the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < kW ? s_warp[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      if (lane < kW) s_warp[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp ? s_warp[warp - 1] : 0) + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      if (lo + k < m) a[lo + k] = before + v[k];
    carry += s_warp[kW - 1];
    __syncthreads();  // s_warp is written again in the next round
  }
}

// Stable placement of one tile by one digit: the tile's users go to their
// digit's offset (the scanned histogram) in user order.  A round ranks 256
// users: within a warp by __match_any_sync, across the warps by their
// per-digit counts in shared memory.  vals_in null: the values are the
// positions (the user ids, on the first pass).
__global__ void __launch_bounds__(kSortThreads)
sort_scatter_kernel(const int* __restrict__ keys_in,
                    const int* __restrict__ vals_in,
                    int* __restrict__ keys_out, int* __restrict__ vals_out,
                    int n, int shift, const int* __restrict__ offsets) {
  constexpr int kW = kSortThreads / 32;
  __shared__ int s_base[kDigits];
  __shared__ int s_cnt[kW][kDigits];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  s_base[t] = offsets[t * gridDim.x + blockIdx.x];
#pragma unroll
  for (int w = 0; w < kW; ++w) s_cnt[w][t] = 0;
  __syncthreads();
  const int base = blockIdx.x * kSortTile;
  for (int r = 0; r < kSortRounds; ++r) {
    const int j = base + r * kSortThreads + t;
    const bool ok = j < n;
    const int key = ok ? keys_in[j] : 0;
    const int val = ok ? (vals_in != nullptr ? vals_in[j] : j) : 0;
    const int digit = ok ? (key >> shift) & (kDigits - 1) : kDigits;
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (ok && rank == 0) s_cnt[warp][digit] = __popc(peers);
    __syncthreads();
    if (ok) {
      int pos = s_base[digit] + rank;
      for (int w = 0; w < warp; ++w) pos += s_cnt[w][digit];
      keys_out[pos] = key;
      vals_out[pos] = val;
    }
    __syncthreads();
    int add = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      add += s_cnt[w][t];
      s_cnt[w][t] = 0;
    }
    s_base[t] += add;
    __syncthreads();
  }
}

// ---- Collisions: the item side ------------------------------------------

// First position p in [lo, hi) with keys[p] >= v (keys ascending).
__device__ __forceinline__ int lower_bound(const int* keys, int lo, int hi,
                                           int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One column of a pair's item delta, rounded to the table type:
//   lr · (err · û − reg ⊙ r) [/ denom],  û = [u[:F], 1, 0…],
// r the item's pre-step row (the TPU package's di.astype(dt)).
template <typename T, bool kMean>
__device__ __forceinline__ float delta_col(float r, float o, int c, int F,
                                           float err, float denom, float lr,
                                           float reg_f, float reg_b) {
  const float hat = c < F ? o : (c == F ? 1.f : 0.f);
  const float reg = c < F ? reg_f : (c == F ? reg_b : 0.f);
  float d = lr * (err * hat - reg * r);
  if constexpr (kMean) d = d / denom;
  return round_to<T>(d);
}

// Lane gl's float4s of the delta of one pair (zero past column F).
template <class L, bool kMean>
__device__ __forceinline__ void pair_delta(float4 (&d)[L::V],
                                           const float4 (&r)[L::V],
                                           const float4 (&o)[L::V],
                                           float err, float denom, int gl,
                                           int F, float lr, float reg_f,
                                           float reg_b) {
  using T = typename L::Elem;
#pragma unroll
  for (int k = 0; k < L::V; ++k) {
    const int c = L::col(gl, k);
    if (c > F) {
      d[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    d[k].x = delta_col<T, kMean>(r[k].x, o[k].x, c, F, err, denom, lr,
                                 reg_f, reg_b);
    d[k].y = delta_col<T, kMean>(r[k].y, o[k].y, c + 1, F, err, denom, lr,
                                 reg_f, reg_b);
    d[k].z = delta_col<T, kMean>(r[k].z, o[k].z, c + 2, F, err, denom, lr,
                                 reg_f, reg_b);
    d[k].w = delta_col<T, kMean>(r[k].w, o[k].w, c + 3, F, err, denom, lr,
                                 reg_f, reg_b);
  }
}

// The item side of mean/sum for runs of at most kLong pairs, in the row
// layout: a lane group an item adds its users' deltas in user order,
// rounding to the table type after each add, with the next user's row in
// flight.  Longer runs go to the long-run list.
template <class L, bool kMean>
__global__ void __launch_bounds__(kThreads, kCollideMinBlocks)
collide_item_kernel(const Step a, const int* __restrict__ sorted_items,
                    const int* __restrict__ sorted_users,
                    int* __restrict__ long_items, int* long_count) {
  using T = typename L::Elem;
  constexpr int G = L::G, W = L::kWidth;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int i = warp_first_row<L>() + lane / G;
  if (i >= a.I) return;
  const int s = lower_bound(sorted_items, 0, a.U, i);
  const int e = lower_bound(sorted_items, s, a.U, i + 1);
  if (e - s > kLong) {
    if (gl == 0) long_items[atomicAdd(long_count, 1)] = i;
    return;
  }
  float4 acc[L::V];
  load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_i, i), gl, W - 1, acc);
  if (e > s) {
    float4 r[L::V], o[L::V], d[L::V];
#pragma unroll
    for (int k = 0; k < L::V; ++k) r[k] = acc[k];
    const float denom = static_cast<float>(e - s);
    int u = __ldg(sorted_users + s);
    float err = __ldg(a.pair_err + u);
    load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_u, u), gl, a.F, o);
    for (int p = s; p < e; ++p) {
      pair_delta<L, kMean>(d, r, o, err, denom, gl, a.F, a.lr, a.reg_q,
                           a.reg_ib);
      if (p + 1 < e) {  // the next pair's loads, before this pair's adds
        u = __ldg(sorted_users + p + 1);
        err = __ldg(a.pair_err + u);
        load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_u, u), gl, a.F, o);
      }
#pragma unroll
      for (int k = 0; k < L::V; ++k) {
        if (L::col(gl, k) > a.F) continue;
        acc[k].x = round_to<T>(acc[k].x + d[k].x);
        acc[k].y = round_to<T>(acc[k].y + d[k].y);
        acc[k].z = round_to<T>(acc[k].z + d[k].z);
        acc[k].w = round_to<T>(acc[k].w + d[k].w);
      }
    }
  }
  store_row<L>(row_ptr<L>(a.T_i_out, i), gl, acc);
}

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(v);
  else
    return v;
}

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (sizeof(T) == 2)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// The item side of mean/sum for the runs longer than kLong: a block a
// (long-run item, slice of kSliceCols columns) pair, the blocks striding
// over the pairs, so that the slices of one hot item run on several SMs
// side by side.  For each tile of the run's users, every warp loads its
// rows' entries of the slice (a lane a column, all the tile's loads in
// flight before the first is used) and writes their deltas into shared
// memory; then the first warp adds them in user order, a lane a column,
// rounding after each add.
template <class L, bool kMean>
__global__ void __launch_bounds__(kLongThreads)
collide_long_kernel(const Step a, const int* __restrict__ sorted_items,
                    const int* __restrict__ sorted_users,
                    const int* __restrict__ long_items,
                    const int* __restrict__ long_count) {
  using T = typename L::Elem;
  constexpr int W = L::kWidth;
  constexpr int kSlices = W / kSliceCols;
  constexpr int kWarpsL = kLongThreads / 32;
  constexpr int kRows = kLongTile / kWarpsL;  // a warp's rows of a tile
  static_assert(W % kSliceCols == 0 && kSliceCols == 32, "a lane a column");
  __shared__ float s_d[kLongTile][kSliceCols];
  const int n_units = *long_count * kSlices;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const int i = long_items[unit / kSlices];
    const int c = (unit % kSlices) * kSliceCols + lane;
    const int s = lower_bound(sorted_items, 0, a.U, i);
    const int e = lower_bound(sorted_items, s, a.U, i + 1);
    const float r = to_float<T>(row_ptr<L>(a.T_i, i)[c]);
    const bool live = c <= a.F;  // the columns past F keep their entry
    const float denom = static_cast<float>(e - s);
    float acc = r;
    for (int t0 = s; t0 < e; t0 += kLongTile) {
      const int nt = min(kLongTile, e - t0);
      if (live) {
        int u[kRows];
        float o[kRows], err[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int row = warp + j * kWarpsL;
          u[j] = row < nt ? __ldg(sorted_users + t0 + row) : -1;
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          o[j] = u[j] >= 0 ? to_float<T>(__ldg(row_ptr<L>(a.T_u, u[j]) + c))
                           : 0.f;
          err[j] = u[j] >= 0 ? __ldg(a.pair_err + u[j]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (u[j] >= 0)
            s_d[warp + j * kWarpsL][lane] = delta_col<T, kMean>(
                r, o[j], c, a.F, err[j], denom, a.lr, a.reg_q, a.reg_ib);
      }
      __syncthreads();
      if (warp == 0 && live)
        for (int k = 0; k < nt; ++k) acc = round_to<T>(acc + s_d[k][lane]);
      __syncthreads();  // the tile is read before the next one is written
    }
    if (warp == 0) row_ptr<L>(a.T_i_out, i)[c] = from_float<T>(acc);
  }
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

int sort_tiles(int U) { return (U + kSortTile - 1) / kSortTile; }

// The most items that can have a run longer than kLong.
int max_long(int U) { return U / (kLong + 1) + 1; }

// The collision kernels after the user kernel.  ws: the workspace of
// sgd_step_workspace(U) ints, its first 2·U the pairs the user kernel wrote.
template <class L>
int launch_collisions(const Step& a, bool mean, cudaStream_t s, int* ws,
                      int item_blocks) {
  const int U = a.U;
  const int tiles = sort_tiles(U);
  int* hist = ws + 6 * static_cast<size_t>(U);
  int* long_items = hist + kDigits * tiles;
  int* long_count = long_items + max_long(U);
  const int* keys = a.pair_item;
  const int* vals = nullptr;
  const int units = max_long(U) * (L::kWidth / kSliceCols);
  const int long_blocks = units < kLongBlocks ? units : kLongBlocks;
  int bits = 0;
  while (bits < 31 && (a.I >> bits) != 0) ++bits;  // keys are 0 … I
  for (int pass = 0; pass * kDigitBits < bits; ++pass) {
    int* kout = ws + (2 + 2 * (pass & 1)) * static_cast<size_t>(U);
    int* vout = kout + U;
    const int shift = pass * kDigitBits;
    sort_hist_kernel<<<tiles, kSortThreads, 0, s>>>(
        keys, U, shift, hist, pass == 0 ? long_count : nullptr);
    exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>(hist, kDigits * tiles);
    sort_scatter_kernel<<<tiles, kSortThreads, 0, s>>>(keys, vals, kout, vout,
                                                       U, shift, hist);
    keys = kout;
    vals = vout;
  }
  if (mean) {
    collide_item_kernel<L, true><<<item_blocks, kThreads, 0, s>>>(
        a, keys, vals, long_items, long_count);
    collide_long_kernel<L, true><<<long_blocks, kLongThreads, 0, s>>>(
        a, keys, vals, long_items, long_count);
  } else {
    collide_item_kernel<L, false><<<item_blocks, kThreads, 0, s>>>(
        a, keys, vals, long_items, long_count);
    collide_long_kernel<L, false><<<long_blocks, kLongThreads, 0, s>>>(
        a, keys, vals, long_items, long_count);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class L>
int launch_step(const Step& a, int mode, cudaStream_t s, int* ws) {
  constexpr int kRows = kWarps * L::kRowsPerWarp;
  const int user_blocks = (a.U + kRows - 1) / kRows;
  const bool pairs = mode == kMean || mode == kSum;
  cudaError_t e = pairs
      ? launch_early(sgd_user_kernel<L, true>, user_blocks, s, a)
      : launch_early(sgd_user_kernel<L, false>, user_blocks, s, a);
  if (e != cudaSuccess || mode == kUsersOnly) return static_cast<int>(e);
  const int blocks = (a.I + kRows - 1) / kRows;
  if (pairs) return launch_collisions<L>(a, mode == kMean, s, ws, blocks);
  if (mode == kFirstWins)
    e = launch_early(sgd_item_kernel<L, 0>, blocks, s, a);
  else if (mode == kTwinMirror)
    e = launch_early(sgd_item_kernel<L, 1>, blocks, s, a);
  else
    e = launch_early(sgd_item_kernel<L, 2>, blocks, s, a);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

int sgd_step_max_width() { return kMaxWidth; }

// Ints of workspace a mean/sum step over U users needs.
long long sgd_step_workspace(int U) {
  return 6LL * U + static_cast<long long>(kDigits) * sort_tiles(U) +
         max_long(U) + 1;
}

// One step.  Tables (rows, W) of one element type (elem: 0 float32,
// 1 bf16), contiguous and 16-byte aligned, W one of 64, 128, 256, 384,
// 512; index arrays int32.  mode: -1 users only (items frozen),
// 0 first_wins, 1 twin mirror, 2 twin lean, 3 mean, 4 sum.  `best` (I
// int32, all kSentinel on entry, left so on exit) and `w_rating` (U
// floats) are used by mode 0 only; the item-major arrays by modes 1-2;
// `ws` (sgd_step_workspace(U) ints) by modes 3-4.  Launches on `stream`;
// returns the cudaError_t of the launches.
int sgd_step_launch(const void* T_u, void* T_u_out, const void* T_i,
                    void* T_i_out, const int* indptr, const int* indices,
                    const float* data, const int* row_ids,
                    const int* it_indptr, const int* it_users,
                    const float* it_vals, const int* it_order, int* best,
                    float* w_rating, int* ws, int U, int I, int W, int F,
                    float mu, float lr, float reg_p, float reg_q,
                    float reg_ub, float reg_ib, unsigned k0, unsigned k1,
                    unsigned it, int start_user, int mode, int elem,
                    void* stream) {
  if (U <= 0 || I <= 0 || W <= F || F < 0 || mode < kUsersOnly ||
      mode > kSum || ((mode == kMean || mode == kSum) && ws == nullptr))
    return cudaErrorInvalidValue;
  const bool pairs = mode == kMean || mode == kSum;
  const Step a{T_u, T_u_out, T_i, T_i_out, indptr, indices, data, row_ids,
               it_indptr, it_users, it_vals, it_order,
               mode == kFirstWins ? best : nullptr, w_rating,
               pairs ? ws : nullptr,
               pairs ? reinterpret_cast<float*>(ws + U) : nullptr, U, I, F,
               mu, lr, reg_p, reg_q, reg_ub, reg_ib, k0, k1, it,
               start_user};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_row(W, elem, [&](auto layout) {
    return launch_step<decltype(layout)>(a, mode, s, ws);
  });
}

}  // extern "C"
