// K0a — one SGD iteration over the packed factor tables, on Hopper: the
// kernels and their launches, shared by sgd_step.cu (one device) and
// sgd_sharded.cu (a shard of a multi-device grid).
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
// the pairs arrive, so the kernels here keep that order instead.  The item
// side is latency, not bytes (about 85 MB at the headline shape, 25 us at
// 3.35 TB/s), so it is a counting sort by item with no pass that waits on
// one block, and runs whose loads are in flight together:
//   1. the user kernel writes each user's sampled item (I for none), its
//      error, and its slot in the item's run: a warp-aggregated integer
//      atomicAdd (__match_any_sync) on counts[item], an array of I ints
//      that the step finds zero and leaves zero;
//   2. run_offsets_kernel: an exclusive scan of the counts across the card
//      (one pass, decoupled look-back between its tiles), which gives each
//      item's run start and length (mean's denominator), clears the
//      counts, and lists the items of runs longer than kLong;
//   3. place_runs_kernel: each user into its item's run at its slot.  The
//      atomics order a run's users as they arrived, so each run is put in
//      ascending user order (the only stable order: a step's users are
//      distinct) before its adds;
//   4. order_long_kernel, for the runs longer than kLong: a block a run
//      marks its users in a bitmap in shared memory and writes them back
//      in ascending order;
//   5. collide_long_kernel, for those runs: a block a slice of 32 columns
//      of such an item, so that a hot item's slices run on several SMs.
//      It streams the ordered run a tile at a time: warps 1-7 compute a
//      tile's deltas into shared memory from rows they loaded during the
//      tile before (32 rows a warp in flight), while warp 0 adds the
//      previous tile's, a lane a column, in order, from registers;
//   6. collide_item_kernel, for the other runs, launched so that it starts
//      while the long-run kernel still runs (programmatic dependent launch)
//      and ends only after it: a lane group an item reads its run's start
//      and length, its users in one load, ranks them by user id in shared
//      memory, then adds their deltas in order in the row layout above,
//      kInFlight pairs' rows and errors loaded before the first is added.
// So the result is a pure function of the step's inputs, and matches the
// plain version (ops/packed.py) up to the float32 rounding of the deltas.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "packed_rows.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// At least eight blocks an SM: at most 64 registers a thread.
constexpr int kMinBlocks = 8;
constexpr int kMaxWidth = 512;  // the widest row dispatch_row takes
constexpr int kSentinel = 0x7fffffff;
// Collisions: the offsets scan's tile (kScanItems counts a thread), the
// longest run the item kernel adds itself, the pairs it has in flight a
// lane group, the long-run kernel's block and tile (a row a producer lane),
// the runs it takes first, and its bitmap's words at most (262,144 users;
// more users are mapped a chunk at a time).
constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kPlaceThreads = 256;
constexpr int kLong = 32;
// Two pairs in flight, not four: on an H100 four spilled 8-36 bytes at
// the 128-register budget and took longer (PERF.md, PR 8).
constexpr int kInFlight = 2;
constexpr int kLongThreads = 256;
constexpr int kLongTile = kLongThreads - 32;
constexpr int kBig = 4 * kLongTile;
constexpr int kMapWords = 8192;
constexpr int kSliceCols = 32;  // columns a long-run block adds
// At least four blocks an SM (at most 128 registers a thread): the
// collision item kernel holds kInFlight pairs' rows a lane group.
constexpr int kCollideMinBlocks = 4;
// The step's control words (ints at the start of the workspace, zeroed by
// the user kernel): the item kernel's and the long-run kernel's work
// tickets, the counts of the long-run lists, the offsets scan's tile
// ticket; then the scan's tile states (64-bit).
enum Ctrl {
  kShortTicket = 0,
  kLongTicket = 1,
  kBigCount = 2,
  kLongCount = 3,
  kScanTicket = 4,
  kCtrlInts = 8
};

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
  // mean/sum (after the fields the other kernels read, whose offsets in
  // the parameter space stay as they were):
  int* slot;        // the pair's slot in its item's run
  int* counts;      // pairs an item, zero on entry and on exit
  int* ctrl;        // the control words (Ctrl), n_ctrl ints
  int n_ctrl;
  // A shard of a (dp × ip) grid (the kShard kernels, sgd_sharded.cu): U
  // and I count the shard's users and items, whose global ids start at
  // user_offset and item_offset; the sampled item ids are global.
  const void* rows;    // the sampled items' rows assembled over ip (U, W),
                       // or null: gathered from T_i (ip = 1)
  const void* raters;  // twin: the sampled raters' rows assembled over dp
                       // (I, W), or null: gathered from T_u (dp = 1)
  float* dT;           // the item deltas (I, W) float32
  const int* denom;    // mean: each item's pairs over the grid, or null:
                       // the shard's own
  int user_offset, item_offset, n_users_global;
};

// The runs of mean/sum: where the collision kernels after the user kernel
// find their arrays in the workspace.
struct Runs {
  int* ctrl;                    // Ctrl
  unsigned long long* status;   // the offsets scan's tile states
  int* offs;                    // I + 1: item i's run is [offs[i], offs[i+1])
  int* placed;                  // U: the users, run by run
  int* ordered;                 // U: the long runs in ascending user order
  int* long_items;              // max_long: from the front the runs longer
                                // than kBig, from the back the other long ones
  int max_long;
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

// The delta of one column that step_col adds:  lr · (err · ô − reg · s).
__device__ __forceinline__ float col_delta(float s, float o, int c, int F,
                                           float err, float lr, float reg_f,
                                           float reg_b) {
  const float hat = c < F ? o : (c == F ? 1.f : 0.f);
  const float reg = c < F ? reg_f : (c == F ? reg_b : 0.f);
  return lr * (err * hat - reg * s);
}

// Lane gl's float4s of the delta  lr · (err · ô − reg ⊙ self)  that
// update_row would add to `self` (zero past column F), for a pair of
// rating `rating`.
template <class L>
__device__ __forceinline__ void delta_row(float4 (&d)[L::V],
                                          const float4 (&s)[L::V],
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
    d[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c + 3 < F) {
      d[k].x = lr * (err * o[k].x - reg_f * s[k].x);
      d[k].y = lr * (err * o[k].y - reg_f * s[k].y);
      d[k].z = lr * (err * o[k].z - reg_f * s[k].z);
      d[k].w = lr * (err * o[k].w - reg_f * s[k].w);
    } else if (c <= F) {  // the float4 that holds the bias column
      d[k].x = col_delta(s[k].x, o[k].x, c, F, err, lr, reg_f, reg_b);
      d[k].y = col_delta(s[k].y, o[k].y, c + 1, F, err, lr, reg_f, reg_b);
      d[k].z = col_delta(s[k].z, o[k].z, c + 2, F, err, lr, reg_f, reg_b);
      d[k].w = col_delta(s[k].w, o[k].w, c + 3, F, err, lr, reg_f, reg_b);
    }
  }
}

// Lane gl's float4s into a float32 row of the layout's width (the item
// deltas of a shard).
template <class L>
__device__ __forceinline__ void store_f32(float* row, int gl,
                                          const float4 (&x)[L::V]) {
#pragma unroll
  for (int k = 0; k < L::V; ++k)
    *reinterpret_cast<float4*>(row + L::col(gl, k)) = x[k];
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

// The same from an array an earlier kernel of the step wrote, read at L2.
__device__ __forceinline__ int load_window_l2(const int* arr, int base,
                                              int last, int n) {
  const int lane = threadIdx.x & 31;
  return lane < n ? __ldcg(arr + min(base + lane, last)) : 0;
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

// One more pair for counts[key] from each lane whose key >= 0 (the lanes
// of a key share one atomicAdd, __match_any_sync); returns the lane's slot
// among its key's pairs.  Every lane of the warp calls it, a lane with no
// pair with a negative key of its own (-1 - lane).
__device__ __forceinline__ int count_pair(int* counts, int key) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int first = __ffs(peers) - 1;
  int base = 0;
  if (key >= 0 && lane == first) base = atomicAdd(counts + key, __popc(peers));
  base = __shfl_sync(0xffffffffu, base, first);
  return base + __popc(peers & ((1u << lane) - 1u));
}

// The step's control words to zero (block 0 of the kernel that starts the
// runs, after its wait).
__device__ __forceinline__ void clear_ctrl(int* ctrl, int n) {
  if (blockIdx.x == 0)
    for (int k = threadIdx.x; k < n; k += blockDim.x) ctrl[k] = 0;
}

// kPairs (mean, sum): also write each user's sampled item, error and slot
// in its item's run for the collision kernels, counting the item's pairs.
// kShard: a shard's users (global ids from user_offset) and items (from
// item_offset); a pair joins the item side only where the shard owns its
// item, and the item's row comes from the rows assembled over ip when
// they are given.
template <class L, bool kPairs, bool kShard = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sgd_user_kernel(const Step a) {
  constexpr int G = L::G, NG = L::kRowsPerWarp, W = L::kWidth;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int g = lane / G;
  const int u0 = warp_first_row<L>();
  const int u = u0 + g;
  const int uid = kShard ? u + a.user_offset : u;  // the stream's id
  // The sampling chain reads only the ratings: it runs while the previous
  // kernel ends.
  const int p = load_window(a.indptr, u0, a.U, NG + 1);
  const int start = __shfl_sync(0xffffffffu, p, g);
  const int len = __shfl_sync(0xffffffffu, p, g + 1) - start;
  int item = 0;
  float rating = 0.f;
  if (u < a.U && len > 0) {
    const int pos = start + draw_offset(
        draw_u01(a.k0, a.k1, a.it, static_cast<uint32_t>(uid)), len);
    item = __ldg(a.indices + pos);
    rating = __ldg(a.data + pos);
  }
  wait_prior_kernel();
  allow_next_kernel();
  bool owned = true;
  if constexpr (kShard) {
    item -= a.item_offset;  // the shard's own index of the item
    owned = item >= 0 && item < a.I;
  }
  int slot = 0;
  if constexpr (kPairs) {
    clear_ctrl(a.ctrl, a.n_ctrl);
    slot = count_pair(a.counts, u < a.U && len > 0 && owned && gl == 0
                                    ? item : -1 - lane);
  }
  if (u >= a.U) return;
  float4 x[L::V];
  load_row<L, Read::kL2>(row_ptr<L>(a.T_u, u), gl, W - 1, x);
  if (len > 0) {
    float4 o[L::V];
    if (kShard && a.rows != nullptr)
      load_row<L, Read::kL2>(row_ptr<L>(a.rows, u), gl, a.F, o);
    else
      load_row<L, Read::kL2>(row_ptr<L>(a.T_i, item), gl, a.F, o);
    const float err = update_row<L>(x, o, rating, gl, lane, a.F, a.mu, a.lr,
                                    a.reg_p, a.reg_ub);
    if constexpr (kPairs) {
      if (gl == 0) {
        a.pair_item[u] = owned ? item : a.I;
        a.pair_err[u] = err;
        a.slot[u] = slot;
      }
    } else if (a.best != nullptr && gl == 0) {
      const int n_users = kShard ? a.n_users_global : a.U;
      int prio = uid - a.start_user;
      if (prio < 0) prio += n_users;
      if (owned) atomicMin(a.best + item, prio);
      a.w_rating[u] = rating;
    }
  } else if constexpr (kPairs) {
    if (gl == 0) a.pair_item[u] = a.I;
  }
  store_row<L>(row_ptr<L>(a.T_u_out, u), gl, x);
}

// kMode: 0 first_wins (election), 1 twin with the item-major mirror,
// 2 twin lean (through the item-major → flat permutation).  kShard (modes
// 0 and 1): a shard's items.  Under first_wins it writes each item's delta
// into dT, nonzero only where the winner (elected over the grid) is one of
// the shard's users, whose pre-step row and sampled rating it holds; under
// twin it draws the rater on the global stream (n_users_global +
// item_offset + i) and reads the rater's row from the rows assembled over
// dp when they are given, both after its wait.
template <class L, int kMode, bool kShard = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sgd_item_kernel(const Step a) {
  static_assert(!kShard || kMode < 2, "a shard's twin takes the mirror");
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
    const int id = kShard ? i + a.n_users_global + a.item_offset : i + a.U;
    if (active && len > 0) {
      const int pos = start + draw_offset(
          draw_u01(a.k0, a.k1, a.it, static_cast<uint32_t>(id)), len);
      if (kMode == 1) {
        partner = __ldg(a.it_users + pos);
        rating = __ldg(a.it_vals + pos);
      } else {
        const int q = __ldg(a.it_order + pos);
        partner = __ldg(a.row_ids + q);
        rating = __ldg(a.data + q);
      }
      if constexpr (!kShard)
        load_row<L, Read::kL2>(row_ptr<L>(a.T_u, partner), gl, a.F, o);
    }
  }
  wait_prior_kernel();
  allow_next_kernel();
  if constexpr (kShard && kMode == 1) {
    if (partner >= 0) {
      if (a.raters != nullptr)
        load_row<L, Read::kL2>(row_ptr<L>(a.raters, i), gl, a.F, o);
      else
        load_row<L, Read::kL2>(row_ptr<L>(a.T_u, partner - a.user_offset),
                               gl, a.F, o);
    }
  }
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
      const int n_users = kShard ? a.n_users_global : a.U;
      partner = b + a.start_user;
      if (partner >= n_users) partner -= n_users;
      if constexpr (kShard) {
        partner -= a.user_offset;  // the shard's own user, or none
        if (partner >= a.U) partner = -1;
      }
      if (!kShard || partner >= 0) {
        rating = __ldcg(a.w_rating + partner);
        load_row<L, Read::kL2>(row_ptr<L>(a.T_u, partner), gl, a.F, o);
      }
    }
  }
  if (!active) return;
  if constexpr (kShard && kMode == 0) {
    float4 d[L::V];
    if (partner >= 0) {
      delta_row<L>(d, x, o, rating, gl, lane, a.F, a.mu, a.lr, a.reg_q,
                   a.reg_ib);
    } else {
#pragma unroll
      for (int k = 0; k < L::V; ++k) d[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    store_f32<L>(a.dT + static_cast<size_t>(i) * W, gl, d);
  } else {
    if (partner >= 0)
      update_row<L>(x, o, rating, gl, lane, a.F, a.mu, a.lr, a.reg_q,
                    a.reg_ib);
    store_row<L>(row_ptr<L>(a.T_i_out, i), gl, x);
  }
}

// ---- Collisions: the runs of the users by sampled item -----------------

// Exclusive prefix sum over a block of kT threads of one int each; *total
// gets the block's sum.  s_warp holds kT / 32 ints.
template <int kT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  constexpr int kW = kT / 32;
  static_assert(kW <= 32, "one warp scans the warps' sums");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
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
  const int before = (warp ? s_warp[warp - 1] : 0) + incl - v;
  *total = s_warp[kW - 1];
  __syncthreads();  // s_warp may be written again by the caller's next scan
  return before;
}

// A tile state of the offsets scan: its flag in the high word (kAggregate:
// the tile's own sum; kPrefix: the sum of it and all tiles before it).
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

__device__ __forceinline__ unsigned long long load_state(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_state(unsigned long long* p,
                                            unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Each item's run start: offs[i] = Σ_{j<i} counts[j], offs[I] the pairs,
// in one pass over the card.  A block takes the next tile of kScanTile
// counts (a ticket, so every tile before it belongs to a block already
// running), publishes the tile's sum, then looks back over the tiles
// before it until one has published its inclusive prefix (Merrill and
// Garland's decoupled look-back).  It clears the counts it read and lists
// the items whose run is longer than kLong.
__global__ void __launch_bounds__(kScanThreads)
run_offsets_kernel(int* counts, int I, const Runs r) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_tile, s_before;
  wait_prior_kernel();
  allow_next_kernel();
  if (threadIdx.x == 0) s_tile = atomicAdd(r.ctrl + kScanTicket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int lo = tile * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    v[k] = lo + k < I ? __ldcg(counts + lo + k) : 0;
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int n = v[k];
    if (n != 0) counts[lo + k] = 0;  // zero for the next step
    if (n > kBig)
      r.long_items[atomicAdd(r.ctrl + kBigCount, 1)] = lo + k;
    else if (n > kLong)
      r.long_items[r.max_long - 1 - atomicAdd(r.ctrl + kLongCount, 1)] =
          lo + k;
    v[k] = sum;
    sum += n;
  }
  int total;
  const int before = block_exclusive_scan<kScanThreads>(sum, s_warp, &total);
  if (threadIdx.x == 0) {
    int excl = 0;
    if (tile > 0) {
      store_state(r.status + tile, kAggregate | static_cast<unsigned>(total));
      for (int j = tile - 1; j >= 0;) {
        const unsigned long long st = load_state(r.status + j);
        if (st < kAggregate) continue;  // not published yet
        excl += static_cast<int>(st & 0xffffffffu);
        if (st >= kPrefix) break;
        --j;
      }
    }
    store_state(r.status + tile,
                kPrefix | static_cast<unsigned>(excl + total));
    s_before = excl;
    if (tile == gridDim.x - 1) r.offs[I] = excl + total;
  }
  __syncthreads();
  const int base = s_before + before;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    if (lo + k < I) r.offs[lo + k] = base + v[k];
}

// Each user with a pair into its item's run, at the slot its count gave.
__global__ void __launch_bounds__(kPlaceThreads)
place_runs_kernel(const int* pair_item, const int* slot, int U, int I,
                  const Runs r) {
  wait_prior_kernel();
  allow_next_kernel();
  const int u = blockIdx.x * kPlaceThreads + threadIdx.x;
  if (u >= U) return;
  const int item = __ldcg(pair_item + u);
  if (item < I) r.placed[__ldcg(r.offs + item) + __ldcg(slot + u)] = u;
}

// A run of n <= kLong users (src[0, n)) in ascending order into run[0, n),
// a shared-memory buffer of kLong ints, by the G lanes of a group: each
// lane ranks its users by counting the smaller ones.  Every lane of the
// warp calls it (active false: nothing to order).
template <int G>
__device__ __forceinline__ void order_run(int* run, const int* src, int n,
                                          int gl, bool active) {
  constexpr int kPer = kLong / G;
  static_assert(kLong % G == 0, "whole users a lane");
  int v[kPer], rank[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int q = gl + G * j;
    v[j] = active && q < n ? __ldcg(src + q) : -1;
    if (v[j] >= 0) run[q] = v[j];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    rank[j] = 0;
    if (v[j] >= 0)
      for (int q = 0; q < n; ++q) rank[j] += run[q] < v[j];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (v[j] >= 0) run[rank[j]] = v[j];
  __syncwarp();
}

// A long run's users in [lo, lo + 32·nw) as a bitmap in shared memory,
// one bit a user, by the whole block.
__device__ __forceinline__ void map_run(unsigned* map, int nw,
                                        const int* src, int n, int lo) {
  for (int w = threadIdx.x; w < nw; w += blockDim.x) map[w] = 0u;
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int u = __ldcg(src + k) - lo;
    if (u >= 0 && u < 32 * nw) atomicOr(map + (u >> 5), 1u << (u & 31));
  }
  __syncthreads();
}

// The users of the bitmap in ascending order into out: each of the kT
// threads takes a run of words, finds the rank of its first user by a
// block scan of the words' counts, and writes its users from there.
// Returns the users written.
template <int kT>
__device__ __forceinline__ int write_map(const unsigned* map, int nw, int lo,
                                         int* s_warp, int* out) {
  const int per = (nw + kT - 1) / kT;
  const int w0 = min(static_cast<int>(threadIdx.x) * per, nw);
  const int w1 = min(w0 + per, nw);
  int cnt = 0;
  for (int w = w0; w < w1; ++w) cnt += __popc(map[w]);
  int total;
  int rank = block_exclusive_scan<kT>(cnt, s_warp, &total);
  for (int w = w0; w < w1; ++w) {
    for (unsigned bits = map[w]; bits != 0u; bits &= bits - 1u)
      out[rank++] = lo + 32 * w + __ffs(bits) - 1;
  }
  __syncthreads();  // the map is read before it is cleared again
  return total;
}

// The item of long-run entry li: the runs longer than kBig first.
__device__ __forceinline__ int long_item(const Runs& r, int n_big, int li) {
  return li < n_big ? __ldcg(r.long_items + li)
                    : __ldcg(r.long_items + r.max_long - 1 - (li - n_big));
}


// The runs longer than kLong, each in ascending user order from placed
// into ordered (the same positions), a block a run, the runs longer than
// kBig first: the run's users marked in a bitmap in shared memory (a
// chunk of 32·nw_max users at a time) and written back in order.  The
// long-run kernel then streams each run.
__global__ void __launch_bounds__(kLongThreads)
order_long_kernel(const Runs r, int U, int nw_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* map = reinterpret_cast<unsigned*>(smem);
  __shared__ int s_warp[kLongThreads / 32];
  wait_prior_kernel();
  allow_next_kernel();
  const int n_big = __ldcg(r.ctrl + kBigCount);
  const int n_long = n_big + __ldcg(r.ctrl + kLongCount);
  for (int li = blockIdx.x; li < n_long; li += gridDim.x) {
    const int i = long_item(r, n_big, li);
    const int s = __ldcg(r.offs + i), n = __ldcg(r.offs + i + 1) - s;
    int done = 0;
    for (int lo = 0; lo < U && done < n; lo += 32 * nw_max) {
      const int nw = min(nw_max, (U - lo + 31) / 32);
      map_run(map, nw, r.placed + s, n, lo);
      done += write_map<kLongThreads>(map, nw, lo, s_warp,
                                      r.ordered + s + done);
    }
  }
}

// ---- Collisions: the item side ------------------------------------------

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

// Lane gl's float4s of the delta of one pair (zero past column F),
// rounded to R: the table type, or float32 for a shard's deltas.
template <class L, bool kMean, typename R = typename L::Elem>
__device__ __forceinline__ void pair_delta(float4 (&d)[L::V],
                                           const float4 (&r)[L::V],
                                           const float4 (&o)[L::V],
                                           float err, float denom, int gl,
                                           int F, float lr, float reg_f,
                                           float reg_b) {
#pragma unroll
  for (int k = 0; k < L::V; ++k) {
    const int c = L::col(gl, k);
    if (c > F) {
      d[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    d[k].x = delta_col<R, kMean>(r[k].x, o[k].x, c, F, err, denom, lr,
                                 reg_f, reg_b);
    d[k].y = delta_col<R, kMean>(r[k].y, o[k].y, c + 1, F, err, denom, lr,
                                 reg_f, reg_b);
    d[k].z = delta_col<R, kMean>(r[k].z, o[k].z, c + 2, F, err, denom, lr,
                                 reg_f, reg_b);
    d[k].w = delta_col<R, kMean>(r[k].w, o[k].w, c + 3, F, err, denom, lr,
                                 reg_f, reg_b);
  }
}

// A row in flight as loaded: float4s, or a bf16 row's packed words (half
// the registers, unpacked when it is used).
template <class L>
struct Held {
  typename std::conditional<L::kBf16, uint4, float4>::type
      w[L::kBf16 ? L::V16 : L::V];
};

template <class L>
__device__ __forceinline__ void load_held(const typename L::Elem* row, int gl,
                                          int last, Held<L>& h) {
  if constexpr (L::kBf16)
    load_words<L, Read::kReadOnly>(row, gl, last, h.w);
  else
    load_row<L, Read::kReadOnly>(row, gl, last, h.w);
}

template <class L>
__device__ __forceinline__ void unpack_held(const Held<L>& h,
                                            float4 (&x)[L::V]) {
  if constexpr (L::kBf16) {
    unpack_words<L>(h.w, x);
  } else {
#pragma unroll
    for (int k = 0; k < L::V; ++k) x[k] = h.w[k];
  }
}

// The item side of mean/sum for runs of at most kLong pairs, in the row
// layout: a lane group an item, the warps taking items a warp's rows at a
// time from a ticket, so that the blocks that run while the long-run
// kernel holds part of the card take the work of those that do not.  The
// group orders its run (order_run), then adds its users' deltas in user
// order, rounding to the table type after each add, kInFlight pairs' rows
// and errors loaded before the first of them is added.  Launched early
// behind the long-run kernel; it waits for it at its end, so that the step
// ends when both have.  kShard: the run's deltas are summed in float32
// from zero into dT (the shard's item deltas), mean dividing by the item's
// pairs over the grid when they are given.
template <class L, bool kMean, bool kShard = false>
__global__ void __launch_bounds__(kThreads, kCollideMinBlocks)
collide_item_kernel(const Step a, const Runs r) {
  // What a delta and each sum round to.
  using T = typename std::conditional<kShard, float,
                                      typename L::Elem>::type;
  constexpr int G = L::G, NG = L::kRowsPerWarp, W = L::kWidth;
  __shared__ int s_run[kWarps][NG * kLong];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane & (G - 1);
  const int g = lane / G;
  int* run = s_run[warp] + g * kLong;
  const int n_tiles = (a.I + NG - 1) / NG;
  for (;;) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(r.ctrl + kShortTicket, 1);
    tile = __shfl_sync(0xffffffffu, tile, 0);
    if (tile >= n_tiles) break;
    const int i0 = tile * NG, i = i0 + g;
    const int p = load_window_l2(r.offs, i0, a.I, NG + 1);
    const int s = __shfl_sync(0xffffffffu, p, g);
    const int n = __shfl_sync(0xffffffffu, p, g + 1) - s;
    const bool mine = i < a.I && n <= kLong;
    float4 acc[L::V];
    if (mine) load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_i, i), gl, W - 1,
                                           acc);
    order_run<G>(run, r.placed + s, n, gl, mine);
    if (mine && n > 0) {
      float4 pre[L::V];
#pragma unroll
      for (int k = 0; k < L::V; ++k) {
        pre[k] = acc[k];
        if (kShard) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float denom = kShard && a.denom != nullptr
                              ? static_cast<float>(__ldcg(a.denom + i))
                              : static_cast<float>(n);
      for (int b = 0; b < n; b += kInFlight) {
        Held<L> o[kInFlight];
        float err[kInFlight];
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          if (b + k < n) {
            const int u = run[b + k];
            err[k] = __ldcg(a.pair_err + u);
            load_held<L>(row_ptr<L>(a.T_u, u), gl, a.F, o[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kInFlight; ++k) {
          if (b + k >= n) break;
          float4 x[L::V], d[L::V];
          unpack_held<L>(o[k], x);
          pair_delta<L, kMean, T>(d, pre, x, err[k], denom, gl, a.F, a.lr,
                                  a.reg_q, a.reg_ib);
#pragma unroll
          for (int c = 0; c < L::V; ++c) {
            if (L::col(gl, c) > a.F) continue;
            acc[c].x = round_to<T>(acc[c].x + d[c].x);
            acc[c].y = round_to<T>(acc[c].y + d[c].y);
            acc[c].z = round_to<T>(acc[c].z + d[c].z);
            acc[c].w = round_to<T>(acc[c].w + d[c].w);
          }
        }
      }
    }
    if (mine) {
      if constexpr (kShard) {
        if (n == 0) {
#pragma unroll
          for (int k = 0; k < L::V; ++k)
            acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        store_f32<L>(a.dT + static_cast<size_t>(i) * W, gl, acc);
      } else {
        store_row<L>(row_ptr<L>(a.T_i_out, i), gl, acc);
      }
    }
    __syncwarp();  // the run buffer is read before the next tile writes it
  }
  wait_prior_kernel();
  allow_next_kernel();
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

// The long-run kernel's shared memory: two tiles of deltas.
constexpr size_t kLongSmem = 2 * sizeof(float) * kLongTile * kSliceCols;

// acc plus d[0][lane], …, d[nt - 1][lane] in that order, rounded to the
// table type after each add, eight deltas at a time loaded into registers
// so that each add waits only on the one before it.
template <typename T>
__device__ __forceinline__ float add_chain(float acc,
                                           const float (*d)[kSliceCols],
                                           int nt, int lane) {
  int k = 0;
  for (; k + 8 <= nt; k += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = d[k + j][lane];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = round_to<T>(acc + v[j]);
  }
  for (; k < nt; ++k) acc = round_to<T>(acc + d[k][lane]);
  return acc;
}

// The order pass's bitmap: nw words.
size_t map_smem(int nw) { return sizeof(unsigned) * nw; }

// The bitmap's words for U users.
int map_words(int U) {
  const int nw = (U + 31) / 32;
  return nw < kMapWords ? nw : kMapWords;
}

// The item side of mean/sum for the runs longer than kLong: a block takes
// a (long-run item, slice of kSliceCols columns holding a column <= F)
// from a ticket, the runs longer than kBig first, so that a hot item's
// slices start at once on several SMs.  It streams the run in the order
// order_long_kernel wrote it, a tile of kLongTile pairs at a time: warps
// 1-7 compute tile t's deltas of the slice (a lane a column, a row a warp
// at a time) into shared memory from the rows they loaded during the tile
// before, then issue the loads of tile t + 1's rows (32 a warp in flight)
// and of tile t + 2's users, while warp 0 adds tile t - 1's deltas in user
// order, a lane a column, eight at a time into registers so that each add
// waits only on the one before it, rounding after each add.  kShard: as
// in collide_item_kernel, float32 sums from zero into dT.
template <class L, bool kMean, bool kShard = false>
__global__ void __launch_bounds__(kLongThreads, 1)
collide_long_kernel(const Step a, const Runs r) {
  using T = typename L::Elem;
  // What a delta and each sum round to.
  using R = typename std::conditional<kShard, float, T>::type;
  constexpr int W = L::kWidth;
  constexpr int kSlices = W / kSliceCols;
  constexpr int kRows = 32;  // rows of a tile a producer warp loads
  static_assert(kSliceCols == 32 && kLongTile == 7 * kRows,
                "a lane a column, warps 1-7 a tile");
  extern __shared__ __align__(16) unsigned char smem[];
  auto s_d = reinterpret_cast<float(*)[kLongTile][kSliceCols]>(smem);
  __shared__ int s_unit;
  wait_prior_kernel();
  allow_next_kernel();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int live_slices = a.F / kSliceCols + 1;
  const int n_big = __ldcg(r.ctrl + kBigCount);
  const int n_units = (n_big + __ldcg(r.ctrl + kLongCount)) * live_slices;
  for (;;) {
    if (threadIdx.x == 0) s_unit = atomicAdd(r.ctrl + kLongTicket, 1);
    __syncthreads();
    const int unit = s_unit;
    __syncthreads();
    if (unit >= n_units) break;
    const int slice = unit % live_slices;
    const int i = long_item(r, n_big, unit / live_slices);
    const int s = __ldcg(r.offs + i);
    const int n = __ldcg(r.offs + i + 1) - s;
    const int c = slice * kSliceCols + lane;
    const bool live = c <= a.F;  // the columns past F keep their entry
    const float pre = to_float<T>(__ldg(row_ptr<L>(a.T_i, i) + c));
    const float denom = kShard && a.denom != nullptr
                            ? static_cast<float>(__ldcg(a.denom + i))
                            : static_cast<float>(n);
    const int tiles = (n + kLongTile - 1) / kLongTile;
    const int* run = r.ordered + s;
    const bool producer = warp > 0 && live;
    const int row0 = (warp - 1) * kRows;
    int u[kRows];
    float o[kRows], err[kRows];
    auto users_of = [&](int t) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int k = t * kLongTile + row0 + j;
        u[j] = k < n ? __ldcg(run + k) : -1;
      }
    };
    auto rows_of = [&]() {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        o[j] = u[j] >= 0 ? to_float<T>(__ldg(row_ptr<L>(a.T_u, u[j]) + c))
                         : 0.f;
        err[j] = u[j] >= 0 ? __ldcg(a.pair_err + u[j]) : 0.f;
      }
    };
    if (producer) {
      users_of(0);
      rows_of();
      users_of(1);
    }
    float acc = kShard ? 0.f : pre;
    for (int t = 0; t <= tiles; ++t) {
      if (producer && t < tiles) {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (t * kLongTile + row0 + j < n)
            s_d[t & 1][row0 + j][lane] = delta_col<R, kMean>(
                pre, o[j], c, a.F, err[j], denom, a.lr, a.reg_q, a.reg_ib);
        if (t + 1 < tiles) {
          rows_of();
          users_of(t + 2);
        }
      } else if (warp == 0 && t > 0 && live) {
        const int nt = min(kLongTile, n - (t - 1) * kLongTile);
        acc = add_chain<R>(acc, s_d[(t - 1) & 1], nt, lane);
      }
      __syncthreads();
    }
    if (kShard && warp == 0) {
      float* out = a.dT + static_cast<size_t>(i) * W;
      out[c] = live ? acc : 0.f;
      if (slice == live_slices - 1)  // the slices past column F: no delta
        for (int k = slice + 1; k < kSlices; ++k)
          out[k * kSliceCols + lane] = 0.f;
    } else if (warp == 0) {
      T* out = row_ptr<L>(a.T_i_out, i);
      const T* in = row_ptr<L>(a.T_i, i);
      out[c] = from_float<T>(acc);
      if (slice == live_slices - 1)  // the slices past column F as they are
        for (int k = slice + 1; k < kSlices; ++k)
          out[k * kSliceCols + lane] = in[k * kSliceCols + lane];
    }
  }
}

// Launches kernel(args…) so that it may start before the kernel ahead of
// it on the stream has ended (see wait_prior_kernel).
template <typename... Exp, typename... Act>
cudaError_t launch_pdl(void (*kernel)(Exp...), int blocks, int threads,
                       size_t smem, cudaStream_t s, Act&&... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
}

template <typename Kernel>
cudaError_t launch_early(Kernel kernel, int blocks, cudaStream_t s,
                         const Step& a) {
  return launch_pdl(kernel, blocks, kThreads, 0, s, a);
}

// The most items that can have a run longer than kLong.
int max_long(int U) { return U / (kLong + 1) + 1; }

int scan_tiles(int I) { return (I + kScanTile - 1) / kScanTile; }

// The workspace of a mean/sum step, in ints: the control words and the
// scan's tile states, then each user's item, error and slot, the users
// run by run, the long runs ordered, the run offsets and the long-run
// lists.
long long workspace_ints(int U, int I) {
  return kCtrlInts + 2LL * scan_tiles(I) + 5LL * U + (I + 1LL) + max_long(U);
}

Runs runs_in(int* ws, int U, int I) {
  Runs r;
  r.ctrl = ws;
  r.status = reinterpret_cast<unsigned long long*>(ws + kCtrlInts);
  int* users = ws + kCtrlInts + 2 * static_cast<size_t>(scan_tiles(I));
  r.placed = users + 3 * static_cast<size_t>(U);
  r.ordered = r.placed + U;
  r.offs = r.ordered + U;
  r.long_items = r.offs + I + 1;
  r.max_long = max_long(U);
  return r;
}

// The card's SMs (the grids of the collision item side).
int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The order pass of the long runs (its bitmap above 48 KB of shared
// memory needs the kernel's attribute raised once).
cudaError_t launch_order(const Runs& r, int U, cudaStream_t s, bool early) {
  static bool raised = false;
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        order_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(map_smem(kMapWords)));
    if (e != cudaSuccess) return e;
    raised = true;
  }
  const int nw = map_words(U);
  if (early)
    return launch_pdl(order_long_kernel, sm_count(), kLongThreads,
                      map_smem(nw), s, r, U, nw);
  order_long_kernel<<<sm_count(), kLongThreads, map_smem(nw), s>>>(r, U, nw);
  return cudaGetLastError();
}

// The scan, the placement and the item side, after the user kernel.
template <class L, bool kMean, bool kShard = false>
cudaError_t launch_runs(const Step& a, const Runs& r, cudaStream_t s) {
  auto long_kernel = collide_long_kernel<L, kMean, kShard>;
  auto item_kernel = collide_item_kernel<L, kMean, kShard>;
  static int item_blocks = 0;  // resident blocks of the item kernel an SM
  if (item_blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kLongSmem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &item_blocks, item_kernel, kThreads, 0);
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = launch_pdl(run_offsets_kernel, scan_tiles(a.I),
                             kScanThreads, 0, s, a.counts, a.I, r);
  if (e == cudaSuccess)
    e = launch_pdl(place_runs_kernel,
                   (a.U + kPlaceThreads - 1) / kPlaceThreads, kPlaceThreads,
                   0, s, static_cast<const int*>(a.pair_item),
                   static_cast<const int*>(a.slot), a.U, a.I, r);
  if (e == cudaSuccess) e = launch_order(r, a.U, s, true);
  if (e == cudaSuccess)
    e = launch_pdl(long_kernel, sm_count(), kLongThreads, kLongSmem, s, a,
                   r);
  if (e == cudaSuccess)
    e = launch_pdl(item_kernel, sm_count() * item_blocks, kThreads, 0, s, a,
                   r);
  return e;
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
  if (pairs) {
    const Runs r = runs_in(ws, a.U, a.I);
    e = mode == kMean ? launch_runs<L, true>(a, r, s)
                      : launch_runs<L, false>(a, r, s);
  } else if (mode == kFirstWins) {
    e = launch_early(sgd_item_kernel<L, 0>, blocks, s, a);
  } else if (mode == kTwinMirror) {
    e = launch_early(sgd_item_kernel<L, 1>, blocks, s, a);
  } else {
    e = launch_early(sgd_item_kernel<L, 2>, blocks, s, a);
  }
  return static_cast<int>(e);
}

// ---- The runs alone: what chip_smoke.py and the card tests hold against
// a stable sort of the step's pairs ---------------------------------------

// The step's sampling (as sgd_user_kernel draws it) and its counts and
// slots, a thread a user.
__global__ void __launch_bounds__(kPlaceThreads)
runs_sample_kernel(const Step a) {
  const int u = blockIdx.x * kPlaceThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  clear_ctrl(a.ctrl, a.n_ctrl);
  int item = a.I, len = 0;
  if (u < a.U) {
    const int start = __ldg(a.indptr + u);
    len = __ldg(a.indptr + u + 1) - start;
    if (len > 0)
      item = __ldg(a.indices + start + draw_offset(
          draw_u01(a.k0, a.k1, a.it, static_cast<uint32_t>(u)), len));
  }
  const int slot = count_pair(a.counts, len > 0 ? item : -1 - lane);
  if (u < a.U) {
    a.pair_item[u] = len > 0 ? item : a.I;
    a.slot[u] = slot;
  }
}

// The runs of at most kLong users in the order the item kernel adds them
// (order_run, eight lanes a run), into out.
constexpr int kOrderG = 8;

__global__ void __launch_bounds__(kThreads)
runs_short_kernel(const Runs r, int I, int* out) {
  constexpr int NG = 32 / kOrderG;
  __shared__ int s_run[kWarps][NG * kLong];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gl = lane & (kOrderG - 1), g = lane / kOrderG;
  const int i0 = (blockIdx.x * kWarps + warp) * NG, i = i0 + g;
  const int p = load_window_l2(r.offs, i0, I, NG + 1);
  const int s = __shfl_sync(0xffffffffu, p, g);
  const int n = __shfl_sync(0xffffffffu, p, g + 1) - s;
  const bool mine = i < I && n <= kLong;
  int* run = s_run[warp] + g * kLong;
  order_run<kOrderG>(run, r.placed + s, n, gl, mine);
  if (mine)
    for (int q = gl; q < n; q += kOrderG) out[s + q] = run[q];
}

}  // namespace

