// K0a's sharded mode — one SGD iteration of a shard of a (dp × ip) grid
// (cu2rec_torch/parallel/sharded.py), the kernels of sgd_step.cuh split
// where the TPU package's sharded step (parallel/sharded.py there,
// _local_step_packed) puts a collective.  The caller runs the collectives
// (all_reduce over the grid's axes) between the calls:
//   1. sgd_shard_assemble (at ip > 1): each local user's sampled item row
//      where this shard owns the item, zero elsewhere, into a (U, W)
//      buffer of the table type, which a SUM over ip completes; under twin
//      at dp > 1 the same pass over the items assembles the sampled
//      raters' pre-step rows, completed by a SUM over dp;
//   2. sgd_shard_users: the user kernel (sgd_user_kernel<L, ·, true>),
//      which updates the shard's user rows, gathering the item rows from
//      the assembled buffer when it is given, and under first_wins
//      atomicMins the global rotated priority into the shard's election
//      buffer (then a MIN over dp), under mean and sum counts the pairs
//      whose item the shard owns (mean then sums a copy over dp for its
//      denominators);
//   3. sgd_shard_items: the item side.  first_wins writes each item's delta
//      into a float32 (I, W) buffer dT, nonzero where the winner is one of
//      the shard's users; mean and sum add the shard's pairs' deltas into
//      dT in ascending user order, in float32 from zero (the counting sort
//      and the collision kernels of sgd_step.cuh); twin writes the new item
//      rows itself, from the raters' rows;
//   4. after a SUM of dT over dp, sgd_shard_apply: T_i + dT rounded once
//      to the table type (the TPU package's (T_i + psum(dT)).astype(dt)).
// The sampling and the election are counter functions of global ids, so a
// shard draws what one device draws.  The bytes over the one-device step
// are dT's write, its read and the apply's pass over T_i; a collective
// between two kernels also ends the overlap of programmatic dependent
// launch there (`early` 0).
#include "sgd_step.cuh"

namespace {

// Row r < n draws its sampled entry from its CSR slice (indptr, the stream
// of id r + id_offset, as the step draws it) and reads the id there; where
// the id less own_offset falls in [0, n_own) the shard owns that id's row
// of `table`, which goes to out[r], and elsewhere out[r] is zero.
template <class L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
assemble_rows_kernel(const int* indptr, const int* ids, int n,
                     uint32_t id_offset, int own_offset, int n_own,
                     const void* table, void* out, uint32_t k0, uint32_t k1,
                     uint32_t it) {
  constexpr int G = L::G, NG = L::kRowsPerWarp, W = L::kWidth;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int g = lane / G;
  const int r0 = warp_first_row<L>();
  const int r = r0 + g;
  const int p = load_window(indptr, r0, n, NG + 1);
  const int start = __shfl_sync(0xffffffffu, p, g);
  const int len = __shfl_sync(0xffffffffu, p, g + 1) - start;
  int own = -1;
  if (r < n && len > 0) {
    const int pos = start + draw_offset(
        draw_u01(k0, k1, it, static_cast<uint32_t>(r) + id_offset), len);
    own = __ldg(ids + pos) - own_offset;
    if (own >= n_own) own = -1;
  }
  if (r >= n) return;
  float4 x[L::V];
  if (own >= 0) {
    load_row<L, Read::kL2>(row_ptr<L>(table, own), gl, W - 1, x);
  } else {
#pragma unroll
    for (int k = 0; k < L::V; ++k) x[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  store_row<L>(row_ptr<L>(out, r), gl, x);
}

// out[k] = T_i[k] + dT[k], rounded once to the table type.
template <typename T>
__global__ void __launch_bounds__(256)
apply_delta_kernel(const T* T_i, const float* dT, T* out, long long n) {
  for (long long k = blockIdx.x * 256LL + threadIdx.x; k < n;
       k += static_cast<long long>(gridDim.x) * 256)
    out[k] = from_float<T>(to_float<T>(T_i[k]) + dT[k]);
}

template <typename Kernel>
cudaError_t launch_step_kernel(Kernel kernel, int blocks, cudaStream_t s,
                               const Step& a, bool early) {
  if (early) return launch_early(kernel, blocks, s, a);
  kernel<<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <class L>
int shard_users(const Step& a, int mode, bool early, cudaStream_t s) {
  constexpr int kRows = kWarps * L::kRowsPerWarp;
  const int blocks = (a.U + kRows - 1) / kRows;
  const bool pairs = mode == kMean || mode == kSum;
  return static_cast<int>(
      pairs ? launch_step_kernel(sgd_user_kernel<L, true, true>, blocks, s,
                                 a, early)
            : launch_step_kernel(sgd_user_kernel<L, false, true>, blocks, s,
                                 a, early));
}

template <class L>
int shard_items(const Step& a, int mode, bool early, cudaStream_t s,
                int* ws) {
  constexpr int kRows = kWarps * L::kRowsPerWarp;
  const int blocks = (a.I + kRows - 1) / kRows;
  cudaError_t e;
  if (mode == kMean || mode == kSum) {
    const Runs r = runs_in(ws, a.U, a.I);
    e = mode == kMean ? launch_runs<L, true, true>(a, r, s)
                      : launch_runs<L, false, true>(a, r, s);
  } else if (mode == kFirstWins) {
    e = launch_step_kernel(sgd_item_kernel<L, 0, true>, blocks, s, a, early);
  } else {
    e = launch_step_kernel(sgd_item_kernel<L, 1, true>, blocks, s, a, early);
  }
  return static_cast<int>(e);
}

// The fields of a Step that the user and item calls share.
Step shard_step(const void* T_u, const void* T_i, int U, int I, int F,
                float mu, float lr, unsigned k0, unsigned k1, unsigned it,
                int start_user, int user_offset, int item_offset,
                int n_users_global, int mode, int* ws, int* counts) {
  Step a = {};
  a.T_u = T_u;
  a.T_i = T_i;
  a.U = U;
  a.I = I;
  a.F = F;
  a.mu = mu;
  a.lr = lr;
  a.k0 = k0;
  a.k1 = k1;
  a.it = it;
  a.start_user = start_user;
  a.user_offset = user_offset;
  a.item_offset = item_offset;
  a.n_users_global = n_users_global;
  if (mode == kMean || mode == kSum) {
    const Runs r = runs_in(ws, U, I);
    int* users = ws + kCtrlInts + 2 * static_cast<size_t>(scan_tiles(I));
    a.pair_item = users;
    a.pair_err = reinterpret_cast<float*>(users + U);
    a.slot = users + 2 * static_cast<size_t>(U);
    a.counts = counts;
    a.ctrl = r.ctrl;
    a.n_ctrl = kCtrlInts + 2 * scan_tiles(I);
  }
  return a;
}

bool bad_mode(int mode, int* ws, int* counts) {
  const bool pairs = mode == kMean || mode == kSum;
  return mode < kUsersOnly || mode > kSum || mode == kTwinLean ||
         (pairs && (ws == nullptr || counts == nullptr));
}

}  // namespace

extern "C" {

// Ints of workspace a shard's mean/sum step over U users and I items needs.
long long sgd_shard_workspace(int U, int I) { return workspace_ints(U, I); }

// out (n, W) of the table type: each row's sampled entry's `table` row
// where this shard owns it, zero elsewhere (see assemble_rows_kernel).
int sgd_shard_assemble(const int* indptr, const int* ids, int n,
                       unsigned id_offset, int own_offset, int n_own,
                       const void* table, void* out, int W, int elem,
                       unsigned k0, unsigned k1, unsigned it, void* stream) {
  if (n <= 0 || n_own <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_row(W, elem, [&](auto layout) {
    using L = decltype(layout);
    constexpr int kRows = kWarps * L::kRowsPerWarp;
    assemble_rows_kernel<L><<<(n + kRows - 1) / kRows, kThreads, 0, s>>>(
        indptr, ids, n, id_offset, own_offset, n_own, table, out, k0, k1,
        it);
    return static_cast<int>(cudaGetLastError());
  });
}

// The shard's user kernel: T_u (U, W) → T_u_out; rows (U, W) the sampled
// items' rows assembled over ip, or null at ip = 1 (then T_i holds every
// item).  mode as sgd_step_launch's (2 excluded); best (I int32, all
// kSentinel) and w_rating (U floats) for first_wins, ws and counts for
// mean/sum as there.  early: launched to overlap the kernel before it.
int sgd_shard_users(const void* T_u, void* T_u_out, const void* T_i,
                    const void* rows, const int* indptr, const int* indices,
                    const float* data, int* best, float* w_rating, int* ws,
                    int* counts, int U, int I, int W, int F, float mu,
                    float lr, float reg_p, float reg_ub, unsigned k0,
                    unsigned k1, unsigned it, int start_user,
                    int user_offset, int item_offset, int n_users_global,
                    int mode, int elem, int early, void* stream) {
  if (U <= 0 || I <= 0 || W <= F || F < 0 || n_users_global <= 0 ||
      bad_mode(mode, ws, counts) || (mode == kFirstWins && best == nullptr))
    return cudaErrorInvalidValue;
  Step a = shard_step(T_u, T_i, U, I, F, mu, lr, k0, k1, it, start_user,
                      user_offset, item_offset, n_users_global, mode, ws,
                      counts);
  a.T_u_out = T_u_out;
  a.indptr = indptr;
  a.indices = indices;
  a.data = data;
  a.rows = rows;
  a.reg_p = reg_p;
  a.reg_ub = reg_ub;
  if (mode == kFirstWins) {
    a.best = best;
    a.w_rating = w_rating;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_row(W, elem, [&](auto layout) {
    return shard_users<decltype(layout)>(a, mode, early != 0, s);
  });
}

// The shard's item side, after the user kernel (and the collectives that
// follow it): first_wins (best reduced over dp) and mean/sum write the
// deltas dT (I, W) float32, twin writes T_i_out, its raters' rows from
// raters (I, W) assembled over dp, or at dp = 1 from T_u.  denom (mean):
// each item's pairs over the grid, or null at dp = 1.
int sgd_shard_items(const void* T_u, const void* T_i, void* T_i_out,
                    float* dT, const void* raters, const int* it_indptr,
                    const int* it_users, const float* it_vals, int* best,
                    float* w_rating, int* ws, int* counts, const int* denom,
                    int U, int I, int W, int F, float mu, float lr,
                    float reg_q, float reg_ib, unsigned k0, unsigned k1,
                    unsigned it, int start_user, int user_offset,
                    int item_offset, int n_users_global, int mode, int elem,
                    int early, void* stream) {
  if (U <= 0 || I <= 0 || W <= F || F < 0 || n_users_global <= 0 ||
      mode < kFirstWins || bad_mode(mode, ws, counts) ||
      (mode == kFirstWins && (best == nullptr || w_rating == nullptr)) ||
      (mode == kTwinMirror && (T_i_out == nullptr || it_indptr == nullptr)) ||
      (mode != kTwinMirror && dT == nullptr))
    return cudaErrorInvalidValue;
  Step a = shard_step(T_u, T_i, U, I, F, mu, lr, k0, k1, it, start_user,
                      user_offset, item_offset, n_users_global, mode, ws,
                      counts);
  a.T_i_out = T_i_out;
  a.dT = dT;
  a.raters = raters;
  a.it_indptr = it_indptr;
  a.it_users = it_users;
  a.it_vals = it_vals;
  a.best = best;
  a.w_rating = w_rating;
  a.denom = denom;
  a.reg_q = reg_q;
  a.reg_ib = reg_ib;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_row(W, elem, [&](auto layout) {
    return shard_items<decltype(layout)>(a, mode, early != 0, s, ws);
  });
}

// T_i_out = T_i + dT over n entries, rounded once to the table type.
int sgd_shard_apply(const void* T_i, const float* dT, void* T_i_out,
                    long long n, int elem, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (n + 2047) / 2048;  // about 8 entries a thread
  const int blocks = want < 65535 ? static_cast<int>(want) : 65535;
  if (elem == kFloat32)
    apply_delta_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(T_i), dT, static_cast<float*>(T_i_out), n);
  else if (elem == kBfloat16)
    apply_delta_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(T_i), dT,
        static_cast<__nv_bfloat16*>(T_i_out), n);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
