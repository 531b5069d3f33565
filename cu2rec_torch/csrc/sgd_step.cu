// K0a — one SGD iteration over the packed factor tables, on one device:
// the C interface over the kernels of sgd_step.cuh (its header says what
// they compute, what bounds them and how they overlap).
#include "sgd_step.cuh"

extern "C" {

int sgd_step_max_width() { return kMaxWidth; }

// Ints of workspace a mean/sum step over U users and I items needs.
long long sgd_step_workspace(int U, int I) { return workspace_ints(U, I); }

// One step.  Tables (rows, W) of one element type (elem: 0 float32,
// 1 bf16), contiguous and 16-byte aligned, W one of 64, 128, 256, 384,
// 512; index arrays int32.  mode: -1 users only (items frozen),
// 0 first_wins, 1 twin mirror, 2 twin lean, 3 mean, 4 sum.  `best` (I
// int32, all kSentinel on entry, left so on exit) and `w_rating` (U
// floats) are used by mode 0 only; the item-major arrays by modes 1-2;
// `ws` (sgd_step_workspace(U, I) ints) and `counts` (I int32, all zero on
// entry, left so on exit) by modes 3-4.  Launches on `stream`; returns the
// cudaError_t of the launches.
int sgd_step_launch(const void* T_u, void* T_u_out, const void* T_i,
                    void* T_i_out, const int* indptr, const int* indices,
                    const float* data, const int* row_ids,
                    const int* it_indptr, const int* it_users,
                    const float* it_vals, const int* it_order, int* best,
                    float* w_rating, int* ws, int* counts, int U, int I,
                    int W, int F, float mu, float lr, float reg_p,
                    float reg_q, float reg_ub, float reg_ib, unsigned k0,
                    unsigned k1, unsigned it, int start_user, int mode,
                    int elem, void* stream) {
  const bool pairs = mode == kMean || mode == kSum;
  if (U <= 0 || I <= 0 || W <= F || F < 0 || mode < kUsersOnly ||
      mode > kSum || (pairs && (ws == nullptr || counts == nullptr)))
    return cudaErrorInvalidValue;
  Step a{T_u, T_u_out, T_i, T_i_out, indptr, indices, data, row_ids,
         it_indptr, it_users, it_vals, it_order,
         mode == kFirstWins ? best : nullptr, w_rating};
  a.U = U;
  a.I = I;
  a.F = F;
  a.mu = mu;
  a.lr = lr;
  a.reg_p = reg_p;
  a.reg_q = reg_q;
  a.reg_ub = reg_ub;
  a.reg_ib = reg_ib;
  a.k0 = k0;
  a.k1 = k1;
  a.it = it;
  a.start_user = start_user;
  if (pairs) {
    const Runs r = runs_in(ws, U, I);
    int* users = ws + kCtrlInts + 2 * static_cast<size_t>(scan_tiles(I));
    a.pair_item = users;
    a.pair_err = reinterpret_cast<float*>(users + U);
    a.slot = users + 2 * static_cast<size_t>(U);
    a.counts = counts;
    a.ctrl = r.ctrl;
    a.n_ctrl = kCtrlInts + 2 * scan_tiles(I);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_row(W, elem, [&](auto layout) {
    return launch_step<decltype(layout)>(a, mode, s, ws);
  });
}

// The runs of a mean/sum step alone: the step's sampling at iteration `it`
// from the user-major arrays, the counts and the run offsets (`offs`, I + 1
// int32: item i's run is users[offs[i], offs[i+1])), and each run's users
// in the order the item side adds them (`users`, U int32; the first
// offs[I] written).  `counts` as for sgd_step_launch, `ws` of
// sgd_step_workspace(U, I) ints.  Launches on `stream`.
int sgd_collision_runs(const int* indptr, const int* indices, int* counts,
                       int* ws, int* offs, int* users, int U, int I,
                       unsigned k0, unsigned k1, unsigned it, void* stream) {
  if (U <= 0 || I <= 0 || counts == nullptr || ws == nullptr ||
      offs == nullptr || users == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Runs r = runs_in(ws, U, I);
  r.offs = offs;
  Step a = {};
  a.indptr = indptr;
  a.indices = indices;
  int* pairs = ws + kCtrlInts + 2 * static_cast<size_t>(scan_tiles(I));
  a.pair_item = pairs;
  a.slot = pairs + 2 * static_cast<size_t>(U);
  a.counts = counts;
  a.ctrl = r.ctrl;
  a.n_ctrl = kCtrlInts + 2 * scan_tiles(I);
  a.U = U;
  a.I = I;
  a.k0 = k0;
  a.k1 = k1;
  a.it = it;
  const int blocks = (U + kPlaceThreads - 1) / kPlaceThreads;
  runs_sample_kernel<<<blocks, kPlaceThreads, 0, s>>>(a);
  run_offsets_kernel<<<scan_tiles(I), kScanThreads, 0, s>>>(counts, I, r);
  place_runs_kernel<<<blocks, kPlaceThreads, 0, s>>>(a.pair_item, a.slot, U,
                                                     I, r);
  constexpr int kRunsPerBlock = kWarps * (32 / kOrderG);
  runs_short_kernel<<<(I + kRunsPerBlock - 1) / kRunsPerBlock, kThreads, 0,
                      s>>>(r, I, users);
  r.ordered = users;
  return static_cast<int>(launch_order(r, U, s, false));
}

}  // extern "C"
