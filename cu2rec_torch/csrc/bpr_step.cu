// K6 — one BPR iteration over the packed factor tables, on one device, in
// one launch.
//
// Semantics: ops/bpr.py::bpr_step, the port's plain step, with the draws of
// ops/bpr.py::bpr_draws.  It replaces no Pallas kernel: the TPU package's
// ops/bpr.py::bpr_step is jnp that XLA fuses.  On the card the plain step
// was the five draw streams, each a chain of int64 emulations of the uint32
// hash, then three passes of row gathers and elementwise ops: about 400
// small launches a step, paced by the host's enqueue.
//
// One launch writes fresh T_u_out and T_i_out from the pre-step T_u and T_i.
// Every read is of the pre-step tables, so no row written is read by another
// row's work: no atomics and no second kernel.  A group of G lanes holds a
// row in the layout of packed_rows.cuh; warps [0, user_warps) take the
// users, the others the items, so that no warp mixes the two:
//   - user u: a positive i ~ rated(u) (stream `key`, id u) and a negative
//     j ~ Uniform(I) (fold_in(key, 1), id u); with x = p_u · (q_i − q_j) +
//     b_i − b_j the row moves by lr · (σ(−x) · (q_i − q_j) − reg ⊙ p_u);
//   - item y: the positive update from a rater w ~ raters(y) (`key`, id
//     U + y) against a negative j ~ Uniform(I) (fold_in(key, 2), id U + y),
//     with the item's regularisation, then the negative update from a user
//     v ~ Uniform(U) (fold_in(key, 3), id U + I + y) and v's positive
//     i ~ rated(v) (fold_in(key, 4), id 2U + y), added in the plain step's
//     order, (T_i + pos) + neg.
// A user with nothing rated keeps its row.  An item with no rater takes no
// positive update (nor its regularisation), and one whose drawn user has
// nothing rated no negative update: the plain step's masks.
//
// Bit-exact draws: the host passes the five streams' keys (the seed's key
// and fold_in(key, 1..4), computed once a key) and the iteration; each lane
// computes K0a's draw_u01 / draw_offset (sgd_step.cuh) in uint32, so every
// sampled id is the one bpr_draws gives, a uniform id as its float32
// product truncated and clamped to n − 1.  The table arithmetic is float32
// (bf16 rows upcast on load, rounded once on store), σ(−x) = 1 / (1 + e^x);
// the sums of a row run in another order than the plain step's.
//
// What bounds it: memory bytes.  A step reads and writes both tables once,
// gathers two item rows a user and two user rows and two item rows an item,
// and reads a few int32 words of the ratings a row: at ML-20M, F = 50 (U =
// 138,493, I = 26,744, W = 64) about 86 MB, 0.026 ms at 3.35 TB/s.  The item
// table (6.8 MB) and much of the user table (35 MB) stay in the 50 MB L2,
// so the gathers are mostly L2 hits.  The design moves each table row once,
// in float4 registers, with the draws and every intermediate in registers;
// a row's loads that depend on the hash alone (its own row, the uniform
// negative's, the uniform user's) are issued before those behind an index
// load, so that the chains of a warp's rows overlap.
#include "sgd_step.cuh"

namespace {

constexpr int kBprWarps = 4;
constexpr int kBprThreads = 32 * kBprWarps;
// At least four blocks an SM: at most 128 registers a thread, for an item
// row's five rows in flight.
constexpr int kBprMinBlocks = 4;

// The step's arguments, by value.  key[2s], key[2s + 1]: stream s's words,
// s = 0 the seed's key, s = 1..4 fold_in(key, s).
struct Bpr {
  const void* T_u;
  void* T_u_out;
  const void* T_i;
  void* T_i_out;
  const int* indptr;
  const int* indices;
  const int* row_ids;
  const int* it_indptr;
  const int* it_users;  // the item-major mirror's users, or null (lean)
  const int* it_order;  // lean: the item-major → flat permutation, or null
  int U, I, F, user_warps;
  float lr, reg_p, reg_q, reg_ub, reg_ib;
  uint32_t key[10];
  uint32_t it;
};

// Stream s's sampled id in [0, n) (n > 0) for draw id `id`.
__device__ __forceinline__ int draw_id(const Bpr& a, int s, uint32_t id,
                                       int n) {
  return draw_offset(draw_u01(a.key[2 * s], a.key[2 * s + 1], a.it, id), n);
}

// σ(−x), as the plain step's torch.sigmoid(-x).
__device__ __forceinline__ float sigmoid_neg(float x) {
  return 1.f / (1.f + expf(x));
}

// One column's share of  Σ_{c<F} s[c]·(p[c] − n[c]) + p[F] − n[F]:  row s's
// score of row p less its score of row n, p's and n's bias columns
// included (s's own bias column meets the 0 of the other rows' hats).
__device__ __forceinline__ float diff_term(float s, float p, float n, int c,
                                           int F) {
  return c < F ? s * (p - n) : (c == F ? p - n : 0.f);
}

template <class L>
__device__ __forceinline__ float diff_dot(const float4 (&s)[L::V],
                                          const float4 (&p)[L::V],
                                          const float4 (&n)[L::V], int gl,
                                          int F) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < L::V; ++k) {
    const int c = L::col(gl, k);
    acc += diff_term(s[k].x, p[k].x, n[k].x, c, F) +
           diff_term(s[k].y, p[k].y, n[k].y, c + 1, F) +
           diff_term(s[k].z, p[k].z, n[k].z, c + 2, F) +
           diff_term(s[k].w, p[k].w, n[k].w, c + 3, F);
  }
  return acc;
}

// One column of a user's row:  s + lr · (e · (p − n) − reg ⊙ s),  the
// hat's bias column 1 − 1 = 0, the padding unchanged.
__device__ __forceinline__ float user_col(const Bpr& a, float s, float p,
                                          float n, int c, float e) {
  if (c < a.F) return s + a.lr * (e * (p - n) - a.reg_p * s);
  if (c == a.F) return s + a.lr * (-(a.reg_ub * s));
  return s;
}

// One column of an item's row:  (s + pos) + neg,  pos = lr · (ep · ŵ −
// reg ⊙ s) where the item has a rater (hy), neg = en · v̂ where its drawn
// user has a positive (hv); ŵ, v̂ the rows' hats (1 at the bias column),
// en = −lr · σ(−x_neg).
__device__ __forceinline__ float item_col(const Bpr& a, float s, float w,
                                          float v, int c, bool hy, float ep,
                                          bool hv, float en) {
  if (c > a.F) return s;
  const bool f = c < a.F;
  float t = s;
  if (hy) t = s + a.lr * (ep * (f ? w : 1.f) - (f ? a.reg_q : a.reg_ib) * s);
  if (hv) t = t + en * (f ? v : 1.f);
  return t;
}

template <class L>
__device__ __forceinline__ void zero_row(float4 (&x)[L::V]) {
#pragma unroll
  for (int k = 0; k < L::V; ++k) x[k] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <class L>
__device__ __forceinline__ void user_row(const Bpr& a, int u, int gl,
                                         int lane) {
  constexpr int G = L::G, W = L::kWidth;
  const int start = __ldg(a.indptr + u);
  const int len = __ldg(a.indptr + u + 1) - start;
  const uint32_t id = static_cast<uint32_t>(u);
  float4 x[L::V], tj[L::V], ti[L::V];
  load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_u, u), gl, W - 1, x);
  load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_i, draw_id(a, 1, id, a.I)), gl,
                               a.F, tj);
  if (len > 0) {
    const int i = __ldg(a.indices + start + draw_id(a, 0, id, len));
    load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_i, i), gl, a.F, ti);
    const float e = sigmoid_neg(group_sum<G>(diff_dot<L>(x, ti, tj, gl, a.F),
                                             group_mask<G>(lane)));
#pragma unroll
    for (int k = 0; k < L::V; ++k) {
      const int c = L::col(gl, k);
      x[k] = make_float4(user_col(a, x[k].x, ti[k].x, tj[k].x, c, e),
                         user_col(a, x[k].y, ti[k].y, tj[k].y, c + 1, e),
                         user_col(a, x[k].z, ti[k].z, tj[k].z, c + 2, e),
                         user_col(a, x[k].w, ti[k].w, tj[k].w, c + 3, e));
    }
  }
  store_row<L>(row_ptr<L>(a.T_u_out, u), gl, x);
}

template <class L>
__device__ __forceinline__ void item_row(const Bpr& a, int y, int gl,
                                         int lane) {
  constexpr int G = L::G, W = L::kWidth;
  const uint32_t U = static_cast<uint32_t>(a.U);
  const uint32_t I = static_cast<uint32_t>(a.I);
  const uint32_t id = static_cast<uint32_t>(y);
  const int ys = __ldg(a.it_indptr + y);
  const int ylen = __ldg(a.it_indptr + y + 1) - ys;
  const int v = draw_id(a, 3, U + I + id, a.U);
  const int vs = __ldg(a.indptr + v);
  const int vlen = __ldg(a.indptr + v + 1) - vs;
  float4 x[L::V], tj[L::V], vr[L::V], wr[L::V], ti[L::V];
  // What the hash alone gives: the own row, the negative's, the user v's.
  load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_i, y), gl, W - 1, x);
  load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_i, draw_id(a, 2, U + id, a.I)),
                               gl, a.F, tj);
  load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_u, v), gl, a.F, vr);
  const bool hy = ylen > 0, hv = vlen > 0;
  if (hy) {
    const int pos = ys + draw_id(a, 0, U + id, ylen);
    const int w = a.it_order != nullptr
                      ? __ldg(a.row_ids + __ldg(a.it_order + pos))
                      : __ldg(a.it_users + pos);
    load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_u, w), gl, a.F, wr);
  } else {
    zero_row<L>(wr);
  }
  if (hv) {
    const int i = __ldg(a.indices + vs + draw_id(a, 4, 2 * U + id, vlen));
    load_row<L, Read::kReadOnly>(row_ptr<L>(a.T_i, i), gl, a.F, ti);
  } else {
    zero_row<L>(ti);
  }
  const unsigned mask = group_mask<G>(lane);
  float ep = 0.f, en = 0.f;
  if (hy) ep = sigmoid_neg(group_sum<G>(diff_dot<L>(wr, x, tj, gl, a.F), mask));
  if (hv)
    en = (-a.lr) *
         sigmoid_neg(group_sum<G>(diff_dot<L>(vr, ti, x, gl, a.F), mask));
#pragma unroll
  for (int k = 0; k < L::V; ++k) {
    const int c = L::col(gl, k);
    x[k] = make_float4(
        item_col(a, x[k].x, wr[k].x, vr[k].x, c, hy, ep, hv, en),
        item_col(a, x[k].y, wr[k].y, vr[k].y, c + 1, hy, ep, hv, en),
        item_col(a, x[k].z, wr[k].z, vr[k].z, c + 2, hy, ep, hv, en),
        item_col(a, x[k].w, wr[k].w, vr[k].w, c + 3, hy, ep, hv, en));
  }
  store_row<L>(row_ptr<L>(a.T_i_out, y), gl, x);
}

template <class L>
__global__ void __launch_bounds__(kBprThreads, kBprMinBlocks)
bpr_step_kernel(const Bpr a) {
  constexpr int NG = L::kRowsPerWarp;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (L::G - 1);
  const int g = lane / L::G;
  const int warp = blockIdx.x * kBprWarps + (threadIdx.x >> 5);
  if (warp < a.user_warps) {
    const int u = warp * NG + g;
    if (u < a.U) user_row<L>(a, u, gl, lane);
  } else {
    const int y = (warp - a.user_warps) * NG + g;
    if (y < a.I) item_row<L>(a, y, gl, lane);
  }
}

template <class L>
int launch_bpr(Bpr a, cudaStream_t s) {
  constexpr int NG = L::kRowsPerWarp;
  a.user_warps = (a.U + NG - 1) / NG;
  const long long warps =
      static_cast<long long>(a.user_warps) + (a.I + NG - 1) / NG;
  const unsigned blocks =
      static_cast<unsigned>((warps + kBprWarps - 1) / kBprWarps);
  bpr_step_kernel<L><<<blocks, kBprThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One step.  Tables (rows, W) of one element type (elem: 0 float32, 1 bf16),
// contiguous and 16-byte aligned, W one of 64, 128, 256, 384, 512; T_u_out
// and T_i_out are written whole and alias neither input.  The ratings'
// arrays are int32: indptr (U + 1), indices, it_indptr (I + 1), and either
// it_users (the item-major mirror) or, lean, it_order with row_ids.  k0..k9:
// the words of the seed's key and of fold_in(key, 1..4), in that order;
// `it` the iteration mod 2^32.  Launches on `stream`; returns the
// cudaError_t of the launch.
int bpr_step_launch(const void* T_u, void* T_u_out, const void* T_i,
                    void* T_i_out, const int* indptr, const int* indices,
                    const int* row_ids, const int* it_indptr,
                    const int* it_users, const int* it_order, int U, int I,
                    int W, int F, float lr, float reg_p, float reg_q,
                    float reg_ub, float reg_ib, unsigned k0, unsigned k1,
                    unsigned k2, unsigned k3, unsigned k4, unsigned k5,
                    unsigned k6, unsigned k7, unsigned k8, unsigned k9,
                    unsigned it, int elem, void* stream) {
  const bool lean = it_order != nullptr && row_ids != nullptr;
  if (U <= 0 || I <= 0 || F < 0 || F >= W || indptr == nullptr ||
      indices == nullptr || it_indptr == nullptr ||
      (!lean && it_users == nullptr))
    return cudaErrorInvalidValue;
  Bpr a{T_u, T_u_out, T_i, T_i_out, indptr, indices, row_ids, it_indptr,
        lean ? nullptr : it_users, lean ? it_order : nullptr};
  a.U = U;
  a.I = I;
  a.F = F;
  a.lr = lr;
  a.reg_p = reg_p;
  a.reg_q = reg_q;
  a.reg_ub = reg_ub;
  a.reg_ib = reg_ib;
  const unsigned k[10] = {k0, k1, k2, k3, k4, k5, k6, k7, k8, k9};
  for (int t = 0; t < 10; ++t) a.key[t] = k[t];
  a.it = it;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_row(W, elem, [&](auto layout) {
    return launch_bpr<decltype(layout)>(a, s);
  });
}

}  // extern "C"
