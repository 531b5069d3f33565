// K0c — the explicit serving fold-in, every iteration in one launch, on
// Hopper.
//
// Semantics: the TPU package's serve/engine.py::ShardedServingEngine.
// _foldin_program (its fori_loop body), which has no Pallas kernel there:
// XLA runs the loop as one device program.  The plain version is
// cu2rec_torch/serve/engine.py::fold_in_steps.  For n_steps iterations,
// each batch slot b with len[b] > 0 ratings draws position
//   p = min(floor(u · len), len − 1),  u = counter_uniform(key, t, b),
// reads the row table[index[b, p]] (float32 or bf16, as float32) and the
// rating vals[b, p], and takes one SGD step of its float32 user row
// towards that row with the item side frozen: K0a's user update
// (sgd_step.cuh: draw_u01, draw_offset, update_row), so the stream and
// the arithmetic are K0a's code.  A slot with len 0 is copied unchanged.
// The table is the catalog's packed item block (one shard: index holds
// item ids) or the (Bp·Dp, W) float32 rows the engine assembled once over
// the shards (index[b, d] = b·Dp + d).
//
// What bounds it: latency, not bytes.  A batch of 512 users × 32 ratings
// at W = 128 can sample about 8.4 MB of rows; its T_u, index and ratings
// are a few hundred KB more, ~3 µs of HBM at 3.35 TB/s.  But each slot's
// iterations form a chain: iteration t + 1 updates the row that t wrote,
// so a slot costs n_steps × (a row load's latency + the group's dot and
// update), whatever the batch.  The design shortens each link:
//   - the user row stays in float4 registers for all n_steps (read once,
//     written once), a group of G lanes a row in K0a's layout
//     (packed_rows.cuh; the table's layout, so a bf16 table's lanes hold
//     the float32 user row at the bf16 row's columns);
//   - the sampled positions do not depend on the rows, so each lane of a
//     group draws one of the next G iterations' positions and loads their
//     row ids and ratings together, a batch of G iterations ahead of use;
//     a shuffle hands each iteration its id and rating;
//   - a one-iteration register double buffer: iteration t + 1's row load
//     is issued before t's dot and update, so the update hides under the
//     load and each link costs about one load's latency.
// A block is one warp: a batch of Bp slots is Bp·G/32 warps (128 at
// Bp = 512, W = 128), and one-warp blocks spread them over as many SMs,
// each with its own L1 and load queue, where blocks of four warps would
// fill a quarter as many.  Deeper prefetch (rows of several iterations in
// flight, or cp.async into shared memory) is later work.
#include "sgd_step.cuh"

namespace {

constexpr int kFoldWarps = 1;  // warps a block (see the header)

// The float32 user row at layout L's columns (L is the table's layout).
template <class L>
__device__ __forceinline__ void load_user(const float* row, int gl,
                                          float4 (&x)[L::V]) {
#pragma unroll
  for (int k = 0; k < L::V; ++k)
    x[k] = __ldg(reinterpret_cast<const float4*>(row + L::col(gl, k)));
}

template <class L>
__device__ __forceinline__ void store_user(float* row, int gl,
                                           const float4 (&x)[L::V]) {
#pragma unroll
  for (int k = 0; k < L::V; ++k)
    *reinterpret_cast<float4*>(row + L::col(gl, k)) = x[k];
}

template <class L>
__global__ void __launch_bounds__(32 * kFoldWarps)
    foldin_kernel(const float* __restrict__ T_u, float* __restrict__ T_out,
                  const typename L::Elem* __restrict__ table,
                  const int* __restrict__ index,
                  const float* __restrict__ vals,
                  const int* __restrict__ lens, int Bp, int Dp, int F,
                  int n_steps, float mu, float lr, float reg_f, float reg_b,
                  uint32_t k0, uint32_t k1) {
  constexpr int G = L::G;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int b = (blockIdx.x * kFoldWarps + (threadIdx.x >> 5)) *
                    L::kRowsPerWarp + lane / G;
  if (b >= Bp) return;  // the whole group: b is the group's
  const unsigned mask = group_mask<G>(lane);
  const int base = lane & ~(G - 1);
  float4 s[L::V];
  load_user<L>(T_u + static_cast<size_t>(b) * L::kWidth, gl, s);
  const int len = __ldg(lens + b);
  if (len > 0 && n_steps > 0) {
    const int* ib = index + static_cast<size_t>(b) * Dp;
    const float* vb = vals + static_cast<size_t>(b) * Dp;
    // Lane gl's share of a batch: iteration t's row id and rating.
    auto sample = [&](int t, int& row, float& rating) {
      row = 0;
      rating = 0.f;
      if (t < n_steps) {
        const int p = draw_offset(draw_u01(k0, k1, static_cast<uint32_t>(t),
                                           static_cast<uint32_t>(b)),
                                  len);
        row = __ldg(ib + p);
        rating = __ldg(vb + p);
      }
    };
    int row_c, row_n;  // this batch's iterations [t0, t0 + G), the next's
    float r_c, r_n;
    sample(gl, row_c, r_c);
    sample(G + gl, row_n, r_n);
    float4 o[L::V], o_next[L::V];
    load_row<L, Read::kReadOnly>(
        row_ptr<L>(table, __shfl_sync(mask, row_c, base)), gl, F, o);
    for (int t = 0; t < n_steps; ++t) {
      const int j = t & (G - 1);
      const float rating = __shfl_sync(mask, r_c, base + j);
      if (t + 1 < n_steps) {
        const int next = j + 1 < G ? __shfl_sync(mask, row_c, base + j + 1)
                                   : __shfl_sync(mask, row_n, base);
        load_row<L, Read::kReadOnly>(row_ptr<L>(table, next), gl, F, o_next);
      }
      update_row<L>(s, o, rating, gl, lane, F, mu, lr, reg_f, reg_b);
      if (t + 1 < n_steps) {
#pragma unroll
        for (int k = 0; k < L::V; ++k) o[k] = o_next[k];
      }
      if (j == G - 1) {
        row_c = row_n;
        r_c = r_n;
        sample(t + 1 + G + gl, row_n, r_n);
      }
    }
  }
  store_user<L>(T_out + static_cast<size_t>(b) * L::kWidth, gl, s);
}

template <class L>
int launch_foldin(const float* T_u, float* T_out, const void* table,
                  const int* index, const float* vals, const int* lens,
                  int Bp, int Dp, int F, int n_steps, float mu, float lr,
                  float reg_f, float reg_b, uint32_t k0, uint32_t k1,
                  cudaStream_t s) {
  constexpr int rows = kFoldWarps * L::kRowsPerWarp;
  foldin_kernel<L><<<(Bp + rows - 1) / rows, 32 * kFoldWarps, 0, s>>>(
      T_u, T_out, static_cast<const typename L::Elem*>(table), index, vals,
      lens, Bp, Dp, F, n_steps, mu, lr, reg_f, reg_b, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The whole fold-in: T_out = n_steps iterations of T_u (Bp, W) float32
// against `table` (rows of W, elem 0 float32 or 1 bf16), slot b sampling
// table[index[b, p]] and vals[b, p] for p < lens[b] (index, vals (Bp, Dp)
// int32 / float32; lens (Bp,) int32 in [0, Dp]).  W one of 64, 128, 256,
// 384, 512; both tables 16-byte aligned.  Launches on `stream`; returns
// the cudaError_t of the launch.
int foldin_launch(const float* T_u, float* T_out, const void* table,
                  const int* index, const float* vals, const int* lens,
                  int Bp, int Dp, int W, int F, int n_steps, int elem,
                  float mu, float lr, float reg_f, float reg_b, unsigned k0,
                  unsigned k1, void* stream) {
  if (Bp <= 0 || Dp <= 0 || F < 0 || F >= W || n_steps < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_row(W, elem, [&](auto layout) {
    return launch_foldin<decltype(layout)>(T_u, T_out, table, index, vals,
                                           lens, Bp, Dp, F, n_steps, mu, lr,
                                           reg_f, reg_b, k0, k1, s);
  });
}

}  // extern "C"
