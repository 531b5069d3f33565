// K0b — Σerr² and Σ|err| over a set of ratings, on Hopper.
//
// Semantics: the TPU package's ops/loss.py::_eval_packed_jit (no Pallas
// kernel there: XLA fuses the gathers, the error and the reductions), over
// float32 or bf16 tables, whose rows are upcast as they load.  For
// rating r of user u and item i, with packed rows T_u[u], T_i[i],
//   pred = mu + Σ_c T_u[u][c] · î[c] + T_i[i][F],   î = [T_i[i][:F], 1, 0…]
//   err  = rating − pred   (float32)
// and the sums of err² and |err| are taken in float64.
//
// Work split.  A warp takes chunks of kChunk consecutive ratings: it loads
// the chunk's rows, cols and vals coalesced into shared memory (the next
// chunk's are fetched into registers while this one is worked on), and
// each group of G lanes (packed_rows.cuh) takes a run of kChunk · G / 32
// consecutive ratings of it, two at a time (four from bf16 rows, which a
// lane holds as loaded, in half the registers, until it reaches them).  So
// a warp has 2 · 32 / G item rows in flight, eight at W = 128 (sixteen in
// bf16), each lane reading its words of the F + 1 used columns.  A group
// keeps the user row in registers while the ratings of one user follow
// each other (the ratings come user-sorted), and reads it again only when
// the user changes; any order of the ratings
// gives the same sums, only slower.
//
// Deterministic: the chunks a warp takes and the order it sums them depend
// only on the rating count and the constants here.  Each group sums its
// ratings in order, the warp adds its groups' sums in a fixed tree, the
// block writes its warps' sums as one partial, and a second launch of one
// block adds the partials in a fixed order, so a run gives the same bits
// every time (the learning-rate plateau compares test RMSEs between eval
// points; a wobble must not flip a decay).
//
// What bounds it.  The HBM bytes the inputs need, 12 bytes a rating and the
// used columns of each table once (about 0.31 GB at 20,000,000 ratings and
// F = 100, ~0.09 ms at 3.35 TB/s), are not its practical floor: each
// rating gathers its item row, 4·(F + 1) bytes, through L2 (the item table,
// 14 MB at ML-20M scale, stays in the 50 MB L2), about 8 GB at 20,000,000
// ratings (half of that from bf16 rows).  That L2 gather traffic is the
// floor of a per-rating design; the design keeps enough of it in flight to
// stream at L2's rate.

#include <cuda_runtime.h>

#include "packed_rows.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;                 // ratings a warp stages at once
constexpr int kPerLane = kChunk / 32;      // of them, loaded by each lane
// 132 SMs × 8: whole waves on an H100 at 1, 2, 4 or 8 blocks an SM.
constexpr int kMaxBlocks = 132 * 8;

// A block's partial sums, the body of the two kernels below: they differ
// only in their register budgets.  (One template with its minimum blocks
// taken from L does not do: a minimum of one block an SM, stated, raises
// the float32 instances' registers, 88 -> 96 at W = 128, against none.)
template <class L>
__device__ __forceinline__ void eval_partials(
    const typename L::Elem* __restrict__ T_u,
    const typename L::Elem* __restrict__ T_i, const int* __restrict__ rows,
    const int* __restrict__ cols, const float* __restrict__ vals,
    long long n, int F, float mu, double* __restrict__ partials) {
  constexpr int G = L::G, V = L::V, W = L::kWidth;
  constexpr int kRun = kChunk / L::kRowsPerWarp;  // a group's ratings
  static_assert(kRun % 2 == 0, "ratings are taken two at a time");
  __shared__ int s_row[kWarps][kChunk];
  __shared__ int s_col[kWarps][kChunk];
  __shared__ float s_val[kWarps][kChunk];
  __shared__ double s_sum[2][kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int first = (lane / G) * kRun;
  const unsigned mask = group_mask<G>(lane);
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;

  // The chunk's ratings, kPerLane a lane; row −1 past the end.
  int nr[kPerLane], nc[kPerLane];
  float nv[kPerLane];
  auto fetch = [&](long long chunk) {
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const long long j = chunk * kChunk + lane + 32 * k;
      const bool ok = j < n;
      nr[k] = ok ? __ldcs(rows + j) : -1;
      nc[k] = ok ? __ldcs(cols + j) : 0;
      nv[k] = ok ? __ldcs(vals + j) : 0.f;
    }
  };

  double sse = 0.0, sae = 0.0;
  int cur = -1;  // the user whose row u holds
  float4 u[V];
#pragma unroll
  for (int k = 0; k < V; ++k) u[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  long long chunk = static_cast<long long>(blockIdx.x) * kWarps + warp;
  fetch(chunk);
  for (; chunk < n_chunks; chunk += stride) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      s_row[warp][lane + 32 * k] = nr[k];
      s_col[warp][lane + 32 * k] = nc[k];
      s_val[warp][lane + 32 * k] = nv[k];
    }
    __syncwarp();
    fetch(chunk + stride);
    if constexpr (L::kBf16) {
      // bf16: four item rows in flight, held as loaded (half the
      // registers of an unpacked row) and unpacked one at a time.
      static_assert(kRun % 4 == 0, "bf16 ratings are taken four at a time");
      for (int t = first; t < first + kRun; t += 4) {
        int r[4];
        uint4 w[4][L::V16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          r[j] = s_row[warp][t + j];
          load_words<L, Read::kReadOnly>(
              T_i + static_cast<size_t>(s_col[warp][t + j]) * W, gl,
              r[j] >= 0 ? F : -1, w[j]);
        }
        // Each lane's share of the four dots first, then the four group
        // sums side by side, so that their shuffles overlap.
        float d[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (r[j] >= 0 && r[j] != cur) {
            load_row<L, Read::kStream>(T_u + static_cast<size_t>(r[j]) * W,
                                       gl, F, u);
            cur = r[j];
          }
          float4 it[V];
          unpack_words<L>(w[j], it);
          d[j] = row_dot<L>(u, it, gl, F);
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            d[j] += __shfl_xor_sync(mask, d[j], off);
        }
        if (gl == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (r[j] < 0) continue;
            const double e =
                static_cast<double>(s_val[warp][t + j] - (mu + d[j]));
            sse += e * e;
            sae += fabs(e);
          }
        }
      }
      continue;
    }
    for (int t = first; t < first + kRun; t += 2) {
      const int ra = s_row[warp][t], rb = s_row[warp][t + 1];
      const float va = s_val[warp][t], vb = s_val[warp][t + 1];
      // Both item rows are in flight before the user row is needed.
      float4 ia[V], ib[V];
      load_row<L, Read::kReadOnly>(
          T_i + static_cast<size_t>(s_col[warp][t]) * W, gl,
          ra >= 0 ? F : -1, ia);
      load_row<L, Read::kReadOnly>(
          T_i + static_cast<size_t>(s_col[warp][t + 1]) * W, gl,
          rb >= 0 ? F : -1, ib);
      if (ra >= 0 && ra != cur) {
        load_row<L, Read::kStream>(T_u + static_cast<size_t>(ra) * W, gl,
                                   F, u);
        cur = ra;
      }
      const float da = group_sum<G>(row_dot<L>(u, ia, gl, F), mask);
      if (rb >= 0 && rb != cur) {
        load_row<L, Read::kStream>(T_u + static_cast<size_t>(rb) * W, gl,
                                   F, u);
        cur = rb;
      }
      const float db = group_sum<G>(row_dot<L>(u, ib, gl, F), mask);
      if (gl == 0) {
        if (ra >= 0) {
          const double e = static_cast<double>(va - (mu + da));
          sse += e * e;
          sae += fabs(e);
        }
        if (rb >= 0) {
          const double e = static_cast<double>(vb - (mu + db));
          sse += e * e;
          sae += fabs(e);
        }
      }
    }
  }
  // The group leaders' sums (the other lanes hold 0) in a fixed tree.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sse += __shfl_xor_sync(0xffffffffu, sse, off);
    sae += __shfl_xor_sync(0xffffffffu, sae, off);
  }
  if (lane == 0) {
    s_sum[0][warp] = sse;
    s_sum[1][warp] = sae;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      a += s_sum[0][w];
      b += s_sum[1][w];
    }
    partials[2 * blockIdx.x] = a;
    partials[2 * blockIdx.x + 1] = b;
  }
}

template <class L>
__global__ void __launch_bounds__(kThreads)
eval_partials_kernel(const typename L::Elem* __restrict__ T_u,
                     const typename L::Elem* __restrict__ T_i,
                     const int* __restrict__ rows,
                     const int* __restrict__ cols,
                     const float* __restrict__ vals, long long n, int F,
                     float mu, double* __restrict__ partials) {
  eval_partials<L>(T_u, T_i, rows, cols, vals, n, F, mu, partials);
}

// bf16 rows, held packed, leave room for a third block of warps an SM up
// to W = 256 (at most 85 registers a thread).
template <class L>
__global__ void __launch_bounds__(kThreads, L::kWidth <= 256 ? 3 : 2)
eval_packed_partials_kernel(const typename L::Elem* __restrict__ T_u,
                            const typename L::Elem* __restrict__ T_i,
                            const int* __restrict__ rows,
                            const int* __restrict__ cols,
                            const float* __restrict__ vals, long long n,
                            int F, float mu,
                            double* __restrict__ partials) {
  eval_partials<L>(T_u, T_i, rows, cols, vals, n, F, mu, partials);
}

// One block: thread t adds partials t, t + kThreads, … in order, then the
// block's sums are added in a fixed tree.
__global__ void __launch_bounds__(kThreads)
eval_finish_kernel(const double* __restrict__ partials, int n_blocks,
                   double* __restrict__ out) {
  __shared__ double s[2][kThreads];
  double a = 0.0, b = 0.0;
  for (int k = threadIdx.x; k < n_blocks; k += kThreads) {
    a += partials[2 * k];
    b += partials[2 * k + 1];
  }
  s[0][threadIdx.x] = a;
  s[1][threadIdx.x] = b;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      s[0][threadIdx.x] += s[0][threadIdx.x + half];
      s[1][threadIdx.x] += s[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = s[0][0];
    out[1] = s[1][0];
  }
}

int blocks_for(long long n) {
  const long long chunks = (n + kChunk - 1) / kChunk;
  const long long b = (chunks + kWarps - 1) / kWarps;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

extern "C" {

// Doubles of scratch the launch for n ratings needs.
int eval_error_partials(long long n) { return 2 * blocks_for(n); }

// T_u (·, W) and T_i (·, W) of one element type (elem: 0 float32, 1 bf16),
// 16-byte aligned, W one of 64, 128, 256, 384, 512; rows, cols int32 and
// vals float32, each of n entries; partials of eval_error_partials(n)
// doubles; out of 2 doubles (Σerr², Σ|err|).  Launches on `stream`;
// returns the cudaError_t.
int eval_error_launch(const void* T_u, const void* T_i, const int* rows,
                      const int* cols, const float* vals, long long n, int W,
                      int F, float mu, double* partials, double* out,
                      int elem, void* stream) {
  if (n < 0 || W <= F || F < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  const int rc = dispatch_row(W, elem, [&](auto layout) {
    using L = decltype(layout);
    using T = typename L::Elem;
    const T* tu = static_cast<const T*>(T_u);
    const T* ti = static_cast<const T*>(T_i);
    if constexpr (L::kBf16)
      eval_packed_partials_kernel<L><<<blocks, kThreads, 0, s>>>(
          tu, ti, rows, cols, vals, n, F, mu, partials);
    else
      eval_partials_kernel<L><<<blocks, kThreads, 0, s>>>(
          tu, ti, rows, cols, vals, n, F, mu, partials);
    return static_cast<int>(cudaGetLastError());
  });
  if (rc != cudaSuccess) return rc;
  eval_finish_kernel<<<1, kThreads, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
