// K0b — Σerr² and Σ|err| over a set of ratings, on Hopper.
//
// Semantics: the TPU package's ops/loss.py::_eval_packed_jit (no Pallas
// kernel there: XLA fuses the gathers, the error and the reductions).  For
// rating r of user u and item i, with packed rows T_u[u], T_i[i],
//   pred = mu + Σ_c T_u[u][c] · î[c] + T_i[i][F],   î = [T_i[i][:F], 1, 0…]
//   err  = rating − pred   (float32)
// and the sums of err² and |err| are taken in float64.
//
// Deterministic: each block writes its two partial sums into a buffer, and a
// second launch of one block adds the partials in a fixed order.  The grid
// depends only on the rating count, so a run gives the same bits every time
// (the learning-rate plateau compares test RMSEs between eval points; a
// wobble must not flip a decay).
//
// What bounds it: memory bytes.  It needs 12 bytes a rating (user id, item
// id, rating) and each table once: at 20,000,000 ratings and W = 128 about
// 0.33 GB, ~0.1 ms at 3.35 TB/s.  One warp per rating reads the F + 1 used
// columns of the two rows as coalesced lines; ratings are user-sorted, so
// consecutive warps share user rows, and the item table (14 MB at ML-20M
// scale) stays in L2.  The gathered rows still cross L2 once a rating, which
// is what this simple form spends above the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxBlocks = 4096;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
eval_partials_kernel(const float* __restrict__ T_u,
                     const float* __restrict__ T_i,
                     const int* __restrict__ rows,
                     const int* __restrict__ cols,
                     const float* __restrict__ vals, long long n, int W,
                     int F, float mu, double* __restrict__ partials) {
  __shared__ double s_sse[kWarps];
  __shared__ double s_sae[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  double sse = 0.0, sae = 0.0;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
       r < n; r += stride) {
    const float* ru = T_u + static_cast<size_t>(rows[r]) * W;
    const float* ri = T_i + static_cast<size_t>(cols[r]) * W;
    float acc = 0.f;
    for (int c = lane; c <= F; c += 32)
      acc += ru[c] * (c < F ? ri[c] : 1.f);
    acc = warp_sum(acc);
    if (lane == 0) {
      const double e = static_cast<double>(vals[r] - (mu + acc + ri[F]));
      sse += e * e;
      sae += fabs(e);
    }
  }
  if (lane == 0) {
    s_sse[warp] = sse;
    s_sae[warp] = sae;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = 0.0, b = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      a += s_sse[w];
      b += s_sae[w];
    }
    partials[2 * blockIdx.x] = a;
    partials[2 * blockIdx.x + 1] = b;
  }
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
  const long long b = (n + kWarps - 1) / kWarps;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

extern "C" {

// Doubles of scratch the launch for n ratings needs.
int eval_error_partials(long long n) { return 2 * blocks_for(n); }

// T_u (·, W) and T_i (·, W) float32; rows, cols int32 and vals float32, each
// of n entries; partials of eval_error_partials(n) doubles; out of 2 doubles
// (Σerr², Σ|err|).  Launches on `stream`; returns the cudaError_t.
int eval_error_launch(const float* T_u, const float* T_i, const int* rows,
                      const int* cols, const float* vals, long long n, int W,
                      int F, float mu, double* partials, double* out,
                      void* stream) {
  if (n < 0 || W <= F || F < 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  eval_partials_kernel<<<blocks, kThreads, 0, s>>>(T_u, T_i, rows, cols,
                                                   vals, n, W, F, mu,
                                                   partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  eval_finish_kernel<<<1, kThreads, 0, s>>>(partials, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
