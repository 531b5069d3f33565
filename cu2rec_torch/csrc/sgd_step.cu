// K0a — one SGD iteration over the packed factor tables, on Hopper.
//
// Semantics: the TPU package's ops/packed.py::packed_step, the body of its
// packed_run_steps loop.  That step has no Pallas kernel there: XLA fuses its
// jnp ops.  Here it is two launches on one stream:
//   1. the user kernel, one warp per user: draw the counter-hash position in
//      the user's CSR slice, gather the sampled item's packed row, compute the
//      prediction and error, and write the user's updated row; under
//      first_wins, also atomicMin the user's rotated priority into best[item]
//      and store the sampled rating for the item side;
//   2. the item kernel, one warp per item (only when items train): find the
//      item's partner (the election winner, recovered by inverting the
//      rotated priority, or under twin the item's own sampled rater, drawn
//      from the item-major arrays on the stream offset by the user count),
//      and update the item row from the partner's pre-step row.
//
// Read-before-write: each side reads the other side's pre-step table.  The
// user kernel writes its rows into a second buffer (T_u_out), so the item
// kernel still reads the pre-step T_u; the item kernel also writes into a
// second buffer (T_i_out), which keeps the step functional like its plain
// version.  The wrapper allocates both; the caching allocator recycles the
// previous step's tables, so the double buffer costs no allocation.
//
// Bit-exact sampling: the hash runs in native uint32 and the position is
// min((int)(u01 * (float)len), len - 1) with __fmul_rn, so no contraction or
// fast-math can move it (the library is built without --use_fast_math).
// The table arithmetic may contract into FMAs: it agrees with the plain
// version within a float32 rounding per step.
//
// What bounds it: memory bytes.  A step reads and writes T_u (2·U·W·4 B)
// and T_i (2·I·W·4 B), gathers one item row per user and one partner row per
// item, and reads a few int32/float words per row of the sampling arrays:
// about 200 MB at U = 138,000, I = 27,000, W = 128, or ~0.06 ms at
// 3.35 TB/s.  One warp per row reads each 512-byte row as four coalesced
// 128-byte lines and keeps the row in registers between the dot product and
// the update, so each row is read once.  The item rows gathered by the user
// kernel (14 MB table) stay in the 50 MB L2.  Later work: persistent warps
// and a CUDA graph over the step loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunks = 16;  // rows of up to 512 floats, in registers
constexpr int kSentinel = 0x7fffffff;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
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

__device__ __forceinline__ void copy_row(const float* __restrict__ src,
                                         float* __restrict__ dst, int W,
                                         int lane) {
  for (int c = lane; c < W; c += 32) dst[c] = src[c];
}

// Row `self` (length W) updated towards `other`:
//   self += lr · (err · ô − reg ⊙ self),  ô = [other[:F], 1, 0…]
// where err = rating − (mu + Σ self·ô' + b), with ô' the same hat of the
// row whose bias stands at column F of `bias_row`.  `self_is_user` picks
// which of the two rows the prediction's hat is taken of, so that the sums
// run in the order of the plain version.
__device__ __forceinline__ void update_row(
    const float* __restrict__ self, const float* __restrict__ other,
    float* __restrict__ out, float rating, int W, int F, float mu, float lr,
    float reg_f, float reg_b, int lane, bool self_is_user) {
  float xs[kMaxChunks], xo[kMaxChunks];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int c = lane + 32 * k;
    xs[k] = 0.f;
    xo[k] = 0.f;
    if (c < W) {
      xs[k] = self[c];
      xo[k] = other[c];
      // pred = mu + Σ(row_u · î) + row_i[F], î = [row_i[:F], 1, 0…]
      const float u = self_is_user ? xs[k] : xo[k];
      const float i = self_is_user ? xo[k] : xs[k];
      acc += u * (c < F ? i : (c == F ? 1.f : 0.f));
    }
  }
  acc = warp_sum(acc);
  const float b_item = self_is_user ? other[F] : self[F];
  const float err = rating - (mu + acc + b_item);
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int c = lane + 32 * k;
    if (c < W) {
      const float hat = c < F ? xo[k] : (c == F ? 1.f : 0.f);
      const float reg = c < F ? reg_f : (c == F ? reg_b : 0.f);
      out[c] = xs[k] + lr * (err * hat - reg * xs[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sgd_user_kernel(const float* __restrict__ T_u, float* __restrict__ T_u_out,
                const float* __restrict__ T_i,
                const int* __restrict__ indptr,
                const int* __restrict__ indices,
                const float* __restrict__ data, int* __restrict__ best,
                float* __restrict__ w_rating, int U, int W, int F, float mu,
                float lr, float reg_f, float reg_b, uint32_t k0, uint32_t k1,
                uint32_t it, int start_user) {
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (u >= U) return;
  const float* ru = T_u + static_cast<size_t>(u) * W;
  float* out = T_u_out + static_cast<size_t>(u) * W;
  const int start = indptr[u];
  const int len = indptr[u + 1] - start;
  if (len <= 0) {
    copy_row(ru, out, W, lane);
    return;
  }
  const int pos = start + draw_offset(
      draw_u01(k0, k1, it, static_cast<uint32_t>(u)), len);
  const int item = indices[pos];
  const float rating = data[pos];
  update_row(ru, T_i + static_cast<size_t>(item) * W, out, rating, W, F, mu,
             lr, reg_f, reg_b, lane, true);
  if (best != nullptr && lane == 0) {
    int prio = u - start_user;
    if (prio < 0) prio += U;
    atomicMin(best + item, prio);
    w_rating[u] = rating;
  }
}

// kMode: 0 first_wins (election), 1 twin with the item-major mirror,
// 2 twin lean (through the item-major → flat permutation).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
sgd_item_kernel(const float* __restrict__ T_u, const float* __restrict__ T_i,
                float* __restrict__ T_i_out, int* __restrict__ best,
                const float* __restrict__ w_rating,
                const int* __restrict__ it_indptr,
                const int* __restrict__ it_users,
                const float* __restrict__ it_vals,
                const int* __restrict__ it_order,
                const int* __restrict__ row_ids,
                const float* __restrict__ data, int U, int I, int W, int F,
                float mu, float lr, float reg_f, float reg_b, uint32_t k0,
                uint32_t k1, uint32_t it, int start_user, int n_users) {
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= I) return;
  const float* ri = T_i + static_cast<size_t>(i) * W;
  float* out = T_i_out + static_cast<size_t>(i) * W;
  int partner = 0;
  float rating = 0.f;
  bool has;
  if (kMode == 0) {
    int b = kSentinel;
    if (lane == 0) {
      b = best[i];
      if (b != kSentinel) best[i] = kSentinel;  // ready for the next step
    }
    b = __shfl_sync(0xffffffffu, b, 0);
    has = b != kSentinel;
    if (has) {
      partner = b + start_user;
      if (partner >= U) partner -= U;
      rating = w_rating[partner];
    }
  } else {
    const int start = it_indptr[i];
    const int len = it_indptr[i + 1] - start;
    has = len > 0;
    if (has) {
      const int pos = start + draw_offset(
          draw_u01(k0, k1, it, static_cast<uint32_t>(i + n_users)), len);
      if (kMode == 1) {
        partner = it_users[pos];
        rating = it_vals[pos];
      } else {
        const int q = it_order[pos];
        partner = row_ids[q];
        rating = data[q];
      }
    }
  }
  if (!has) {
    copy_row(ri, out, W, lane);
    return;
  }
  update_row(ri, T_u + static_cast<size_t>(partner) * W, out, rating, W, F,
             mu, lr, reg_f, reg_b, lane, false);
}

}  // namespace

extern "C" {

int sgd_step_max_width() { return 32 * kMaxChunks; }

// One step.  Tables (rows, W) float32 contiguous; index arrays int32.
// mode: -1 users only (items frozen), 0 first_wins, 1 twin mirror, 2 twin
// lean.  `best` (I int32, all kSentinel on entry, left so on exit) and
// `w_rating` (U floats) are used by mode 0 only; the item-major arrays by
// modes 1-2.  Launches on `stream`; returns the cudaError_t of the launches.
int sgd_step_launch(const float* T_u, float* T_u_out, const float* T_i,
                    float* T_i_out, const int* indptr, const int* indices,
                    const float* data, const int* row_ids,
                    const int* it_indptr, const int* it_users,
                    const float* it_vals, const int* it_order, int* best,
                    float* w_rating, int U, int I, int W, int F, float mu,
                    float lr, float reg_p, float reg_q, float reg_ub,
                    float reg_ib, unsigned k0, unsigned k1, unsigned it,
                    int start_user, int mode, void* stream) {
  if (U <= 0 || I <= 0 || W <= F || W > 32 * kMaxChunks || mode < -1 ||
      mode > 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ublocks = (U + kWarps - 1) / kWarps;
  sgd_user_kernel<<<ublocks, kThreads, 0, s>>>(
      T_u, T_u_out, T_i, indptr, indices, data, mode == 0 ? best : nullptr,
      w_rating, U, W, F, mu, lr, reg_p, reg_ub, k0, k1, it, start_user);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || mode < 0) return static_cast<int>(e);
  const int iblocks = (I + kWarps - 1) / kWarps;
  if (mode == 0)
    sgd_item_kernel<0><<<iblocks, kThreads, 0, s>>>(
        T_u, T_i, T_i_out, best, w_rating, it_indptr, it_users, it_vals,
        it_order, row_ids, data, U, I, W, F, mu, lr, reg_q, reg_ib, k0, k1,
        it, start_user, U);
  else if (mode == 1)
    sgd_item_kernel<1><<<iblocks, kThreads, 0, s>>>(
        T_u, T_i, T_i_out, best, w_rating, it_indptr, it_users, it_vals,
        it_order, row_ids, data, U, I, W, F, mu, lr, reg_q, reg_ib, k0, k1,
        it, start_user, U);
  else
    sgd_item_kernel<2><<<iblocks, kThreads, 0, s>>>(
        T_u, T_i, T_i_out, best, w_rating, it_indptr, it_users, it_vals,
        it_order, row_ids, data, U, I, W, F, mu, lr, reg_q, reg_ib, k0, k1,
        it, start_user, U);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
