// Packed rows in float4 registers: the layout K0a (sgd_step.cu) and K0b
// (eval_error.cu) share.
//
// A packed row of W floats, [factors(F) | bias | 0-pad], is held by a group
// of G lanes of one warp.  Lane l of the group holds the float4s l, l + G,
// …, l + (V − 1)·G of the row, so the group's lanes read neighbouring
// 16-byte words and a warp holds 32 / G rows at once, each with its loads in
// flight.  G is a power of two, fixed at compile time for each width that
// ops/packed.py::packed_width gives:
//
//   W    64  128  256  384  512
//   G     4    8   16   32   32     lanes a row
//   V     4    4    4    3    4     float4s a lane
//
// The prediction of a (user, item) pair is symmetric in the two rows:
//   pred = mu + Σ_{c<F} u[c]·i[c] + u[F] + i[F]
// (each row's bias meets the 1 at column F of the other row's hat), so one
// dot serves both sides of the step and the eval.

#pragma once

#include <cuda_runtime.h>

template <int W>
struct RowLayout {
  static_assert(W == 64 || W == 128 || W == 256 || W == 384 || W == 512,
                "a width packed_width gives for F < 512");
  static constexpr int kWidth = W;
  static constexpr int G = W >= 384 ? 32 : W / 16;  // lanes a row
  static constexpr int V = W / (4 * G);             // float4s a lane
  static constexpr int kRowsPerWarp = 32 / G;
};

// fn(RowLayout<w>()) for the runtime width w, or cudaErrorInvalidValue
// for a width the kernels do not take.
template <typename Fn>
int dispatch_width(int w, Fn&& fn) {
  switch (w) {
    case 64: return fn(RowLayout<64>());
    case 128: return fn(RowLayout<128>());
    case 256: return fn(RowLayout<256>());
    case 384: return fn(RowLayout<384>());
    case 512: return fn(RowLayout<512>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The lanes of the group that `lane` belongs to.
template <int G>
__device__ __forceinline__ unsigned group_mask(int lane) {
  if constexpr (G == 32)
    return 0xffffffffu;
  else
    return ((1u << G) - 1u) << (lane & ~(G - 1));
}

// Sum over the G lanes of a group; every lane of the group gets it.
template <int G>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(mask, v, off);
  return v;
}

// How a row is read: kReadOnly through the read-only cache (__ldg: a table
// no kernel writes while this one runs); kStream once (__ldcs: evict first
// from L1 and L2); kL2 at L2 only (__ldcg: a table that an earlier kernel
// wrote while this one may already have been running, see sgd_step.cu).
enum class Read { kReadOnly, kStream, kL2 };

template <Read kRead>
__device__ __forceinline__ float4 read4(const float4* p) {
  if constexpr (kRead == Read::kReadOnly)
    return __ldg(p);
  else if constexpr (kRead == Read::kStream)
    return __ldcs(p);
  else
    return __ldcg(p);
}

// Lane `gl`'s float4s of `row` that hold a column <= last (the others are
// zero): last = F reads the factors and the bias, last = W − 1 the row.
template <int W, Read kRead>
__device__ __forceinline__ void load_row(
    const float* row, int gl, int last,
    float4 (&x)[RowLayout<W>::V]) {
  constexpr int G = RowLayout<W>::G;
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k < RowLayout<W>::V; ++k) {
    const int q = gl + G * k;
    x[k] = 4 * q <= last ? read4<kRead>(p + q)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* row, int gl,
                                          const float4 (&x)[RowLayout<W>::V]) {
  float4* p = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int k = 0; k < RowLayout<W>::V; ++k)
    p[gl + RowLayout<W>::G * k] = x[k];
}

// One column's share of the prediction (see the header).
__device__ __forceinline__ float pred_term(float a, float b, int c, int F) {
  return c < F ? a * b : (c == F ? a + b : 0.f);
}

// Σ pred_term over the float4s a, b at columns c … c + 3.  All but one
// float4 of a row hold factors only or padding only: they skip the
// per-column selects.
__device__ __forceinline__ float pred_part(float4 a, float4 b, int c, int F) {
  if (c + 3 < F) return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  if (c > F) return 0.f;
  return pred_term(a.x, b.x, c, F) + pred_term(a.y, b.y, c + 1, F) +
         pred_term(a.z, b.z, c + 2, F) + pred_term(a.w, b.w, c + 3, F);
}

// Lane `gl`'s share of Σ pred_term over the row: group_sum of it is
// pred − mu.
template <int W>
__device__ __forceinline__ float row_dot(const float4 (&a)[RowLayout<W>::V],
                                         const float4 (&b)[RowLayout<W>::V],
                                         int gl, int F) {
  constexpr int G = RowLayout<W>::G;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < RowLayout<W>::V; ++k)
    acc += pred_part(a[k], b[k], 4 * (gl + G * k), F);
  return acc;
}
