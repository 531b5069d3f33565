// Packed rows in float4 registers: the layout K0a (sgd_step.cu) and K0b
// (eval_error.cu) share, for float32 and bf16 tables.
//
// A packed row of W values, [factors(F) | bias | 0-pad], is held by a group
// of G lanes of one warp.  Each lane reads V16 sixteen-byte words of the
// row, lane l of the group taking the words l, l + G, …, l + (V16 − 1)·G,
// so the group's lanes read neighbouring words and a warp holds 32 / G rows
// at once, each with its loads in flight.  Whatever the table stores, a
// lane holds its share of the row as V float4 registers, and all arithmetic
// is float32.  G is a power of two, fixed at compile time for each width
// that ops/packed.py::packed_width gives and each element type:
//
//   float32: a word is 4 floats, one float4 register
//   W    64  128  256  384  512
//   G     4    8   16   32   32     lanes a row
//   V     4    4    4    3    4     words (= float4s) a lane
//
//   bf16: a word is 8 bf16, unpacked into two float4 registers
//   W    64  128  256  384  512
//   G     4    8   16   16   32     lanes a row
//   V16   2    2    2    3    2     words a lane (V = 2 · V16 float4s)
//
// A bf16 row is loaded, unpacked to float32 (__bfloat1622float2, exact) and
// stored back rounded to nearest even (__floats2bfloat162_rn): the
// astype(float32) … astype(bfloat16) of the TPU package's packed step.
//
// The prediction of a (user, item) pair is symmetric in the two rows:
//   pred = mu + Σ_{c<F} u[c]·i[c] + u[F] + i[F]
// (each row's bias meets the 1 at column F of the other row's hat), so one
// dot serves both sides of the step and the eval.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// RowLayout<W, float> or RowLayout<W, __nv_bfloat16>.
template <int W, typename T = float>
struct RowLayout;

template <int W>
struct RowLayout<W, float> {
  static_assert(W == 64 || W == 128 || W == 256 || W == 384 || W == 512,
                "a width packed_width gives for F < 512");
  using Elem = float;
  static constexpr bool kBf16 = false;
  static constexpr int kWidth = W;
  static constexpr int G = W >= 384 ? 32 : W / 16;  // lanes a row
  static constexpr int V16 = W / (4 * G);           // words a lane
  static constexpr int V = V16;                     // float4s a lane
  static constexpr int kRowsPerWarp = 32 / G;
  // The first column of float4 register k of lane gl.
  static __device__ __forceinline__ int col(int gl, int k) {
    return 4 * (gl + G * k);
  }
};

template <int W>
struct RowLayout<W, __nv_bfloat16> {
  static_assert(W == 64 || W == 128 || W == 256 || W == 384 || W == 512,
                "a width packed_width gives for F < 512");
  using Elem = __nv_bfloat16;
  static constexpr bool kBf16 = true;
  static constexpr int kWidth = W;
  static constexpr int G = W >= 512 ? 32 : (W == 384 ? 16 : W / 16);
  static constexpr int V16 = W / (8 * G);
  static constexpr int V = 2 * V16;
  static constexpr int kRowsPerWarp = 32 / G;
  static __device__ __forceinline__ int col(int gl, int k) {
    return 8 * (gl + G * (k >> 1)) + 4 * (k & 1);
  }
};

// Table element types: 0 float32, 1 bf16 (the `elem` of the C interfaces).
enum ElemType { kFloat32 = 0, kBfloat16 = 1 };

template <int W, typename Fn>
int dispatch_elem(int elem, Fn&& fn) {
  if (elem == kFloat32) return fn(RowLayout<W, float>());
  if (elem == kBfloat16) return fn(RowLayout<W, __nv_bfloat16>());
  return static_cast<int>(cudaErrorInvalidValue);
}

// fn(RowLayout<w, T>()) for the runtime width w and element type elem, or
// cudaErrorInvalidValue for a width or type the kernels do not take.
template <typename Fn>
int dispatch_row(int w, int elem, Fn&& fn) {
  switch (w) {
    case 64: return dispatch_elem<64>(elem, fn);
    case 128: return dispatch_elem<128>(elem, fn);
    case 256: return dispatch_elem<256>(elem, fn);
    case 384: return dispatch_elem<384>(elem, fn);
    case 512: return dispatch_elem<512>(elem, fn);
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

template <Read kRead, typename V4>
__device__ __forceinline__ V4 read16(const V4* p) {
  if constexpr (kRead == Read::kReadOnly)
    return __ldg(p);
  else if constexpr (kRead == Read::kStream)
    return __ldcs(p);
  else
    return __ldcg(p);
}

// Two bf16 in one 32-bit word (the lower address in the low half) as float2.
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  __nv_bfloat162 h;
  static_assert(sizeof(h) == sizeof(w), "two bf16 a word");
  memcpy(&h, &w, sizeof(w));
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t float2_to_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t w;
  memcpy(&w, &h, sizeof(w));
  return w;
}

// x rounded to the table type, as float32: what storing it and loading it
// back gives.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// A bf16 row's words as loaded, before unpacking: lane `gl`'s words that
// hold a column <= last (the others are zero).  Half the registers of the
// unpacked row, so that more rows can be in flight.
template <class L, Read kRead>
__device__ __forceinline__ void load_words(const typename L::Elem* row,
                                           int gl, int last,
                                           uint4 (&w)[L::V16]) {
  static_assert(L::kBf16, "packed words are bf16 rows");
  const uint4* p = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < L::V16; ++k) {
    const int q = gl + L::G * k;
    w[k] = 8 * q <= last ? read16<kRead>(p + q) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <class L>
__device__ __forceinline__ void unpack_words(const uint4 (&w)[L::V16],
                                             float4 (&x)[L::V]) {
#pragma unroll
  for (int k = 0; k < L::V16; ++k) {
    const float2 a = bf16x2_to_float2(w[k].x), b = bf16x2_to_float2(w[k].y);
    const float2 c = bf16x2_to_float2(w[k].z), d = bf16x2_to_float2(w[k].w);
    x[2 * k] = make_float4(a.x, a.y, b.x, b.y);
    x[2 * k + 1] = make_float4(c.x, c.y, d.x, d.y);
  }
}

// Lane `gl`'s float4s of `row` that hold a column <= last (the others are
// zero): last = F reads the factors and the bias, last = W − 1 the row.
template <class L, Read kRead>
__device__ __forceinline__ void load_row(const typename L::Elem* row, int gl,
                                         int last, float4 (&x)[L::V]) {
  constexpr int G = L::G;
  if constexpr (!L::kBf16) {
    const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int k = 0; k < L::V; ++k) {
      const int q = gl + G * k;
      x[k] = 4 * q <= last ? read16<kRead>(p + q)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    uint4 w[L::V16];
    load_words<L, kRead>(row, gl, last, w);
    unpack_words<L>(w, x);
  }
}

template <class L>
__device__ __forceinline__ void store_row(typename L::Elem* row, int gl,
                                          const float4 (&x)[L::V]) {
  if constexpr (!L::kBf16) {
    float4* p = reinterpret_cast<float4*>(row);
#pragma unroll
    for (int k = 0; k < L::V; ++k) p[gl + L::G * k] = x[k];
  } else {
    uint4* p = reinterpret_cast<uint4*>(row);
#pragma unroll
    for (int k = 0; k < L::V16; ++k) {
      const float4 a = x[2 * k], b = x[2 * k + 1];
      p[gl + L::G * k] =
          make_uint4(float2_to_bf16x2(a.x, a.y), float2_to_bf16x2(a.z, a.w),
                     float2_to_bf16x2(b.x, b.y), float2_to_bf16x2(b.z, b.w));
    }
  }
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
template <class L>
__device__ __forceinline__ float row_dot(const float4 (&a)[L::V],
                                         const float4 (&b)[L::V], int gl,
                                         int F) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < L::V; ++k)
    acc += pred_part(a[k], b[k], L::col(gl, k), F);
  return acc;
}
