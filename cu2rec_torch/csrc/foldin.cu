// K0c — the explicit serving fold-in, every iteration in one launch, on
// Hopper.
//
// Semantics: the TPU package's serve/engine.py::ShardedServingEngine.
// _foldin_program (its fori_loop body) after the host compaction of its
// fold_in_padded; neither has a Pallas kernel there: XLA runs the loop as
// one device program.  The plain version is cu2rec_torch/serve/engine.py::
// fold_in_steps.  The request arrives as it was sent: (Bp, Dp) item ids,
// ratings and a mask, holes allowed.  Slot b's valid positions are its
// mask's set columns in order (the stable compaction), len[b] of them.
// For n_steps iterations each slot with len > 0 draws position
//   p = min(floor(u · len), len − 1),  u = counter_uniform(key, t, b)
// (K0a's draw_u01 / draw_offset, sgd_step.cuh), reads the row
// table[index[b, c]] (float32 or bf16, as float32) and the rating
// vals[b, c] at the column c of its p-th valid position, and takes one SGD
// step of its float32 user row towards that row with the item side frozen:
//   pred = mu + Σ s·ô + o[F],  ô = o·fm + bm,
//   s   += lr · (err · ô − reg ⊙ s),  err = rating − pred,
// fm the factor mask, bm the bias column, reg = reg_f·fm + reg_b·bm (the
// plain version's factor, biascol and reg_u, ops/packed.py::_reg_vectors).
// A slot with len 0 is copied unchanged.  The table is the catalog's
// packed item block (one shard: index holds item ids) or the (Bp·Dp, W)
// float32 rows the engine assembled once over the shards (index[b, d] =
// b·Dp + d).
//
// What bounds it: latency, not bytes.  A batch of 512 users × 32 ratings
// at W = 128 samples about 4.7 MB, ~1.4 µs of HBM at 3.35 TB/s.  But each
// slot's iterations form a chain (iteration t + 1 updates the row t wrote),
// so the launch takes n_steps links of a slot's chain, whatever the
// batch.  The design keeps the link to the dot, the group's sum and the
// update, and moves everything else off it:
//   - a group of G lanes holds a slot's user row in float4 registers for
//     all n_steps, each lane V float4s of the table's packed layout
//     (packed_rows.cuh: lane gl takes the row's 16-byte words gl + G·k);
//   - the masks fm, bm and reg are each lane's float4 constants, worked
//     out before the loop, so the dot is straight multiply-adds into four
//     partial sums and the update two multiply-adds a column, with no
//     compare on F and no divergence in the group;
//   - rows of kStages iterations are in flight (16; 8 where G = 8): a
//     ring of kStages rows a slot in shared memory (16 rows are ~2 µs
//     ahead at ~0.12 µs a link, past an HBM round trip for a row L2 has
//     not kept), each lane filling its own words with 16-byte cp.async
//     (the words past column F zero-filled, no bytes read) and waiting
//     only for the stage the next iteration needs; a lane reads back only
//     the words it copied, so the group never synchronises.
//     Row t + 1 is read from the ring and its ô worked out while row t's
//     dot is summed across the group;
//   - the draws, the column search and the id and rating loads run a
//     batch of G iterations at a time, each lane one iteration, two
//     batches ahead of use, so their loads are never waited on in a link;
//     a shuffle hands each iteration its id and rating.
// The compaction: before the loop each group reads its slot's mask row, a
// ballot a G columns, and writes a table of (32 mask bits, set bits
// before them) a 32-column word into shared memory; position p is found
// by a binary search of that table and a popcount select in its word
// (one word, no search, where Dp ≤ 32).
// A block is one warp: the batch's Bp·G/32 warps spread over the SMs.  G,
// the lanes a row, is the widest of 8, 16 and 32 that fits the row
// (fold_lanes): a wider group has fewer multiply-adds a lane and one
// shuffle level more a doubling, and more warps an SM.  At G = 32, W = 128
// an iteration is 65 instructions and its dependent path 16 of them, five
// of them the shuffles of the group's sum, which pace the link (~0.12 µs
// on an H100).
#include "sgd_step.cuh"

namespace {

// The shared memory a block may have (H100: 227 KB).
constexpr size_t kMaxSmem = 232448;
// The most float4s a lane holds of a row (each held seven times over: the
// user row, three masks, two rows of the ring and the row as read).
constexpr int kMaxV = 6;

// K0a's packed row (packed_rows.cuh) over G lanes of one warp: a row of W
// elements of T is kWords 16-byte words; lane gl holds the words gl + G·k,
// k < V16, as V float4s (a bf16 word unpacks into two).
template <int W, typename T, int kG>
struct FoldLayout {
  using Elem = T;
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kWidth = W;
  static constexpr int kRowBytes = W * static_cast<int>(sizeof(T));
  static constexpr int kWords = kRowBytes / 16;
  static constexpr int kColsPerWord = 16 / static_cast<int>(sizeof(T));
  static constexpr int G = kG;
  static constexpr int V16 = kWords / G;
  static constexpr int V = kBf16 ? 2 * V16 : V16;
  static constexpr int kRowsPerWarp = 32 / G;
  // Rows of a slot's iterations in flight: the ring's stages (≤ G, so that
  // the two batches of draws in hand name every row the ring is to fetch).
  static constexpr int kStages = G < 16 ? G : 16;
  static_assert(kWords % G == 0 && V16 >= 1, "G lanes share a row's words");
  // The first column of float4 register k of lane gl.
  static __device__ __forceinline__ int col(int gl, int k) {
    if constexpr (kBf16)
      return 8 * (gl + G * (k >> 1)) + 4 * (k & 1);
    else
      return 4 * (gl + G * k);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// The slot's mask row m (Dp bytes) as nw words of (bits, set bits before
// them) in tab; returns the slot's valid count.  Every lane of the group
// calls it; lane 0 writes the table.
template <int G>
__device__ __forceinline__ int compact_slot(const unsigned char* m, int Dp,
                                            int nw, uint2* tab, int gl,
                                            unsigned gmask, int base) {
  constexpr unsigned kLow = G == 32 ? ~0u : (1u << G) - 1u;
  int len = 0;
  for (int w = 0; w < nw; ++w) {
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < 32 / G; ++j) {
      const int c = 32 * w + G * j + gl;
      const bool on = c < Dp && __ldg(m + c) != 0;
      bits |= ((__ballot_sync(gmask, on) >> base) & kLow) << (G * j);
    }
    if (gl == 0) tab[w] = make_uint2(bits, static_cast<unsigned>(len));
    len += __popc(bits);
  }
  __syncwarp(gmask);
  return len;
}

// The bit of x with k set bits below it (k < popc(x)).
__device__ __forceinline__ int nth_set_bit(uint32_t x, int k) {
  int pos = 0;
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) {
    const int below = __popc(x & ((1u << h) - 1u));
    const bool up = k >= below;
    k -= up ? below : 0;
    x = up ? x >> h : x;
    pos += up ? h : 0;
  }
  return pos;
}

// The column of valid position p: the last word with fewer than p + 1 set
// bits before it, then the bit in that word.
__device__ __forceinline__ int valid_column(const uint2* tab, int nw, int p) {
  int lo = 0;
  for (int n = nw; n > 1;) {
    const int half = n >> 1;
    if (static_cast<int>(tab[lo + half].y) <= p) {
      lo += half;
      n -= half;
    } else {
      n = half;
    }
  }
  const uint2 e = tab[lo];
  return 32 * lo + nth_set_bit(e.x, p - static_cast<int>(e.y));
}

// Lane gl's words of row `id` into a ring stage: the words that hold a
// column <= F when `live`, zeros otherwise (no bytes read).
template <class L>
__device__ __forceinline__ void fetch_row(unsigned char* stage,
                                          const typename L::Elem* table,
                                          int id, bool live, int gl, int F) {
  const unsigned char* row = reinterpret_cast<const unsigned char*>(
      table + static_cast<size_t>(id) * L::kWidth);
#pragma unroll
  for (int k = 0; k < L::V16; ++k) {
    const int q = gl + L::G * k;
    cp_async16(stage + 16 * q, row + 16 * q,
               live && q * L::kColsPerWord <= F ? 16 : 0);
  }
}

// Lane gl's ô = o·fm + bm of the row in a ring stage; returns its share
// of o[F] (o·bm).
template <class L>
__device__ __forceinline__ float read_row(const unsigned char* stage, int gl,
                                          const float4 (&fm)[L::V],
                                          const float4 (&bm)[L::V],
                                          float4 (&oh)[L::V]) {
  float4 o[L::V];
  if constexpr (L::kBf16) {
    uint4 w[L::V16];
#pragma unroll
    for (int k = 0; k < L::V16; ++k)
      w[k] = *reinterpret_cast<const uint4*>(stage + 16 * (gl + L::G * k));
    unpack_words<L>(w, o);
  } else {
#pragma unroll
    for (int k = 0; k < L::V; ++k)
      o[k] = *reinterpret_cast<const float4*>(stage + 16 * (gl + L::G * k));
  }
  float ob = 0.f;
#pragma unroll
  for (int k = 0; k < L::V; ++k) {
    oh[k] = make_float4(fmaf(o[k].x, fm[k].x, bm[k].x),
                        fmaf(o[k].y, fm[k].y, bm[k].y),
                        fmaf(o[k].z, fm[k].z, bm[k].z),
                        fmaf(o[k].w, fm[k].w, bm[k].w));
    ob = fmaf(o[k].x, bm[k].x, ob);
    ob = fmaf(o[k].y, bm[k].y, ob);
    ob = fmaf(o[k].z, bm[k].z, ob);
    ob = fmaf(o[k].w, bm[k].w, ob);
  }
  return ob;
}

template <class L>
__global__ void __launch_bounds__(32, 1)
    foldin_kernel(const float* __restrict__ T_u, float* __restrict__ T_out,
                  const typename L::Elem* __restrict__ table,
                  const int* __restrict__ index,
                  const float* __restrict__ vals,
                  const unsigned char* __restrict__ valid, int Bp, int Dp,
                  int F, int n_steps, float mu, float lr, float reg_f,
                  float reg_b, uint32_t k0, uint32_t k1) {
  constexpr int G = L::G, V = L::V, R = L::kRowsPerWarp;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int gl = lane & (G - 1), slot = lane / G;
  const int b = blockIdx.x * R + slot;
  if (b >= Bp) return;  // the whole group: b is the group's
  const unsigned gmask = group_mask<G>(lane);
  const int base = lane & ~(G - 1);
  const int nw = (Dp + 31) >> 5;
  unsigned char* ring = smem + slot * kStages * L::kRowBytes;
  uint2* tab =
      reinterpret_cast<uint2*>(smem + R * kStages * L::kRowBytes) + slot * nw;

  float4 s[V];
  load_user<L>(T_u + static_cast<size_t>(b) * L::kWidth, gl, s);
  const int len = compact_slot<G>(valid + static_cast<size_t>(b) * Dp, Dp,
                                  nw, tab, gl, gmask, base);
  if (len > 0 && n_steps > 0) {
    float4 fm[V], bm[V], rg[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = L::col(gl, k);
      float f[4], h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[e] = c + e < F ? 1.f : 0.f;
        h[e] = c + e == F ? 1.f : 0.f;
      }
      fm[k] = make_float4(f[0], f[1], f[2], f[3]);
      bm[k] = make_float4(h[0], h[1], h[2], h[3]);
      rg[k] = make_float4(reg_f * f[0] + reg_b * h[0],
                          reg_f * f[1] + reg_b * h[1],
                          reg_f * f[2] + reg_b * h[2],
                          reg_f * f[3] + reg_b * h[3]);
    }
    const int* ib = index + static_cast<size_t>(b) * Dp;
    const float* vb = vals + static_cast<size_t>(b) * Dp;
    // Lane gl's share of a batch: iteration t's row id and rating.
    auto draw = [&](int t, int& id, float& rating) {
      id = 0;
      rating = 0.f;
      if (t < n_steps) {
        const int p = draw_offset(draw_u01(k0, k1, static_cast<uint32_t>(t),
                                           static_cast<uint32_t>(b)),
                                  len);
        const int c = valid_column(tab, nw, p);
        id = __ldg(ib + c);
        rating = __ldg(vb + c);
      }
    };
    // Batches n, n + 1, n + 2 of G iterations (n the current one).
    int id0, id1, id2;
    float r0, r1, r2;
    draw(gl, id0, r0);
    draw(G + gl, id1, r1);
    draw(2 * G + gl, id2, r2);
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      fetch_row<L>(ring + i * L::kRowBytes, table,
                   __shfl_sync(gmask, id0, base + i), i < n_steps, gl, F);
      cp_async_commit();
    }
    float4 oh[V];
    cp_async_wait<kStages - 1>();
    float ob = read_row<L>(ring, gl, fm, bm, oh);
    for (int t0 = 0; t0 < n_steps; t0 += G) {
      const int nj = min(G, n_steps - t0);
#pragma unroll 2
      for (int j = 0; j < nj; ++j) {
        const int t = t0 + j;
        // The link: the dot into four partial sums, the group's sum, the
        // error and the update.
        float a0 = ob, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a0 = fmaf(s[k].x, oh[k].x, a0);
          a1 = fmaf(s[k].y, oh[k].y, a1);
          a2 = fmaf(s[k].z, oh[k].z, a2);
          a3 = fmaf(s[k].w, oh[k].w, a3);
        }
        const float dot = group_sum<G>((a0 + a1) + (a2 + a3), gmask);
        const float rating = __shfl_sync(gmask, r0, base + j);
        // Off the link: row t + 1's ô while the sum crosses the group.
        float4 on[V];
        cp_async_wait<kStages - 2>();
        const float obn = read_row<L>(
            ring + ((t + 1) & (kStages - 1)) * L::kRowBytes, gl, fm, bm, on);
        const float err = (rating - mu) - dot;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s[k].x = fmaf(lr, fmaf(err, oh[k].x, -rg[k].x * s[k].x), s[k].x);
          s[k].y = fmaf(lr, fmaf(err, oh[k].y, -rg[k].y * s[k].y), s[k].y);
          s[k].z = fmaf(lr, fmaf(err, oh[k].z, -rg[k].z * s[k].z), s[k].z);
          s[k].w = fmaf(lr, fmaf(err, oh[k].w, -rg[k].w * s[k].w), s[k].w);
        }
        // Row t + kStages into the stage row t held (read an iteration
        // ago, its values used above).
        const int ahead = j + kStages;
        const int id = __shfl_sync(gmask, ahead < G ? id0 : id1,
                                   base + (ahead & (G - 1)));
        fetch_row<L>(ring + (t & (kStages - 1)) * L::kRowBytes, table, id,
                     t + kStages < n_steps, gl, F);
        cp_async_commit();
#pragma unroll
        for (int k = 0; k < V; ++k) oh[k] = on[k];
        ob = obn;
      }
      id0 = id1;
      r0 = r1;
      id1 = id2;
      r1 = r2;
      draw(t0 + 3 * G + gl, id2, r2);
    }
    cp_async_wait<0>();
  }
  store_user<L>(T_out + static_cast<size_t>(b) * L::kWidth, gl, s);
}

template <class L>
int launch_foldin(const float* T_u, float* T_out, const void* table,
                  const int* index, const float* vals,
                  const unsigned char* valid, int Bp, int Dp, int F,
                  int n_steps, float mu, float lr, float reg_f, float reg_b,
                  uint32_t k0, uint32_t k1, cudaStream_t s) {
  constexpr int R = L::kRowsPerWarp;
  const size_t nw = (static_cast<size_t>(Dp) + 31) / 32;
  const size_t smem = static_cast<size_t>(R) * L::kStages * L::kRowBytes +
                      R * nw * sizeof(uint2);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        foldin_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  foldin_kernel<L><<<(Bp + R - 1) / R, 32, smem, s>>>(
      T_u, T_out, static_cast<const typename L::Elem*>(table), index, vals,
      valid, Bp, Dp, F, n_steps, mu, lr, reg_f, reg_b, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

// Whether g lanes can hold a row of `words` 16-byte words (`unpack`
// float4s a word): g divides the words and a lane holds at most kMaxV
// float4s.
constexpr bool lanes_fit(int words, int unpack, int g) {
  return words % g == 0 && words / g * unpack <= kMaxV;
}

// The widest group a build takes: 32 lanes a row.  Built with
// -DFOLDIN_MAX_LANES=8 or 16, the kernel takes narrower groups where they
// fit (experiments/foldin_times.py times them that way).
#ifndef FOLDIN_MAX_LANES
#define FOLDIN_MAX_LANES 32
#endif

// The lanes a row of W elements of T: the widest of 8, 16 and 32 that fits
// it, at most FOLDIN_MAX_LANES where a narrower one fits (at W = 128
// float32, 32 lanes were the fastest of the three on an H100: the fewest
// instructions a warp and the most warps an SM outweigh the shuffle level
// each doubling adds).
template <int W, typename T>
constexpr int fold_lanes() {
  constexpr int unpack = sizeof(T) == 2 ? 2 : 1;
  constexpr int words = W * static_cast<int>(sizeof(T)) / 16;
  int g = 0;
  for (int c = 8; c <= 32; c *= 2)
    if (lanes_fit(words, unpack, c) && (g == 0 || c <= FOLDIN_MAX_LANES))
      g = c;
  return g;
}

}  // namespace

extern "C" {

// The whole fold-in: T_out = n_steps iterations of T_u (Bp, W) float32
// against `table` (rows of W, elem 0 float32 or 1 bf16), slot b sampling
// table[index[b, c]] and vals[b, c] at the columns c where valid[b, c] is
// nonzero (index, vals (Bp, Dp) int32 / float32, valid (Bp, Dp) bytes, in
// the request's order).  W one of 64, 128, 256, 384, 512; both tables
// 16-byte aligned.  Launches on `stream`; returns the cudaError_t of the
// launch.
int foldin_launch(const float* T_u, float* T_out, const void* table,
                  const int* index, const float* vals,
                  const unsigned char* valid, int Bp, int Dp, int W, int F,
                  int n_steps, int elem, float mu, float lr, float reg_f,
                  float reg_b, unsigned k0, unsigned k1, void* stream) {
  if (Bp <= 0 || Dp <= 0 || F < 0 || F >= W || n_steps < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_row(W, elem, [&](auto row) {
    using RL = decltype(row);
    using T = typename RL::Elem;
    constexpr int g = fold_lanes<RL::kWidth, T>();
    static_assert(g > 0, "some group of lanes fits every row width");
    return launch_foldin<FoldLayout<RL::kWidth, T, g>>(
        T_u, T_out, table, index, vals, valid, Bp, Dp, F, n_steps, mu, lr,
        reg_f, reg_b, k0, k1, s);
  });
}

}  // extern "C"
