// K4 — the ALS/iALS gather-Gram: each system's Gram and right-hand side
// built from its rated rows, gathered by id, on Hopper.
//
// Replaces no Pallas kernel.  It takes the semantics of the TPU package's
// fused chunk programs: ops/als.py::_solve_bucket_weighted and _solve_heavy
// (gather T_other[cols], X = [q | 1]·mask, y = (r − μ − b)·mask, then the
// einsums XᵀX and Xᵀy in float32) and ops/ials.py::_solve_ials_bucket and
// _solve_ials_heavy (Σ (α r m) q qᵀ and Σ (1 + α r) m q), which XLA runs as
// one device program a chunk.  Here the (B, D, N) design tensor never goes
// to device memory: the rows are gathered into shared memory and consumed
// there.
//
// For a system s of D slots (a row of a regular chunk or a segment of a
// heavy one) with the augmented left operand a_d = [w_d·x_d | r_d] and the
// right operand x_d (x_d the slot's N-column row, zero where masked):
//     ALS:  w_d = 1,        r_d = (v_d − μ − b_d)·m_d
//     iALS: w_d = α v_d m_d, r_d = (1 + α v_d)·m_d
// the lower triangle of Σ_d a_d x_dᵀ holds G (rows < N) and rhsᵀ (row N).
// ALS reads b_d from column N of the design row, so one gather brings
// both.  The plain version multiplies by the mask where this kernel reads
// a zero row, so the same inputs give the same result, a NaN under a
// masked slot included (NaN·0).
//
// What bounds it: at the headline width (N = 101) a slot costs 2·5,252
// flops of triangle and rhs (78 ns per thousand slots at 67 TFLOP/s) and
// 404 bytes of row if none repeats (121 ns at 3.35 TB/s), and each system
// writes its whole G, 40.8 KB: wide buckets are bound by the float32 FMA
// rate once rows repeat in L2, narrow ones by G's write.
//
// Design:
// - gather_gram_sums_kernel: the augmented triangle is cut into 8 × 8
//   tiles, one a thread (91 tiles, 96 threads at N = 101; 153 at N = 129),
//   each tile's 64 sums in registers (no spills: -Xptxas -v in the build
//   log).  Diagonal tiles compute their upper half too.  Past 160 tiles
//   (N > 129) the tiles are shared out over blockIdx.y, each block
//   gathering its own copy of the rows.
// - A work item is one part of a system's slots: at most 2,048 (one
//   float32 chain of a heavy segment's 8,192 terms drifts further from the
//   exact sum than four of 2,048 added in order); where a chunk has fewer
//   systems than twice the blocks the card holds, more parts of at least
//   256 slots, so that a heavy chunk of 81 segments still fills 132 SMs.
//   A block takes items blockIdx.x, blockIdx.x + gridDim.x, …
// - The slots are staged 32 at a time (fewer where D is smaller) into
//   shared memory by cp.async (16 bytes a copy; a slot's copies spread
//   over the block's threads; a masked slot zero-filled), double
//   buffered: the next stage, of this item or the next, is in flight
//   while this one is summed, and the ids, mask and values of the stage
//   after it are loaded into registers then too, so no thread waits on
//   them.  A staged row keeps each 8-column group split in halves, [0..3]
//   of every group then [4..7], so that the eight threads of a quarter
//   warp reading float4s of eight groups hit 32 banks.  For iALS a second
//   buffer holds w_d·x_d.
// - Each slot's terms are added in slot order with float32 FMAs, the parts
//   in part order: no atomics, so two runs give the same bits.  No TF32.
// - Epilogue: each thread adds a regular chunk's ridge to its tile in
//   registers (ALS: λ·max(deg, 1) on the diagonal; iALS: YᵀY + G, then λ
//   on the diagonal) and stores the tile, two float4s a row, into the
//   system's lower triangle in shared memory (`tri`, rows padded so that a
//   column read down 8 rows hits 8 banks); the block then writes G whole,
//   a warp a row, its lanes along the row (the lower triangle mirrored),
//   and rhs, coalesced.  A system of one part is written so by its own
//   block where `tri` beside the stages leaves as many blocks on an SM.
//   Otherwise (several parts, tiles over several blocks, or too little
//   shared memory) the sums go to a workspace, element-major (a warp's
//   stores coalesce), and gather_gram_finish_kernel adds the parts in
//   order, read coalesced by threads a tile each, into `tri` and writes
//   them the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTile = 8;          // a thread's tile: 8 × 8 sums
constexpr int kSums = kTile * kTile;
constexpr int kMaxThreads = 160;  // the tiles of N = 129 (153) in one block
constexpr int kSlots = 32;        // slots a stage at most
constexpr int kMinPart = 256;     // slots a part at least
constexpr int kMaxPart = 2048;    // slots a part at most (see the header)
constexpr int kFinishThreads = 384;      // the finish kernel's aim
constexpr int kFinishMaxThreads = 1024;  // its most: one set of 861 tiles
// Shared memory a block may take: the stages, or a system's `tri`
// (N ≤ 327).
constexpr size_t kMaxSmem = 227 * 1024;

struct GramArgs {
  const float* rows;          // (R, stride) float32, 16-byte aligned
  long long stride;           // floats between rows, a multiple of 4
  const long long* idx;       // (B, D) row ids, or null: row s·D + d
  const float* vals;          // (B, D)
  const unsigned char* mask;  // (B, D) bool
  const float* mu;            // ALS: the global mean, one float; null: iALS
  float alpha;                // iALS: the confidence scale
  const float* reg_vec;       // ALS regular chunk: (n,) ridge, or null
  const float* deg;           // ALS regular chunk: (B,) degrees
  const float* g_global;      // iALS regular chunk: (n, n) YᵀY, or null
  float reg;                  // iALS regular chunk: the ridge
  float* G;                   // (B, n, n)
  float* rhs;                 // (B, n)
  float* work;                // (B · parts, 64, tiles) sums, unless direct
  int B, D, n;
  int rw;                     // floats a staged row: 8 · row tiles
  int slots;                  // slots a stage: kSlots, or D rounded to 4
  int tiles;                  // tiles of the augmented lower triangle
  int parts, part_len;        // parts a system, slots a part
  int direct;                 // 1: the sums kernel writes G itself
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Where element e of a staged row lives: each 8-column group split into
// its halves, all first halves first.
__device__ __forceinline__ int split_pos(int e, int rw) {
  return ((e >> 2) & 1) * (rw >> 1) + (e >> 3) * 4 + (e & 3);
}

// Where a stage is: item w, its slots [d0, min(d0 + slots, hi)).
struct Cursor {
  int w, d0, hi;
};

__device__ __forceinline__ Cursor item_start(const GramArgs& a, int w) {
  const int d0 = (w % a.parts) * a.part_len;
  return {w, d0, min(a.D, d0 + a.part_len)};
}

// The next stage: of this item, or the first of the block's next one.
__device__ __forceinline__ Cursor advance(const GramArgs& a, Cursor c) {
  if (c.d0 + a.slots < c.hi) return {c.w, c.d0 + a.slots, c.hi};
  return item_start(a, c.w + gridDim.x);
}

// Slots a stage stages: those left, at most a.slots, rounded up to 4
// (slots past `hi` are zero rows of zero weight).
__device__ __forceinline__ int stage_slots(const GramArgs& a, Cursor c) {
  return min(a.slots, (c.hi - c.d0 + 3) & ~3);
}

// What this thread stages of a stage: one slot d (its id, mask and value,
// loaded together) and its share of the slot's 16-byte copies.
struct Meta {
  long long row;
  float v;
  int d, part, per;
  bool live, m;
};

__device__ __forceinline__ Meta meta_load(const GramArgs& a, Cursor c,
                                          int items) {
  Meta t{0, 0.f, 0, 0, 1, false, false};
  if (c.w >= items) return t;
  const int nd = stage_slots(a, c);
  if (nd == 0) return t;
  t.per = max(1, static_cast<int>(blockDim.x) / nd);
  const int k = threadIdx.x;
  if (k >= nd * t.per) return t;
  t.live = true;
  t.d = k % nd;
  t.part = k / nd;
  const int gd = c.d0 + t.d;
  if (gd < c.hi) {
    const long long at = static_cast<long long>(c.w / a.parts) * a.D + gd;
    t.m = a.mask[at];
    t.row = a.idx ? a.idx[at] : at;
    t.v = a.vals[at];
  }
  return t;
}

// Issues this thread's copies of its slot into X and, for one thread a
// slot, the slot's weights: iALS w_d and r_d; ALS v_d − μ and m_d, r_d
// being finished once the row (and its bias) has landed.
__device__ __forceinline__ void stage_issue(const GramArgs& a, float* X,
                                            float* wg, float* wr,
                                            const Meta& t) {
  if (!t.live) return;
  const int nchunk = (a.n + (a.mu ? 1 : 0) + 3) >> 2;
  float* dst = X + t.d * a.rw;
  const float* src = a.rows + (t.m ? t.row : 0) * a.stride;
  for (int c = t.part; c < nchunk; c += t.per) {
    float* to = dst + (c & 1) * (a.rw >> 1) + (c >> 1) * 4;
    if (t.m)
      cp_async16(to, src + c * 4);
    else
      *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (t.part != 0) return;
  const float mf = t.m ? 1.f : 0.f;
  if (a.mu == nullptr) {
    const float av = __fmul_rn(a.alpha, t.v);
    wg[t.d] = __fmul_rn(av, mf);
    wr[t.d] = __fmul_rn(__fadd_rn(1.f, av), mf);
  } else {
    wg[t.d] = mf;
    wr[t.d] = __fsub_rn(t.v, *a.mu);
  }
}

// Completes a stage once its copies have landed.  The left operand's
// column n becomes r_d (ALS: (v_d − μ − b_d)·m_d, b_d read from column n);
// for iALS the left operand is w_d·x_d.
__device__ void stage_fix(const GramArgs& a, float* X, float* A,
                          const float* wg, const float* wr, int nd) {
  if (a.mu != nullptr) {  // ALS: A is X
    const int p = split_pos(a.n, a.rw);
    for (int d = threadIdx.x; d < nd; d += blockDim.x) {
      float* y = X + d * a.rw + p;
      *y = __fmul_rn(__fsub_rn(wr[d], *y), wg[d]);
    }
    return;
  }
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int d = threadIdx.x >> 5; d < nd; d += warps) {
    const float w = wg[d];
    for (int e = lane; e <= a.n; e += 32) {
      const int p = d * a.rw + split_pos(e, a.rw);
      A[p] = e < a.n ? __fmul_rn(X[p], w) : wr[d];
    }
  }
}

__device__ __forceinline__ void tile_sums(float (&acc)[kTile][kTile],
                                          const float* A, const float* X,
                                          int rw, int nd, int ti, int tj) {
  const float4* A4 = reinterpret_cast<const float4*>(A);
  const float4* X4 = reinterpret_cast<const float4*>(X);
  const int rw4 = rw >> 2, h4 = rw >> 3;
#pragma unroll 2
  for (int d = 0; d < nd; ++d) {
    const float4 a0 = A4[d * rw4 + ti], a1 = A4[d * rw4 + h4 + ti];
    const float4 b0 = X4[d * rw4 + tj], b1 = X4[d * rw4 + h4 + tj];
    const float av[kTile] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[kTile] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
#pragma unroll
      for (int l = 0; l < kTile; ++l)
        acc[k][l] = fmaf(av[k], bv[l], acc[k][l]);
    }
  }
}

// Thread tile g of the augmented triangle: (ti, tj), tj ≤ ti; row tile ti
// starts at tile ti(ti + 1)/2.
__device__ __forceinline__ void tile_of(int g, int* ti, int* tj) {
  int t = 0;
  while ((t + 1) * (t + 2) / 2 <= g) ++t;
  *ti = t;
  *tj = g - t * (t + 1) / 2;
}

// A system's augmented lower triangle in shared memory (`tri`), row-major:
// row r of row tile t = r / 8 holds columns 0 .. 8t + 7 and 4 floats of
// padding, so that rows start on 16 bytes (a tile row goes in as two
// float4s) and the 8 rows of a row tile, read down a column, fall in 8
// distinct banks.  32·nr(nr + 2) floats for nr row tiles.
__device__ __forceinline__ int tri_row(int r) {
  const int t = r >> 3;
  return 32 * t * (t + 2) + (r & 7) * (8 * t + 12);
}

// Floats of `tri` for n: nr = (n + 8) / 8 row tiles of 8 rows.
__host__ __device__ __forceinline__ int tri_floats(int n) {
  const int nr = (n + kTile) / kTile;
  return 32 * nr * (nr + 2);
}

// A regular chunk's epilogue on sum (r, c) of system s, in the order the
// plain version adds it: ALS λ_r·max(deg, 1) on the diagonal; iALS
// YᵀY + G (YᵀY's lower triangle), then λ on the diagonal.  Sums above the
// diagonal and of row n (rhs) are left as they are (the former are never
// written out).
__device__ __forceinline__ float element_epilogue(const GramArgs& a, int s,
                                                  int r, int c, float x) {
  if (r >= a.n || c > r) return x;
  if (a.g_global != nullptr) {
    x = __fadd_rn(a.g_global[r * a.n + c], x);
    if (c == r) x = __fadd_rn(x, a.reg);
  } else if (a.reg_vec != nullptr && c == r) {
    x = __fadd_rn(x, __fmul_rn(a.reg_vec[r], fmaxf(a.deg[s], 1.f)));
  }
  return x;
}

// The epilogue on thread tile (ti, tj) of system s, in registers: ALS's
// ridge touches only the diagonal tiles' diagonals; iALS's YᵀY the lower
// entries, one after another.
__device__ __forceinline__ void tile_epilogue(const GramArgs& a, int s,
                                              float (&acc)[kTile][kTile],
                                              int ti, int tj) {
  if (a.reg_vec != nullptr && ti == tj) {
#pragma unroll
    for (int k = 0; k < kTile; ++k)
      acc[k][k] = element_epilogue(a, s, ti * kTile + k, ti * kTile + k,
                                   acc[k][k]);
  } else if (a.g_global != nullptr) {
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int r = ti * kTile + k;
      if (r >= a.n) break;
#pragma unroll
      for (int l = 0; l < kTile; ++l) {
        const int c = tj * kTile + l;
        if (c > r) break;
        acc[k][l] = element_epilogue(a, s, r, c, acc[k][l]);
      }
    }
  }
}

// Thread tile (ti, tj) into `tri`, each of its rows two float4s.
__device__ __forceinline__ void tile_dump(float* tri,
                                          const float (&acc)[kTile][kTile],
                                          int ti, int tj) {
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    float4* row = reinterpret_cast<float4*>(tri + tri_row(ti * kTile + k) +
                                            tj * kTile);
    row[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
    row[1] = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
  }
}

// Writes system s from `tri`: G row after row, each warp a row, its lanes
// along the row (the lower triangle mirrored), then rhs (row n).  A lane's
// first kCols columns have their `tri` rows worked out once.
__device__ __forceinline__ void write_system(const GramArgs& a, int s,
                                             const float* tri) {
  constexpr int kCols = 5;  // columns a lane up to n = 160
  const int n = a.n, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int oj[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) oj[c] = tri_row(lane + 32 * c);
  for (int i = warp; i < n; i += warps) {
    const float* lo = tri + tri_row(i);
    float* __restrict__ Gi = a.G + (static_cast<long long>(s) * n + i) * n;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = lane + 32 * c;
      if (j < n) Gi[j] = j <= i ? lo[j] : tri[oj[c] + i];
    }
    for (int j = lane + 32 * kCols; j < n; j += 32)
      Gi[j] = j <= i ? lo[j] : tri[tri_row(j) + i];
  }
  const float* rhs = tri + tri_row(n);
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    a.rhs[static_cast<long long>(s) * n + j] = rhs[j];
}

__global__ void __launch_bounds__(kMaxThreads, 2)
gather_gram_sums_kernel(const GramArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int nbuf = a.mu == nullptr ? 2 : 1;  // iALS: X and w·X
  const int stage_floats = nbuf * a.slots * a.rw + 2 * a.slots;
  float* out_s = smem + 2 * stage_floats;    // direct: a system's `tri`
  for (int k = threadIdx.x; k < 2 * stage_floats; k += blockDim.x)
    smem[k] = 0.f;
  // This thread's tile (ti, tj), tj ≤ ti, of the augmented triangle: row
  // tiles cover rows 0..n, column tiles columns 0..n − 1; row tile ti
  // starts at tile ti(ti + 1)/2.
  const int g = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = g < a.tiles;
  int ti, tj;
  tile_of(g, &ti, &tj);
  __syncthreads();

  float acc[kTile][kTile];
#pragma unroll
  for (int k = 0; k < kTile; ++k)
#pragma unroll
    for (int l = 0; l < kTile; ++l) acc[k][l] = 0.f;

  const int items = a.B * a.parts;
  if (static_cast<int>(blockIdx.x) >= items) return;
  Cursor cur = item_start(a, blockIdx.x);
  {
    float* X = smem;
    float* wt = X + nbuf * a.slots * a.rw;
    stage_issue(a, X, wt, wt + a.slots, meta_load(a, cur, items));
  }
  cp_async_commit();
  Cursor nxt = advance(a, cur);
  Meta mnext = meta_load(a, nxt, items);
  for (int stage = 0;; stage ^= 1) {
    if (nxt.w < items) {
      float* X = smem + (stage ^ 1) * stage_floats;
      float* wt = X + nbuf * a.slots * a.rw;
      stage_issue(a, X, wt, wt + a.slots, mnext);
    }
    cp_async_commit();
    // The stage after next: its ids, mask and values load while this
    // stage is summed.
    const Cursor after = nxt.w < items ? advance(a, nxt) : nxt;
    mnext = meta_load(a, after, items);
    cp_async_wait_one();
    __syncthreads();
    float* X = smem + stage * stage_floats;
    float* A = nbuf == 2 ? X + a.slots * a.rw : X;
    const float* wt = X + nbuf * a.slots * a.rw;
    const int nd = stage_slots(a, cur);
    stage_fix(a, X, A, wt, wt + a.slots, nd);
    __syncthreads();
    if (active) tile_sums(acc, A, X, a.rw, nd, ti, tj);
    if (cur.d0 + a.slots >= cur.hi) {  // the item's last stage
      if (a.direct) {
        if (active) {
          tile_epilogue(a, cur.w, acc, ti, tj);
          tile_dump(out_s, acc, ti, tj);
        }
        __syncthreads();
        write_system(a, cur.w, out_s);
      } else if (active) {
        float* out = a.work + static_cast<long long>(cur.w) * kSums *
                                  a.tiles + g;
#pragma unroll
        for (int k = 0; k < kTile; ++k)
#pragma unroll
          for (int l = 0; l < kTile; ++l)
            out[(k * kTile + l) * a.tiles] = acc[k][l];
      }
#pragma unroll
      for (int k = 0; k < kTile; ++k)
#pragma unroll
        for (int l = 0; l < kTile; ++l) acc[k][l] = 0.f;
    }
    if (nxt.w >= items) break;
    __syncthreads();  // this stage is refilled next
    cur = nxt;
    nxt = after;
  }
}

// Adds each system's parts in part order and writes it through `tri`:
// thread x < sets · tiles takes tile x % tiles and its sums e = x / tiles,
// e + sets, …, read coalesced (sum e of tile t at e·tiles + t), adds the
// epilogue to each and stores it in `tri`.
__global__ void __launch_bounds__(kFinishMaxThreads, 1)
gather_gram_finish_kernel(const GramArgs a, int sets) {
  extern __shared__ __align__(16) float tri[];
  const int t = threadIdx.x % a.tiles, e0 = threadIdx.x / a.tiles;
  int ti, tj;
  tile_of(t, &ti, &tj);
  const long long per_item = static_cast<long long>(kSums) * a.tiles;
  for (int s = blockIdx.x; s < a.B; s += gridDim.x) {
    __syncthreads();  // the last system's reads are done
    if (e0 < sets) {
      const float* sums = a.work + s * a.parts * per_item + t;
      for (int e = e0; e < kSums; e += sets) {
        float v = sums[e * a.tiles];
        for (int p = 1; p < a.parts; ++p)
          v = __fadd_rn(v, sums[p * per_item + e * a.tiles]);
        const int r = ti * kTile + (e >> 3), c = tj * kTile + (e & 7);
        tri[tri_row(r) + c] = element_epilogue(a, s, r, c, v);
      }
    }
    __syncthreads();
    write_system(a, s, tri);
  }
}

// The launch's shape, from the chunk's shape and what the card holds.
struct Plan {
  int threads, groups, tiles, rw, slots, parts, part_len, direct, grid;
  int sets, finish_threads;
  size_t smem, tri_bytes;
  long long work;  // floats of the parts' sums (0 when direct)
};

int tiles_of(int n) {
  const int nr = (n + kTile) / kTile, nc = (n + kTile - 1) / kTile;
  int tiles = 0;
  for (int ti = 0; ti < nr; ++ti) tiles += std::min(ti, nc - 1) + 1;
  return tiles;
}

cudaError_t resident(const Plan& p, int* per_sm, int* sms) {
  cudaError_t err;
  if (p.smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(gather_gram_sums_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(p.smem))) != cudaSuccess)
    return err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, gather_gram_sums_kernel, p.threads, p.smem)) !=
      cudaSuccess)
    return err;
  return *per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

cudaError_t plan_of(int B, int D, int n, bool ials, Plan* p) {
  if (B <= 0 || D < 0 || n <= 0) return cudaErrorInvalidValue;
  p->tiles = tiles_of(n);
  p->rw = kTile * ((n + kTile) / kTile);
  // Narrow systems stage what they have: shared memory for 32 slots
  // would cost an iALS block of D = 8 a third of its blocks an SM.
  p->slots = std::min(kSlots, std::max(4, (D + 3) & ~3));
  p->threads = std::min(kMaxThreads, (p->tiles + 31) / 32 * 32);
  p->groups = (p->tiles + p->threads - 1) / p->threads;
  const size_t stages = 2 * sizeof(float) *
      (static_cast<size_t>(ials ? 2 : 1) * p->slots * p->rw + 2 * p->slots);
  p->tri_bytes = sizeof(float) * tri_floats(n);
  p->smem = stages;
  if (p->smem > kMaxSmem || p->tri_bytes > kMaxSmem)
    return cudaErrorInvalidValue;
  // The finish kernel: as many sets of a thread a tile as fit in
  // kFinishThreads (at least one), in whole warps.
  p->sets = std::max(1, kFinishThreads / p->tiles);
  p->finish_threads = (p->sets * p->tiles + 31) / 32 * 32;
  int per_sm = 0, sms = 0;
  cudaError_t err = resident(*p, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  // Two waves of the blocks the card holds, in parts of kMinPart slots or
  // more.
  const long long want = 2LL * per_sm * sms / p->groups;
  int parts = (D + kMaxPart - 1) / kMaxPart;
  if (B < want)
    parts = std::max(parts, static_cast<int>(std::min<long long>(
        (want + B - 1) / B, std::max(1, D / kMinPart))));
  parts = std::max(parts, 1);
  p->part_len = D == 0 ? 0 : (D + parts - 1) / parts;
  p->parts = D == 0 ? 1 : (D + p->part_len - 1) / p->part_len;
  // A system of one part, all its tiles in one block, is written by its
  // block where its `tri` beside the stages leaves as many blocks on an SM
  // (at N = 101, ALS up to 32 slots a stage; iALS, whose stages are twice
  // as large, up to 16).
  p->direct = p->parts == 1 && p->groups == 1 &&
              stages + p->tri_bytes <= kMaxSmem;
  if (p->direct) {
    Plan q = *p;
    q.smem = stages + p->tri_bytes;
    int direct_per_sm = 0;
    if ((err = resident(q, &direct_per_sm, &sms)) != cudaSuccess) return err;
    p->direct = direct_per_sm >= per_sm;
    if (p->direct) p->smem = q.smem;
  }
  const long long items = static_cast<long long>(B) * p->parts;
  p->grid = static_cast<int>(std::min<long long>(
      items, std::max(1, per_sm * sms / p->groups)));
  p->work = p->direct ? 0 : static_cast<long long>(B) * p->parts * kSums *
                                p->tiles;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The floats of workspace a launch at this shape needs (B · parts · 64 ·
// tiles, or 0 where each system is written by its block), or a negative
// cudaError_t.  ials: 1 for iALS (no `mu`).
long long gather_gram_workspace(int B, int D, int n, int ials) {
  Plan p;
  const cudaError_t err = plan_of(B, D, n, ials != 0, &p);
  return err == cudaSuccess ? p.work : -static_cast<long long>(err);
}

// rows (R, stride) float32, 16-byte aligned, stride a multiple of 4; idx
// (B, D) int64 or null (row s·D + d); vals (B, D) float32; mask (B, D)
// bool.  ALS when `mu` (a device float) is given: rows are design rows
// [q | 1 | b | 0…], stride ≥ n + 1, b in column n; iALS when it is null,
// with `alpha`, stride ≥ n.  Epilogue: ALS `reg_vec` (n,) and `deg` (B,)
// add reg_vec·max(deg, 1) to the diagonal; iALS `g_global` (n, n) adds
// it, then `reg` on the diagonal; neither writes the raw sums.  G
// (B, n, n) and rhs (B, n) float32, contiguous; `work`
// gather_gram_workspace(B, D, n, mu == null) floats (`work_len`).
// Launches on `stream` and returns the first cudaError_t.
int gather_gram_launch(const float* rows, long long stride,
                       const long long* idx, const float* vals,
                       const unsigned char* mask, const float* mu,
                       float alpha, const float* reg_vec, const float* deg,
                       const float* g_global, float reg, float* G,
                       float* rhs, float* work, long long work_len, int B,
                       int D, int n, void* stream) {
  if (stride < n + (mu ? 1 : 0) || stride % 4 != 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0)
    return cudaErrorMisalignedAddress;
  Plan p;
  cudaError_t err = plan_of(B, D, n, mu == nullptr, &p);
  if (err != cudaSuccess) return err;
  if (work_len < p.work) return cudaErrorInvalidValue;
  const GramArgs a{rows, stride, idx, vals, mask, mu, alpha, reg_vec, deg,
                   g_global, reg, G, rhs, work, B, D, n, p.rw, p.slots,
                   p.tiles, p.parts, p.part_len, p.direct};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gather_gram_sums_kernel<<<dim3(p.grid, p.groups), p.threads, p.smem, s>>>(
      a);
  if ((err = cudaGetLastError()) != cudaSuccess || p.direct) return err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int grid = std::min(B, 16 * sms);
  if (p.tri_bytes > 48 * 1024 &&
      (err = cudaFuncSetAttribute(
           gather_gram_finish_kernel,
           cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(p.tri_bytes))) != cudaSuccess)
    return err;
  gather_gram_finish_kernel<<<grid, p.finish_threads, p.tri_bytes, s>>>(
      a, p.sets);
  return cudaGetLastError();
}

}  // extern "C"
