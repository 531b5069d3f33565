// K1 — batched ridge solve θ = G⁻¹·rhs for many small SPD systems, on Hopper.
//
// Replaces: the TPU package's ops/pallas_linalg.py::_ridge_kernel (a
// lane-batched in-place Cholesky held in VMEM).  Same arithmetic: a
// right-looking Cholesky G = L·Lᵀ, a forward solve L·z = rhs, then a back
// solve Lᵀ·θ = z.
//
// What bounds it: the lower triangle of G is read once (B·N(N+1)/2 floats),
// rhs read and θ written once, against about B·N³/3 flops.  At the serving
// shape (B = 256, N = 100) that is ~5.4 MB (~1.6 µs at 3.35 TB/s) and
// ~90 MFLOP (~1.35 µs at 67 TFLOP/s), but no design that factors column
// after column reaches it there: one system's N columns form a dependency
// chain, and 256 systems fill the card only once.  The time is that chain.
// Bytes and flops can bind only at large B (ALS sweeps, B in the thousands).
//
// Three kernels; the wrapper picks one from N alone (ops/cuda_linalg.py,
// kernel_for):
//
// 1. ridge_bucket_kernel<TS, NL, SYS>, for N + 1 ≤ NP = TS·NL (NP = 32,
//    64, 104, 128): the system is the augmented lower triangle
//    [[G], [rhsᵀ]] of NP rows, held in registers by a TS × TS grid of
//    threads, thread (tr, tc)
//    owning the NL(NL+1)/2 elements (i, k), k ≤ i, of rows i = tr + TS·a
//    and columns k = tc + TS·c, a, c < NL (a cyclic layout: every thread
//    keeps work while the trailing matrix shrinks).  Column j, updated but
//    unscaled, is published once into its own slot of a packed column store
//    in shared memory; at step j every thread reads it, takes 1/G'_jj and
//    updates the elements it owns; the owners of column j+1 publish it; then
//    one barrier.  Each slot is written once, so one barrier a column is all
//    the ordering needed.  The steps run in phases of TS columns in which
//    every register index and block bound is a compile-time constant: no
//    step branches.  Row N (rhsᵀ) takes the same trailing update, so the
//    forward solve comes out of the factor: its entry in column j is
//    z_j·sqrt(G'_jj).  The back solve runs on one warp in axpy form with the
//    solution in registers across the lanes: one shuffle broadcasts θ_j,
//    and each lane subtracts L_jk·θ_j from the rows k < j it holds, reading
//    the columns the factor left in shared memory (no reduction a row).
//    With unscaled columns c_k (c_k[i] = G'_ik):
//        w_k = c_k[N];  for j = N-1 … 0:  θ_j = w_j / c_j[j],
//        w_k -= c_k[j]·θ_j  (k < j).
//    Buckets, each the faster in an A/B on one H100 (PERF.md): NP = 32,
//    16 threads a system owning 8 × 8 blocks, 16 systems a block, two a
//    warp (__syncwarp); NP = 64, 16 threads owning 16 × 16 blocks, 4
//    systems a block; NP = 104 and 128, 64 threads owning 13 × 13 and
//    16 × 16 blocks, one system a block (__syncthreads).  NP = 104 holds
//    the systems of the headline width F = 100 (N = 100 fold-in, N = 101
//    ALS) with two rows of padding, where 128 would carry 26.  The larger
//    blocks take 163–207 registers a thread, so four to six 64-thread
//    systems share an SM: per FMA they issue fewer loads, scalings and
//    stores than 8 × 8 blocks, which matters once B fills the card.
//
// 2. ridge_cholesky_kernel_blocked<...>, for 128 ≤ N ≤ 338 (ALS and iALS
//    at F = 127 … 337, ALS-WR at F = 300): one block a system, the
//    augmented trapezoid [[G], [rhsᵀ]] column-major in shared memory
//    (Trapezoid, up to 227 KB, so one system an SM at N = 301).  What
//    bounds it at N = 301 (497,951 systems a sweep): the triangles' bytes,
//    91.7 GB a sweep, 27.4 ms at 3.35 TB/s, ~7 µs a system an SM; the
//    N³/6 ≈ 4.55 M multiply-adds of a system, ~20 µs on one SM at 128 a
//    cycle; and the chain of N pivots, each an rsqrt and a broadcast,
//    which no split of the update shortens.  One system an SM makes the
//    time a system's latency on its SM, so the design cuts what each
//    phase waits for:
//    - right-looking by panels of kNB = 16 columns.  The trailing update is
//      a rank-16 update: each lane holds a register tile (8 × 8 or 4 × 4
//      elements, 16 or more independent sums), reads its rows' and
//      columns' L as float4s of a panel column (one wavefront each for the
//      warp), adds in the order of k as before, and writes the tile back
//      once a panel; a branch-free loop of 4 loads and 64 FMAs a k;
//    - the panel's diagonal block on one warp in registers, a shuffle, an
//      rsqrt and two FMAs a column on the chain; its rows solved by the
//      block's threads, four rows a thread; and while a few warps factor
//      the next panel, the others update the columns beyond it (the next
//      panel's columns first): two barriers a panel, not two a column;
//    - rhs as row N, so the forward solve comes out of the factor; the back
//      solve by blocks of 16, a shuffle a column on one warp and the
//      block's terms for the rows above spread over the threads;
//    - the load reads row i's i + 1 floats of G, coalesced, with no
//      division and sixteen loads a lane in flight.
//    The launcher picks the variant from N: 512 threads with 8 × 8 tiles
//    where one block fills an SM's shared memory, 256 threads with 8 × 4
//    tiles where two or more blocks fit (N ≈ 128 keeps several systems an
//    SM), and the packed trapezoid (four scalar loads for a float4) at
//    N = 336 … 338, where the aligned one does not fit.
//
// 3. ridge_cholesky_kernel, for N > 338: one block a system on per-system
//    global scratch that the caller allocates, so every N is taken.  Two
//    barriers a column, one warp a row of the trailing update, the
//    substitutions on one warp.

#include <cuda_runtime.h>

namespace {

// -- 1. the bucket kernel ----------------------------------------------------

__host__ __device__ constexpr int owned(int a, int c) {
  return a * (a + 1) / 2 + c;
}

// A TS × TS grid of threads a system, each owning NL row blocks and NL
// column blocks; SYS systems a block.
template <int TS, int NL, int SYS>
struct Bucket {
  static constexpr int kOwned = NL * (NL + 1) / 2;
  static constexpr int kNP = NL * TS;              // augmented rows taken
  static constexpr int kThreads = TS * TS;         // threads a system
  static constexpr int kSystems = SYS;
  static constexpr int kBlock = SYS * kThreads;
  static constexpr int kSlots = kNP * (kNP + 1) / 2;
  static constexpr int kFloats = kSlots + kNP;     // column slots, 1/pivots
  // Lanes of the back solve, and the rows each holds.
  static constexpr int kLanes = kThreads < 32 ? kThreads : 32;
  static constexpr int kRows = (kNP + kLanes - 1) / kLanes;
};

// Start of column j's slot, which holds rows j..NP-1.
template <int NP>
__device__ __forceinline__ int slot(int j) {
  return j * NP - j * (j - 1) / 2;
}

// The barrier of one system's threads: the block, or the warp that holds
// it and others.
template <class Bk>
__device__ __forceinline__ void system_sync() {
  static_assert(Bk::kSystems == 1 || 32 % Bk::kThreads == 0,
                "systems that share a block lie within one warp");
  if constexpr (Bk::kSystems == 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

template <int TS, int NL, int SYS>
__global__ void __launch_bounds__(SYS * TS * TS, SYS * TS * TS >= 256 ? 2 : 1)
ridge_bucket_kernel(const float* __restrict__ G,
                    const float* __restrict__ rhs, float* __restrict__ out,
                    int batch, int n) {
  using Bk = Bucket<TS, NL, SYS>;
  constexpr int NP = Bk::kNP;
  constexpr int kNL = NL;
  __shared__ float smem[Bk::kSystems * Bk::kFloats];
  const int sys = threadIdx.x / Bk::kThreads;
  const int t = threadIdx.x % Bk::kThreads;
  const int tr = t / TS, tc = t % TS;
  // A block's spare systems repeat the batch's last one and store nothing,
  // so that every thread reaches every barrier.
  const int b_out = blockIdx.x * Bk::kSystems + sys;
  const int b = b_out < batch ? b_out : batch - 1;
  float* col = smem + sys * Bk::kFloats;
  float* rdiag = col + Bk::kSlots;
  const float* g = G + static_cast<size_t>(b) * n * n;
  const float* r = rhs + static_cast<size_t>(b) * n;

  float A[Bk::kOwned];
#pragma unroll
  for (int a = 0; a < kNL; ++a) {
#pragma unroll
    for (int c = 0; c <= a; ++c) {
      const int i = tr + TS * a, k = tc + TS * c;
      float v = 0.f;
      if (k <= i && i < n) v = g[static_cast<size_t>(i) * n + k];
      else if (i == n && k < n) v = r[k];
      A[owned(a, c)] = v;
    }
  }
  // Zero the store: the entries of rows past N stay zero, and every read
  // below that falls on no published entry sees a finite value.
  for (int e = t; e < Bk::kFloats; e += Bk::kThreads) col[e] = 0.f;
  system_sync<Bk>();
  if (tc == 0) {
#pragma unroll
    for (int a = 0; a < kNL; ++a) {
      const int i = tr + TS * a;
      if (i <= n) col[i] = A[owned(a, 0)];
    }
  }
  system_sync<Bk>();

  // The steps run in phases: phase C publishes the columns of block C
  // (jn = j + 1 in [TS·C, TS·C + TS)), and while it runs, only the blocks
  // c, a ≥ C hold a column still to factor.  So every register index and
  // every block bound below is a constant of the unrolled phase, and no
  // step branches.  An element of a live block that needs no update (a
  // finished row, a row past N, an upper element of a diagonal block) is
  // updated all the same, from store entries that are zero or finite, and
  // is never published.
  float* cj = col;  // column j's slot, indexed by row: cj[i] = G'_ij
#pragma unroll
  for (int C = 0; C < kNL; ++C) {
    const int j_end = min(n, TS * C + TS - 1);
    for (int j = C == 0 ? 0 : TS * C - 1; j < j_end; ++j) {
      const float s = rsqrtf(cj[j]);
      const float rinv = s * s;
      if (t == 0) rdiag[j] = rinv;
      float li[kNL];
#pragma unroll
      for (int a = C; a < kNL; ++a) li[a] = cj[tr + TS * a] * rinv;
#pragma unroll
      for (int c = C; c < kNL; ++c) {
        const float lk = cj[tc + TS * c];
#pragma unroll
        for (int a = c; a < kNL; ++a) A[owned(a, c)] -= li[a] * lk;
      }
      // Column j+1 goes to the slot after column j's, from its owners.
      float* cn = cj + NP - j - 1;
      const int jn = j + 1;
      const bool owner = jn < n && tc == jn - TS * C;
#pragma unroll
      for (int a = C; a < kNL; ++a) {
        const int i = tr + TS * a;
        if (owner && i >= jn) cn[i] = A[owned(a, C)];
      }
      cj = cn;
      system_sync<Bk>();
    }
  }

  // Back solve on the system's first kLanes threads, in phases of kLanes
  // rows: in phase Q, lane j - kLanes·Q holds w_j in w[Q], and the rows of
  // w[q < Q] all lie above j.
  constexpr int LW = Bk::kLanes;
  if (t >= LW) return;
  float w[Bk::kRows];
  int base[Bk::kRows];  // col[base[q] + j] = G'_ji, row j of column i < NP
#pragma unroll
  for (int q = 0; q < Bk::kRows; ++q) {
    const int i = t + LW * q;
    base[q] = i < NP ? slot<NP>(i) - i : 0;
    w[q] = i < n ? col[base[q] + n] : 0.f;
  }
#pragma unroll
  for (int Q = Bk::kRows - 1; Q >= 0; --Q) {
    const int i = t + LW * Q;
    for (int j = min(n - 1, LW * Q + LW - 1); j >= LW * Q; --j) {
      const float th =
          __shfl_sync(0xffffffffu, w[Q], j - LW * Q, LW) * rdiag[j];
#pragma unroll
      for (int q = 0; q < Q; ++q) w[q] = fmaf(-col[base[q] + j], th, w[q]);
      const float l = col[base[Q] + j];
      w[Q] = i < j ? fmaf(-l, th, w[Q]) : (i == j ? th : w[Q]);
    }
  }
  if (b_out < batch) {
#pragma unroll
    for (int q = 0; q < Bk::kRows; ++q) {
      const int i = t + LW * q;
      if (i < n) out[static_cast<size_t>(b) * n + i] = w[q];
    }
  }
}

template <int TS, int NL, int SYS>
int launch_bucket(const float* G, const float* rhs, float* out, int batch,
                  int n, cudaStream_t s) {
  using Bk = Bucket<TS, NL, SYS>;
  ridge_bucket_kernel<TS, NL, SYS>
      <<<(batch + SYS - 1) / SYS, Bk::kBlock, 0, s>>>(G, rhs, out, batch, n);
  return static_cast<int>(cudaGetLastError());
}

// -- 2. one block a system, blocked, for 128 ≤ N ≤ 338 -----------------------

// Columns a panel: factored between two rank-kNB trailing updates.
constexpr int kNB = 16;
// A block's shared memory on an H100.
constexpr int kSmemBytes = 232448;
// Floats past the trapezoid that loads of rows beyond N may read (their
// values are never used): the solve's vector and this slack lie there.
constexpr int kSlack = 64;
// The largest N the shared-memory kernel takes; the back solve sizes its
// registers by it.
constexpr int kSharedMaxN = 338;
constexpr unsigned kFull = 0xffffffffu;

// The augmented lower trapezoid [[G], [rhsᵀ]] (N + 1 rows, N columns),
// column-major in shared memory: element (i, c), c ≤ i ≤ N, at
// p[col(c) + i].  Aligned: column c holds rows 4⌊c/4⌋ … NP4 − 1 (NP4 is
// N + 1 rounded up to 4), so col(c) is a multiple of 4 and the four rows
// from a multiple of 4 are one float4; it fits up to N = 335.  Packed:
// column c holds rows c … N, n(n + 3)/2 floats, and four rows are four
// loads.  The solve's vector x follows, on a 16-byte boundary.
template <bool kAligned>
struct Trapezoid {
  float* p;
  int n, np4;

  __host__ __device__ Trapezoid(float* p_, int n_)
      : p(p_), n(n_), np4((n_ + 4) & ~3) {}

  __host__ __device__ int col(int c) const {
    if constexpr (kAligned) {
      const int q = c >> 2;
      return c * np4 - 4 * (2 * q * (q - 1) + (c & 3) * q) - 4 * q;
    } else {
      return c * n - c * (c - 1) / 2;
    }
  }
  // Offset of x: the trapezoid's floats, rounded up to 4.
  __host__ __device__ int vec() const {
    return (col(n) + (kAligned ? 4 * (n >> 2) : n) + 3) & ~3;
  }
  __host__ __device__ static int bytes(int n) {
    const Trapezoid t(nullptr, n);
    return 4 * (t.vec() + ((n + 3) & ~3) + kSlack);
  }

  // Four floats from p[e] (e a multiple of 4 where aligned).
  __device__ void load4(int e, float v[4]) const {
    if constexpr (kAligned) {
      const float4 f = *reinterpret_cast<const float4*>(p + e);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) v[r] = p[e + r];
    }
  }
  // Rows i0 … i0 + 3 of column c (i0 a multiple of 4 where aligned), where
  // the trapezoid holds them: aligned, the whole float4 once a row lies on
  // or below the diagonal (the others are column c's padding, never read
  // as data); packed, each row c ≤ i ≤ N.
  __device__ void store4(int c, int i0, const float v[4]) const {
    float* q = p + col(c) + i0;
    if constexpr (kAligned) {
      if (i0 + 3 >= c && i0 <= n)
        *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i0 + r >= c && i0 + r <= n) q[r] = v[r];
    }
  }
};

// The lower triangle of G, row by row (coalesced, no division), and rhs as
// row N, into the trapezoid: a warp takes four rows at a time and each lane
// four columns of them, so each store is one float4 where aligned.  Every
// load is made unconditionally (a clamped column, or rhs, where the
// element is not G's lower triangle; the value is then replaced by 0), so a
// lane's sixteen loads are in flight together.
template <int kWarps, bool kAligned>
__device__ void load_system(const Trapezoid<kAligned>& A,
                            const float* __restrict__ g,
                            const float* __restrict__ r, int warp, int lane) {
  const int n = A.n;
  for (int q = warp; q < A.np4 / 4; q += kWarps) {
    const int i0 = 4 * q;
    const int kend = min(i0 + 4, n);
    for (int k0 = lane; k0 < kend; k0 += 128) {
      float v[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = min(k0 + 32 * s, kend - 1);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i = i0 + rr;
          const float t = __ldcs(i < n ? g + static_cast<size_t>(i) * n +
                                             min(k, i)
                                       : r + k);
          v[s][rr] = (i < n ? k <= i : i == n) ? t : 0.f;
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (k0 + 32 * s < kend) A.store4(k0 + 32 * s, i0, v[s]);
    }
  }
}

// The panel's diagonal block (columns j0 … j0 + jb − 1) on one warp, lane t
// holding row j0 + t in registers.  Each column's pivot comes by one
// shuffle, every lane scales by its rsqrt, and the next pivot is updated
// before the rest of the block, so a column's chain is a shuffle, an rsqrt
// and two multiply-adds.  Writes L and each column's rsqrt into x.
template <bool kAligned>
__device__ void factor_diagonal(const Trapezoid<kAligned>& A, float* x,
                                int j0, int jb, int t) {
  float a[kNB];
#pragma unroll
  for (int u = 0; u < kNB; ++u)
    a[u] = u <= t && t < jb ? A.p[A.col(j0 + u) + j0 + t] : 0.f;
  // Columns past jb (the last panel's) run on zeros with a unit pivot, so
  // that every shuffle is the whole warp's.
  float rd = 0.f;
  float d = __shfl_sync(kFull, a[0], 0);
#pragma unroll
  for (int u = 0; u < kNB; ++u) {
    const float s = rsqrtf(d);
    const float l = a[u] * s;
    if (t == u) rd = s;
    a[u] = l;
    if (u + 1 < kNB) {
      const float dn = __shfl_sync(kFull, fmaf(-l, l, a[u + 1]), u + 1);
      d = u + 1 < jb ? dn : 1.f;
    }
#pragma unroll
    for (int c = u + 1; c < kNB; ++c)
      a[c] = fmaf(-l, __shfl_sync(kFull, l, c), a[c]);
  }
  if (t < jb) {
#pragma unroll
    for (int u = 0; u < kNB; ++u)
      if (u <= t) A.p[A.col(j0 + u) + j0 + t] = a[u];
    x[j0 + t] = rd;
  }
}

// Rows j1 … N of the panel's columns, SR rows a thread (its values in
// registers), each solved against the diagonal block's L, read by
// broadcast.  Row N comes out as the forward solve's z.  Where aligned and
// SR = 4 the rows start at j1 rounded down to 4; rows of the diagonal
// block among them are left as they are.
template <int kThreads, int SR, bool kAligned>
__device__ void panel_rows(const Trapezoid<kAligned>& A, const float* x,
                           int j0, int jb, int tid) {
  static_assert(SR == 1 || SR == 4, "one row or four a thread");
  const int j1 = j0 + jb;
  const int lo = SR == 4 && kAligned ? (j1 & ~3) : j1;
  for (int i0 = lo + SR * tid; i0 <= A.n; i0 += SR * kThreads) {
    // Columns past jb (the last panel's) hold zeros and scale by zero.
    float v[SR][kNB];
#pragma unroll
    for (int u = 0; u < kNB; ++u) {
      const int e = A.col(j0 + u) + i0;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (u < jb) {
        if constexpr (SR == 4) A.load4(e, f);
        else f[0] = A.p[e];
      }
#pragma unroll
      for (int r = 0; r < SR; ++r) v[r][u] = f[r];
    }
#pragma unroll
    for (int u = 0; u < kNB; ++u) {
      const float s = u < jb ? x[j0 + u] : 0.f;
#pragma unroll
      for (int r = 0; r < SR; ++r) v[r][u] *= s;
      const int e = A.col(j0 + u) + j0;
#pragma unroll
      for (int q = (u + 1) / 4; q < kNB / 4; ++q) {
        float l[4];  // L[j0 + 4q + cc][j0 + u]
        A.load4(e + 4 * q, l);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          if (4 * q + cc <= u) continue;
#pragma unroll
          for (int r = 0; r < SR; ++r)
            v[r][4 * q + cc] = fmaf(-v[r][u], l[cc], v[r][4 * q + cc]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kNB; ++u) {
      if (u >= jb) continue;
      float* q = A.p + A.col(j0 + u) + i0;
      if constexpr (SR == 4 && kAligned) {
        if (i0 >= j1) {
          *reinterpret_cast<float4*>(q) =
              make_float4(v[0][u], v[1][u], v[2][u], v[3][u]);
          continue;
        }
      }
#pragma unroll
      for (int r = 0; r < SR; ++r)
        if (i0 + r >= j1 && (kAligned || i0 + r <= A.n)) q[r] = v[r][u];
    }
  }
}

// One warp's region of the trailing update A[i][c] −= Σ_k L[i][k]·L[c][k]
// over the panel's columns k, in the order of k: rows r0 … r0 + 4·WA·HR − 1
// and columns c0 … c0 + 4·WB·HC − 1.  Lane (a, b) holds a tile of HR groups
// of four rows (r0 + 4(a + WA·h)) by HC groups of four columns
// (c0 + 4(b + WB·g)) in registers.  For each k it reads its rows' and its
// columns' L as float4s of column k: the warp's row reads fall on WA
// consecutive float4s and its column reads on WB, each one wavefront of
// shared memory, for 16·HR·HC multiply-adds a lane.  Groups that start
// past N, or columns from c_hi on, are not loaded or stored.
template <int HR, int HC, int WA, bool kAligned>
__device__ void update_region(const Trapezoid<kAligned>& A, int j0, int j1,
                              int c0, int c_hi, int r0, int lane) {
  constexpr int WB = 32 / WA;
  const int n = A.n;
  const int a = lane % WA, bw = lane / WA;
  // A skipped group reads its warp's first group's L (a valid address)
  // in the loop over k, whose sums are never stored: the loop has no branch.
  int row[HR], cl[HC], rk[HR], ck[HC];
  bool hon[HR], gon[HC];
#pragma unroll
  for (int h = 0; h < HR; ++h) {
    row[h] = r0 + 4 * (a + WA * h);
    hon[h] = r0 + 4 * WA * h <= n;
    rk[h] = hon[h] ? row[h] : row[0];
  }
#pragma unroll
  for (int g = 0; g < HC; ++g) {
    cl[g] = c0 + 4 * (bw + WB * g);
    gon[g] = c0 + 4 * WB * g < c_hi;
    ck[g] = gon[g] ? cl[g] : cl[0];
  }
  float acc[HR][4][HC][4];
#pragma unroll
  for (int h = 0; h < HR; ++h)
#pragma unroll
    for (int g = 0; g < HC; ++g)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = cl[g] + cc;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (hon[h] && gon[g] && c < c_hi) A.load4(A.col(c) + row[h], v);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) acc[h][rr][g][cc] = v[rr];
      }
  for (int k = j0; k < j1; ++k) {
    const int e = A.col(k);
    float rv[HR][4], cv[HC][4];
#pragma unroll
    for (int h = 0; h < HR; ++h) A.load4(e + rk[h], rv[h]);
#pragma unroll
    for (int g = 0; g < HC; ++g) A.load4(e + ck[g], cv[g]);
#pragma unroll
    for (int h = 0; h < HR; ++h)
#pragma unroll
      for (int g = 0; g < HC; ++g)
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[h][rr][g][cc] =
                fmaf(-rv[h][rr], cv[g][cc], acc[h][rr][g][cc]);
  }
#pragma unroll
  for (int h = 0; h < HR; ++h)
#pragma unroll
    for (int g = 0; g < HC; ++g)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int c = cl[g] + cc;
        if (!hon[h] || !gon[g] || c >= c_hi) continue;
        float v[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) v[rr] = acc[h][rr][g][cc];
        A.store4(c, row[h], v);
      }
}

// The rank-16 update of columns c_lo … c_hi − 1 of the trailing trapezoid
// (each from its diagonal down to row N) by the panel's columns j0 … j1 − 1:
// strips of CW columns, each cut from its diagonal down into bands of RH
// rows, the regions dealt in turn to nwarps warps, of which this is `warp`.
template <int HR, int HC, int WA, bool kAligned>
__device__ void trailing_update(const Trapezoid<kAligned>& A, int j0, int j1,
                                int c_lo, int c_hi, int warp, int nwarps,
                                int lane) {
  constexpr int RH = 4 * WA * HR, CW = 4 * (32 / WA) * HC;
  const int n = A.n;
  int rho = warp;
  for (int c0 = c_lo; c0 < c_hi; c0 += CW) {
    const int bands = (n - c0 + RH) / RH;
    for (; rho < bands; rho += nwarps)
      update_region<HR, HC, WA>(A, j0, j1, c0, c_hi, c0 + RH * rho, lane);
    rho -= bands;
  }
}

// Lᵀ·θ = z by blocks of kNB, last first.  Thread j holds w_j = z_j less
// the blocks solved so far; a block's w go to the z slots (row N), one warp
// solves the block (θ_j = w_j·rsqrt(G'_jj), a shuffle a column), and every
// thread j above the block takes the block's kNB terms, reading column j's
// rows as float4s.  x[j] turns from the pivot's rsqrt into θ_j.
template <int kThreads, bool kAligned>
__device__ void back_solve(const Trapezoid<kAligned>& A, float* x,
                           float* __restrict__ out, int tid, int warp) {
  constexpr int kW = (kSharedMaxN + kThreads - 1) / kThreads;
  const int n = A.n;
  float w[kW];
#pragma unroll
  for (int q = 0; q < kW; ++q) {
    const int j = tid + kThreads * q;
    w[q] = j < n ? A.p[A.col(j) + n] : 0.f;
  }
  for (int j0 = (n - 1) / kNB * kNB; j0 >= 0; j0 -= kNB) {
    const int jb = min(kNB, n - j0);
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      const int j = tid + kThreads * q;
      if (j >= j0 && j < j0 + jb) A.p[A.col(j) + n] = w[q];
    }
    __syncthreads();
    if (warp == 0) {
      const int t = tid;
      const int e = A.col(j0 + t) + j0;
      float wt = 0.f, rt = 0.f, lt[kNB];
      if (t < jb) {
        wt = A.p[e - j0 + n];
        rt = x[j0 + t];
      }
#pragma unroll
      for (int u = 0; u < kNB; ++u)
        lt[u] = t < u && u < jb ? A.p[e + u] : 0.f;
      float th_t = 0.f;
#pragma unroll
      for (int u = kNB - 1; u >= 0; --u) {  // lanes past jb hold zeros
        const float th = __shfl_sync(kFull, wt * rt, u);
        if (t == u) th_t = th;
        wt = fmaf(-lt[u], th, wt);
      }
      if (t < jb) x[j0 + t] = th_t;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kW; ++q) {
      const int j = tid + kThreads * q;
      if (j >= j0) continue;
      const int e = A.col(j) + j0;
#pragma unroll
      for (int g = 0; g < kNB / 4; ++g) {
        float l[4];
        A.load4(e + 4 * g, l);
        const float4 th = *reinterpret_cast<const float4*>(x + j0 + 4 * g);
        const float t4[4] = {th.x, th.y, th.z, th.w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          if (4 * g + cc < jb) w[q] = fmaf(-l[cc], t4[cc], w[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kW; ++q) {
    const int j = tid + kThreads * q;
    if (j < n) out[j] = x[j];
  }
}

template <int kThreads, int kMinBlocks, int HR, int HC, int WA, int SR,
          bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
ridge_cholesky_kernel_blocked(const float* __restrict__ G,
                              const float* __restrict__ rhs,
                              float* __restrict__ out, int n) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kPanelWarps = 4;
  extern __shared__ float4 blocked_smem[];
  const Trapezoid<kAligned> A(reinterpret_cast<float*>(blocked_smem), n);
  float* x = A.p + A.vec();
  const int tid = threadIdx.x, lane = tid & 31;
  // The warp's index as the compiler can see it is the same on all its
  // lanes, so that shuffles under `warp == 0` need no divergence handling.
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const size_t b = blockIdx.x;
  load_system<kWarps>(A, G + b * n * n, rhs + b * n, warp, lane);
  __syncthreads();
  {
    const int jb = min(kNB, n);
    if (warp == 0) factor_diagonal(A, x, 0, jb, lane);
    __syncthreads();
    panel_rows<kThreads, SR>(A, x, 0, jb, tid);
    __syncthreads();
  }
  // Panel j0 is factored.  First its update reaches the next panel's
  // columns; then kPanelWarps factor that panel while the other warps
  // update the columns beyond it.
  for (int j0 = 0; j0 + kNB < n; j0 += kNB) {
    const int j1 = j0 + kNB, j2 = min(j1 + kNB, n);
    trailing_update<1, 1, 8>(A, j0, j1, j1, j2, warp, kWarps, lane);
    __syncthreads();
    if (warp < kPanelWarps) {
      if (warp == 0) factor_diagonal(A, x, j1, j2 - j1, lane);
      // Barrier 1: the panel warps alone.
      asm volatile("bar.sync 1, %0;" ::"r"(kPanelWarps * 32) : "memory");
      panel_rows<kPanelWarps * 32, SR>(A, x, j1, j2 - j1, tid);
    } else if (j2 < n) {
      trailing_update<HR, HC, WA>(A, j0, j1, j2, n, warp - kPanelWarps,
                                  kWarps - kPanelWarps, lane);
    }
    __syncthreads();
  }
  back_solve<kThreads>(A, x, out + b * n, tid, warp);
}

template <int kThreads, int kMinBlocks, int HR, int HC, int WA, int SR,
          bool kAligned>
int launch_blocked(const float* G, const float* rhs, float* out, int batch,
                   int n, cudaStream_t s) {
  auto* kernel = ridge_cholesky_kernel_blocked<kThreads, kMinBlocks, HR, HC,
                                               WA, SR, kAligned>;
  const int bytes = Trapezoid<kAligned>::bytes(n);
  if (bytes > kSmemBytes || n > kSharedMaxN) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<batch, kThreads, bytes, s>>>(G, rhs, out, n);
  return static_cast<int>(cudaGetLastError());
}

// The variant for N: the aligned trapezoid where it fits (N ≤ 335), else
// the packed one; a smaller block of smaller tiles where two or more fit
// an SM, so that systems of N ≈ 128 still share one.
int launch_shared(const float* G, const float* rhs, float* out, int batch,
                  int n, cudaStream_t s) {
  const int bytes = Trapezoid<true>::bytes(n);
  if (bytes > kSmemBytes)
    return launch_blocked<512, 1, 2, 2, 8, 4, false>(G, rhs, out, batch, n,
                                                     s);
  if (bytes <= kSmemBytes / 2 - 1024)
    return launch_blocked<256, 2, 2, 1, 4, 1, true>(G, rhs, out, batch, n,
                                                    s);
  return launch_blocked<512, 1, 2, 2, 8, 4, true>(G, rhs, out, batch, n, s);
}

// -- 3. one block a system on global scratch, for N > 338 --------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline size_t tri_floats(int n) {
  return static_cast<size_t>(n) * (n + 1) / 2;
}

// Per-system workspace: packed lower triangle, pivot column, solution.
__host__ __device__ inline size_t workspace_floats(int n) {
  return tri_floats(n) + 2 * static_cast<size_t>(n);
}

// Offset of row i of the packed (row-major) lower triangle.
__device__ __forceinline__ size_t tri_row(int i) {
  return static_cast<size_t>(i) * (i + 1) / 2;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
ridge_cholesky_kernel(const float* __restrict__ G,
                      const float* __restrict__ rhs,
                      float* __restrict__ out,
                      float* __restrict__ scratch, int n) {
  const int b = blockIdx.x;
  float* tri = scratch + b * workspace_floats(n);
  float* col = tri + tri_floats(n);
  float* x = col + n;
  const float* g = G + static_cast<size_t>(b) * n * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Load the lower triangle of G (coalesced over the full row-major
  // matrix) and the right-hand side.
  const size_t nn = static_cast<size_t>(n) * n;
  for (size_t e = tid; e < nn; e += kThreads) {
    const int i = static_cast<int>(e / n);
    const int j = static_cast<int>(e - static_cast<size_t>(i) * n);
    if (j <= i) tri[tri_row(i) + j] = g[e];
  }
  for (int i = tid; i < n; i += kThreads)
    x[i] = rhs[static_cast<size_t>(b) * n + i];
  __syncthreads();

  // Right-looking Cholesky.  Column j is scaled into `col` (tri is only
  // read in this phase, so the pivot needs no barrier of its own); the
  // trailing phase writes L[:, j] back into tri and updates rows > j.
  for (int j = 0; j < n; ++j) {
    const float dinv = rsqrtf(tri[tri_row(j) + j]);
    for (int i = j + tid; i < n; i += kThreads)
      col[i] = tri[tri_row(i) + j] * dinv;
    __syncthreads();
    if (tid == 0) tri[tri_row(j) + j] = col[j];
    for (int i = j + 1 + warp; i < n; i += kWarps) {
      const float li = col[i];
      float* row = tri + tri_row(i);
      if (lane == 0) row[j] = li;
      for (int k = j + 1 + lane; k <= i; k += 32) row[k] -= li * col[k];
    }
    __syncthreads();
  }

  if (warp != 0) return;
  // Forward substitution L z = rhs: row j of L is contiguous in tri.
  for (int j = 0; j < n; ++j) {
    const float* row = tri + tri_row(j);
    float acc = 0.f;
    for (int k = lane; k < j; k += 32) acc += row[k] * x[k];
    acc = warp_sum(acc);
    if (lane == 0) x[j] = (x[j] - acc) / row[j];
    __syncwarp();
  }
  // Back substitution Lᵀ θ = z: θ[j] = (z[j] - Σ_{k>j} L[k][j] θ[k]) / L[j][j].
  for (int j = n - 1; j >= 0; --j) {
    float acc = 0.f;
    for (int k = j + 1 + lane; k < n; k += 32) acc += tri[tri_row(k) + j] * x[k];
    acc = warp_sum(acc);
    if (lane == 0) x[j] = (x[j] - acc) / tri[tri_row(j) + j];
    __syncwarp();
  }
  for (int i = lane; i < n; i += 32) out[static_cast<size_t>(b) * n + i] = x[i];
}

}  // namespace

extern "C" {

// G (batch, n, n), rhs and out (batch, n), all float32, contiguous, on the
// current device.  `kernel` is what ops/cuda_linalg.py::kernel_for(n)
// chose: 32, 64, 104 or 128 for the bucket kernel of that many augmented
// rows (n + 1 ≤ kernel), 0 for the one-block-a-system kernel in shared
// memory, -1 for the same kernel on `scratch` (batch · (n(n+1)/2 + 2n)
// floats).
// Launches on `stream` and returns the launch's cudaError_t.
int ridge_cholesky_launch(const float* G, const float* rhs, float* out,
                          float* scratch, int batch, int n, int kernel,
                          void* stream) {
  if (batch <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel) {
    case 32:
    case 64:
    case 104:
    case 128:
      if (n + 1 > kernel) return cudaErrorInvalidValue;
      switch (kernel) {
        case 32:
          return launch_bucket<4, 8, 16>(G, rhs, out, batch, n, s);
        case 64:
          return launch_bucket<4, 16, 4>(G, rhs, out, batch, n, s);
        case 104:
          return launch_bucket<8, 13, 1>(G, rhs, out, batch, n, s);
        default:
          return launch_bucket<8, 16, 1>(G, rhs, out, batch, n, s);
      }
    case 0:
      return launch_shared(G, rhs, out, batch, n, s);
    case -1:
      if (scratch == nullptr) return cudaErrorInvalidValue;
      ridge_cholesky_kernel<<<batch, kThreads, 0, s>>>(
          G, rhs, out, scratch, n);
      return static_cast<int>(cudaGetLastError());
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
