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
// Two kernels; the wrapper picks one from N alone (ops/cuda_linalg.py,
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
// 2. ridge_cholesky_kernel<kShared>, for N ≥ 128: one block a system, the
//    packed lower triangle in dynamic shared memory (N ≤ 338 on an H100) or,
//    above that, in per-system global scratch that the caller allocates, so
//    every N is taken.  Two barriers a column, one warp a row of the
//    trailing update, the substitutions on one warp.

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

// -- 2. one block a system, for N ≥ 128 --------------------------------------

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

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
ridge_cholesky_kernel(const float* __restrict__ G,
                      const float* __restrict__ rhs,
                      float* __restrict__ out,
                      float* __restrict__ scratch, int n) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  float* tri = kShared ? smem : scratch + b * workspace_floats(n);
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
    case 0: {
      const size_t bytes = workspace_floats(n) * sizeof(float);
      cudaError_t e = cudaFuncSetAttribute(
          ridge_cholesky_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (e != cudaSuccess) return e;
      ridge_cholesky_kernel<true><<<batch, kThreads, bytes, s>>>(
          G, rhs, out, nullptr, n);
      return static_cast<int>(cudaGetLastError());
    }
    case -1:
      if (scratch == nullptr) return cudaErrorInvalidValue;
      ridge_cholesky_kernel<false><<<batch, kThreads, 0, s>>>(
          G, rhs, out, scratch, n);
      return static_cast<int>(cudaGetLastError());
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
