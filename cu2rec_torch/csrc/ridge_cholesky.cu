// K1 — batched ridge solve θ = G⁻¹·rhs for many small SPD systems, on Hopper.
//
// Replaces: the TPU package's ops/pallas_linalg.py::_ridge_kernel (a
// lane-batched in-place Cholesky held in VMEM).  Same arithmetic: an in-place
// right-looking Cholesky G = L·Lᵀ with the pivot scaled by rsqrt, a forward
// solve L·z = rhs, then a back solve Lᵀ·θ = z.
//
// What bounds it: the lower triangle of G is read once (B·N(N+1)/2 floats),
// rhs read and θ written once, against about B·N³/3 flops, so at the serving
// shape (B = 256, N = 100) it is bound by device-memory bytes (~5.4 MB →
// ~1.6 µs on an H100 SXM at 3.35 TB/s); the arithmetic (~90 MFLOP of f32,
// ~1.35 µs at 67 TFLOP/s) is close behind.
//
// Design (simple and right first): one thread block per system, so a batch
// of any size runs with no padded slots, and G is read from device memory
// exactly once, coalesced.  The block keeps the packed lower triangle of its
// system (N(N+1)/2 floats: 20 KB at N = 100, 182 KB at N = 301), the scaled
// pivot column and the solution vector in dynamic shared memory; the factor
// loop runs column by column with the block's warps sharing the trailing
// lower-triangle update (one warp per row, lanes along the contiguous packed
// row, so shared-memory reads do not conflict) and two barriers per column.
// The substitutions run on the first warp with a warp-shuffle reduction per
// row: a row holds at most a few hundred terms, and one warp needs no block
// barrier between rows.  When the workspace exceeds the block's shared-memory
// limit (N > 338 on an H100), the same code runs on a per-system scratch
// buffer in global memory that the caller allocates; every N is taken.
// Later work: several systems per block, wgmma for the trailing update.

#include <cuda_runtime.h>

namespace {

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

// Floats of global scratch each system needs: 0 when its workspace fits in
// the current device's shared memory, -1 on a CUDA error.
long long ridge_cholesky_scratch_floats(int n) {
  int dev = 0;
  int optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  const size_t bytes = workspace_floats(n) * sizeof(float);
  return bytes <= static_cast<size_t>(optin)
             ? 0
             : static_cast<long long>(workspace_floats(n));
}

// G (batch, n, n), rhs and out (batch, n), all float32, contiguous, on the
// current device.  `scratch` is null for the shared-memory path, else
// batch · ridge_cholesky_scratch_floats(n) floats.  Launches on `stream`
// and returns the launch's cudaError_t.
int ridge_cholesky_launch(const float* G, const float* rhs, float* out,
                          float* scratch, int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch == nullptr) {
    const size_t bytes = workspace_floats(n) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        ridge_cholesky_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    ridge_cholesky_kernel<true><<<batch, kThreads, bytes, s>>>(
        G, rhs, out, nullptr, n);
  } else {
    ridge_cholesky_kernel<false><<<batch, kThreads, 0, s>>>(
        G, rhs, out, scratch, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
