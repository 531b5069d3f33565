// K3 — row gather out[m] = table[idx[m]] from a table held in shared memory,
// on Hopper.
//
// Replaces: experiments/vmem_gather_probe.py::vmem_gather of the TPU
// package, a probe that keeps the whole table resident in on-chip memory
// (VMEM) across the grid and streams index blocks past it, copying rows
// on-chip instead of one device-memory transaction per row.
//
// Design: one persistent block per SM (the grid is never larger than the SM
// count, so the table is read from device memory once per SM, not once per
// block).  Each block stages the whole table into dynamic shared memory with
// 16-byte loads, then walks blocks of 2048 indices in a grid-stride loop;
// each warp copies one row at a time shared→global with 16-byte stores.  An
// index outside [0, I) writes a row of NaN and reads nothing.
// Above 48 KB the launch opts in with cudaFuncSetAttribute; a table larger
// than a block's shared memory (232,448 bytes on an H100: 454 rows at
// W = 128) does not fit, and the wrapper refuses it before launch.  That is
// the finding this probe records for the card: the catalogs the SGD step
// gathers from (9-14 MB) live in the 50 MB L2, not in shared memory.
//
// What bounds it: bytes.  Each index read once (4 B), each output row
// written once (W·4 B), and the table read once (I·W·4 B).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIndexBlock = 2048;

__global__ void __launch_bounds__(kThreads)
smem_gather_kernel(const float4* __restrict__ table,
                   const int* __restrict__ idx, float4* __restrict__ out,
                   long long M, int I, int w4) {
  extern __shared__ float4 tab[];
  const int n4 = I * w4;
  for (int e = threadIdx.x; e < n4; e += kThreads) tab[e] = table[e];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n_blocks = (M + kIndexBlock - 1) / kIndexBlock;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long m_end = b * kIndexBlock + kIndexBlock < M
                                ? b * kIndexBlock + kIndexBlock
                                : M;
    for (long long m = b * kIndexBlock + warp; m < m_end; m += kWarps) {
      const int r = idx[m];
      float4* dst = out + m * w4;
      if (static_cast<unsigned>(r) < static_cast<unsigned>(I)) {
        const float4* src = tab + static_cast<size_t>(r) * w4;
        for (int c = lane; c < w4; c += 32) dst[c] = src[c];
      } else {
        const float nan = __int_as_float(0x7fc00000);
        for (int c = lane; c < w4; c += 32)
          dst[c] = make_float4(nan, nan, nan, nan);
      }
    }
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of the current device can opt in to.
int smem_gather_limit_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin;
}

// table (I, W) and out (M, W) float32, 16-byte aligned, W a multiple of 4;
// idx (M,) int32 (a row of NaN for an index outside [0, I)).  Launches on `stream`; returns the
// cudaError_t (cudaErrorInvalidValue when the table does not fit).
int smem_gather_launch(const float* table, const int* idx, float* out,
                       long long M, int I, int W, void* stream) {
  if (M <= 0 || I <= 0 || W <= 0 || W % 4 != 0) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(I) * W * 4;
  const int limit = smem_gather_limit_bytes();
  if (limit < 0) return cudaErrorInvalidDevice;
  if (bytes > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(smem_gather_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_blocks = (M + kIndexBlock - 1) / kIndexBlock;
  const int grid = static_cast<int>(n_blocks < sms ? n_blocks : sms);
  smem_gather_kernel<<<grid, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<float4*>(out), M, I, W / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
