// K3 — row gather out[m] = table[idx[m]] from a table held in shared memory,
// on Hopper.
//
// Replaces: experiments/vmem_gather_probe.py::vmem_gather of the TPU
// package, a probe that keeps the whole table resident in on-chip memory
// (VMEM) across the grid and streams index blocks past it, copying rows
// on-chip instead of one device-memory transaction per row.
//
// What bounds it: bytes.  Each index read once (4 B), each output row
// written once (W·4 B), and the table read once (I·W·4 B): the writes are
// almost all of it.
//
// Design: one persistent block of 1,024 threads per SM (the grid is never
// larger than the SM count, so the table is read from device memory once
// per SM, not once per block).  Each block stages the whole table into
// dynamic shared memory with 16-byte loads.  Then each warp takes 32
// indices at a time: one coalesced load, one index a lane, kept in a
// register and broadcast by shuffle, so no row waits on a load from device
// memory of its own.  At W = 128 a row is one 16-byte store a lane (a
// wider row several, a narrower one leaves lanes idle), and the 32 rows'
// stores go out back to back, streaming (evict first: the output is never
// read here).  The table is never written after staging, so nothing waits
// but the stores.  An index outside [0, I) writes a row of NaN and reads
// nothing.  Above 48 KB the launch opts in with
// cudaFuncSetAttribute; a table larger than a block's shared memory
// (232,448 bytes on an H100: 454 rows at W = 128) does not fit, and the
// wrapper refuses it before launch.  That is the finding this probe records
// for the card: the catalogs the SGD step gathers from (9-14 MB) live in
// the 50 MB L2, not in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Copies row r of the staged table (or NaN when r is out of range) to dst,
// one float4 a lane, columns lane, lane + 32, ...
__device__ __forceinline__ void copy_row(const float4* tab, float4* dst,
                                         int r, int I, int w4, int lane) {
  if (static_cast<unsigned>(r) < static_cast<unsigned>(I)) {
    const float4* src = tab + static_cast<size_t>(r) * w4;
    for (int c = lane; c < w4; c += 32) __stcs(dst + c, src[c]);
  } else {
    const float nan = __int_as_float(0x7fc00000);
    for (int c = lane; c < w4; c += 32)
      __stcs(dst + c, make_float4(nan, nan, nan, nan));
  }
}

__global__ void __launch_bounds__(kThreads)
smem_gather_kernel(const float4* __restrict__ table,
                   const int* __restrict__ idx, float4* __restrict__ out,
                   long long M, int I, int w4) {
  extern __shared__ float4 tab[];
  const int n4 = I * w4;
  for (int e = threadIdx.x; e < n4; e += kThreads) tab[e] = table[e];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long n_chunks = (M + 31) / 32;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long ch = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
       ch < n_chunks; ch += stride) {
    const long long m0 = ch * 32;
    const int rows = M - m0 < 32 ? static_cast<int>(M - m0) : 32;
    const int mine = lane < rows ? __ldcs(idx + m0 + lane) : 0;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) {
      const int r = __shfl_sync(0xffffffffu, mine, k);
      if (k < rows) copy_row(tab, out + (m0 + k) * w4, r, I, w4, lane);
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
// idx (M,) int32 (a row of NaN for an index outside [0, I)).  Launches on
// `stream`; returns the cudaError_t (cudaErrorInvalidValue when the table
// does not fit).
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
  const long long per_block = 32LL * kWarps;  // indices a block takes a pass
  const long long n_blocks = (M + per_block - 1) / per_block;
  const int grid = static_cast<int>(n_blocks < sms ? n_blocks : sms);
  smem_gather_kernel<<<grid, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<float4*>(out), M, I, W / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
