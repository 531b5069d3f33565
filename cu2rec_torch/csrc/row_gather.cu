// K2 — random row gather out[m] = table[idx[m]] with one bulk copy per row,
// on Hopper.
//
// Replaces: experiments/gather_roofline.py::_pallas_row_gather of the TPU
// package, a probe that issues one HBM→VMEM DMA per row with 16 copies in
// flight, to measure the copy-issue rate of the SGD step's random gathers.
// The Hopper form of "one copy per row, 16 in flight" is the Tensor Memory
// Accelerator's bulk copy: one thread of each block issues a
// cp.async.bulk global→shared per row, which completes on an mbarrier; a
// ring of 16 stages keeps 16 copies in flight per block.  As each row
// arrives the block's warp stores it to `out` with 16-byte stores, then the
// issuing thread reuses the stage for the row 16 ahead.
//
// Ordering: a stage's mbarrier completes (phase parity = use count & 1) once
// its copy has landed, and the wait makes the bytes visible to the warp.
// Before a stage is refilled, the warp's reads of it are ordered ahead of
// the copy engine's write by __syncwarp and fence.proxy.async.shared::cta.
// Rows must be 16-byte multiples on 16-byte boundaries (bulk-copy rules); the
// wrapper checks that.  An index outside [0, I) issues no copy (the stage's
// barrier completes on a plain arrive) and writes a row of NaN, so the kernel
// never reads outside the table; checking indices on the host would cost a
// reduction and a sync per call, more than the gather itself.
//
// What bounds it: bytes.  Each index is read once (4 B), each row read once
// and written once (2·W·4 B): at M = 131,072 and W = 128, 134 MB, ~0.04 ms at
// 3.35 TB/s.  A 512-byte row is four 128-byte lines, so the row-transaction
// rate, not the byte rate, is what a gather of short rows runs into; this
// probe measures how close per-row bulk copies come.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 16;
constexpr int kThreads = 32;
constexpr int kRowsPerBlock = 64;
constexpr int kMaxRowBytes = 2048;
constexpr int kBarrierBytes = 128;  // kStages mbarriers of 8 bytes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ table,
                  const int* __restrict__ idx, float* __restrict__ out,
                  long long M, int I, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarrierBytes);
  const long long m0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long rem = M - m0;
  const int n = static_cast<int>(rem < kRowsPerBlock ? rem : kRowsPerBlock);
  const int lane = threadIdx.x;
  const uint32_t row_bytes = static_cast<uint32_t>(W) * 4u;

  auto in_range = [&](int j) {
    return static_cast<unsigned>(idx[m0 + j]) < static_cast<unsigned>(I);
  };
  auto issue = [&](int j) {
    const int s = j % kStages;
    if (!in_range(j)) {
      mbar_arrive(&bars[s]);
      return;
    }
    mbar_expect_tx(&bars[s], row_bytes);
    bulk_copy_g2s(ring + s * W,
                  table + static_cast<size_t>(idx[m0 + j]) * W, row_bytes,
                  &bars[s]);
  };

  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < n && j < kStages; ++j) issue(j);
  }
  __syncwarp();

  const int w4 = W / 4;
  for (int j = 0; j < n; ++j) {
    const int s = j % kStages;
    mbar_wait(&bars[s], static_cast<uint32_t>((j / kStages) & 1));
    const float4* src = reinterpret_cast<const float4*>(ring + s * W);
    float4* dst = reinterpret_cast<float4*>(out + (m0 + j) * W);
    if (in_range(j)) {
      for (int c = lane; c < w4; c += 32) dst[c] = src[c];
    } else {
      const float nan = __int_as_float(0x7fc00000);
      for (int c = lane; c < w4; c += 32)
        dst[c] = make_float4(nan, nan, nan, nan);
    }
    __syncwarp();
    if (lane == 0 && j + kStages < n) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(j + kStages);
    }
  }
}

}  // namespace

extern "C" {

// table (I, W) and out (M, W) float32, idx (M,) int32 (a row of NaN for an
// index outside [0, I)); W a multiple of 4 with 4·W <= kMaxRowBytes; table
// and out 16-byte aligned.  Launches on `stream`; returns the cudaError_t.
int row_gather_launch(const float* table, const int* idx, float* out,
                      long long M, int I, int W, void* stream) {
  if (M <= 0 || I < 0 || W <= 0 || W % 4 != 0 || 4 * W > kMaxRowBytes)
    return cudaErrorInvalidValue;
  const long long blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  const size_t smem = kBarrierBytes + static_cast<size_t>(kStages) * W * 4;
  row_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(table, idx, out,
                                                           M, I, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
