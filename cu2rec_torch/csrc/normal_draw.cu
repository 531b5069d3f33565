// K5 — a model's starting tables, Normal(0, 1/F), drawn on Hopper with the
// very bits that `torch.randn` gives on the CPU from
// `torch.Generator().manual_seed(seed)`.
//
// No Pallas original: the TPU package draws its tables from a threefry
// stream inside XLA.  The port's tables come from torch's CPU generator
// (the benchmark's plain reference draws them the same way), which took
// the host over a second a Netflix-sized job while the card idled.
//
// What torch's CPU draw is, for a float32 tensor of n >= 16 entries (the
// wrapper, ops/cuda_draw.py, takes this kernel only then):
//   * n uniforms, each the low 24 bits of one tempered MT19937 word
//     (at::mt19937, seeded from seed & 0xffffffff);
//   * Box–Muller in groups of 16: with k1 = the 24 bits of word p and
//     k2 = those of word p + 8 (p < 8), entry p = r[k1]·cos[k2] and entry
//     p + 8 = r[k1]·sin[k2], each product rounded once, then + 0.0f (torch's
//     fma(x, 1, 0), which makes −0 +0);
//   * where n % 16 != 0, entries [n − 16, n) drawn again from 16 more words,
//     so the tensor takes n + 16 words; the tables follow each other in the
//     stream (the plan's offsets).
// r, cos and sin are torch's own vectorised transcendentals, not libm's nor
// CUDA's: the wrapper tabulates them once from torch's CPU kernel for each
// of the 2^24 inputs (r: R[k], cos and sin interleaved: CS[k]) and checks
// a draw against torch before it trusts them.  Then each entry is divided
// by F (IEEE division, as the CPU's tensor / scalar) and cast to the
// table's dtype (bf16: round to nearest even, as `.to` does).
//
// Two kernels.
//   mt_windows_kernel, one block: walks the MT19937 recurrence
//     x[k + 624] = x[k + 397] ^ twist(x[k], x[k + 1])
//   227 words a step (624 − 397, the recurrence's own dependency distance),
//   two steps between barriers (454 words: the second step's words 624
//   back are still older than the first step's), each thread carrying its
//   word 227 back in a register.  The last 2,048 words live in shared
//   memory; every kChunk words it writes the 624-word window that starts a
//   chunk.
//   normal_draw_kernel, a block a chunk: rebuilds its kChunk + 16 words from
//   the window in shared memory (the groups that start in the chunk end at
//   most 15 words past it), tempers them, and writes each pair of entries
//   of every group that starts in the chunk straight into the table.  A
//   tail group writes [n − 16, n), the main groups only below it: one
//   writer an entry.
//
// What bounds it.  The draw writes 4 bytes an entry (0.6 GB at Netflix's
// F = 300) and gathers R and CS at random, a 32-byte sector each for every
// two entries: about 4.8 GB of sectors, ~1.5 ms at 3.35 TB/s.  The walk is
// serial, ~660,000 steps for Netflix's 150 M words; its barrier sets the
// pace there (jump-ahead would split it, and is not needed while the walk
// stays a small share of the second the CPU took).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The tables of one draw, in stream order (ops/cuda_draw.py::_DrawPlan).
struct DrawTable {
  void* out;            // n entries, float32 or bf16
  long long n;
  long long offset;     // its first word in the stream
};

struct DrawPlan {
  DrawTable t[4];
  int count;
};

namespace {

constexpr int kN = 624;              // MT19937 state words
constexpr int kM = 397;
constexpr int kStep = kN - kM;       // 227 words a step of the walk
constexpr int kThreads = 256;
constexpr int kChunk = 8192;         // words a draw block starts groups in
constexpr int kSpan = kChunk + 16;   // words a draw block rebuilds
constexpr int kRing = 2048;          // the walk's shared ring, in words
constexpr int kMaxTables = 4;

__device__ __forceinline__ uint32_t twist(uint32_t a, uint32_t b) {
  const uint32_t y = (a & 0x80000000u) | (b & 0x7fffffffu);
  return (y >> 1) ^ ((b & 1u) ? 0x9908b0dfu : 0u);
}

__device__ __forceinline__ uint32_t temper24(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  y ^= y >> 18;
  return y & 0xffffffu;
}

// Windows of the stream x: window c is x[c·kChunk .. c·kChunk + 623].
__global__ void __launch_bounds__(kThreads, 1)
mt_windows_kernel(uint32_t seed, long long n_windows,
                  uint32_t* __restrict__ windows) {
  __shared__ uint32_t ring[kRing];       // x[k] at ring[k mod kRing]
  const int t = threadIdx.x;
  if (t == 0) {                          // at::mt19937::init_with_uint32
    uint32_t x = seed;
    ring[0] = x;
    for (uint32_t j = 1; j < kN; ++j) {
      x = 1812433253u * (x ^ (x >> 30)) + j;
      ring[j] = x;
    }
  }
  __syncthreads();
  for (int i = t; i < kN; i += kThreads) windows[i] = ring[i];
  // Two steps between barriers: thread t makes x[j] and x[j + 227],
  // j = J + t, from the word 227 back (its own last one) and the words
  // 624, 623 back (x[j − 624], x[j − 623]; x[j − 397], x[j − 396] for the
  // second), all made before J, so visible since the last barrier.  Ring
  // slots are taken from the low bits of a 32-bit count, which kRing
  // divides.
  constexpr uint32_t kMask = kRing - 1;
  const bool maker = t < kStep;
  uint32_t prev = maker ? ring[kM + t] : 0u;
  uint32_t j = kN + t;
  long long made = kN;                   // x[0 .. made) are made
  long long next = 1;                    // the next window to write
  while (next < n_windows) {
    if (maker) {
      const uint32_t a = ring[(j - kN) & kMask];
      const uint32_t b = ring[(j - kN + 1) & kMask];
      const uint32_t a2 = ring[(j - kM) & kMask];
      const uint32_t b2 = ring[(j - kM + 1) & kMask];
      const uint32_t x1 = prev ^ twist(a, b);
      prev = x1 ^ twist(a2, b2);
      ring[j & kMask] = x1;
      ring[(j + kStep) & kMask] = prev;
    }
    __syncthreads();
    j += 2 * kStep;
    made += 2 * kStep;
    // A window is written once its last word is made, so it lies in the
    // last 1,078 words made; the next two steps write the 454 after them,
    // in no slot of it.
    const long long w0 = next * kChunk;
    if (w0 + kN <= made) {
      uint32_t* out = windows + next * kN;
      for (int i = t; i < kN; i += kThreads)
        out[i] = ring[static_cast<uint32_t>(w0 + i) & kMask];
      ++next;
    }
  }
}

template <class T>
__device__ __forceinline__ void store(void* out, long long i, float v);

template <>
__device__ __forceinline__ void store<float>(void* out, long long i,
                                             float v) {
  static_cast<float*>(out)[i] = v;
}

template <>
__device__ __forceinline__ void store<__nv_bfloat16>(void* out, long long i,
                                                     float v) {
  static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

// One pair of a group: entries e and e + 8 from words k1, k2, each written
// if below lim.
template <class T>
__device__ __forceinline__ void emit(void* out, long long e, long long lim,
                                     uint32_t k1, uint32_t k2,
                                     const float* __restrict__ R,
                                     const float2* __restrict__ CS,
                                     float divisor) {
  const float r = __ldg(R + k1);
  const float2 cs = __ldg(CS + k2);
  const float c = __fadd_rn(__fmul_rn(r, cs.x), 0.0f);
  const float s = __fadd_rn(__fmul_rn(r, cs.y), 0.0f);
  if (e < lim) store<T>(out, e, __fdiv_rn(c, divisor));
  if (e + 8 < lim) store<T>(out, e + 8, __fdiv_rn(s, divisor));
}

template <class T>
__global__ void __launch_bounds__(kThreads)
normal_draw_kernel(const uint32_t* __restrict__ windows,
                   const float* __restrict__ R,
                   const float2* __restrict__ CS, DrawPlan plan,
                   float divisor) {
  __shared__ uint32_t x[kN + kSpan];
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  const uint32_t* win = windows + static_cast<long long>(blockIdx.x) * kN;
  for (int i = threadIdx.x; i < kN; i += kThreads) x[i] = win[i];
  __syncthreads();
  // Word c0 + i is temper(x[kN + i]), made two steps between barriers
  // as the walk makes them: each reads only words made before it.
  const bool maker = threadIdx.x < kStep;
  uint32_t prev = maker ? x[kM + threadIdx.x] : 0u;
  for (int base = 0; base < kSpan; base += 2 * kStep) {
    const int i = base + threadIdx.x;
    if (maker) {
      const uint32_t x1 = prev ^ twist(x[i], x[i + 1]);
      prev = x1 ^ twist(x[i + kStep], x[i + kStep + 1]);
      if (i < kSpan) x[kN + i] = x1;
      if (i + kStep < kSpan) x[kN + i + kStep] = prev;
    }
    __syncthreads();
  }
  const uint32_t* w = x + kN;
#pragma unroll
  for (int k = 0; k < kMaxTables; ++k) {
    if (k >= plan.count) break;
    const DrawTable tab = plan.t[k];
    const long long groups = tab.n / 16;
    const bool tail = tab.n % 16 != 0;
    const long long lim = tail ? tab.n - 16 : tab.n;
    // Main group g starts at word offset + 16g: those in [c0, c0 + kChunk).
    const long long d0 = c0 - tab.offset;
    const long long d1 = d0 + kChunk;
    const long long g0 = d0 <= 0 ? 0 : (d0 + 15) / 16;
    const long long g1 = d1 <= 0 ? 0 : min(groups, (d1 + 15) / 16);
    for (long long q = g0 * 8 + threadIdx.x; q < g1 * 8; q += kThreads) {
      const long long g = q >> 3;
      const int p = static_cast<int>(q & 7);
      const int s = static_cast<int>(16 * g - d0);
      emit<T>(tab.out, 16 * g + p, lim, temper24(w[s + p]),
              temper24(w[s + p + 8]), R, CS, divisor);
    }
    // The tail group starts at word offset + n and writes [n − 16, n).
    const long long ts = tab.n - d0;
    if (tail && ts >= 0 && ts < kChunk && threadIdx.x < 8) {
      const int s = static_cast<int>(ts);
      const int p = threadIdx.x;
      emit<T>(tab.out, tab.n - 16 + p, tab.n, temper24(w[s + p]),
              temper24(w[s + p + 8]), R, CS, divisor);
    }
  }
}

}  // namespace

extern "C" {

// Words a block of the draw starts groups in.
int normal_draw_chunk() { return kChunk; }

// The stream's windows for n_windows chunks, into windows (n_windows · 624
// uint32).  Launches on `stream`; returns the cudaError_t.
int normal_draw_windows(uint32_t seed, long long n_windows, uint32_t* windows,
                        void* stream) {
  if (n_windows < 1) return cudaErrorInvalidValue;
  mt_windows_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      seed, n_windows, windows);
  return static_cast<int>(cudaGetLastError());
}

// The tables of `plan` (count of them, each n >= 16, of one element type:
// elem 0 float32, 1 bf16) from the windows of n_windows chunks, which
// cover every group's start; R (2^24 floats) and CS (2^24 float2) the
// transforms.  Launches on `stream`; returns the cudaError_t.
int normal_draw_launch(const uint32_t* windows, long long n_windows,
                       const float* R, const void* CS, DrawPlan plan,
                       float divisor, int elem, void* stream) {
  if (n_windows < 1 || n_windows > 0x7fffffffLL || plan.count < 1 ||
      plan.count > kMaxTables)
    return cudaErrorInvalidValue;
  for (int k = 0; k < plan.count; ++k)
    if (plan.t[k].n < 16 || plan.t[k].offset < 0)
      return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* cs = static_cast<const float2*>(CS);
  const unsigned blocks = static_cast<unsigned>(n_windows);
  if (elem == 0)
    normal_draw_kernel<float><<<blocks, kThreads, 0, s>>>(windows, R, cs,
                                                          plan, divisor);
  else if (elem == 1)
    normal_draw_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        windows, R, cs, plan, divisor);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
