// dma_gather: row gather out[i, :] = tab[idx[i], :] of a narrow u32 table,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/probe_microbench.py (dma_kernel,
// called by dma_gather): one async DMA per row into a VMEM tile of TROWS
// rows, n a multiple of TROWS. Contract: tab [nrows, width] and out
// [n, width] int32 (u32 bit patterns), idx [n] int32 with 0 <= idx < nrows;
// any n >= 0 and width >= 1. An index outside [0, nrows) traps (the launch
// fails), as the card's own indexing asserts.
//
// Bound: device memory at random addresses. Each output row moves 4 width
// bytes of contiguous output and 4 width bytes from a random table row,
// and the memory does not move 20 bytes: a 20-byte row at a 20-byte stride
// lies in one 32-byte sector or straddles two (48 bytes a row on average),
// and a sector that misses the L2 costs a 64-byte access at a random
// address. Measured on the card (PERF.md): the time follows the table's
// size, not the kernel's shape. A table of 21 MB stays in the
// L2 and the gather runs a third faster than on the main shape's 42 MB,
// which the L2 does not keep from one launch to the next beside 24 MB of
// indices and output streaming through; on a 640 MB table every variant
// tried lands within 3% of the same time.
//
// Design: a block owns rows_per_block consecutive output rows (the TPU's
// TROWS, any value up to kMaxRows), one contiguous run of the output.
//   1. It stages the rows' word offsets in shared memory once (and traps
//      on an index out of range).
//   2. Its threads walk the run with unit stride between neighbours, so a
//      warp's 32 words lie in about 7 table rows and its stores fill whole
//      128-byte lines whatever the width. A thread steps its (row, column)
//      pair by the constant that kThreads words make: one integer division
//      a thread, none a word.
//   3. A thread starts kBatch independent loads before it stores the first
//      of them (at the main shape, 256 rows of 5 words, that is all of its
//      words), so each thread has kBatch sectors in flight, not one. Worth
//      about 1% on the card.
//   4. Indices and output are touched once: their loads and stores carry
//      an L2 evict-first policy, which leaves the L2 to the table. Worth
//      3-4% at the main shape, nothing on a table far beyond the L2.
// No tiling of n is needed: the last block masks its ragged edge.
//
// Tried on the card and not adopted, being slower at the main shape (times
// in PERF.md): a persistent grid staging each tile through a ring of shared-
// memory slots with 4-byte cp.async and writing it out in 16-byte stores
// (a barrier a tile and a second pass over shared memory cost more than
// the wider stores gain; TMA bulk copies do not apply, a 20-byte row has
// no 16-byte alignment); an L2 evict-last policy
// on a quarter to all of the table's lines (the table then evicts itself).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 1024;
constexpr int kBatch = 5;      // loads a thread starts before it stores

// L2 policy for data touched once
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ int32_t load_once(const int32_t* p, uint64_t pol) {
  int32_t v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.b32 %0, [%1], %2;\n"
      : "=r"(v)
      : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void store_once(int32_t* p, int32_t v,
                                           uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;\n" ::"l"(p),
               "r"(v), "l"(pol)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
dma_gather_kernel(const int32_t* __restrict__ tab, long long nrows,
                  int width, const int32_t* __restrict__ idx, long long n,
                  int rows_per_block, int32_t* __restrict__ out) {
  __shared__ long long row_of[kMaxRows];
  const uint64_t once = evict_first_policy();
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long left = n - r0;
  const int rows = left < rows_per_block ? (int)left : rows_per_block;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const long long i = load_once(idx + r0 + r, once);
    if (i < 0 || i >= nrows) __trap();
    row_of[r] = i * width;
  }
  __syncthreads();
  const int nwords = rows * width;
  int32_t* dst = out + r0 * width;
  // (row, column) of word threadIdx.x and the step that kThreads words make
  const int r_step = kThreads / width, c_step = kThreads - r_step * width;
  int r = threadIdx.x / width, c = threadIdx.x - r * width;
  for (int e = threadIdx.x; e < nwords; e += kThreads * kBatch) {
    int32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (e + u * kThreads < nwords) v[u] = __ldg(tab + row_of[r] + c);
      r += r_step;
      c += c_step;
      if (c >= width) {
        c -= width;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (e + u * kThreads < nwords)
        store_once(dst + e + u * kThreads, v[u], once);
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int krepp_dma_gather(const void* tab, long long nrows, int width,
                                const void* idx, long long n,
                                int rows_per_block, void* out,
                                void* stream) {
  if (n <= 0) return 0;
  if (width < 1 || rows_per_block < 1 || rows_per_block > kMaxRows ||
      (long long)rows_per_block * width > 0x7fffffffLL - kThreads * kBatch)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dma_gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, nrows, width, (const int32_t*)idx, n,
      rows_per_block, (int32_t*)out);
  return (int)cudaGetLastError();
}
