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
// Bound: memory. Each output row moves 4 width bytes from a random table
// row (a 32-byte sector read for the 20-byte rows of the bucket-row table)
// and 4 width bytes of contiguous output. Design: a block owns
// rows_per_block consecutive output rows (the TPU's TROWS, any value up to
// kMaxRows). It stages their indices in shared memory once, then its
// threads walk the block's contiguous run of rows_per_block * width output
// words with unit stride: stores are coalesced whatever the width, loads
// go through the read-only cache. No tiling of n is needed: the last block
// masks its ragged edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 1024;

__global__ void __launch_bounds__(kThreads)
dma_gather_kernel(const int32_t* __restrict__ tab, long long nrows,
                  int width, const int32_t* __restrict__ idx, long long n,
                  int rows_per_block, int32_t* __restrict__ out) {
  __shared__ long long row_of[kMaxRows];
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long left = n - r0;
  const int rows = left < rows_per_block ? (int)left : rows_per_block;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const long long i = __ldg(idx + r0 + r);
    if (i < 0 || i >= nrows) __trap();
    row_of[r] = i * width;
  }
  __syncthreads();
  const int nwords = rows * width;
  int32_t* dst = out + r0 * width;
  for (int e = threadIdx.x; e < nwords; e += kThreads) {
    const int r = e / width;
    dst[e] = __ldg(tab + row_of[r] + (e - r * width));
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
      (long long)rows_per_block * width > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dma_gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, nrows, width, (const int32_t*)idx, n,
      rows_per_block, (int32_t*)out);
  return (int)cudaGetLastError();
}
