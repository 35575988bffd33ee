// hdist_chunk: count-gated Hamming compare of each probe with its C
// candidates, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel krepp_tpu/query/pallas_kernels.py
// (_hdist_kernel, called by hdist_chunk). Contract, per probe n of N and
// candidate j < C:
//   hd[n, j] = popcount(((z | z >> 16) & 0xffff)), z = enc[n, j] ^ res[n],
//              or 255 where j >= cnt[n] or that distance exceeds th
//   gmin[n]  = min over j of hd[n, j]
// res [N], enc [N, C] (u32 bit patterns) and cnt [N] are int32.
//
// Bound: memory. 8 C + 8 bytes move per probe (enc in, hd out, res and cnt
// in) for a few integer ops per element. Design: a block of 256 threads
// owns 256 consecutive probes, i.e. one contiguous run of 256 C elements of
// enc and hd, which its threads stream with unit stride (coalesced loads
// and stores, whatever C is). Row minima go through shared-memory
// atomicMin, which commutes, so the result is deterministic. The TPU
// kernel's 1024-row padded tiles are not needed: the last block masks its
// ragged edge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;
constexpr int kSentinel = 255;

__device__ __forceinline__ int hdist16(uint32_t a, uint32_t b) {
  const uint32_t z = a ^ b;
  return __popc((z | (z >> 16)) & 0xffffu);
}

__global__ void __launch_bounds__(kThreads)
hdist_chunk_kernel(const int32_t* __restrict__ res,
                   const int32_t* __restrict__ enc,
                   const int32_t* __restrict__ cnt, int N, int C, int th,
                   int32_t* __restrict__ hd, int32_t* __restrict__ gmin) {
  __shared__ int32_t row_min[kRows];
  const size_t row0 = (size_t)blockIdx.x * kRows;
  const long long left = (long long)N - (long long)row0;
  const int nrows = left < kRows ? (int)left : kRows;
  for (int i = threadIdx.x; i < kRows; i += kThreads) row_min[i] = kSentinel;
  __syncthreads();
  const int nelem = nrows * C;
  const size_t e0 = row0 * C;
  for (int e = threadIdx.x; e < nelem; e += kThreads) {
    const int r = e / C;
    const int j = e - r * C;
    const size_t n = row0 + r;
    int h = hdist16((uint32_t)enc[e0 + e], (uint32_t)res[n]);
    if (j >= cnt[n] || h > th) h = kSentinel;
    hd[e0 + e] = h;
    if (h < kSentinel) atomicMin(&row_min[r], h);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows; i += kThreads)
    gmin[row0 + i] = row_min[i];
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int krepp_hdist_chunk(const void* res, const void* enc,
                                 const void* cnt, int N, int C, int th,
                                 void* hd, void* gmin, void* stream) {
  if (N <= 0) return 0;
  if (C < 1 || th < 0 || (long long)kRows * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int blocks = (N + kRows - 1) / kRows;
  hdist_chunk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)res, (const int32_t*)enc, (const int32_t*)cnt, N, C, th,
      (int32_t*)hd, (int32_t*)gmin);
  return (int)cudaGetLastError();
}
