// probe_hist_packed: the dist probe epilogue for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel krepp_tpu/query/pallas_kernels.py
// (_packed_kernel, called by probe_hist_packed). Contract, per strand-read
// row n of N and position p < P (P <= 255):
//   hd_c   = popcount(((z | z >> 16) & 0xffff)), z = enc_c ^ res   (c < C0)
//   hdg_c  = hd_c if (hd_c <= th and light) else X          (X = th + 1)
//   mh(s)  = min over c with bit s of mask_c of hdg_c, else X   (s < S)
//   hist[n, s, x] = #positions with mh(s) == x                   (x < X)
//   minall[n]     = min over (p, s) of mh(s), 255 when that is X
// i.e. the reference's per-(position, leaf) minimum-distance dedupe
// (src/query.hpp:153-176). Inputs are the gathered bucket rows
// d [N, P, width] int32 (word 0 = count, enc_c at 1 + 2c, mask_c at
// 2 + 2c), the probe residuals res [N, P] int32 and light [N, P] bool.
//
// Bound: about 4 + 1 + 4 * 2 * C0 (~21-28) bytes read per (row, position)
// and S * X * 4 bytes written per row, with a handful of integer ops per
// byte: bandwidth- and latency-bound, far from any compute limit. Design:
// one block per row, one thread per position (P <= 255 < 256 threads). Each
// thread folds its candidates into per-class leaf planes with first-class-
// wins (plane_x = leaves whose minimum class is x); a warp then counts leaf
// s of class x with one __ballot_sync + __popc, the eight warps' counts are
// summed through shared memory, and minall is a warp min-reduce. No
// atomics: the result is deterministic and bit-equal to the plain version.
// The TPU kernel's base-256 packed counters are unnecessary here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxX = 6;
constexpr int kMaxS = 32;
constexpr int kMaxC0 = 2;
constexpr int kSentinel = 255;

__global__ void __launch_bounds__(kThreads)
probe_hist_packed_kernel(const int32_t* __restrict__ res,
                         const uint8_t* __restrict__ light,
                         const int32_t* __restrict__ d, int P, int width,
                         int th, int C0, int S, int32_t* __restrict__ hist,
                         int32_t* __restrict__ minall) {
  __shared__ int32_t counts[kWarps][kMaxX][kMaxS];
  __shared__ int32_t warp_min[kWarps];

  const int row = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int X = th + 1;
  const uint32_t leaf_bits = S >= 32 ? 0xffffffffu : ((1u << S) - 1u);

  uint32_t plane[kMaxX];
#pragma unroll
  for (int x = 0; x < kMaxX; ++x) plane[x] = 0u;
  int gm = X;

  if (p < P) {
    const size_t off = (size_t)row * P + p;
    if (light[off]) {
      const uint32_t r = (uint32_t)res[off];
      const int32_t* e = d + off * width;
      int hdg[kMaxC0];
      uint32_t msk[kMaxC0];
#pragma unroll
      for (int c = 0; c < kMaxC0; ++c) {
        hdg[c] = X;
        msk[c] = 0u;
        if (c < C0) {
          const uint32_t z = (uint32_t)e[1 + 2 * c] ^ r;
          const int hd = __popc((z | (z >> 16)) & 0xffffu);
          hdg[c] = hd <= th ? hd : X;
          msk[c] = (uint32_t)e[2 + 2 * c] & leaf_bits;
          if (msk[c] != 0u && hdg[c] < gm) gm = hdg[c];
        }
      }
      uint32_t seen = 0u;
#pragma unroll
      for (int x = 0; x < kMaxX; ++x) {
        uint32_t hit = 0u;
#pragma unroll
        for (int c = 0; c < kMaxC0; ++c)
          if (hdg[c] == x) hit |= msk[c];
        plane[x] = hit & ~seen;  // first (lowest) class wins per leaf
        seen |= hit;
      }
    }
  }

  // per-warp counts: lane s keeps the count of leaf s for each class
#pragma unroll
  for (int x = 0; x < kMaxX; ++x) {
    if (x < X) {
      int mine = 0;
      for (int s = 0; s < S; ++s) {
        const unsigned b = __ballot_sync(0xffffffffu, (plane[x] >> s) & 1u);
        if (lane == s) mine = __popc(b);
      }
      counts[warp][x][lane] = mine;
    }
  }
  const int wm = __reduce_min_sync(0xffffffffu, gm);
  if (lane == 0) warp_min[warp] = wm;
  __syncthreads();

  int32_t* out = hist + (size_t)row * S * X;
  for (int t = threadIdx.x; t < S * X; t += kThreads) {
    const int s = t / X;
    const int x = t - s * X;
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += counts[w][x][s];
    out[t] = sum;
  }
  if (threadIdx.x == 0) {
    int m = warp_min[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = min(m, warp_min[w]);
    minall[row] = m >= X ? kSentinel : m;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int krepp_probe_hist_packed(const void* res, const void* light,
                                       const void* d, int N, int P, int width,
                                       int th, int C0, int S, void* hist,
                                       void* minall, void* stream) {
  if (N <= 0) return 0;
  if (P < 1 || P > kThreads - 1 || th < 0 || th + 1 > kMaxX || S < 1 ||
      S > kMaxS || C0 < 1 || C0 > kMaxC0 || width < 1 + 2 * C0)
    return (int)cudaErrorInvalidValue;
  probe_hist_packed_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)res, (const uint8_t*)light, (const int32_t*)d, P, width,
      th, C0, S, (int32_t*)hist, (int32_t*)minall);
  return (int)cudaGetLastError();
}
