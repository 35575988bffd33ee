// probe_hist_tiles: the general dist probe epilogue for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel krepp_tpu/query/pallas_kernels.py
// (_probe_hist_kernel, called by probe_hist_tiles). Contract, per strand-read
// row n of N, position p < P (any P) and candidate c < C0 (C0 <= 2):
//   hd_c    = popcount(((z | z >> 16) & 0xffff)), z = enc_c ^ res
//   match_c = hd_c <= th and light and (any mask word of c != 0)
//   mh(s)   = min over matching c with bit s of its mask of hd_c, else none
//   hist[n, s, x] = #positions with mh(s) == x            (s < S, x < X)
//   minall[n]     = min over (p, matching c) of hd_c, 255 when none
// i.e. the reference's per-(position, leaf) minimum-distance dedupe
// (src/query.hpp:153-176), with S <= 32 W leaves in W <= 8 mask words.
// Inputs: the gathered bucket rows d [N, P, width] int32, either embed rows
// (enc_c at column 1 + c(1+W), its W mask words after it) or 'se' rows
// (enc_c at 1 + c, the color id se_c at 1 + C0 + c; the mask words are read
// through the id from mask_tab [nse, W], so no [N, P, C0, W] gather is ever
// materialised), the residuals res [N, P] int32 and light [N, P] bool.
//
// Bound: about 25 bytes read per (row, position) of d/res/light, plus up to
// 2 W mask words from an L2-resident table for 'se' rows; the work is a few
// integer ops per candidate and, per set leaf bit of a warp, one
// __match_any_sync. Latency/issue-bound, far from any memory or compute
// roof. Design: one block of 128 threads per row, looping over positions in
// chunks of 128 (any P). Each thread orders its two candidates by class, so
// its first-class-wins planes are a = mask of the lower class and
// b = mask of the other & ~a. Per mask word the warp walks the union of its
// set leaf bits (warp-uniform, so the shuffles stay converged); lanes with
// the same class for that leaf are grouped by __match_any_sync and their
// leader adds the group size to a [S, X] int32 counter array in shared
// memory. Integer atomics commute, so the result is deterministic and
// bit-equal to the plain version. minall is a warp min-reduce. The TPU
// kernel's (8, 128) tiling and its [X, W] plane loops are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 8;
constexpr int kMaxC0 = 2;
constexpr int kMaxSmem = 48 * 1024;
constexpr int kSentinel = 255;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int hdist16(uint32_t a, uint32_t b) {
  const uint32_t z = a ^ b;
  return __popc((z | (z >> 16)) & 0xffffu);
}

__global__ void __launch_bounds__(kThreads)
probe_hist_tiles_kernel(const int32_t* __restrict__ res,
                        const uint8_t* __restrict__ light,
                        const int32_t* __restrict__ d,
                        const int32_t* __restrict__ mask_tab, int nse, int P,
                        int width, int th, int C0, int W, int S,
                        int32_t* __restrict__ hist,
                        int32_t* __restrict__ minall) {
  extern __shared__ int32_t counts[];  // [S][X]
  __shared__ int32_t warp_min[kWarps];

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int X = th + 1;
  for (int t = threadIdx.x; t < S * X; t += kThreads) counts[t] = 0;
  __syncthreads();

  int gm = kSentinel;
  for (int base = 0; base < P; base += kThreads) {  // uniform trip count
    const int p = base + threadIdx.x;
    int hd[kMaxC0];
    bool match[kMaxC0];
    uint32_t m[kMaxC0][kMaxW];
#pragma unroll
    for (int c = 0; c < kMaxC0; ++c) {
      hd[c] = kSentinel;
      match[c] = false;
#pragma unroll
      for (int w = 0; w < kMaxW; ++w) m[c][w] = 0u;
    }
    if (p < P) {
      const size_t off = (size_t)row * P + p;
      if (light[off]) {
        const uint32_t r = (uint32_t)res[off];
        const int32_t* e = d + off * width;
#pragma unroll
        for (int c = 0; c < kMaxC0; ++c) {
          if (c < C0) {
            const int32_t* words;
            if (mask_tab == nullptr) {
              hd[c] = hdist16((uint32_t)e[1 + c * (1 + W)], r);
              words = e + 2 + c * (1 + W);
            } else {
              hd[c] = hdist16((uint32_t)e[1 + c], r);
              const int se = min(max(e[1 + C0 + c], 0), nse - 1);
              words = mask_tab + (size_t)se * W;
            }
            uint32_t any = 0u;
#pragma unroll
            for (int w = 0; w < kMaxW; ++w) {
              if (w < W) {
                m[c][w] = (uint32_t)words[w];
                any |= m[c][w];
              }
            }
            match[c] = any != 0u && hd[c] <= th;
            if (match[c]) gm = min(gm, hd[c]);
          }
        }
      }
    }
    // order the candidates by class: A holds the lower one
    const bool swap = match[0] && match[1] && hd[1] < hd[0];
    const int hA = swap ? hd[1] : hd[0];
    const int hB = swap ? hd[0] : hd[1];
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w < W) {
        const int lo = w * 32;
        const uint32_t leaf_bits =
            S - lo >= 32 ? 0xffffffffu : ((1u << (S - lo)) - 1u);
        const uint32_t m0 = match[0] ? m[0][w] : 0u;
        const uint32_t m1 = match[1] ? m[1][w] : 0u;
        const uint32_t a = (swap ? m1 : m0) & leaf_bits;
        const uint32_t b = (swap ? m0 : m1) & leaf_bits & ~a;
        uint32_t U = __reduce_or_sync(kFull, a | b);
        while (U != 0u) {  // warp-uniform
          const int s = __ffs(U) - 1;
          U &= U - 1u;
          const int cls =
              ((a >> s) & 1u) ? hA : (((b >> s) & 1u) ? hB : -1);
          const unsigned same = __match_any_sync(kFull, cls);
          if (cls >= 0 && lane == __ffs(same) - 1)
            atomicAdd(&counts[(lo + s) * X + cls], __popc(same));
        }
      }
    }
  }

  const int wm = __reduce_min_sync(kFull, gm);
  if (lane == 0) warp_min[warp] = wm;
  __syncthreads();
  int32_t* out = hist + (size_t)row * S * X;
  for (int t = threadIdx.x; t < S * X; t += kThreads) out[t] = counts[t];
  if (threadIdx.x == 0) {
    int mn = warp_min[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mn = min(mn, warp_min[w]);
    minall[row] = mn;
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// mask_tab is null for embed rows.
extern "C" int krepp_probe_hist_tiles(const void* res, const void* light,
                                      const void* d, const void* mask_tab,
                                      int nse, int N, int P, int width, int th,
                                      int C0, int W, int S, void* hist,
                                      void* minall, void* stream) {
  if (N <= 0) return 0;
  const int X = th + 1;
  const int need = mask_tab == nullptr ? 1 + C0 * (1 + W) : 1 + 2 * C0;
  if (P < 1 || th < 0 || C0 < 1 || C0 > kMaxC0 || W < 1 || W > kMaxW ||
      (S + 31) / 32 != W || width < need ||
      (mask_tab != nullptr && nse < 1) ||
      (long long)S * X * 4 > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  probe_hist_tiles_kernel<<<N, kThreads, S * X * 4, (cudaStream_t)stream>>>(
      (const int32_t*)res, (const uint8_t*)light, (const int32_t*)d,
      (const int32_t*)mask_tab, nse, P, width, th, C0, W, S,
      (int32_t*)hist, (int32_t*)minall);
  return (int)cudaGetLastError();
}
