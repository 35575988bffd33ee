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
// Bound: bytes. A row reads P * (4 width + 5) bytes once and writes
// S * X * 4 + 4. An earlier design ran X * S ballots per warp in all eight
// warps of a 256-thread block, whatever the data and however few positions
// a warp held, with strided 4-byte loads of the 20-byte rows: eight to
// nine times over the bound.
//
// Design: a warp owns a row and only ceil(P / 32) chunks of work exist per
// row. The warp stages the row's contiguous span of d, res and light in its own
// shared-memory double buffer with cp.async, 16 bytes a copy, and the next
// row's copy runs while this row is counted; nothing synchronises across
// warps. A lane takes one position of each chunk, orders its two
// candidates by class and forms two disjoint leaf planes (a: the lower
// class, b: the other & ~a). Two chunks go through a trip together, so
// their butterflies overlap; planes that are empty across the warp are
// skipped (__reduce_or_sync); the others are transposed with a five-stage
// shuffle butterfly (S <= 32 is one warp wide), so lane s holds leaf s's
// positions and adds popc(plane & ballot(class == x)) to X counters in
// registers: 2 X ballots per chunk instead of X * S, no shared counters,
// no block barrier, no atomics. Deterministic and bit-equal to the plain
// version. The grid is persistent, rows dealt to warps round-robin. The
// TPU kernel's base-256 packed counters are unnecessary here.

#include <algorithm>

#include "probe_hist_common.cuh"

namespace {

using namespace krepp;

constexpr int kWarps = 24;
constexpr int kMaxX = 6;
constexpr int kMaxS = 32;
constexpr int kMaxP = 255;

// A lane's two leaf planes of one position (a: the lower class, b: the
// other & ~a) and their classes; empty when the position is past P or dark.
struct Planes {
  uint32_t a, b;
  int hA, hB;
};

__device__ __forceinline__ Planes position_planes(const Tile& tl, int q, int P,
                                                  int width, int th, int C0,
                                                  uint32_t leaf_bits,
                                                  int& gm) {
  int hd[kMaxC0];
  bool match[kMaxC0];
  uint32_t msk[kMaxC0];
#pragma unroll
  for (int c = 0; c < kMaxC0; ++c) {
    hd[c] = kSentinel;
    match[c] = false;
    msk[c] = 0u;
  }
  if (q < P && tl.sl[q]) {
    const uint32_t r = tl.sr[q];
    const uint32_t* e = tl.sd + q * width;
#pragma unroll
    for (int c = 0; c < kMaxC0; ++c) {
      if (c < C0) {
        const int h = hdist16(e[1 + 2 * c], r);
        const uint32_t mk = e[2 + 2 * c] & leaf_bits;
        if (h <= th && mk != 0u) {
          match[c] = true;
          msk[c] = mk;
          hd[c] = h;
          gm = min(gm, h);
        }
      }
    }
  }
  const Ordered o = order_candidates(hd, match);
  Planes p;
  p.a = o.swap ? msk[1] : msk[0];
  p.b = (o.swap ? msk[0] : msk[1]) & ~p.a;
  p.hA = o.hA;
  p.hB = o.hB;
  return p;
}

__global__ void __launch_bounds__(kWarps * 32)
probe_hist_packed_kernel(const uint32_t* __restrict__ res,
                         const uint8_t* __restrict__ light,
                         const uint32_t* __restrict__ d, int N, int P,
                         int width, int th, int C0, int S, int chunks,
                         int32_t* __restrict__ hist,
                         int32_t* __restrict__ minall) {
  extern __shared__ uint4 smem4[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int X = th + 1;
  const uint32_t leaf_bits = S >= 32 ? 0xffffffffu : ((1u << S) - 1u);
  const int bufw = buf_words(chunks, width);
  uint32_t* bufs = (uint32_t*)smem4 + (size_t)warp * 2 * bufw;
  const Butterfly bf = make_butterfly(lane);

  const long long nw = (long long)gridDim.x * wpb;
  long long row = (long long)blockIdx.x * wpb + warp;
  bool have = row < N;
  if (have)
    stage_tile(res, light, d, (size_t)row * P, P, width, chunks, bufs, lane);
  cp_async_commit();
  int b = 0;

  while (have) {  // warp-uniform
    const long long nrow = row + nw;
    const bool nhave = nrow < N;
    if (nhave)
      stage_tile(res, light, d, (size_t)nrow * P, P, width, chunks,
                 bufs + (b ^ 1) * bufw, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this row has landed; the next may be in flight
    __syncwarp();

    const Tile tl = view_tile(res, light, d, (size_t)row * P, width, chunks,
                              bufs + b * bufw);
    int acc[kMaxX];  // lane s: leaf s's count per class
#pragma unroll
    for (int x = 0; x < kMaxX; ++x) acc[x] = 0;
    int gm = X;

    // two chunks a trip: their butterflies are independent instructions
    for (int j = 0; j < chunks; j += 2) {
      const Planes p0 = position_planes(tl, j * 32 + lane, P, width, th, C0,
                                        leaf_bits, gm);
      const Planes p1 = position_planes(tl, j * 32 + 32 + lane, P, width, th,
                                        C0, leaf_bits, gm);
      const uint32_t nz = __reduce_or_sync(
          kFull, ((p0.a | p1.a) != 0u ? 1u : 0u) |
                     ((p0.b | p1.b) != 0u ? 2u : 0u));
      if (nz == 0u) continue;  // warp-uniform: nothing matched here
      // after a transpose lane s holds leaf s's positions of the chunk
      const uint32_t ta0 = transpose32(p0.a, bf);
      const uint32_t ta1 = transpose32(p1.a, bf);
      uint32_t tb0 = 0u, tb1 = 0u;
      if (nz & 2u) {
        tb0 = transpose32(p0.b, bf);
        tb1 = transpose32(p1.b, bf);
      }
#pragma unroll
      for (int x = 0; x < kMaxX; ++x) {
        if (x < X) {
          // a and b are disjoint, so one popc counts both
          acc[x] += __popc((ta0 & __ballot_sync(kFull, p0.hA == x)) |
                           (tb0 & __ballot_sync(kFull, p0.hB == x))) +
                    __popc((ta1 & __ballot_sync(kFull, p1.hA == x)) |
                           (tb1 & __ballot_sync(kFull, p1.hB == x)));
        }
      }
    }

    const int wm = __reduce_min_sync(kFull, gm);
    if (lane == 0) minall[row] = wm >= X ? kSentinel : wm;
    if (lane < S) {
      int32_t* out = hist + ((size_t)row * S + lane) * X;
#pragma unroll
      for (int x = 0; x < kMaxX; ++x)
        if (x < X) out[x] = acc[x];
    }
    __syncwarp();  // buffer b is free again
    row = nrow;
    have = nhave;
    b ^= 1;
  }
  cp_async_wait<0>();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int krepp_probe_hist_packed(const void* res, const void* light,
                                       const void* d, int N, int P, int width,
                                       int th, int C0, int S, void* hist,
                                       void* minall, void* stream) {
  if (N <= 0) return 0;
  if (P < 1 || P > kMaxP || th < 0 || th + 1 > kMaxX || S < 1 || S > kMaxS ||
      C0 < 1 || C0 > kMaxC0 || width < 1 + 2 * C0)
    return (int)cudaErrorInvalidValue;
  const int chunks = (P + 31) / 32;  // <= kMaxChunks since P <= 255
  const size_t per_warp =
      (size_t)4 * 2 * buf_words(chunks, width);
  const int warps =
      (int)std::min<size_t>(kWarps, (size_t)kMaxSmem / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t rc = sm_count(&dev, &sms);
  if (rc != cudaSuccess) return (int)rc;
  const size_t smem = per_warp * warps;
  static bool allowed[kMaxDevices] = {};  // the full shared memory, once
  if (!allowed[dev]) {
    rc = cudaFuncSetAttribute(probe_hist_packed_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
    if (rc != cudaSuccess) return (int)rc;
    allowed[dev] = true;
  }
  const int blocks = std::min(sms, (N + warps - 1) / warps);
  probe_hist_packed_kernel<<<blocks, warps * 32, smem,
                             (cudaStream_t)stream>>>(
      (const uint32_t*)res, (const uint8_t*)light, (const uint32_t*)d, N, P,
      width, th, C0, S, chunks, (int32_t*)hist, (int32_t*)minall);
  return (int)cudaGetLastError();
}
