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
// Bound: bytes. A row reads P * (4 width + 5) bytes once and writes
// S * X * 4 + 4; mask_tab stays in L2. The work beside that is integer
// counting of P * S (position, leaf) cells per row, which an earlier design
// paid per set leaf bit (one __match_any_sync and a shared atomic each, one
// block of 128 threads per row, strided 4-byte loads), so dense leaf sets
// ran 25 times over the bound.
//
// Design: a warp owns a row. It stages the row's contiguous span of d, res
// and light (tiles of up to 96 positions) in its own shared-memory double
// buffer with cp.async, 16 bytes a copy, and the next tile's copy runs
// while this tile is counted; nothing synchronises across warps. A lane
// takes one position of each 32-position chunk and fetches a candidate's
// mask words (two 16-byte loads at W = 8) only when its Hamming distance
// passes; a chunk in which no lane matched ends there (__any_sync), which
// is most chunks of a sparse batch. Otherwise the lane orders its two
// candidates by class and forms two disjoint leaf planes per mask word
// (a: the lower class, b: the other & ~a). Per non-empty mask word (a
// __reduce_or_sync tells which; two words at a time when both of a pair
// are set, so four butterflies overlap) the warp transposes the 32 x 32
// bit planes with a five-stage shuffle butterfly, so lane s holds leaf s's
// 32 positions, and adds popc((Ta & ballot(class A == x)) |
// (Tb & ballot(class B == x))) to its own counter [S, X] in shared memory:
// no __match_any_sync, no atomics, a cost that does not depend on how many
// leaf bits are set. Counters leave with 16-byte stores. Integer sums in
// any order: deterministic and bit-equal to the plain version. The grid is
// persistent (one block per SM, up to 24 warps as shared memory allows),
// rows dealt to warps round-robin. The TPU kernel's (8, 128) tiling is not
// carried over.

#include <algorithm>

#include "probe_hist_common.cuh"

namespace {

using namespace krepp;

constexpr int kMaxW = 8;
constexpr int kMaxWarps = 24;
constexpr int kTileChunks = 3;  // 32-position chunks of a staged tile
constexpr int kMaxHd = 16;  // hd is a popcount of 16 bits

template <int KX>
__global__ void __launch_bounds__(kMaxWarps * 32)
probe_hist_tiles_kernel(const uint32_t* __restrict__ res,
                        const uint8_t* __restrict__ light,
                        const uint32_t* __restrict__ d,
                        const uint32_t* __restrict__ mask_tab, int nse, int N,
                        int P, int width, int th, int C0, int W, int S,
                        int chunks, int vec_tab, int vec_out,
                        int32_t* __restrict__ hist,
                        int32_t* __restrict__ minall) {
  extern __shared__ uint4 smem4[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int X = th + 1;
  const int SX = S * X;
  const int SXr = (SX + 3) & ~3;
  const int bufw = buf_words(chunks, width);
  uint32_t* mine = (uint32_t*)smem4 + (size_t)warp * (SXr + 2 * bufw);
  int32_t* counts = (int32_t*)mine;  // [S][X]
  uint32_t* bufs = mine + SXr;
  for (int i = lane; i < SXr; i += 32) counts[i] = 0;
  __syncwarp();
  const Butterfly bf = make_butterfly(lane);

  const int tile = chunks * 32;
  const int tiles = (P + tile - 1) / tile;
  const long long nw = (long long)gridDim.x * wpb;
  long long row = (long long)blockIdx.x * wpb + warp;
  int t = 0;
  bool have = row < N;
  if (have)
    stage_tile(res, light, d, (size_t)row * P, min(tile, P), width, chunks,
               bufs, lane);
  cp_async_commit();
  int b = 0;
  int gm = kSentinel;

  while (have) {  // warp-uniform
    long long nrow = row;
    int nt = t + 1;
    if (nt == tiles) {
      nt = 0;
      nrow += nw;
    }
    const bool nhave = nrow < N;
    if (nhave)
      stage_tile(res, light, d, (size_t)nrow * P + nt * tile,
                 min(tile, P - nt * tile), width, chunks,
                 bufs + (b ^ 1) * bufw, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed; the next may be in flight
    __syncwarp();

    const int p0 = t * tile;
    const int np = min(tile, P - p0);
    const size_t off = (size_t)row * P + p0;
    const Tile tl =
        view_tile(res, light, d, off, width, chunks, bufs + b * bufw);
    const int nchunks = (np + 31) >> 5;

    for (int j = 0; j < nchunks; ++j) {
      const int q = j * 32 + lane;
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
      if (q < np && tl.sl[q]) {
        const uint32_t r = tl.sr[q];
        const uint32_t* e = tl.sd + (size_t)q * width;
#pragma unroll
        for (int c = 0; c < kMaxC0; ++c) {
          if (c < C0) {
            // the mask words are fetched only for a candidate near enough
            if (mask_tab == nullptr) {
              const int h = hdist16(e[1 + c * (1 + W)], r);
              if (h <= th) {
                hd[c] = h;
                const uint32_t* words = e + 2 + c * (1 + W);
#pragma unroll
                for (int w = 0; w < kMaxW; ++w)
                  if (w < W) m[c][w] = words[w];
              }
            } else {
              const int h = hdist16(e[1 + c], r);
              if (h <= th) {
                hd[c] = h;
                const int se = min(max((int)e[1 + C0 + c], 0), nse - 1);
                const uint32_t* words = mask_tab + (size_t)se * W;
                if (vec_tab) {  // rows of mask_tab are 16-byte aligned
                  const uint4* wv = (const uint4*)words;
#pragma unroll
                  for (int w4 = 0; w4 < kMaxW / 4; ++w4) {
                    if (w4 * 4 < W) {
                      const uint4 v = __ldg(wv + w4);
                      m[c][4 * w4] = v.x;
                      m[c][4 * w4 + 1] = v.y;
                      m[c][4 * w4 + 2] = v.z;
                      m[c][4 * w4 + 3] = v.w;
                    }
                  }
                } else {
#pragma unroll
                  for (int w = 0; w < kMaxW; ++w)
                    if (w < W) m[c][w] = __ldg(words + w);
                }
              }
            }
            uint32_t any = 0u;
#pragma unroll
            for (int w = 0; w < kMaxW; ++w) any |= m[c][w];
            match[c] = any != 0u;  // near enough, and in some leaf
            if (match[c])
              gm = min(gm, hd[c]);
            else
              hd[c] = kSentinel;
          }
        }
      }
      // warp-uniform: most chunks of a sparse batch end here
      if (!__any_sync(kFull, match[0] || match[1])) continue;
      // planes: m[0][w] becomes a (the lower class), m[1][w] becomes b
      const Ordered o = order_candidates(hd, match);
      uint32_t nz = 0u;
#pragma unroll
      for (int w = 0; w < kMaxW; ++w) {
        const int lo = w * 32;
        const uint32_t leaf_bits = S - lo >= 32  ? 0xffffffffu
                                   : S - lo <= 0 ? 0u
                                                 : ((1u << (S - lo)) - 1u);
        // the words of a candidate that does not match are all zero
        const uint32_t a = (o.swap ? m[1][w] : m[0][w]) & leaf_bits;
        const uint32_t bb = (o.swap ? m[0][w] : m[1][w]) & leaf_bits & ~a;
        m[0][w] = a;
        m[1][w] = bb;
        if ((a | bb) != 0u) nz |= 1u << w;
      }
      const uint32_t wmask = __reduce_or_sync(kFull, nz);
      if (wmask == 0u) continue;  // warp-uniform: no leaf below S

      uint32_t MA[KX], MB[KX];  // positions of the chunk by class
#pragma unroll
      for (int x = 0; x < KX; ++x) {
        MA[x] = __ballot_sync(kFull, o.hA == x);
        MB[x] = __ballot_sync(kFull, o.hB == x);
      }
#pragma unroll
      for (int wp = 0; wp < kMaxW / 2; ++wp) {
        const uint32_t pm = (wmask >> (2 * wp)) & 3u;  // warp-uniform
        if (pm == 0u) continue;
        // after a transpose lane s holds leaf (32 w + s)'s positions
        int32_t* c0 = counts + ((2 * wp) * 32 + lane) * X;
        if (pm == 3u) {  // both words: four independent butterflies
          const uint32_t ta0 = transpose32(m[0][2 * wp], bf);
          const uint32_t tb0 = transpose32(m[1][2 * wp], bf);
          const uint32_t ta1 = transpose32(m[0][2 * wp + 1], bf);
          const uint32_t tb1 = transpose32(m[1][2 * wp + 1], bf);
          int32_t* c1 = c0 + 32 * X;
#pragma unroll
          for (int x = 0; x < KX; ++x) {
            if (x < X) {
              // a and b are disjoint, so one popc counts both
              const int n0 = __popc((ta0 & MA[x]) | (tb0 & MB[x]));
              const int n1 = __popc((ta1 & MA[x]) | (tb1 & MB[x]));
              if (n0) c0[x] += n0;  // leaves >= S are masked out: n == 0
              if (n1) c1[x] += n1;
            }
          }
        } else {  // one word of the pair
          const bool hi = pm == 2u;
          const uint32_t ta =
              transpose32(hi ? m[0][2 * wp + 1] : m[0][2 * wp], bf);
          const uint32_t tb =
              transpose32(hi ? m[1][2 * wp + 1] : m[1][2 * wp], bf);
          if (hi) c0 += 32 * X;
#pragma unroll
          for (int x = 0; x < KX; ++x) {
            if (x < X) {
              const int n0 = __popc((ta & MA[x]) | (tb & MB[x]));
              if (n0) c0[x] += n0;
            }
          }
        }
      }
    }

    if (t == tiles - 1) {  // the row is counted: write it out
      const int wm = __reduce_min_sync(kFull, gm);
      if (lane == 0) minall[row] = wm;
      gm = kSentinel;
      __syncwarp();
      int32_t* out = hist + (size_t)row * SX;
      if (vec_out) {
        uint4* c4 = (uint4*)counts;
        uint4* o4 = (uint4*)out;
        for (int i = lane; i < (SX >> 2); i += 32) {
          o4[i] = c4[i];
          c4[i] = make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        for (int i = lane; i < SX; i += 32) {
          out[i] = counts[i];
          counts[i] = 0;
        }
      }
    }
    __syncwarp();  // buffer b and the counters are free again
    row = nrow;
    t = nt;
    have = nhave;
    b ^= 1;
  }
  cp_async_wait<0>();
}

template <int KX>
int launch(const void* res, const void* light, const void* d,
           const void* mask_tab, int nse, int N, int P, int width, int th,
           int C0, int W, int S, int chunks, int warps, int blocks,
           size_t smem, int dev, void* hist, void* minall,
           cudaStream_t stream) {
  // 16-byte accesses where the addresses allow them
  const int vec_tab = (W & 3) == 0 && ((uintptr_t)mask_tab & 15) == 0;
  const int vec_out = ((S * (th + 1)) & 3) == 0 && ((uintptr_t)hist & 15) == 0;
  auto kernel = probe_hist_tiles_kernel<KX>;
  static bool allowed[kMaxDevices] = {};  // the full shared memory, once
  if (!allowed[dev]) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc != cudaSuccess) return (int)rc;
    allowed[dev] = true;
  }
  kernel<<<blocks, warps * 32, smem, stream>>>(
      (const uint32_t*)res, (const uint8_t*)light, (const uint32_t*)d,
      (const uint32_t*)mask_tab, nse, N, P, width, th, C0, W, S, chunks,
      vec_tab, vec_out,
      (int32_t*)hist, (int32_t*)minall);
  return (int)cudaGetLastError();
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
  const long long X = (long long)th + 1;
  const int need = mask_tab == nullptr ? 1 + C0 * (1 + W) : 1 + 2 * C0;
  if (P < 1 || th < 0 || C0 < 1 || C0 > kMaxC0 || W < 1 || W > kMaxW ||
      (S + 31) / 32 != W || width < need ||
      (mask_tab != nullptr && nse < 1) || (long long)S * X * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  // the largest tile (up to kTileChunks * 32 positions) that leaves room for
  // 8 warps
  const int SXr = ((int)(S * X) + 3) & ~3;
  int chunks = std::min((P + 31) / 32, kTileChunks);
  auto warp_bytes = [&](int ch) {
    return (size_t)4 * (SXr + 2 * buf_words(ch, width));
  };
  while (chunks > 1 && warp_bytes(chunks) * 8 > (size_t)kMaxSmem) --chunks;
  const size_t per_warp = warp_bytes(chunks);
  const int warps =
      (int)std::min<size_t>(kMaxWarps, (size_t)kMaxSmem / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  const cudaError_t rc = sm_count(&dev, &sms);
  if (rc != cudaSuccess) return (int)rc;
  const int blocks = std::min(sms, (N + warps - 1) / warps);
  const size_t smem = per_warp * warps;
  const int classes = (int)std::min<long long>(X, kMaxHd + 1);
  cudaStream_t s = (cudaStream_t)stream;
  if (classes <= 5)
    return launch<5>(res, light, d, mask_tab, nse, N, P, width, th, C0, W, S,
                     chunks, warps, blocks, smem, dev, hist, minall, s);
  if (classes <= 8)
    return launch<8>(res, light, d, mask_tab, nse, N, P, width, th, C0, W, S,
                     chunks, warps, blocks, smem, dev, hist, minall, s);
  return launch<kMaxHd + 1>(res, light, d, mask_tab, nse, N, P, width, th, C0,
                            W, S, chunks, warps, blocks, smem, dev, hist,
                            minall, s);
}
