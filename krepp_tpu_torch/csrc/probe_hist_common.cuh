// Shared pieces of the two probe-epilogue kernels (probe_hist_tiles.cu,
// probe_hist_packed.cu) for Hopper (sm_90a): a warp owns a row, stages the
// row's contiguous span of bucket rows, residuals and light bytes in shared
// memory with cp.async (16-byte copies between a 4-byte head and tail, since
// a span starts 16-byte aligned only when P * width * 4 is a multiple of 16),
// and
// counts leaf bits by transposing the warp's 32 x 32 bit plane, so the cost
// of counting does not depend on how many leaf bits are set.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace krepp {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSentinel = 255;   // "no match" Hamming distance
constexpr int kMaxChunks = 8;    // 32-position chunks of one staged tile
constexpr int kMaxC0 = 2;
constexpr int kMaxSmem = 227 * 1024;   // dynamic shared memory of a block

constexpr int kMaxDevices = 64;

// Host: the current device and its number of SMs (asked once per device).
inline cudaError_t sm_count(int* dev, int* sms) {
  static int known[kMaxDevices] = {};
  cudaError_t rc = cudaGetDevice(dev);
  if (rc != cudaSuccess) return rc;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (known[*dev] == 0) {
    rc = cudaDeviceGetAttribute(&known[*dev], cudaDevAttrMultiProcessorCount,
                                *dev);
    if (rc != cudaSuccess) return rc;
  }
  *sms = known[*dev];
  return cudaSuccess;
}

__device__ __forceinline__ int hdist16(uint32_t a, uint32_t b) {
  const uint32_t z = a ^ b;
  return __popc((z | (z >> 16)) & 0xffffu);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `Pending` of this thread's committed groups are open.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Word misalignment (0..3) of a 4-byte aligned global address within its
// 16-byte line; staged data keeps it, so 16-byte copies line up.
__device__ __forceinline__ int word_mis(const void* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

// The warp copies n words from src (global, 4-byte aligned) to
// dst + word_mis(src) (dst: shared, 16-byte aligned, room for n + 3 words):
// 4-byte copies up to the first 16-byte line, 16-byte copies, 4-byte tail.
// Asynchronous: complete after cp_async_commit / cp_async_wait.
__device__ __forceinline__ void stage_words(uint32_t* dst, const uint32_t* src,
                                            int n, int lane) {
  const int mis = word_mis(src);
  uint32_t* out = dst + mis;
  const int head = min(n, (4 - mis) & 3);
  const int body = (n - head) >> 2;
  if (lane < head) cp_async4(out + lane, src + lane);
  for (int i = lane; i < body; i += 32)
    cp_async16(out + head + 4 * i, src + head + 4 * i);
  const int done = head + 4 * body;
  if (lane < n - done) cp_async4(out + done + lane, src + done + lane);
}

// The warp copies the n bytes from src (global, any alignment) to
// dst + ((uintptr_t)src & 3) (dst: shared, 4-byte aligned, room for n + 6
// bytes) as the 4-byte words that cover them. A covering word holds at
// least one byte of the array, so it lies inside the array's allocation.
__device__ __forceinline__ void stage_bytes(uint32_t* dst, const uint8_t* src,
                                            int n, int lane) {
  const int lead = (int)((uintptr_t)src & 3);
  const uint32_t* src4 = (const uint32_t*)(src - lead);
  const int words = (lead + n + 3) >> 2;
  for (int i = lane; i < words; i += 32) cp_async4(dst + i, src4 + i);
}

// Words of one staging buffer: a tile's bucket rows (d_words), residuals
// (r_words) and light bytes (l_words), each with room for its misalignment
// and 16-byte aligned.
__host__ __device__ inline int d_words(int chunks, int width) {
  return (chunks * 32 * width + 3 + 3) & ~3;
}
__host__ __device__ inline int r_words(int chunks) { return chunks * 32 + 4; }
__host__ __device__ inline int l_words(int chunks) { return chunks * 8 + 4; }
__host__ __device__ inline int buf_words(int chunks, int width) {
  return d_words(chunks, width) + r_words(chunks) + l_words(chunks);
}

// One staged tile: np positions from flat position `off` (= row * P + p0)
// on. stage_tile starts the copies into buf; view_tile gives the pointers
// to read once they have landed (sl: one byte per position).
struct Tile {
  const uint32_t* sd;
  const uint32_t* sr;
  const uint8_t* sl;
};

__device__ __forceinline__ void stage_tile(
    const uint32_t* __restrict__ res, const uint8_t* __restrict__ light,
    const uint32_t* __restrict__ d, size_t off, int np, int width, int chunks,
    uint32_t* buf, int lane) {
  stage_words(buf, d + off * width, np * width, lane);
  stage_words(buf + d_words(chunks, width), res + off, np, lane);
  stage_bytes(buf + d_words(chunks, width) + r_words(chunks), light + off, np,
              lane);
}

__device__ __forceinline__ Tile view_tile(
    const uint32_t* __restrict__ res, const uint8_t* __restrict__ light,
    const uint32_t* __restrict__ d, size_t off, int width, int chunks,
    const uint32_t* buf) {
  Tile t;
  t.sd = buf + word_mis(d + off * width);
  t.sr = buf + d_words(chunks, width) + word_mis(res + off);
  t.sl = (const uint8_t*)(buf + d_words(chunks, width) + r_words(chunks)) +
         ((uintptr_t)(light + off) & 3);
  return t;
}

// A lane's constants for the five butterfly stages of transpose32 (stage i
// exchanges with lane ^ (16 >> i)): the bits it keeps, and the rotation that
// brings its partner's bits into the places it gives up.
struct Butterfly {
  uint32_t keep[5];
  int rot[5];
};

__device__ __forceinline__ Butterfly make_butterfly(int lane) {
  Butterfly bf;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int j = 16 >> i;
    const uint32_t m = j == 16  ? 0x0000ffffu
                       : j == 8 ? 0x00ff00ffu
                       : j == 4 ? 0x0f0f0f0fu
                       : j == 2 ? 0x33333333u
                                : 0x55555555u;
    bf.keep[i] = (lane & j) ? ~m : m;
    bf.rot[i] = (lane & j) ? 32 - j : j;
  }
  return bf;
}

// Transposes the warp's 32 x 32 bit matrix (row = lane, column = bit): on
// return bit p of lane s is what bit s of lane p was. Five stages of one
// shuffle, one rotate and one bit select each: a lane whose index has bit j
// clear keeps its columns with bit j clear and takes its partner's, moved up
// by j, into the others (the bits a rotation wraps around fall on columns
// the lane keeps); the other lanes do the mirror image.
__device__ __forceinline__ uint32_t transpose32(uint32_t v,
                                                const Butterfly& bf) {
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const uint32_t t = __shfl_xor_sync(kFull, v, 16 >> i);
    const uint32_t r = __funnelshift_l(t, t, bf.rot[i]);
    v = (v & bf.keep[i]) | (r & ~bf.keep[i]);
  }
  return v;
}

// Orders a position's two candidates by class (the lower Hamming distance
// first), so that "the lowest class wins a leaf" becomes two disjoint
// planes per mask word: a = word of the first, b = word of the other & ~a.
struct Ordered {
  bool swap;
  int hA, hB;
};

__device__ __forceinline__ Ordered order_candidates(
    const int (&hd)[kMaxC0], const bool (&match)[kMaxC0]) {
  Ordered o;
  o.swap = match[0] && match[1] && hd[1] < hd[0];
  o.hA = o.swap ? hd[1] : hd[0];
  o.hB = o.swap ? hd[0] : hd[1];
  return o;
}

}  // namespace krepp
