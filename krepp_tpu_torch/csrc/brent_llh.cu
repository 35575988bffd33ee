// brent_llh: boost's Brent minimiser over the moment-form Hamming-histogram
// pseudo-likelihood, every lane to its own stop in one launch, for Hopper
// (sm_90a).
//
// Replaces the device loop of krepp_tpu/core/llh.py: brent_find_minima
// (:192-290, a jax.lax.while_loop whose body XLA fuses) run by
// brent_on_mask (:316-376, lane compaction into a capacity tier picked with
// lax.switch). It has no Pallas original. The spec is the port's plain form
// in krepp_tpu_torch/core/llh.py (brent_find_minima over make_llh_fast,
// through brent_on_mask), select for select:
//   llh(d) = -(k log(1-d)) A - (log d - log(1-d)) Bx
//            - log(rho lv(d) + 1 - rho) uc,
//   lv(d)  = sum_{x<=th} C'(x) q_x + (1 - sum_{x<=th} C(k,x) q_x),
//   q_x    = (1-d)^k (d/(1-d))^x, C' = binom_hnk, C = binom_k;
// Brent on [1e-10, 0.5] from x = w = v = 0.5, the same fract1 / fract2 stop
// test before each step, the same golden / parabolic choice, the q == 0
// guard, at most 200 steps; a lane outside the mask gets d = v = 0.
// Every f64 add, subtract, multiply and divide is written with the _rn
// intrinsics, which are never contracted into an FMA, so each rounds as the
// plain form's separate eager ops do; log is CUDA's log(double), the
// function ATen's torch.log calls. The kernel aims at bit equality with the
// plain form on the card.
//
// Inputs: A, Bx, uc, rho f64 [N]; mask bool [N] or null (every lane);
// binom f64 [2 (th + 1)] in host memory: binom_k[0..th] then
// binom_hnk[0..th]. Outputs: d, v f64 [N].
//
// Bound: a lane reads 33 bytes and writes 16, and a selected lane takes
// ~12 steps (up to 200) of ~55 f64 operations plus a likelihood of
// 24 + 5 (th + 1) operations with two logs: on the main path's inputs
// (a third of the lanes selected or fewer) the least time is the bytes'.
// What sets the time is latency: each lane is one chain of dependent f64
// operations (two logs and a division a step, software routines on the
// card, and the likelihood's sums over 0..th), so a launch lasts at least
// as long as its slowest lane. chip_smoke.py measures that floor (one
// launch of the slowest lane alone); on the batches the main path gives
// the kernel it is most of a call's time (PERF.md, section 6).
// Design: one thread per lane, its whole state (bracket, three points,
// their values, two step lengths) in registers; no host sync and no shared
// state between lanes. A block first compacts its selected lanes (warp
// ballots and a prefix over the warps in shared memory) so that its warps
// are full of selected lanes and only the block's last warp is partial: a
// sparse mask (place's dense [B, Q] stage 3) costs the warps it fills, not
// its length. The chain is kept short: the likelihood is compiled for
// each th of 0..7, so its sums over the classes are unrolled (a generic
// loop serves th of 8 and above, and is no faster than a loop over a
// table in device memory: PERF.md, section 6); the binomials travel in the kernel's parameters, read from
// the constant bank as operands (no table in device or shared memory, no
// barrier); the powers of 1 - d unroll over the six bits k can have; a
// golden-section step skips the parabolic step's division, whose result
// it would not use. Lanes of a warp that stop at different steps diverge:
// the warp runs until its slowest lane stops and the others idle. A lane
// queue that gives a thread the next lane as soon as its lane stops (a
// persistent grid of the resident blocks, one likelihood a thread a trip,
// rings of lane ids in shared memory, a block's or a warp's) was built and
// timed against this design in one call on the same card: bit-equal
// (lanes are independent, so the order in which they are taken changes no
// bit), and slower on every shape: the main path's calls select fewer
// lanes than the card holds threads, so a queue has nothing to refill,
// and its vote and branches on every trip lengthen each lane's chain.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTh = 32;
constexpr int kMaxIter = 200;
constexpr double kLo = 1e-10;
constexpr double kHi = 0.5;
constexpr double kTol = 1.0 / 32768.0;   // ldexp(1, 1 - 16)
constexpr double kTolQ = kTol * 0.25;    // exact: a power of two
// boost: `static const T golden = 0.3819660f;` (a float literal)
constexpr double kGolden = (double)0.3819660f;

// binom_k[0..th] and binom_hnk[0..th], passed by value
struct Binom {
  double k[kMaxTh + 1];
  double h[kMaxTh + 1];
};

__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}

// make_llh_fast's likelihood in its op order (_ipow's multiplication
// order over the bits of k included); TH = th, or -1 for th at run time
template <int TH>
__device__ __forceinline__ double llh(double d, double A, double Bx,
                                      double uc, double rho, int k, int th,
                                      const Binom& bn) {
  const double omd = sub(1.0, d);
  double acc = 1.0;
  bool have = false;
  double base = omd;
#pragma unroll
  for (int bit = 0; bit < 6; ++bit) {   // k <= 32: six bits
    const int n = k >> bit;
    if (n == 0) break;
    if (n & 1) {
      acc = have ? mul(acc, base) : base;
      have = true;
    }
    base = mul(base, base);
  }
  double powdc = acc;
  const double logdn = log(omd);
  const double logdp = sub(log(d), logdn);
  const double dratio = __ddiv_rn(d, omd);
  double lv = 0.0;
  double ck = 0.0;
#pragma unroll
  for (int x = 0; x <= (TH < 0 ? th : TH); ++x) {
    lv = add(lv, mul(bn.h[x], powdc));
    ck = add(ck, mul(bn.k[x], powdc));
    powdc = mul(powdc, dratio);
  }
  lv = add(lv, sub(1.0, ck));
  const double s = sub(mul(-mul((double)k, logdn), A), mul(logdp, Bx));
  return sub(s, mul(log(sub(add(mul(rho, lv), 1.0), rho)), uc));
}

template <int TH>
__global__ void __launch_bounds__(kThreads)
brent_llh_kernel(const double* __restrict__ A, const double* __restrict__ Bx,
                 const double* __restrict__ uc,
                 const double* __restrict__ rho,
                 const uint8_t* __restrict__ mask, long long N, int k, int th,
                 const __grid_constant__ Binom bn, double* __restrict__ dout,
                 double* __restrict__ vout) {
  __shared__ int warp_sel[kWarps];
  __shared__ int lane_of[kThreads];
  const int tid = threadIdx.x;

  // compact the block's selected lanes, in order, to its first threads
  const long long lane0 = (long long)blockIdx.x * kThreads;
  const long long mine = lane0 + tid;
  const bool in = mine < N;
  const bool sel = in && (mask == nullptr || mask[mine] != 0);
  if (in && !sel) {
    dout[mine] = 0.0;
    vout[mine] = 0.0;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, sel);
  const int wid = tid >> 5;
  const int lid = tid & 31;
  if (lid == 0) warp_sel[wid] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lid) - 1u));
  int total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < wid) before += warp_sel[w];
    total += warp_sel[w];
  }
  if (sel) lane_of[before] = tid;
  __syncthreads();
  if (tid >= total) return;

  const long long lane = lane0 + lane_of[tid];
  const double a = A[lane], b = Bx[lane], u_c = uc[lane], r = rho[lane];

  double mn = kLo, mx = kHi;
  double x = kHi, w = kHi, v = kHi;
  double fx = llh<TH>(x, a, b, u_c, r, k, th, bn);
  double fw = fx, fv = fx;
  double delta = 0.0, delta2 = 0.0;
  for (int it = 0; it < kMaxIter; ++it) {
    const double mid = mul(add(mn, mx), 0.5);
    const double fract1 = add(mul(kTol, fabs(x)), kTolQ);
    const double fract2 = mul(2.0, fract1);
    if (fabs(sub(x, mid)) <= sub(fract2, mul(sub(mx, mn), 0.5))) break;

    // parabolic fit when |delta2| > fract1
    const bool use_para = fabs(delta2) > fract1;
    const double rr = mul(sub(x, w), sub(fx, fv));
    double q = mul(sub(x, v), sub(fx, fw));
    double p = sub(mul(sub(x, v), q), mul(sub(x, w), rr));
    q = mul(2.0, sub(q, rr));
    if (q > 0.0) p = -p;
    q = fabs(q);
    const bool golden_step =
        !use_para || (fabs(p) >= fabs(mul(mul(q, delta2), 0.5))) ||
        (p <= mul(q, sub(mn, x))) || (p >= mul(q, sub(mx, x)));
    const double g_delta2 = x >= mid ? sub(mn, x) : sub(mx, x);
    const double g_delta = mul(kGolden, g_delta2);
    const double new_delta2 =
        golden_step ? g_delta2 : (use_para ? delta : delta2);
    double new_delta = g_delta;
    if (!golden_step) {
      new_delta = __ddiv_rn(p, q == 0.0 ? 1.0 : q);
      const double u_try = add(x, new_delta);
      if ((sub(u_try, mn) < fract2) || (sub(mx, u_try) < fract2))
        new_delta = sub(mid, x) < 0.0 ? -fabs(fract1) : fabs(fract1);
    }

    const double u = fabs(new_delta) >= fract1
                         ? add(x, new_delta)
                         : (new_delta > 0.0 ? add(x, fabs(fract1))
                                            : sub(x, fabs(fract1)));
    const double fu = llh<TH>(u, a, b, u_c, r, k, th, bn);

    // bracket update and point shuffle; fu <= fx is false for NaN
    if (fu <= fx) {
      if (u >= x) mn = x; else mx = x;
      v = w; fv = fw;
      w = x; fw = fx;
      x = u; fx = fu;
    } else {
      if (u < x) mn = u; else mx = u;
      if ((fu <= fw) || (w == x)) {
        v = w; fv = fw;
        w = u; fw = fu;
      } else if ((fu <= fv) || (v == x) || (v == w)) {
        v = u; fv = fu;
      }
    }
    delta = new_delta;
    delta2 = new_delta2;
  }
  dout[lane] = x;
  vout[lane] = fx;
}

template <int TH>
int launch(unsigned blocks, cudaStream_t stream, const void* A,
           const void* Bx, const void* uc, const void* rho, const void* mask,
           long long N, int k, int th, const Binom& bn, void* d, void* v) {
  brent_llh_kernel<TH><<<blocks, kThreads, 0, stream>>>(
      (const double*)A, (const double*)Bx, (const double*)uc,
      (const double*)rho, (const uint8_t*)mask, N, k, th, bn, (double*)d,
      (double*)v);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int krepp_brent_llh(const void* A, const void* Bx, const void* uc,
                               const void* rho, const void* mask,
                               long long N, int k, int th, const void* binom,
                               void* d, void* v, void* stream) {
  if (N <= 0) return 0;
  if (k < 1 || k > 32 || th < 0 || th > kMaxTh || th > k)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (N + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Binom bn = {};
  for (int x = 0; x <= th; ++x) {
    bn.k[x] = ((const double*)binom)[x];
    bn.h[x] = ((const double*)binom)[th + 1 + x];
  }
  const unsigned g = (unsigned)blocks;
  cudaStream_t st = (cudaStream_t)stream;
  switch (th) {
    case 0: return launch<0>(g, st, A, Bx, uc, rho, mask, N, k, th, bn, d, v);
    case 1: return launch<1>(g, st, A, Bx, uc, rho, mask, N, k, th, bn, d, v);
    case 2: return launch<2>(g, st, A, Bx, uc, rho, mask, N, k, th, bn, d, v);
    case 3: return launch<3>(g, st, A, Bx, uc, rho, mask, N, k, th, bn, d, v);
    case 4: return launch<4>(g, st, A, Bx, uc, rho, mask, N, k, th, bn, d, v);
    case 5: return launch<5>(g, st, A, Bx, uc, rho, mask, N, k, th, bn, d, v);
    case 6: return launch<6>(g, st, A, Bx, uc, rho, mask, N, k, th, bn, d, v);
    case 7: return launch<7>(g, st, A, Bx, uc, rho, mask, N, k, th, bn, d, v);
    default:
      return launch<-1>(g, st, A, Bx, uc, rho, mask, N, k, th, bn, d, v);
  }
}
