"""The Hamming-histogram pseudo-likelihood and Brent's minimiser of the
plain reference, over many lanes at once in plain torch.

Semantics: HDistHistLLH::operator() (src/hdhistllh.hpp:71-89) and boost's
brent_find_minima with 16 bits of tolerance on [1e-10, 0.5], as krepp's
src/query.cpp:426-433 calls it. Each lane follows the scalar algorithm
step for step (a lane that has met its stopping rule is frozen). `dtype`
is the precision of every float operation: float64 is the reference,
float32 the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LO, HI = 1e-10, 0.5
TOL_BITS = 16
GOLDEN = float(np.float32(0.3819660))      # boost's float literal
MAX_STEPS = 10000


def binomials(k: int, h: int, th: int):
    """(C(k, x) for x <= k, C(k, x) - C(k-h, x) for x <= th with 0 at x = 0),
    integer-exact (src/hdhistllh.hpp:56-68)."""
    bk = [math.comb(k, x) for x in range(k + 1)]
    bh = [0] + [bk[x] - math.comb(k - h, x) for x in range(1, th + 1)]
    return bk, bh


def llh(d, hist, uc, rho, k: int, h: int, th: int):
    """Negative log pseudo-likelihood of distance d [n] given the per-class
    match counts hist [n, th+1], the unmatched k-mers uc [n] and the
    subsampling rate rho [n]; the float type is d's."""
    bk, bh = binomials(k, h, th)
    one = torch.ones_like(d)
    powdc = torch.pow(one - d, k)
    logdn = torch.log(one - d)
    logdp = torch.log(d) - logdn
    logdn = logdn * k
    dratio = d / (one - d)
    s = torch.zeros_like(d)
    lv_m = torch.zeros_like(d)
    for x in range(k + 1):
        if x <= th:
            s = s - (logdn + x * logdp) * hist[:, x]
            lv_m = lv_m + bh[x] * powdc
        else:
            lv_m = lv_m + powdc * bk[x]
        powdc = powdc * dratio
    return s - torch.log(rho * lv_m + one - rho) * uc


def brent(f, n: int, dtype, device):
    """Minimise f over [LO, HI] for n lanes at once: (x, f(x)) of each."""
    def full(v):
        return torch.full((n,), v, dtype=dtype, device=device)

    tol = full(math.ldexp(1.0, 1 - TOL_BITS))
    golden = full(GOLDEN)
    x = full(HI)
    w = x.clone()
    v = x.clone()
    fx = f(x)
    fw = fx.clone()
    fv = fx.clone()
    delta = full(0.0)
    delta2 = full(0.0)
    mn = full(LO)
    mx = full(HI)
    live = torch.ones(n, dtype=torch.bool, device=device)
    for _ in range(MAX_STEPS):
        mid = (mn + mx) / 2
        fract1 = tol * x.abs() + tol / 4
        fract2 = 2 * fract1
        live &= ~((x - mid).abs() <= fract2 - (mx - mn) / 2)
        if not bool(live.any()):
            break
        gold2 = torch.where(x >= mid, mn - x, mx - x)
        parab = delta2.abs() > fract1
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q = 2 * (q - r)
        p = torch.where(q > 0, -p, p)
        q = q.abs()
        td = delta2
        reject = ((p.abs() >= (q * td / 2).abs()) | (p <= q * (mn - x))
                  | (p >= q * (mx - x)))
        pstep = p / q
        u_p = x + pstep
        near = ((u_p - mn) < fract2) | ((mx - u_p) < fract2)
        pstep = torch.where(near, torch.where(mid - x < 0, -fract1.abs(),
                                              fract1.abs()), pstep)
        use_gold = ~parab | reject
        n_delta2 = torch.where(use_gold, gold2, delta)
        n_delta = torch.where(use_gold, golden * gold2, pstep)
        u = torch.where(n_delta.abs() >= fract1, x + n_delta,
                        torch.where(n_delta > 0, x + fract1.abs(),
                                    x - fract1.abs()))
        fu = f(u)
        better = fu <= fx
        n_mn = torch.where(better, torch.where(u >= x, x, mn),
                           torch.where(u < x, u, mn))
        n_mx = torch.where(better, torch.where(u >= x, mx, x),
                           torch.where(u < x, mx, u))
        shift_w = ~better & ((fu <= fw) | (w == x))
        shift_v = ~better & ~shift_w & ((fu <= fv) | (v == x) | (v == w))
        n_v = torch.where(better | shift_w, w, torch.where(shift_v, u, v))
        n_fv = torch.where(better | shift_w, fw, torch.where(shift_v, fu, fv))
        n_w = torch.where(better, x, torch.where(shift_w, u, w))
        n_fw = torch.where(better, fx, torch.where(shift_w, fu, fw))
        n_x = torch.where(better, u, x)
        n_fx = torch.where(better, fu, fx)
        for old, new in ((mn, n_mn), (mx, n_mx), (v, n_v), (fv, n_fv),
                         (w, n_w), (fw, n_fw), (x, n_x), (fx, n_fx),
                         (delta, n_delta), (delta2, n_delta2)):
            old.copy_(torch.where(live, new, old))
    return x, fx
