"""Hamming-histogram pseudo-likelihood + batched Brent minimizer in torch f64.

Port of krepp_tpu/core/llh.py (see its docstring for the reference
semantics: src/hdhistllh.hpp:71-89 and boost's brent_find_minima as used
by src/query.cpp:426-433). The card has native f64, so the float-float
scatters of the TPU version are plain index writes here.

`brent_llh` is the one entry point of the query paths: on the card it
launches the hand-written kernel `csrc/brent_llh.cu` (Brent over the
moment-form llh, every lane to its own stop in one launch, no host sync:
the counterpart of the reference's on-device `jax.lax.while_loop`), on the
host it runs the plain form `brent_llh_ref`. The plain form is
`brent_find_minima` over `make_llh_fast`, through `brent_on_mask`: it
checks `all(done)` every BRENT_SYNC_EVERY iterations (one sync each);
lanes that are done are frozen, so the extra iterations change nothing and
the loop still stops at exactly max_iter; brent_on_mask compacts to the
exact kept lane set (one sync for its size). `brent_llh.launches` counts
kernel launches; with `brent_llh.keep_next = True` the next launch leaves
copies of its arguments in `brent_llh.kept`, and with
`brent_find_minima.lane_steps = []` each call of the plain form appends
the Brent steps each of its lanes took (an int64 tensor of its batch
shape): measurement hooks that nothing in the package sets (the count and
the keep hook exact under threads, through core/launches.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from .launches import count_launch, take_keep

F = torch.float64

# boost uses `static const T golden = 0.3819660f;` (a float literal)
_GOLDEN = float(np.float64(np.float32(0.3819660)))
_TOL_BITS = 16
_TOLERANCE = float(np.ldexp(1.0, 1 - _TOL_BITS))
_BRENT_LO = 1e-10
_BRENT_HI = 0.5
_MAX_ITER = 200
BRENT_SYNC_EVERY = 8
MAX_BRENT_K = 32      # the kernel's room for its tables (th <= k entries)


def binom_tables(k: int, h: int, hdist_th: int) -> Tuple[np.ndarray, np.ndarray]:
    """Integer-exact binomial tables (ref: src/hdhistllh.hpp:56-68).

    binom_k[x] = C(k, x); binom_hnk[0] = 0 and for 1 <= x <= th,
    binom_hnk[x] = C(k, x) - C(k-h, x)."""
    ival = 1
    ivals = [1]
    for i in range(k):
        ival = (ival * (k - i)) // (i + 1)
        ivals.append(ival)
    binom_k = np.array(ivals, dtype=np.float64)
    binom_hnk = np.zeros(hdist_th + 1, dtype=np.float64)
    vc = 1
    nh = k - h
    for i in range(1, hdist_th + 1):
        vc = (vc * (nh - i + 1)) // i
        binom_hnk[i] = ivals[i] - vc
    return binom_k, binom_hnk


def _ipow(x, n: int):
    """x**n by squaring: multiplications only (the reference's order)."""
    acc = None
    base = x
    while n:
        if n & 1:
            acc = base if acc is None else acc * base
        base = base * base
        n >>= 1
    return acc if acc is not None else torch.ones_like(x)


def make_llh(k: int, h: int, hdist_th: int):
    """llh(d, hist[..., th+1], uc, rho) -> negative log pseudo-likelihood,
    in the reference's accumulation order (ref: src/hdhistllh.hpp:71-89)."""
    binom_k, binom_hnk = binom_tables(k, h, hdist_th)

    def llh(d, hist, uc, rho):
        d = d.to(F)
        powdc = _ipow(1.0 - d, k)
        logdn = torch.log(1.0 - d)
        logdp = torch.log(d) - logdn
        logdn = logdn * float(k)
        dratio = d / (1.0 - d)
        s = torch.zeros_like(d)
        lv_m = torch.zeros_like(d)
        for x in range(k + 1):
            if x <= hdist_th:
                s = s - (logdn + float(x) * logdp) * hist[..., x]
                lv_m = lv_m + float(binom_hnk[x]) * powdc
            else:
                lv_m = lv_m + powdc * float(binom_k[x])
            powdc = powdc * dratio
        return s - torch.log(rho * lv_m + 1.0 - rho) * uc

    return llh


def make_llh_fast(k: int, h: int, hdist_th: int):
    """Moment-form llh(d, A, Bx, uc, rho) for the Brent inner loop: O(th)
    per evaluation (see krepp_tpu.core.llh.make_llh_fast)."""
    binom_k, binom_hnk = binom_tables(k, h, hdist_th)

    def llh(d, A, Bx, uc, rho):
        d = d.to(F)
        powdc = _ipow(1.0 - d, k)
        logdn = torch.log(1.0 - d)
        logdp = torch.log(d) - logdn
        dratio = d / (1.0 - d)
        lv_m = torch.zeros_like(d)
        ck = torch.zeros_like(d)
        for x in range(hdist_th + 1):
            lv_m = lv_m + float(binom_hnk[x]) * powdc
            ck = ck + float(binom_k[x]) * powdc
            powdc = powdc * dratio
        lv_m = lv_m + (1.0 - ck)
        s = -(float(k) * logdn) * A - logdp * Bx
        return s - torch.log(rho * lv_m + 1.0 - rho) * uc

    return llh


def make_llh_np(k: int, h: int, hdist_th: int):
    """Host (numpy f64) mirror of make_llh with the identical accumulation
    order; computes the report-only chi-square ratio on the host."""
    binom_k, binom_hnk = binom_tables(k, h, hdist_th)

    def ipow(x, n: int):
        acc = None
        base = x
        while n:
            if n & 1:
                acc = base.copy() if acc is None else acc * base
            base = base * base
            n >>= 1
        return acc if acc is not None else np.ones_like(x)

    def llh(d, hist, uc, rho):
        d = np.asarray(d, np.float64)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            powdc = ipow(1.0 - d, k)
            logdn = np.log(1.0 - d)
            logdp = np.log(d) - logdn
            logdn = logdn * float(k)
            dratio = d / (1.0 - d)
            s = np.zeros_like(d)
            lv_m = np.zeros_like(d)
            for x in range(k + 1):
                if x <= hdist_th:
                    s = s - (logdn + float(x) * logdp) * hist[..., x]
                    lv_m = lv_m + binom_hnk[x] * powdc
                else:
                    lv_m = lv_m + powdc * binom_k[x]
                powdc = powdc * dratio
            return s - np.log(rho * lv_m + 1.0 - rho) * uc

    return llh


def brent_find_minima(f, batch_shape, device, lo: float = _BRENT_LO,
                      hi: float = _BRENT_HI, max_iter: int = _MAX_ITER):
    """Batched boost-style Brent minimisation of f over [lo, hi].

    f maps an f64 tensor of shape `batch_shape` to f64 of the same shape.
    Returns (x_min, f_min). A lane freezes once its own criterion
    |x - mid| <= fract2 - (max-min)/2 holds, exactly as boost's loop break.
    """
    tol = _TOLERANCE
    golden = _GOLDEN
    where = torch.where
    mn = torch.full(batch_shape, lo, dtype=F, device=device)
    mx = torch.full(batch_shape, hi, dtype=F, device=device)
    x = torch.full(batch_shape, hi, dtype=F, device=device)  # boost: upper
    w = x.clone()
    v = x.clone()
    fx = f(x)
    fw = fx.clone()
    fv = fx.clone()
    delta = torch.zeros(batch_shape, dtype=F, device=device)
    delta2 = delta.clone()
    done = torch.zeros(batch_shape, dtype=torch.bool, device=device)
    steps = None
    if brent_find_minima.lane_steps is not None:
        steps = torch.zeros(batch_shape, dtype=torch.int64, device=device)

    for it in range(max_iter):
        if it % BRENT_SYNC_EVERY == 0 and bool(done.all()):
            break
        mid = (mn + mx) * 0.5
        fract1 = tol * torch.abs(x) + tol * 0.25
        fract2 = 2.0 * fract1
        newly_done = torch.abs(x - mid) <= (fract2 - (mx - mn) * 0.5)
        act = ~(done | newly_done)

        # parabolic fit when |delta2| > fract1
        use_para = torch.abs(delta2) > fract1
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q = 2.0 * (q - r)
        p = where(q > 0.0, -p, p)
        q = torch.abs(q)
        td = delta2
        golden_step = ~use_para | (
            (torch.abs(p) >= torch.abs(q * td * 0.5))
            | (p <= q * (mn - x)) | (p >= q * (mx - x)))
        g_delta2 = where(x >= mid, mn - x, mx - x)
        g_delta = golden * g_delta2
        p_delta = p / where(q == 0.0, 1.0, q)  # guarded; unused when golden
        u_try = x + p_delta
        p_delta = where(((u_try - mn) < fract2) | ((mx - u_try) < fract2),
                        where((mid - x) < 0.0, -torch.abs(fract1),
                              torch.abs(fract1)),
                        p_delta)
        new_delta2 = where(golden_step, g_delta2,
                           where(use_para, delta, delta2))
        new_delta = where(golden_step, g_delta, p_delta)

        u = where(torch.abs(new_delta) >= fract1, x + new_delta,
                  where(new_delta > 0.0, x + torch.abs(fract1),
                        x - torch.abs(fract1)))
        fu = f(u)

        improve = fu <= fx
        mn2 = where(improve, where(u >= x, x, mn), where(u < x, u, mn))
        mx2 = where(improve, where(u >= x, mx, x), where(u < x, mx, u))
        v2 = where(improve, w, v)
        fv2 = where(improve, fw, fv)
        w2 = where(improve, x, w)
        fw2 = where(improve, fx, fw)
        x2 = where(improve, u, x)
        fx2 = where(improve, fu, fx)
        cond_w = ~improve & ((fu <= fw) | (w == x))
        v2 = where(cond_w, w, v2)
        fv2 = where(cond_w, fw, fv2)
        w2 = where(cond_w, u, w2)
        fw2 = where(cond_w, fu, fw2)
        cond_v = ~improve & ~cond_w & ((fu <= fv) | (v == x) | (v == w))
        v2 = where(cond_v, u, v2)
        fv2 = where(cond_v, fu, fv2)

        if steps is not None:
            steps += act
        done = done | newly_done
        mn = where(act, mn2, mn)
        mx = where(act, mx2, mx)
        x = where(act, x2, x)
        w = where(act, w2, w)
        v = where(act, v2, v)
        fx = where(act, fx2, fx)
        fw = where(act, fw2, fw)
        fv = where(act, fv2, fv)
        delta = where(act, new_delta, delta)
        delta2 = where(act, new_delta2, delta2)
    if steps is not None:
        brent_find_minima.lane_steps.append(steps)
    return x, fx


brent_find_minima.lane_steps = None


def brent_on_mask(llh_fast, A, Bx, uc, rho, mask):
    """Batched Brent over the mask-selected lanes only (moment-form llh).

    The JAX version picks the smallest capacity tier that fits; lanes are
    independent, so running the exact kept set gives the same d and v.
    Unselected lanes return d = 0.0, v = 0.0 — callers gate on their own
    masks."""
    shape = uc.shape
    maskf = mask.reshape(-1)
    N = maskf.shape[0]
    idx = torch.nonzero(maskf).squeeze(1)
    a = A.reshape(N)[idx]
    b = Bx.reshape(N)[idx]
    u = uc.reshape(N)[idx]
    r = rho.reshape(N)[idx]
    d, v = brent_find_minima(lambda dd: llh_fast(dd, a, b, u, r),
                             (idx.shape[0],), uc.device)
    D = torch.zeros(N, dtype=F, device=uc.device)
    V = torch.zeros(N, dtype=F, device=uc.device)
    D[idx] = d
    V[idx] = v
    return D.reshape(shape), V.reshape(shape)


# ------------------------------------------------------ Brent as one kernel
def _check_brent(A, Bx, uc, rho, mask, k: int, h: int, th: int):
    """Validate the brent_llh contract."""
    ts = (A, Bx, uc, rho) + (() if mask is None else (mask,))
    if any(t.shape != uc.shape for t in ts):
        raise ValueError("shape mismatch: " + ", ".join(
            str(tuple(t.shape)) for t in ts))
    if any(t.dtype != F for t in (A, Bx, uc, rho)) or (
            mask is not None and mask.dtype != torch.bool):
        raise TypeError("A, Bx, uc, rho must be float64 and mask bool, got "
                        + ", ".join(str(t.dtype) for t in ts))
    if len({t.device for t in ts}) != 1:
        raise ValueError("A, Bx, uc, rho and mask must share one device")
    if not 1 <= h <= k <= MAX_BRENT_K:
        raise ValueError(f"k={k}, h={h}: need 1 <= h <= k <= {MAX_BRENT_K}")
    if not 0 <= th <= k:     # binom_k[x] exists for x <= k
        raise ValueError(f"th={th} is outside brent_llh's range 0..{k} "
                         f"(k={k})")


def brent_llh_ref(A: torch.Tensor, Bx: torch.Tensor, uc: torch.Tensor,
                  rho: torch.Tensor, mask, k: int, h: int, th: int):
    """Plain torch version of brent_llh (same contract): brent_find_minima
    over make_llh_fast, on the mask-selected lanes (brent_on_mask) or, with
    mask None, on every lane."""
    _check_brent(A, Bx, uc, rho, mask, k, h, th)
    f = make_llh_fast(k, h, th)
    if mask is None:
        return brent_find_minima(lambda dd: f(dd, A, Bx, uc, rho), uc.shape,
                                 uc.device)
    return brent_on_mask(f, A, Bx, uc, rho, mask)


@functools.lru_cache(maxsize=None)
def _binom_host(k: int, h: int, th: int) -> np.ndarray:
    """binom_k[0..th] then binom_hnk[0..th], f64 in host memory: the
    launcher passes them to the kernel by value, in its parameters."""
    binom_k, binom_hnk = binom_tables(k, h, th)
    return np.concatenate([binom_k[: th + 1], binom_hnk])


def _brent_launcher():
    from ..csrc.build import load

    fn = load("brent_llh").krepp_brent_llh
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 4)
    return fn


def brent_llh(A: torch.Tensor, Bx: torch.Tensor, uc: torch.Tensor,
              rho: torch.Tensor, mask, k: int, h: int, th: int):
    """Brent's minimiser of the moment-form llh per lane -> (d, v).

    A, Bx, uc, rho: f64 of one shape, contiguous, on one device; mask: bool
    of that shape, or None for every lane. d is the arg-min in [1e-10,
    0.5], v the minimum; a lane outside the mask gets d = v = 0.0 (callers
    gate on their own masks). The CUDA kernel csrc/brent_llh.cu for CUDA
    tensors, the plain version (brent_llh_ref) for host tensors."""
    if uc.device.type == "cpu":
        return brent_llh_ref(A, Bx, uc, rho, mask, k, h, th)
    if uc.device.type != "cuda":
        raise ValueError(f"unsupported device {uc.device}")
    _check_brent(A, Bx, uc, rho, mask, k, h, th)
    for name, t in (("A", A), ("Bx", Bx), ("uc", uc), ("rho", rho),
                    ("mask", mask)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    d = torch.empty_like(uc)
    v = torch.empty_like(uc)
    N = uc.numel()
    if N == 0:
        return d, v
    if take_keep(brent_llh):
        brent_llh.kept = (A.clone(), Bx.clone(), uc.clone(), rho.clone(),
                          None if mask is None else mask.clone(), k, h, th)
    tab = _binom_host(k, h, th)
    fn = _brent_launcher()
    with torch.cuda.device(uc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(A.data_ptr(), Bx.data_ptr(), uc.data_ptr(), rho.data_ptr(),
                0 if mask is None else mask.data_ptr(), N, k, th,
                tab.ctypes.data, d.data_ptr(), v.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"brent_llh launch failed: cudaError {rc}")
    count_launch(brent_llh)
    return d, v


brent_llh.launches = 0
brent_llh.keep_next = False
brent_llh.kept = None
