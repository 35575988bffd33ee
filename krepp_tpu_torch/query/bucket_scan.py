"""Bucket scans -> per-(read, leaf) first-match histograms (torch).

Port of krepp_tpu/query/bucket_scan.py: the leaf-bit expander, the
bounded scan loop (the hybrid heavy tail's ultra-deep buckets), the
CSR-mode strand probe with its top-k heavy tail, the exact full-depth scan
(the last-resort fallback), and seek's color-less minimum scan. Semantics: min Hamming
distance per (read, position, leaf), counted once per position
(ref: src/query.hpp:153-176).

The loop bound of a scan is a host integer: the caller reads the deepest
bucket it must cover (one sync), where JAX ran a device while_loop.
"""

from __future__ import annotations

import torch

from ..core.codec import hdist_lr32
from ..core.host_turn import host_int
from .kernels import HD_SENTINEL

PHASE1_C = 4
HEAVY_FRACTION = 64  # K = N // HEAVY_FRACTION top-k slots for heavy probes
# elements of _first_x_hist's largest [rows, P, S] temporary
_HIST_ELEMS = 1 << 25


def make_expander(S: int, W: int):
    """mask [..., W] int32 words -> bits [..., S] int32 (0/1)."""
    def expand(mask):
        outs = []
        for wd in range(W):
            lo = wd * 32
            sh = torch.arange(0, min(S, lo + 32) - lo, dtype=torch.int32,
                              device=mask.device)
            outs.append((mask[..., wd: wd + 1] >> sh) & 1)
        return torch.cat(outs, dim=-1) if W > 1 else outs[0]

    return expand


def _scan_loop(enc_se, mask_tab, start, cnt, res, th, W, j0: int, j1: int,
               Mm, gmin):
    """OR leaf masks into Mm [X, ..., W] per distance class (in place) and
    lower gmin for bucket entries j0 <= j < j1; returns (Mm, gmin)."""
    nk = max(enc_se.shape[0], 1)
    for j in range(j0, j1):
        idx = torch.clamp(start + j, max=nk - 1)
        inb = j < cnt
        pair = enc_se[idx]
        hd = hdist_lr32(pair[..., 0], res)
        match = inb & (hd <= th)
        gmin = torch.where(match, torch.minimum(gmin, hd), gmin)
        msk = mask_tab[torch.where(inb, pair[..., 1], 0).long()]
        for x in range(th + 1):
            hit = (match & (hd == x))[..., None]
            Mm[x] = torch.where(hit, Mm[x] | msk, Mm[x])
    return Mm, gmin


def _first_x_hist(Mm, expand, weight, th):
    """Mm [X, B, P, W] -> hist [B, S, X] of first-set-x per (p, leaf),
    weighted per probe by `weight` [B, P] (0/1). Runs in row chunks so
    the [rows, P, S] bit planes stay under _HIST_ELEMS elements."""
    _, B, P, W = Mm.shape
    rows = max(1, _HIST_ELEMS // (P * 32 * W))
    parts = []
    for lo in range(0, B, rows):
        seen = None
        outs = []
        w = weight[lo: lo + rows, :, None].to(torch.int32)
        for x in range(th + 1):
            bits = expand(Mm[x, lo: lo + rows])
            if seen is None:
                new = bits
                seen = bits
            else:
                new = bits & (seen ^ 1)
                seen = seen | bits
            outs.append((new * w).sum(dim=1, dtype=torch.int32))
        parts.append(torch.stack(outs, dim=-1))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def probe_strand(enc_se, mask_tab, expand, start, cnt, res, th: int, W: int,
                 S: int, max_bucket: int):
    """CSR-mode strand probe of [B, P] probes: a short phase-1 scan of the
    first PHASE1_C entries of every bucket, then the K deepest probes
    (K = N // HEAVY_FRACTION, picked as lax.top_k picks: by count, ties to
    the lower index) rescanned to their true depth.

    Returns (hist [B, S, th+1] int32, minall [B] int32, overflow bool
    tensor), overflow set when more than K probes are heavy (the caller
    re-runs the exact scan)."""
    B, P = res.shape
    X = th + 1
    dev = res.device
    C = min(PHASE1_C, max_bucket)
    maxcnt = min(host_int(cnt.max()), max_bucket) if cnt.numel() else 0
    Mm = torch.zeros((X, B, P, W), dtype=torch.int32, device=dev)
    gmin = torch.full((B, P), HD_SENTINEL, dtype=torch.int32, device=dev)
    Mm, gmin = _scan_loop(enc_se, mask_tab, start, cnt, res, th, W,
                          0, min(maxcnt, C), Mm, gmin)
    minall = gmin.amin(dim=1)
    if max_bucket <= C:
        hist = _first_x_hist(Mm, expand, torch.ones_like(res), th)
        return hist, minall, torch.zeros((), dtype=torch.bool, device=dev)

    is_heavy = cnt > C
    hist = _first_x_hist(Mm, expand, ~is_heavy, th)
    N = B * P
    K = min(N, max(128, N // HEAVY_FRACTION))
    cnt_f = cnt.reshape(N)
    overflow = is_heavy.sum() > K
    top = torch.sort(cnt_f, descending=True, stable=True)
    hcnt, hidx = top.values[:K], top.indices[:K]
    # sort by read id for the per-read aggregation
    b_of = hidx // P
    order = torch.argsort(b_of, stable=True)
    hidx, hcnt, b_of = hidx[order], hcnt[order], b_of[order]
    hstart = start.reshape(N)[hidx]
    hres = res.reshape(N)[hidx]
    hMm = torch.zeros((X, K, W), dtype=torch.int32, device=dev)
    hgmin = torch.full((K,), HD_SENTINEL, dtype=torch.int32, device=dev)
    hmax = min(host_int(hcnt.max()), max_bucket)
    hMm, hgmin = _scan_loop(enc_se, mask_tab, hstart, hcnt, hres, th, W,
                            C, hmax, hMm, hgmin)
    # merge with the heavy probes' phase-1 masks
    merged = Mm.reshape(X, N, W)[:, hidx] | hMm
    really_heavy = (hcnt > C).to(torch.int32)
    seen = None
    for x in range(X):
        bits = expand(merged[x])
        if seen is None:
            new = bits
            seen = bits
        else:
            new = bits & (seen ^ 1)
            seen = seen | bits
        hist[:, :, x].index_add_(0, b_of, new * really_heavy[:, None])
    hgmin = torch.where(really_heavy != 0, hgmin, HD_SENTINEL)
    minall = minall.scatter_reduce(0, b_of, hgmin, "amin")
    return hist, minall, overflow


def probe_strand_full(enc_se, mask_tab, expand, start, cnt, res, th: int,
                      W: int, S: int, max_bucket: int):
    """Exact full-depth scan of [B, P] probes (the overflow fallback).

    Returns (hist [B, S, th+1] int32, minall [B] int32)."""
    B, P = res.shape
    X = th + 1
    maxcnt = min(host_int(cnt.max()), max_bucket) if cnt.numel() else 0
    Mm = torch.zeros((X, B, P, W), dtype=torch.int32, device=res.device)
    gmin = torch.full((B, P), HD_SENTINEL, dtype=torch.int32,
                      device=res.device)
    Mm, gmin = _scan_loop(enc_se, mask_tab, start, cnt, res, th, W,
                          0, maxcnt, Mm, gmin)
    hist = _first_x_hist(Mm, expand, torch.ones_like(res), th)
    return hist, gmin.amin(dim=1)


def scan_buckets_min(enc_v, start, cnt, res, th: int, max_bucket: int):
    """Color-less scan for seek: min Hamming distance per probe, HD_SENTINEL
    above th (ref: src/seek.cpp:103-119). enc_v int32 [nk]; start, cnt,
    res [...] (int64, int64, int32)."""
    nk = max(enc_v.shape[0], 1)
    gmin = torch.full(res.shape, HD_SENTINEL, dtype=torch.int32,
                      device=res.device)
    maxcnt = min(host_int(cnt.max()), max_bucket) if cnt.numel() else 0
    for j in range(maxcnt):
        hd = hdist_lr32(enc_v[torch.clamp(start + j, max=nk - 1)], res)
        gmin = torch.where(j < cnt, torch.minimum(gmin, hd), gmin)
    return torch.where(gmin <= th, gmin, HD_SENTINEL)
