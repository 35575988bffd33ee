"""Bucket scans -> per-(read, leaf) first-match histograms (torch).

Port of the parts of krepp_tpu/query/bucket_scan.py that the hybrid dist
path runs: the leaf-bit expander, the bounded scan loop (the heavy tail's
ultra-deep buckets) and the exact full-depth scan (the last-resort
fallback). Semantics: min Hamming distance per (read, position, leaf),
counted once per position (ref: src/query.hpp:153-176).

The loop bound of a scan is a host integer: the caller reads the deepest
bucket it must cover (one sync), where JAX ran a device while_loop.
"""

from __future__ import annotations

import torch

from ..core.codec import hdist_lr32
from .kernels import HD_SENTINEL


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
    weighted per probe by `weight` [B, P] (0/1)."""
    seen = None
    outs = []
    w = weight[..., None].to(torch.int32)
    for x in range(th + 1):
        bits = expand(Mm[x])
        if seen is None:
            new = bits
            seen = bits
        else:
            new = bits & (seen ^ 1)
            seen = seen | bits
        outs.append((new * w).sum(dim=1, dtype=torch.int32))
    return torch.stack(outs, dim=-1)


def probe_strand_full(enc_se, mask_tab, expand, start, cnt, res, th: int,
                      W: int, S: int, max_bucket: int):
    """Exact full-depth scan of [B, P] probes (the overflow fallback).

    Returns (hist [B, S, th+1] int32, minall [B] int32)."""
    B, P = res.shape
    X = th + 1
    maxcnt = min(int(cnt.max()), max_bucket) if cnt.numel() else 0
    Mm = torch.zeros((X, B, P, W), dtype=torch.int32, device=res.device)
    gmin = torch.full((B, P), HD_SENTINEL, dtype=torch.int32,
                      device=res.device)
    Mm, gmin = _scan_loop(enc_se, mask_tab, start, cnt, res, th, W,
                          0, maxcnt, Mm, gmin)
    hist = _first_x_hist(Mm, expand, torch.ones_like(res), th)
    return hist, gmin.amin(dim=1)
