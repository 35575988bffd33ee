"""Genome winnowing with SDUST masking (--sdust-t/--sdust-w > 0).

Port of krepp_tpu/core/masked_extract.py, which transliterates the masked
control flow of RSeq::extract_mers (ref: src/rqseq.cpp:72-107): k-mers
whose end index i satisfies i + k > region_start while the region is active
are skipped (but still counted by the c1 HLL); crossing a region end resets
the run counter. The region-advance/run-reset state machine is inherently
sequential, so this path runs the control loop on the host over per-position
arrays (hashes, rows, residuals) computed on `device` by
minimizer._window_stats. Used only when sdust is enabled.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..params import IndexParams
from .hll import genome_rho
from .minimizer import window_stats_host
from .sdust import sdust


def extract_sequence_mers_masked(codes: np.ndarray, params: IndexParams,
                                 device="cuda"):
    """Winnow one contig with SDUST masking.

    Returns (rows, res, c1_hashes, c2_hashes) like
    minimizer.extract_sequence_mers, or None for short contigs."""
    lsh = params.lsh
    k, w = lsh.k, max(params.w, lsh.k)
    n = len(codes)
    if n < params.w:
        return None
    ldiff = w - k + 1
    regions = (sdust(codes, params.sdust_t, params.sdust_w)
               if params.sdust_t > 0 and params.sdust_w > 0 else [])
    _vk, _vw, z64, z_lo, rix, res = window_stats_host(codes, lsh, w, device)

    mi, mn = 0, len(regions)
    mrs, mre = (regions[0] if mn else (0, n))
    win_z = np.zeros(ldiff, np.uint64)
    win_pos = np.full(ldiff, -1, np.int64)
    kix = 0
    kept_rows: List[int] = []
    kept_res: List[int] = []
    c1: List[int] = []
    c2: List[int] = []
    m, r, frac = lsh.m, params.r, params.frac
    base_valid = codes < 4

    l = 0
    for i in range(1, n + 1):  # i = 1-based end index, as the reference
        if not base_valid[i - 1]:
            l = 0
            continue
        l += 1
        if l < k:
            continue
        t = i - k  # window index
        if mi < mn and (i + k) > mrs:
            c1.append(int(z_lo[t]))
            if i < mre:
                continue
            mi += 1
            l = 0
            if mi < mn:
                mrs, mre = regions[mi]
            continue
        klix = kix % ldiff
        win_z[klix] = z64[t]
        win_pos[klix] = t
        c1.append(int(z_lo[t]))
        kix += 1
        if l < w and i != n:
            continue
        amin = int(np.argmin(win_z))
        if win_pos[amin] < 0:  # zero-initialised ring buffer entry
            sel_rix, sel_res, sel_zlo = 0, 0, 0
        else:
            tsel = int(win_pos[amin])
            sel_rix, sel_res = int(rix[tsel]), int(res[tsel])
            sel_zlo = int(z_lo[tsel])
        c2.append(sel_zlo)
        rmod = sel_rix % m
        if (rmod <= r) if frac else (rmod == r):
            local = sel_rix // m * (r + 1) + rmod if frac else sel_rix // m
            kept_rows.append(local)
            kept_res.append(sel_res)
    return (np.array(kept_rows, np.uint32), np.array(kept_res, np.uint32),
            np.array(c1, np.uint32), np.array(c2, np.uint32))


def extract_genome_mers_masked(contigs, params: IndexParams, device="cuda"):
    """Masked-path genome winnow; returns (rows, res, rho) like the device
    path (per-sequence HLL estimate ratio, ref: src/rqseq.hpp:79)."""
    return genome_rho(
        (extract_sequence_mers_masked(np.asarray(codes, np.uint8), params,
                                      device) for codes in contigs),
        from_registers=False)
