"""Minimizer winnowing + LSH subsampling for reference-genome sketching.

Port of krepp_tpu/core/minimizer.py; the semantics are RSeq::extract_mers'
(ref: src/rqseq.cpp:51-144) and the reference quirks kept there are kept
here (the zero-initialised ring buffer, the stale pre-N k-mer at an
end-of-sequence emission, sequences shorter than w skipped with their HLL
contribution; see that module's docstring).

The per-position work (validity, bp packing, xur64, LSH row, residual) runs
as torch ops on `device`; the data-dependent compaction and trailing-window
argmin run on the host in numpy, as in the original. What differs: the
64-bit minimizer hash is ONE int64 per window (the u64's bit pattern)
instead of a (hi, lo) u32 pair, because the card has 64-bit integers;
`xur64` and `less_u64` are the int64 forms of the original's u64.xur64 and
u64.less64.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .. import resolve_device
from ..params import IndexParams, LSHParams
from . import codec
from .hll import genome_rho

# xur64 (murmur3 finaliser) multipliers (ref: src/common.hpp:147-155) as the
# two's-complement int64 of the u64 constants; int64 products wrap mod 2^64
_C1 = 0xFF51AFD7ED558CCD - (1 << 64)
_C2 = 0xC4CEB9FE1A85EC53 - (1 << 64)
_LOW31 = (1 << 31) - 1
SIGN64 = -(1 << 63)
U32_MASK = (1 << 32) - 1


def xur64(h: torch.Tensor) -> torch.Tensor:
    """xur64_hash on int64 bit patterns of u64 (ref: src/common.hpp:147-155).

    `h >> 33` must be the logical shift: torch's fills with the sign, so
    the 31 bits that remain are masked."""
    h = h ^ ((h >> 33) & _LOW31)
    h = h * _C1
    h = h ^ ((h >> 33) & _LOW31)
    h = h * _C2
    return h ^ ((h >> 33) & _LOW31)


def ordered_u64(h: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns of u64 -> int64 keys whose SIGNED order is the
    u64s' unsigned order (the sign bit flipped; its own inverse)."""
    return h ^ SIGN64


def less_u64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a < b) as u64, for int64 bit patterns."""
    return ordered_u64(a) < ordered_u64(b)


def _window_stats(codes: torch.Tensor, lsh: LSHParams, w: int):
    """Per-window quantities for one (batch of) contig(s).

    Returns (valid_k, valid_w, z, rix, res), each [..., P] with
    P = L - k + 1: z the xur64 hash as int64 (the original's z_hi and z_lo
    are its halves), rix and res int32 bit patterns of the u32 values;
    valid_w[t] is False for t < w - k."""
    k = lsh.k
    valid_k = codec.window_valid(codes, k)
    if w > k:
        vw_full = codec.window_valid(codes, w)          # [..., L - w + 1]
        pad = torch.zeros(codes.shape[:-1] + (w - k,), dtype=torch.bool,
                          device=codes.device)
        valid_w = torch.cat([pad, vw_full], dim=-1)
    else:
        valid_w = valid_k
    z = xur64(codec.bp64(codes, k))
    rix = codec.lsh_hash_or(codes, lsh)
    res = codec.residual_or(codes, lsh)
    return valid_k, valid_w, z, rix, res


def window_stats_host(codes: np.ndarray, lsh: LSHParams, w: int, device):
    """_window_stats of one contig on `device`, fetched as numpy:
    (valid_k, valid_w, z64 u64, z_lo u32, rix u32, res u32)."""
    dev = resolve_device(device)
    valid_k, valid_w, z, rix, res = _window_stats(
        torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(dev),
        lsh, w)
    z64 = z.cpu().numpy().view(np.uint64)
    return (valid_k.cpu().numpy(), valid_w.cpu().numpy(), z64,
            z64.astype(np.uint32), rix.cpu().numpy().view(np.uint32),
            res.cpu().numpy().view(np.uint32))


def _round_len(n: int) -> int:
    """The reference's padded length of an n-base contig (a power of two,
    at least 256). The port pads nothing, but a contig is cut into tiles
    exactly when this length exceeds the tile size, as in the reference."""
    return 1 << max(8, (n - 1).bit_length())


def extract_sequence_mers(codes: np.ndarray, params: IndexParams,
                          device="cuda"):
    """Winnow one contig. Returns (rows, res, c1_hashes, c2_hashes) or None.

    rows/res: kept (local-row, residual) pairs, uint32. c1/c2: low-32-bit
    xur64 hashes feeding the per-sequence HLL counters."""
    lsh = params.lsh
    k, w = lsh.k, max(params.w, lsh.k)
    n = len(codes)
    if n < params.w:  # ref: src/rqseq.hpp:80-86 (set_curr_seq)
        return None
    ldiff = w - k + 1
    valid_k, valid_w, z64, z_lo, rix, res = window_stats_host(
        codes, lsh, w, device)
    Pn = n - k + 1

    V = np.flatnonzero(valid_k)  # compacted valid k-mer positions
    if V.size == 0:
        return (np.empty(0, np.uint32), np.empty(0, np.uint32),
                np.empty(0, np.uint32), np.empty(0, np.uint32))

    # emit rule (ref: src/rqseq.cpp:112-116): l >= w, or final base with l >= k
    emit = valid_w[V].copy()
    if V[-1] == Pn - 1:
        emit[-1] = True

    zv = z64[V]
    # trailing window min of width ldiff over the compacted array, with
    # zero-entry padding before the start (zero-initialised ring buffer)
    zpad = np.concatenate([np.zeros(ldiff - 1, np.uint64), zv])
    sw = np.lib.stride_tricks.sliding_window_view(zpad, ldiff)  # [nv, ldiff]
    amin = np.argmin(sw, axis=1)  # first minimum ~ reference's min_element
    sel_c = np.arange(V.size) - (ldiff - 1) + amin  # <0 => zero entry

    e_idx = np.flatnonzero(emit)
    sel_e = sel_c[e_idx]
    is_zero_entry = sel_e < 0
    sel_pos = V[np.maximum(sel_e, 0)]
    mrix = np.where(is_zero_entry, np.uint32(0), rix[sel_pos]).astype(np.uint32)
    mres = np.where(is_zero_entry, np.uint32(0), res[sel_pos]).astype(np.uint32)
    mz_lo = np.where(is_zero_entry, np.uint32(0),
                     z_lo[sel_pos]).astype(np.uint32)

    m, r, frac = lsh.m, params.r, params.frac
    rmod = mrix % np.uint32(m)
    keep = (rmod <= np.uint32(r)) if frac else (rmod == np.uint32(r))
    if frac:
        local = (mrix // np.uint32(m)) * np.uint32(r + 1) + rmod
    else:
        local = mrix // np.uint32(m)

    c1 = z_lo[V].astype(np.uint32)  # all valid k-mers (ref: src/rqseq.cpp:110)
    c2 = mz_lo                      # every emitted minimizer (ref: :117)
    return local[keep].astype(np.uint32), mres[keep], c1, c2


def extract_genome_mers(contigs: Iterable[np.ndarray], params: IndexParams,
                        device="cuda"):
    """Winnow a whole genome (iterable of contig code arrays).

    Returns (rows, res, rho); rows/res are NOT deduplicated here (the table
    build sorts/dedupes per row, ref: src/table.cpp:248-260)."""
    return genome_rho(
        (extract_sequence_mers(np.asarray(codes, dtype=np.uint8), params,
                               device) for codes in contigs),
        from_registers=False)
