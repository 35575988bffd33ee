"""Fully on-device genome winnowing: minimizers, LSH filter, dedupe, HLL.

Port of krepp_tpu/core/winnow_device.py. The whole pipeline runs as torch
ops on one device:

  windows -> xur64 -> trailing-window (ldiff) minimizer argmin ->
  LSH residue filter -> (row, residual) sort + neighbour dedupe ->
  HyperLogLog registers via scatter amax

and only the deduplicated entries and two 4096-entry HLL register arrays
per tile come back to the host. Semantics match RSeq::extract_mers
(ref: src/rqseq.cpp:51-144) exactly, including the end-of-sequence emission
over the last `ldiff` *valid* k-mers with its zero-initialised-buffer quirk
(ref: src/rqseq.cpp:67,112-116).

What differs from the original:

  * `winnow_device` works on a batch of tiles ([T, L] codes; n_real, t_lo
    and do_final per tile), always with that axis, so the sharded build
    needs no vmap;
  * the 64-bit hash is one int64 per window, compared unsigned through
    minimizer.ordered_u64;
  * the trailing-window argmin is a doubling sliding minimum (about
    log2(ldiff) shifted passes instead of ldiff - 1). xur64 is a bijection,
    so equal hashes in a window are equal k-mers with the same row and
    residual, and which of them the argmin names changes nothing;
  * the sorted unique entries come back compacted (a boolean mask), not in
    a fixed padded shape, and contigs are not padded to powers of two: the
    original did both to spare compiles. A contig is still tiled exactly
    when its power-of-two length would exceed `_CHUNK`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..params import IndexParams, LSHParams
from .hll import HLL_B as _HLL_B
from .hll import HyperLogLog, genome_rho
from .minimizer import (U32_MASK, _round_len, _window_stats,
                        extract_sequence_mers, ordered_u64)

_I64MAX = (1 << 63) - 1
_RANK_BITS = 32 - _HLL_B
# ordered_u64 of the least pair whose row is 0xFFFFFFFF (a dropped entry)
_ROW_DROPPED = ((1 << 31) - 1) << 32

# longest contig winnowed in one piece; longer ones are processed in
# halo-overlapped tiles of this many bases
_CHUNK = 1 << 20
# tiles per device per launch: bounds the batch's memory (about thirty
# int64 arrays of TILE_GROUP * _CHUNK positions) while amortizing dispatch
TILE_GROUP = 8


def _hll_ranks(zlo: torch.Tensor):
    """(register index, rank) of u32 hashes held in int64.

    rank = min(32-b, clz(hash << b)) + 1, clz(0) = 32
    (ref: src/hyperloglog.hpp:21,98-105). torch has no clz: the rank
    depends only on the low 32-b bits u of the hash and equals
    32-b+1 - bit_length(u), and bit_length(u) is the exponent frexp gives
    for u as a float32 (exact below 2^24; 0 for u = 0)."""
    idx = zlo >> _RANK_BITS
    u = (zlo & ((1 << _RANK_BITS) - 1)).to(torch.float32)
    return idx, _RANK_BITS + 1 - torch.frexp(u).exponent


def _hll_registers(zlo: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """HyperLogLog register maxima (b=12) of the masked u32 hashes of each
    row: zlo int64 [T, n], mask bool [T, n] -> int32 [T, 4096]."""
    idx, rank = _hll_ranks(zlo)
    rank = torch.where(mask, rank, 0)
    reg = torch.zeros(zlo.shape[:-1] + (1 << _HLL_B,), dtype=torch.int32,
                      device=zlo.device)
    return reg.scatter_reduce_(-1, idx, rank, "amax", include_self=True)


def _shifted(x: torch.Tensor, s: int, fill: int) -> torch.Tensor:
    """y[..., t] = x[..., t - s], `fill` where t < s."""
    P = x.shape[-1]
    pad = x.new_full(x.shape[:-1] + (min(s, P),), fill)
    return torch.cat([pad, x[..., :max(P - s, 0)]], dim=-1)


def _trailing_argmin(key: torch.Tensor, width: int):
    """Sliding minimum of `key` over the trailing `width` positions, by
    doubling: (min [.., P], offset back to it [.., P] int64). Positions
    before the start count as int64 max; a strict compare never takes one."""
    best = key
    off = torch.zeros_like(key)
    have = 1
    while have < width:
        s = min(have, width - have)
        cand = _shifted(best, s, _I64MAX)
        better = cand < best
        best = torch.where(better, cand, best)
        off = torch.where(better, _shifted(off, s, 0) + s, off)
        have += s
    return best, off


def winnow_device(codes: torch.Tensor, n_real: torch.Tensor, lsh: LSHParams,
                  w: int, r: int, frac: bool, t_lo: torch.Tensor = None,
                  do_final: torch.Tensor = None):
    """A batch of contigs or halo'd tiles -> deduped (local_row, residual)
    pairs + HLL registers, all on codes' device.

    codes: [T, L] uint8, each row padded with 4 past its n_real [T] bases.
    For tiles of a chunked long contig, t_lo [T] masks emissions/c1 to
    window positions >= t_lo (the left halo) and do_final [T] gates the
    end-of-sequence emission (last tile only); defaults 0 and True.
    Returns (rows, res, nuniq [T], c1reg [T, 4096], c2reg [T, 4096]): rows
    and res are int64 tensors holding u32 values, the sorted unique kept
    pairs of tile 0, then tile 1's, ...: nuniq[i] of them for tile i."""
    T, L = codes.shape
    dev = codes.device
    k = lsh.k
    m = lsh.m
    w = max(w, k)
    ldiff = w - k + 1
    P = L - k + 1

    def per_tile(x, default, dtype):
        if x is None:
            return torch.full((T, 1), default, dtype=dtype, device=dev)
        return torch.as_tensor(x, device=dev).reshape(T, 1).to(dtype)

    n_real = per_tile(n_real, None, torch.int64)
    t_lo = per_tile(t_lo, 0, torch.int64)
    do_final = per_tile(do_final, True, torch.bool)
    t_idx = torch.arange(P, dtype=torch.int64, device=dev)[None]

    valid_k, valid_w, z, rix, res = _window_stats(codes, lsh, w)
    valid = valid_k & (t_idx <= n_real - k)
    valid_w = valid_w & valid
    # unsigned order as signed keys; an invalid window is u64 max (int64 max
    # as a key) and loses every compare
    key = torch.where(valid, ordered_u64(z), _I64MAX)
    rix = rix.to(torch.int64) & U32_MASK
    res = res.to(torch.int64) & U32_MASK

    # trailing-window (ldiff) argmin of the 64-bit hash, positional: at any
    # valid_w position the last ldiff k-mer positions are all valid, so the
    # positional window equals the reference's ring buffer of the last
    # ldiff valid k-mers
    best, off = _trailing_argmin(key, ldiff)
    sel = t_idx - off
    mrow = rix.gather(-1, sel)
    mres = res.gather(-1, sel)
    mzlo = best & U32_MASK          # xur64 low word of the window minimizer

    # end-of-sequence emission: min over the last min(ldiff, total) valid
    # k-mers, zero-entry padded when total < ldiff (zero wins every compare)
    vcum = torch.cumsum(valid, dim=-1)
    total = vcum[:, -1:]
    fin_mask = valid & (vcum > total - ldiff)
    fkey, fsel = torch.where(fin_mask, key, _I64MAX).min(dim=-1, keepdim=True)
    zero_entry = total < ldiff
    f_row = torch.where(zero_entry, 0, rix.gather(-1, fsel))
    f_res = torch.where(zero_entry, 0, res.gather(-1, fsel))
    f_zlo = torch.where(zero_entry, 0, fkey & U32_MASK)
    last_t = (n_real - k).clamp(0, P - 1)
    f_valid = valid.gather(-1, last_t) & (n_real >= k) & do_final

    # LSH residue filter + unified local row (single-partial build scheme,
    # ref: src/rqseq.cpp:125-139)
    def keep_and_local(rr):
        rmod = rr % m
        if frac:
            return rmod <= r, (rr // m) * (r + 1) + rmod
        return rmod == r, rr // m

    in_tile = t_idx >= t_lo
    emit = valid_w & in_tile
    kp, local = keep_and_local(torch.cat([mrow, f_row], dim=-1))
    kp = kp & torch.cat([emit, f_valid], dim=-1)
    # (row, residual) as one u64, ordered unsigned; a dropped entry is u64
    # max (row = residual = 0xFFFFFFFF, as in the original) and sorts last
    pair = torch.where(
        kp, ordered_u64((local << 32) | torch.cat([mres, f_res], dim=-1)),
        _I64MAX)
    pair = torch.sort(pair, dim=-1).values
    isuniq = pair < _ROW_DROPPED
    isuniq[:, 1:] &= pair[:, 1:] != pair[:, :-1]
    nuniq = isuniq.sum(dim=-1)
    pair = ordered_u64(pair[isuniq])
    rows = (pair >> 32) & U32_MASK
    res_out = pair & U32_MASK

    c1reg = _hll_registers(z & U32_MASK, valid & in_tile)
    c2reg = _hll_registers(torch.cat([mzlo, f_zlo], dim=-1),
                           torch.cat([emit, f_valid], dim=-1))
    return rows, res_out, nuniq, c1reg, c2reg


def winnow_tiles_host(tiles, params: IndexParams, dev):
    """Winnow tiles (contig codes, start, slice_len, t_lo, do_final) as ONE
    batch on `dev`, each row padded to the longest slice. Returns per tile
    (rows u32, res u32, c1reg u8, c2reg u8)."""
    codes = np.full((len(tiles), max(t[2] for t in tiles)), 4, np.uint8)
    for i, (contig, start, slen, _tl, _fin) in enumerate(tiles):
        codes[i, :slen] = contig[start: start + slen]
    rows, res, nuniq, c1reg, c2reg = winnow_device(
        torch.from_numpy(codes).to(dev),
        torch.tensor([t[2] for t in tiles]), params.lsh, params.w, params.r,
        params.frac, t_lo=torch.tensor([t[3] for t in tiles]),
        do_final=torch.tensor([bool(t[4]) for t in tiles]))
    rows = rows.cpu().numpy().astype(np.uint32)
    res = res.cpu().numpy().astype(np.uint32)
    c1reg = c1reg.cpu().numpy().astype(np.uint8)
    c2reg = c2reg.cpu().numpy().astype(np.uint8)
    ends = np.cumsum(nuniq.cpu().numpy())
    return [(rows[e - n: e], res[e - n: e], c1reg[i], c2reg[i])
            for i, (e, n) in enumerate(zip(ends, np.diff(ends, prepend=0)))]


def contig_tiles(codes: np.ndarray, params: IndexParams):
    """Cut one contig into (start, slice_len, t_lo, do_final) tile specs:
    the whole contig as one tile when its power-of-two length fits
    `_CHUNK`, else tiles of `_CHUNK` bases with a (w-k)-position left halo,
    so that each emit position is computed by exactly one tile with its
    full minimizer window in view.

    None means the contig needs the exact host path: the end-of-sequence
    emission needs the last `ldiff` valid k-mers inside the final tile, and
    with a pathological trailing N-run they may not be."""
    k = params.lsh.k
    w = max(params.w, k)
    ldiff = w - k + 1
    n = len(codes)
    if _round_len(n) <= _CHUNK:
        return [(0, n, 0, True)]
    left = w - k                      # halo width in window positions
    span = _CHUNK - left - k + 1      # emit positions per tile
    P_global = n - k + 1
    tiles = list(range(0, P_global, span))
    f_start = max(tiles[-1] - left, 0)
    tail = codes[f_start:]
    bad = (tail >= 4).astype(np.int32)
    cbad = np.concatenate([[0], np.cumsum(bad)])
    tail_valid = (int(((cbad[k:] - cbad[:-k]) == 0).sum())
                  if len(tail) >= k else 0)
    if tail_valid < ldiff:
        return None
    specs = []
    for a in tiles:
        b = min(a + span, P_global)
        start = a - left if a > 0 else 0
        specs.append((start, b + k - 1 - start, a - start, b == P_global))
    return specs


def _dedupe_pairs(rows: np.ndarray, res: np.ndarray):
    key = np.unique(rows.astype(np.uint64) << np.uint64(32) | res)
    return ((key >> np.uint64(32)).astype(np.uint32),
            (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def host_fallback(codes: np.ndarray, params: IndexParams, device):
    """The exact host path for a contig contig_tiles refuses: deduped
    (rows, res) and the two register arrays."""
    rows, res, c1h, c2h = extract_sequence_mers(codes, params, device)
    h1 = HyperLogLog(_HLL_B)
    h1.add_many(c1h)
    h2 = HyperLogLog(_HLL_B)
    h2.add_many(c2h)
    return _dedupe_pairs(rows, res) + (h1.M, h2.M)


def extract_sequence_mers_device(codes: np.ndarray, params: IndexParams,
                                 device="cuda"):
    """Device-winnowed equivalent of minimizer.extract_sequence_mers.

    Returns (rows, res, c1reg, c2reg) with rows/res deduplicated, or None
    for contigs shorter than w. Long contigs are winnowed tile by tile
    (see contig_tiles) and the tile results merged on the host."""
    dev = resolve_device(device)
    if len(codes) < params.w:
        return None
    specs = contig_tiles(codes, params)
    if specs is None:
        return host_fallback(codes, params, dev)
    tiles = [(codes,) + s for s in specs]
    outs = []
    for g0 in range(0, len(tiles), TILE_GROUP):
        outs += winnow_tiles_host(tiles[g0: g0 + TILE_GROUP], params, dev)
    if len(outs) == 1:
        return outs[0]
    c1acc = np.maximum.reduce([o[2] for o in outs])
    c2acc = np.maximum.reduce([o[3] for o in outs])
    # cross-tile dedupe (each tile is internally unique already)
    return _dedupe_pairs(np.concatenate([o[0] for o in outs]),
                         np.concatenate([o[1] for o in outs])) + (c1acc,
                                                                  c2acc)


def extract_genome_mers_device(contigs, params: IndexParams, device="cuda"):
    """Winnow a genome on device; returns (rows, res, rho).

    rho is the summed per-sequence HLL-estimate ratio, identical to the
    reference accumulation (ref: src/rqseq.hpp:79) because the register
    maxima match the sequential implementation exactly."""
    return genome_rho(
        (extract_sequence_mers_device(np.asarray(codes, np.uint8), params,
                                      device) for codes in contigs),
        from_registers=True)
