"""k-mer codec in torch: base codes -> LSH rows, residual encodings, bits.

Port of krepp_tpu/core/codec.py. The bit-position convention, the slice-sum
formulation of the hashes and the Hamming distance are the reference's
(see that module's docstring). What differs:

  * the strand hashes use the exact integer slice-sum form
    (lsh_hash_or/rc, residual_or/rc, window_valid) instead of the bf16
    convolution of `strand_hashes_conv`, whose output contract they meet
    on every window without N bases;
  * u32 quantities are int32 bit patterns; sums that must wrap modulo 2^32
    accumulate in int64 and are folded back with `as_i32`;
  * torch has no popcount, so `hdist_lr32` uses a SWAR count of the
    16-bit folded word.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..io.native_batch import ReadCodes, pad_rows
from ..params import LSHParams

# ASCII -> base code table (ref: src/common.cpp:10-14): ACGT/acgt -> 0..3,
# everything else -> 4.
SEQ_NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    SEQ_NT4_TABLE[ord(_c)] = _i
    SEQ_NT4_TABLE[ord(_c.lower())] = _i

_U32 = 1 << 32


def seq_to_codes(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (host side)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return SEQ_NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def pad_codes_batch(code_list, pad_to: int | None = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack variable-length code vectors into [B, Lmax] padded with 4 (=N).

    code_list is a list of arrays or a batch's `ReadCodes` (the query
    batcher's reads), whose rows C fills, one copy a row.
    Returns (codes[B, Lmax] uint8, lengths[B] int32)."""
    batch = isinstance(code_list, ReadCodes)
    lengths = (code_list.lengths if batch else
               np.array([len(c) for c in code_list], dtype=np.int32))
    lmax = int(pad_to if pad_to is not None
               else (lengths.max() if len(lengths) else 1))
    if batch:
        return pad_rows(code_list, lmax), lengths
    out = np.full((len(code_list), lmax), 4, dtype=np.uint8)
    for i, c in enumerate(code_list):
        out[i, : len(c)] = c
    return out, lengths


def pack_codes_host(codes: np.ndarray, lengths: np.ndarray):
    """[B, L] uint8 base codes -> (packed u32 [B, ceil(L/16)], vbits or None).

    vbits (one validity bit per base) is returned only when some read holds
    a non-ACGT code inside its length. Runs the port's native C packer
    (core/native_sort.py, built at first use)."""
    from .native_sort import pack_codes

    return pack_codes(codes, lengths)


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value (any integer; taken mod 2^32) -> the int32
    tensor with the same bit pattern."""
    x = x & (_U32 - 1)
    return torch.where(x >= (1 << 31), x - _U32, x).to(torch.int32)


def unpack_codes(packed: torch.Tensor, lengths: torch.Tensor, L: int,
                 vbits: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of pack_codes_host -> [B, L] int32 codes on packed's device.

    packed/vbits are int32 bit patterns of the u32 words. Positions >=
    lengths (or with vbits == 0) decode to 4 (invalid)."""
    B, W = packed.shape
    dev = packed.device
    shifts = torch.arange(0, 32, 2, dtype=torch.int32, device=dev)
    ex = (packed[:, :, None] >> shifts) & 3
    ex = ex.reshape(B, W * 16)[:, :L]
    pos = torch.arange(L, dtype=torch.int32, device=dev)
    ok = pos[None, :] < lengths[:, None]
    if vbits is not None:
        vsh = torch.arange(32, dtype=torch.int32, device=dev)
        vb = (vbits[:, :, None] >> vsh) & 1
        ok = ok & (vb.reshape(B, -1)[:, :L] == 1)
    return torch.where(ok, ex, 4)


def pack_bits_device(flags: torch.Tensor) -> torch.Tensor:
    """bool [..., S] -> int32 [..., ceil(S/32)] bitmap words (bit j of word
    w = flag[w*32+j]). Words are built in int64: bit 31 would make an int32
    sum negative."""
    S = flags.shape[-1]
    Wp = (S + 31) // 32
    f = torch.zeros(flags.shape[:-1] + (Wp * 32,), dtype=torch.int64,
                    device=flags.device)
    f[..., :S] = flags.to(torch.int64)
    f = f.reshape(flags.shape[:-1] + (Wp, 32))
    sh = torch.arange(32, dtype=torch.int64, device=flags.device)
    return as_i32((f << sh).sum(dim=-1))


def unpack_bits_host(words: np.ndarray, S: int) -> np.ndarray:
    """Inverse of pack_bits_device on the host."""
    w = np.asarray(words).view(np.uint32)
    bits = (w[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(w.shape[:-1] + (-1,))[..., :S].astype(bool)


def set_bits_host(words: np.ndarray, S: int):
    """(row, bit) int64 arrays of every set bit below S of pack_bits_device's
    words [R, Wp], in row-major, bit-minor order: np.nonzero of
    unpack_bits_host(words, S) without building it. Only the nonzero words
    are expanded."""
    w = np.ascontiguousarray(words).view(np.uint32)
    Wp = w.shape[1]
    nz = np.flatnonzero(w)
    # bit j of a little-endian word is bit j % 8 of its byte j // 8
    le = w.reshape(-1)[nz].astype("<u4", copy=False).view(np.uint8)
    on = np.flatnonzero(np.unpackbits(le, bitorder="little"))
    row, bit = np.divmod(nz[on >> 5] * 32 + (on & 31), Wp * 32)
    if S < Wp * 32:
        keep = bit < S
        row, bit = row[keep], bit[keep]
    return row, bit


def window_valid(codes: torch.Tensor, k: int) -> torch.Tensor:
    """valid[..., t] = all of codes[..., t : t+k] are ACGT (code < 4).

    (ref: src/query.cpp:49-57). Output has P = L-k+1 positions."""
    bad = (codes >= 4).to(torch.int32)
    c = torch.cumsum(bad, dim=-1, dtype=torch.int32)
    czero = torch.cat([torch.zeros(c.shape[:-1] + (1,), dtype=torch.int32,
                                   device=c.device), c], dim=-1)
    return (czero[..., k:] - czero[..., :-k]) == 0


def _window_sum(terms, k: int, const: int = 0) -> torch.Tensor:
    """sum_r x_r[..., off_r : off_r + P] * w_r over windows, in int64 (mod
    2^32 on output). terms: list of (int64 tensor [..., L], off, weight)."""
    L = terms[0][0].shape[-1]
    P = L - k + 1
    x0 = terms[0][0]
    acc = torch.full(x0.shape[:-1] + (P,), const, dtype=torch.int64,
                     device=x0.device)
    for x, off, wgt in terms:
        acc += x[..., off: off + P] * wgt
    return as_i32(acc)


def lsh_hash_or(codes: torch.Tensor, lsh: LSHParams) -> torch.Tensor:
    """Forward-strand LSH bucket row per window, int32 [..., P]."""
    c = codes.to(torch.int64)
    return _window_sum([(c, lsh.k - 1 - p, 4 ** r)
                        for r, p in enumerate(lsh.ppos)], lsh.k)


def lsh_hash_rc(codes: torch.Tensor, lsh: LSHParams) -> torch.Tensor:
    """Reverse-complement-strand LSH bucket row per window, int32 [..., P].

    rc base at bit-position p = 3 - codes[t + p]."""
    c = codes.to(torch.int64)
    const = sum(3 * 4 ** r for r in range(lsh.h))
    return _window_sum([(c, p, -(4 ** r)) for r, p in enumerate(lsh.ppos)],
                       lsh.k, const)


def _residual(codes: torch.Tensor, lsh: LSHParams, rc: bool) -> torch.Tensor:
    c = codes.to(torch.int64)
    lo = c & 1
    hi = c >> 1
    if rc:   # rc base value = 3 - b: both bits flip (for b in 0..3)
        lo = lo ^ 1
        hi = hi ^ 1
    terms = []
    for r, n in enumerate(lsh.npos):
        off = n if rc else lsh.k - 1 - n
        terms.append((lo, off, 1 << r))
        terms.append((hi, off, 1 << (16 + r)))
    return _window_sum(terms, lsh.k)


def residual_or(codes: torch.Tensor, lsh: LSHParams) -> torch.Tensor:
    """Forward-strand 32-bit lr residual over npos, int32 bits [..., P]."""
    return _residual(codes, lsh, rc=False)


def residual_rc(codes: torch.Tensor, lsh: LSHParams) -> torch.Tensor:
    """Reverse-complement-strand 32-bit lr residual, int32 bits [..., P]."""
    return _residual(codes, lsh, rc=True)


def strand_hashes(codes: torch.Tensor, lsh: LSHParams):
    """(rix_or, rix_rc, res_or, res_rc, valid), each [..., P].

    The output contract of krepp_tpu's strand_hashes_conv: equal to it on
    every valid window (windows holding an N base are masked by `valid`
    everywhere downstream)."""
    return (lsh_hash_or(codes, lsh), lsh_hash_rc(codes, lsh),
            residual_or(codes, lsh), residual_rc(codes, lsh),
            window_valid(codes, lsh.k))


def bp64(codes: torch.Tensor, k: int) -> torch.Tensor:
    """2-bit packed k-mer encoding per window as ONE int64 (the bit
    pattern of the u64), [..., P].

    bp64 = sum_j base(bit-position j) << 2j (ref: src/common.hpp:225-243);
    bit-position j is offset k-1-j in the window. The reference's
    `bp64_pair` carries it as a (hi, lo) u32 pair; here each half is summed
    mod 2^32 as there and the halves are joined, so a window holding an N
    (code 4, which spills over its two bits) gives the same bits as the
    pair does. Only the index-build path (minimizer hashing) needs it."""
    P = codes.shape[-1] - k + 1
    c = codes.to(torch.int64)
    lo = torch.zeros(c.shape[:-1] + (P,), dtype=torch.int64,
                     device=c.device)
    hi = torch.zeros_like(lo)
    for j in range(k):
        win = c[..., k - 1 - j: k - 1 - j + P]
        if j < 16:
            lo += win << (2 * j)
        else:
            hi += win << (2 * j - 32)
    # (hi & mask) << 32 wraps into the sign bit for k = 32: the bit pattern
    # is the u64's
    return ((hi & (_U32 - 1)) << 32) | (lo & (_U32 - 1))


def popcount16(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 values in [0, 2^16)."""
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def hdist_lr32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between lr residuals (ref: src/common.hpp:169-175).

    int32 bit patterns in; the arithmetic shift's sign fill is masked away
    by the 16-bit fold."""
    z = a ^ b
    return popcount16((z | (z >> 16)) & 0xFFFF)
