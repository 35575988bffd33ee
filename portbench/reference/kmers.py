"""K-mer side of the plain reference: encodings, LSH rows, residuals,
winnowing and the HyperLogLog subsampling rate, in plain torch integer ops.

Semantics are krepp's (RSeq::extract_mers, src/rqseq.cpp:51-144, and
IBatch::search_mers, src/query.cpp:40-94), as the pure-Python oracle of
the repository's tests spells them out for one k-mer at a time; here every
position of many sequences at once. Sequences hold base codes 0..3 only
(the benchmark generates no N), so a k-mer starts at every position.

u64 values live in int64 tensors as their bit patterns: products wrap mod
2^64 and `>>` fills with the sign, so every right shift is masked.
"""

from __future__ import annotations

import torch

I64 = torch.int64
_C1 = 0xFF51AFD7ED558CCD - (1 << 64)
_C2 = 0xC4CEB9FE1A85EC53 - (1 << 64)
_SIGN = -(1 << 63)


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def xur64(h: torch.Tensor) -> torch.Tensor:
    """The murmur3 finaliser of src/common.hpp:147-155."""
    h = h ^ _shr(h, 33)
    h = h * _C1
    h = h ^ _shr(h, 33)
    h = h * _C2
    return h ^ _shr(h, 33)


def kmer_bp(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[..., L] base codes -> [..., L-k+1] 2-bit packed k-mers, the first
    base in the highest slot (src/common.hpp:225-235)."""
    c = codes.to(I64)
    n = c.shape[-1] - k + 1
    x = torch.zeros(c.shape[:-1] + (n,), dtype=I64, device=c.device)
    for j in range(k):
        x |= c[..., j: j + n] << (2 * (k - 1 - j))
    return x


def bp_to_lr(x: torch.Tensor, k: int) -> torch.Tensor:
    """2-bit packed k-mer -> its "lr" form: the low bit of each base in the
    low half, the high bit in the high half (src/common.hpp:223)."""
    lr = torch.zeros_like(x)
    for j in range(k):
        b = _shr(x, 2 * j) & 3
        lr |= ((b & 1) << j) | ((b >> 1) << (32 + j))
    return lr


def revcomp_bp(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of a 2-bit packed k-mer (src/common.hpp:177-186)."""
    out = torch.zeros_like(x)
    for j in range(k):
        out |= (3 - (_shr(x, 2 * j) & 3)) << (2 * (k - 1 - j))
    return out


def lsh_row(x: torch.Tensor, ppos) -> torch.Tensor:
    """The h bases at the hash positions, packed in ascending order: pext of
    the bp form with a 2-bit mask at each position (src/lshf.cpp)."""
    out = torch.zeros_like(x)
    for i, p in enumerate(ppos):
        out |= (_shr(x, 2 * p) & 3) << (2 * i)
    return out


def residual(lr: torch.Tensor, npos, k: int) -> torch.Tensor:
    """The stored 32-bit residual: pext of the lr form with the npos bits
    of both halves and 16-(k-h) filler bits above k in the low half
    (src/lshf.cpp:39-45). The filler bits of a masked k-mer are zero, so
    the low half gives len(npos) bits, then zeros, then the high half."""
    low = torch.zeros_like(lr)
    high = torch.zeros_like(lr)
    for i, p in enumerate(npos):
        low |= (_shr(lr, p) & 1) << i
        high |= (_shr(lr, 32 + p) & 1) << i
    return low | (high << 16)


def hdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bases that differ between two residuals (src/common.hpp:169-173)."""
    z = a ^ b
    z = (z | _shr(z, 16)) & 0xFFFF
    n = torch.zeros_like(z)
    for i in range(16):
        n += (z >> i) & 1
    return n


def resident_local(rix: torch.Tensor, m: int, r: int, frac: bool):
    """(resident, local row) of global LSH rows under (m, r, frac)."""
    rr = rix % m
    if frac:
        return rr <= r, (rix // m) * (r + 1) + rr
    return rr == r, rix // m


def winnow(codes: torch.Tensor, k: int, w: int, ppos, npos, m: int, r: int,
           frac: bool):
    """Minimizers of [G, L] genomes (one contig each, L >= w).

    Returns (genome [n], local row [n], residual [n], c1 [G, nk], c2 [G, nw])
    over every emitted window whose minimizer's row is resident (with
    repeats: a minimizer spans windows), and the low 32 bits of every
    k-mer's hash (c1) and of every window minimum (c2) for the HLL."""
    ldiff = w - k + 1 if w > k else 1
    x = kmer_bp(codes, k)                           # [G, nk]
    z = xur64(x)
    key = z ^ _SIGN                                 # signed order = u64 order
    nk = x.shape[1]
    nw = nk - ldiff + 1
    win = torch.stack([key[:, j: j + nw] for j in range(ldiff)])
    arg = win.argmin(dim=0) + torch.arange(nw, device=x.device)
    sel = torch.gather(x, 1, arg)                   # [G, nw] window minima
    c1 = z & 0xFFFFFFFF
    c2 = torch.gather(z, 1, arg) & 0xFFFFFFFF
    rix = lsh_row(sel, ppos)
    res_ok, local = resident_local(rix, m, r, frac)
    g = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(sel)
    keep = res_ok
    selk = sel[keep]
    res = residual(bp_to_lr(selk, k), npos, k)
    return g[keep], local[keep], res, c1, c2


def read_probes(codes: torch.Tensor, k: int, ppos, npos):
    """Every k-mer of [n, L] reads on both strands (src/query.cpp:40-94):
    (pos, rix, res) each [2, n, L-k+1], strand 0 the read as given (pos the
    k-mer's start), strand 1 its reverse complement (pos counted from the
    read's end, as the reference's rc position)."""
    x = kmer_bp(codes, k)
    L = codes.shape[-1]
    nk = x.shape[-1]
    t = torch.arange(nk, device=x.device).expand_as(x)
    xr = revcomp_bp(x, k)
    pos = torch.stack([t, L - (t + k)])
    rix = torch.stack([lsh_row(x, ppos), lsh_row(xr, ppos)])
    res = torch.stack([residual(bp_to_lr(x, k), npos, k),
                       residual(bp_to_lr(xr, k), npos, k)])
    return pos, rix, res


HLL_B = 12


def hll_estimate(h32: torch.Tensor) -> torch.Tensor:
    """HyperLogLog (b = 12) estimates of the distinct values in each row of
    [G, n] u32 hashes (src/hyperloglog.hpp:53-188), f64 [G]."""
    b = HLL_B
    m = 1 << b
    G = h32.shape[0]
    idx = _shr(h32, 32 - b) & (m - 1)
    v = (h32 << b) & 0xFFFFFFFF
    _, e = torch.frexp(v.to(torch.float64))          # bit length of v
    clz = torch.where(v == 0, 32, 32 - e.to(I64))
    rank = torch.clamp(clz, max=32 - b) + 1
    regs = torch.zeros((G, m), dtype=I64, device=h32.device)
    regs.scatter_reduce_(1, idx, rank, reduce="amax")
    alpha_mm = 0.7213 / (1.0 + 1.079 / m) * m * m
    s = torch.exp2(-regs.to(torch.float64)).sum(dim=1)
    est = alpha_mm / s
    zeros = (regs == 0).sum(dim=1).to(torch.float64)
    small = (est <= 2.5 * m) & (zeros > 0)
    est = torch.where(small, m * torch.log(m / zeros.clamp(min=1)), est)
    big = est > (1.0 / 30.0) * 4294967296.0
    est = torch.where(big, -4294967296.0 * torch.log(1.0 - est / 4294967296.0),
                      est)
    return est
