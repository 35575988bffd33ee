"""Bit-exact std::mt19937 + libstdc++ uniform_int_distribution.

The reference draws its LSH positions from a thread-local ``std::mt19937``
via ``std::uniform_int_distribution<uint8_t>(0, k-1)``
(ref: src/lshf.cpp:126-147, src/common.cpp:6-8). Reproducing those draws
bit-exactly makes indexes *regenerated* by this framework interchangeable
with reference-built ones for the same ``--seed`` (same ppos/npos, hence
identical bucket keys and residuals), instead of only being cross-loadable
via artifact metadata.

Two pieces are reproduced exactly:

1. ``MT19937`` — the standard Mersenne Twister (as specified by C++11
   [rand.eng.mers]; default seed 5489, reseeded via ``gen.seed(s)`` only
   when the reference CLI sees an explicit ``--seed`` —
   ref: src/krepp.cpp:688-693).
2. ``uniform_int_u32`` — libstdc++'s downscaling for a 32-bit generator,
   which is Lemire's nearly-divisionless algorithm
   (``_S_nd<uint64>`` in bits/uniform_int_dist.h): reject while the low
   32 bits of ``g() * range`` fall below ``(2^32 - range) % range``, then
   return the high 32 bits. This is ABI-stable behaviour of GCC >= 10;
   the krepp release binaries are built with it (bioconda gcc toolchain).

The port's own copy of krepp_tpu/core/stdrand.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

_MASK32 = 0xFFFFFFFF
MT19937_DEFAULT_SEED = 5489


class MT19937:
    """std::mt19937 (C++11 [rand.eng.mers] parameters)."""

    def __init__(self, seed: int = MT19937_DEFAULT_SEED):
        self._state: List[int] = [0] * 624
        self._index = 624
        self.seed(seed)

    def seed(self, s: int) -> None:
        s &= _MASK32
        st = self._state
        st[0] = s
        for i in range(1, 624):
            s = (1812433253 * (s ^ (s >> 30)) + i) & _MASK32
            st[i] = s
        self._index = 624

    def _twist(self) -> None:
        st = self._state
        for i in range(624):
            y = (st[i] & 0x80000000) | (st[(i + 1) % 624] & 0x7FFFFFFF)
            nxt = st[(i + 397) % 624] ^ (y >> 1)
            if y & 1:
                nxt ^= 0x9908B0DF
            st[i] = nxt
        self._index = 0

    def __call__(self) -> int:
        if self._index >= 624:
            self._twist()
        y = self._state[self._index]
        self._index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _MASK32


def uniform_int_u32(gen: MT19937, lo: int, hi: int) -> int:
    """libstdc++ uniform_int_distribution<T>(lo, hi) on a 32-bit generator."""
    urange = hi - lo
    if urange == _MASK32:
        return gen() + lo
    erange = urange + 1
    product = gen() * erange
    low = product & _MASK32
    if low < erange:
        threshold = ((1 << 32) - erange) % erange
        while low < threshold:
            product = gen() * erange
            low = product & _MASK32
    return (product >> 32) + lo


def reference_lsh_positions(k: int, h: int,
                            seed: Optional[int] = None
                            ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Draw (ppos, npos) exactly as LSHF::get_random_positions does.

    ``seed=None`` reproduces the reference's default-constructed generator
    (no ``--seed`` flag); an integer reproduces ``gen.seed(seed)``.
    Rejection of duplicates and the final ascending sort mirror
    ref: src/lshf.cpp:126-147. Returns both tuples ascending (the
    reference's artifact files store ppos descending; writers reverse).
    """
    gen = MT19937(MT19937_DEFAULT_SEED if seed is None else seed)
    ppos: List[int] = []
    while len(ppos) < h:
        n = uniform_int_u32(gen, 0, k - 1)
        if n not in ppos:
            ppos.append(n)
    ppos.sort()
    npos = tuple(i for i in range(k) if i not in set(ppos))
    return tuple(ppos), npos
