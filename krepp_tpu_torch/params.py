"""Configuration dataclasses: LSH function and index/sketch parameters.

Mirrors the reference's CLI defaults and validation rules
(ref: src/krepp.hpp:29-98, src/lshf.cpp:126-147) but keeps everything as
plain, hashable dataclasses so they can be closed over by jitted functions.

The port's own copy of krepp_tpu/params.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class LSHParams:
    """The locality-sensitive hash function.

    ``h`` of the ``k`` bit-positions (position j = the base j places from the
    *right-hand* end of the k-mer; the reference packs base at sequence offset
    p of the k-mer into bit-position k-1-p, ref: src/common.hpp:225-243) form
    the bucket key; the remaining ``k - h`` positions form the stored 32-bit
    "lr" residual encoding (ref: src/lshf.cpp:61-71).

    ``ppos``: hash positions, ascending. ``npos``: residual positions,
    ascending. The reference stores ppos descending in its artifacts
    (ref: src/lshf.cpp:146); loaders must normalise.
    """

    k: int
    h: int
    m: int
    ppos: Tuple[int, ...]  # ascending
    npos: Tuple[int, ...]  # ascending

    def __post_init__(self):
        if len(self.ppos) != self.h or len(self.npos) != self.k - self.h:
            raise ValueError("ppos/npos lengths inconsistent with k, h")
        if tuple(sorted(self.ppos)) != self.ppos or tuple(sorted(self.npos)) != self.npos:
            raise ValueError("ppos/npos must be sorted ascending")
        if set(self.ppos) | set(self.npos) != set(range(self.k)):
            raise ValueError("ppos and npos must partition 0..k-1")

    @property
    def nrows_global(self) -> int:
        """Global LSH table size 2^(2h) (ref: src/index.cpp:82)."""
        return 1 << (2 * self.h)

    @staticmethod
    def generate(k: int, h: int, m: int, seed: int | None = 0) -> "LSHParams":
        """Draw h distinct positions out of k, bit-exactly as the reference.

        Reproduces std::mt19937 + libstdc++ uniform_int_distribution draws
        (ref: src/lshf.cpp:126-147) via core.stdrand, so an index regenerated
        here with the same ``--seed`` has the same ppos/npos (hence identical
        bucket keys/residuals) as one built by the reference binary.
        ``seed=None`` matches the reference with no ``--seed`` flag
        (default-constructed generator, ref: src/common.cpp:7).
        """
        from .core.stdrand import reference_lsh_positions

        ppos, npos = reference_lsh_positions(k, h, seed)
        return LSHParams(k=k, h=h, m=m, ppos=ppos, npos=npos)


def validate_lsh_config(k: int, h: int, w: int) -> None:
    """Reference validation rules (ref: src/krepp.hpp:59-85)."""
    if w < k:
        raise ValueError("The minimum minimizer window size (-w) is k (-k).")
    if h < 3:
        raise ValueError("The minimum number of LSH positions (-h) is 3.")
    if h > 15:
        raise ValueError("The maximum number of LSH positions (-h) is 15.")
    if k > 31:
        raise ValueError("The maximum allowed k-mer length (-k) is 31.")
    if k < 19:
        raise ValueError("The minimum allowed k-mer length (-k) is 19.")
    if (k - h) > 16:
        raise ValueError("For compact k-mer encodings, h must be >= k-16.")


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Build-time parameters of an index or sketch.

    Defaults follow the reference (`index`: k=29,w=k+6,h=13,m=4,r=1,frac —
    ref: src/krepp.hpp:47-58; `sketch`: k=26,h=10 — ref: src/krepp.hpp:35-46).
    """

    lsh: LSHParams
    w: int
    r: int
    frac: bool
    sdust_t: int = 0
    sdust_w: int = 0

    @property
    def k(self) -> int:
        return self.lsh.k

    @property
    def h(self) -> int:
        return self.lsh.h

    @property
    def m(self) -> int:
        return self.lsh.m

    @property
    def nrows_local(self) -> int:
        """Number of rows a partial index with this (m, r, frac) stores.

        Mirrors BaseLSH::set_nrows (ref: src/krepp.cpp:5-16).
        """
        hash_size = self.lsh.nrows_global
        full_residue = hash_size % self.m
        if self.frac:
            nrows = (hash_size // self.m) * (self.r + 1)
            nrows += (self.r + 1) if full_residue > self.r else full_residue
        else:
            nrows = hash_size // self.m
            if full_residue > self.r:
                nrows += 1
        return nrows

    @property
    def suffix(self) -> str:
        """Artifact filename suffix (ref: src/krepp.cpp:587-590)."""
        return f"-m{self.m}r{self.r}" + ("-frac" if self.frac else "-no_frac")

    @staticmethod
    def index_defaults(k: int = 29, w: int | None = None, h: int | None = None,
                       m: int = 4, r: int = 1, frac: bool = True,
                       seed: int = 0, sdust_t: int = 0, sdust_w: int = 0) -> "IndexParams":
        w = k + 6 if w is None else w
        h = k - 16 if h is None else h
        validate_lsh_config(k, h, w)
        return IndexParams(lsh=LSHParams.generate(k, h, m, seed), w=w, r=r,
                           frac=frac, sdust_t=sdust_t, sdust_w=sdust_w)

    @staticmethod
    def sketch_defaults(k: int = 26, w: int | None = None, h: int | None = None,
                        m: int = 4, r: int = 1, frac: bool = True,
                        seed: int = 0, sdust_t: int = 0, sdust_w: int = 0) -> "IndexParams":
        return IndexParams.index_defaults(k=k, w=w, h=h, m=m, r=r, frac=frac,
                                          seed=seed, sdust_t=sdust_t, sdust_w=sdust_w)


# Query batching granularity (ref: src/rqseq.hpp:10-11): a batch closes when
# cumulative bp >= RBATCH_SIZE * DSEQ_LEN.
RBATCH_SIZE = 512
DSEQ_LEN = 150
BATCH_BP_LIMIT = RBATCH_SIZE * DSEQ_LEN
