"""HyperLogLog cardinality estimator (host side, numpy-vectorized).

Faithful reimplementation of the estimator the reference vendors
(ref: src/hyperloglog.hpp:53-188, used with b=12 in src/rqseq.cpp:63-64) —
the subsampling rate rho = |distinct minimizers| / |distinct k-mers| feeds
the likelihood model, so the estimator semantics must match.

Note the reference passes 64-bit xur64 hashes to HyperLogLog::add(uint32_t)
(ref: src/rqseq.cpp:92,110,117), truncating to the LOW 32 bits; callers here
must do the same (pass the lo word).

The port's own copy of krepp_tpu/core/hll.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

import numpy as np

HLL_B = 12      # register bits of the winnower's estimators (csrc/extract.c)


class HyperLogLog:
    def __init__(self, b: int = 12):
        if b < 4 or b > 30:
            raise ValueError("bit width must be in the range [4,30]")
        self.b = b
        self.m = 1 << b
        self.M = np.zeros(self.m, dtype=np.uint8)
        if self.m == 16:
            alpha = 0.673
        elif self.m == 32:
            alpha = 0.697
        elif self.m == 64:
            alpha = 0.709
        else:
            alpha = 0.7213 / (1.0 + 1.079 / self.m)
        self.alphaMM = alpha * self.m * self.m

    def add_many(self, hashes: np.ndarray) -> None:
        """Add an array of uint32 hashes.

        rank = min(32-b, clz(hash << b)) + 1 (ref: src/hyperloglog.hpp:21,
        98-105). clz(0) is treated as 32 (LZCNT semantics).
        """
        h = np.asarray(hashes, dtype=np.uint32)
        if h.size == 0:
            return
        idx = (h >> np.uint32(32 - self.b)).astype(np.int64)
        v = (h << np.uint32(self.b)).astype(np.uint32)
        # count leading zeros of v (32 for v == 0)
        bl = np.zeros(v.shape, dtype=np.int64)
        nz = v > 0
        bl[nz] = np.floor(np.log2(v[nz].astype(np.float64))).astype(np.int64) + 1
        clz = 32 - bl
        rank = (np.minimum(32 - self.b, clz) + 1).astype(np.uint8)
        np.maximum.at(self.M, idx, rank)

    def estimate(self) -> float:
        """Raw estimate with linear-counting / large-range corrections
        (ref: src/hyperloglog.hpp:112-134)."""
        s = float(np.sum(1.0 / (1 << self.M.astype(np.int64))))
        est = self.alphaMM / s
        if est <= 2.5 * self.m:
            zeros = int(np.sum(self.M == 0))
            if zeros != 0:
                est = self.m * np.log(self.m / zeros)
        elif est > (1.0 / 30.0) * 4294967296.0:
            est = -4294967296.0 * np.log(1.0 - est / 4294967296.0)
        return est

    def merge(self, other: "HyperLogLog") -> None:
        if self.m != other.m:
            raise ValueError("number of registers doesn't match")
        np.maximum(self.M, other.M, out=self.M)
