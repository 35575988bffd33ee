"""The port's own loader of the native genome winnower (csrc/extract.c).

Builds the port's `csrc/extract.c` (a byte-identical copy of the
reference's) with the reference's flags into `krepp_tpu_torch/csrc/_build/`,
under a name keyed on the source hash. The compiler writes to a temporary
name that is renamed into place, so concurrent loaders (xdist workers, build
threads) never open a half-written library. `_declare`, `_self_test` and the
extraction wrappers are copies of krepp_tpu/core/native_extract.py's that
call this library.

There is no quiet fallback: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterable, Tuple

import numpy as np

from ..csrc.build import BUILD_DIR, CSRC_DIR, cc_library
from ..params import IndexParams
from .hll import HLL_B as _HLL_B
from .hll import HyperLogLog

SRC = os.path.join(CSRC_DIR, "extract.c")
CC_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared")
# extract.c rejects window spans past its stack rings (MAX_LDIFF_STACK)
MAX_LDIFF_STACK = 4096

_LIBS = {}
_LOCK = threading.Lock()


def _declare(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.krepp_extract.restype = ctypes.c_int64
    lib.krepp_extract.argtypes = [
        u8p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32,
        i32p, ctypes.c_int32, i32p, ctypes.c_int32,
        u32p, u32p, u8p, u8p]


def _self_test(lib) -> None:
    """Tiny end-to-end call; catches a stale/foreign .so before first use
    (the .so is a build artifact, never shipped: -march=native output can
    SIGILL on a different host, and mtimes do not survive checkout)."""
    codes = np.arange(40, dtype=np.uint8) % 4
    rows = np.empty(64, np.uint32)
    res = np.empty(64, np.uint32)
    c1 = np.zeros(1 << _HLL_B, np.uint8)
    c2 = np.zeros(1 << _HLL_B, np.uint8)
    ppos = np.arange(5, dtype=np.int32)
    npos = np.arange(5, 19, dtype=np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    kept = lib.krepp_extract(
        codes.ctypes.data_as(u8p), len(codes), 19, 25, 1, 0, 0,
        ppos.ctypes.data_as(i32p), len(ppos),
        npos.ctypes.data_as(i32p), len(npos),
        rows.ctypes.data_as(u32p), res.ctypes.data_as(u32p),
        c1.ctypes.data_as(u8p), c2.ctypes.data_as(u8p))
    if not 0 <= kept <= 64:
        raise RuntimeError(f"native extractor self-test returned {kept}")


def get_lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build (at first use), load, bind and self-test the winnower."""
    with _LOCK:
        lib = _LIBS.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(cc_library(SRC, "extract", CC_FLAGS,
                                          build_dir))
            _declare(lib)
            _self_test(lib)
            _LIBS[build_dir] = lib
        return lib


def window_fits(params: IndexParams) -> bool:
    """False when w - k + 1 exceeds the extractor's fixed window rings."""
    return params.w - params.lsh.k + 1 <= MAX_LDIFF_STACK


def extract_sequence_mers_native(codes: np.ndarray, params: IndexParams):
    """One contig -> (rows, res, c1reg, c2reg), or None when len < w (see
    krepp_tpu.core.native_extract.extract_sequence_mers_native)."""
    lib = get_lib()
    lsh = params.lsh
    n = len(codes)
    if n < params.w:
        return None
    codes = np.ascontiguousarray(codes, np.uint8)
    cap = n - lsh.k + 2
    rows = np.empty(cap, np.uint32)
    res = np.empty(cap, np.uint32)
    c1 = np.zeros(1 << _HLL_B, np.uint8)
    c2 = np.zeros(1 << _HLL_B, np.uint8)
    ppos = np.asarray(lsh.ppos, np.int32)
    npos = np.asarray(lsh.npos, np.int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    kept = lib.krepp_extract(
        codes.ctypes.data_as(u8p), n,
        lsh.k, max(params.w, lsh.k),
        lsh.m, params.r, int(params.frac),
        ppos.ctypes.data_as(i32p), len(ppos),
        npos.ctypes.data_as(i32p), len(npos),
        rows.ctypes.data_as(u32p), res.ctypes.data_as(u32p),
        c1.ctypes.data_as(u8p), c2.ctypes.data_as(u8p))
    if kept < 0:
        raise RuntimeError("native extractor failed")
    return rows[:kept].copy(), res[:kept].copy(), c1, c2


def extract_genome_mers_native(contigs: Iterable[np.ndarray],
                               params: IndexParams
                               ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Winnow a genome natively; returns (rows, res, rho), rho the summed
    per-sequence HLL-estimate ratio (ref: src/rqseq.hpp:79)."""
    all_rows, all_res = [], []
    n1 = n2 = 0.0
    for codes in contigs:
        out = extract_sequence_mers_native(np.asarray(codes, np.uint8),
                                           params)
        if out is None:
            continue
        rows, res, c1, c2 = out
        all_rows.append(rows)
        all_res.append(res)
        h1 = HyperLogLog(_HLL_B)
        h1.M = c1
        n1 += h1.estimate()
        h2 = HyperLogLog(_HLL_B)
        h2.M = c2
        n2 += h2.estimate()
    rows = np.concatenate(all_rows) if all_rows else np.empty(0, np.uint32)
    res = np.concatenate(all_res) if all_res else np.empty(0, np.uint32)
    rho = (n2 / n1) if n1 > 0 else 0.0
    return rows, res, rho
