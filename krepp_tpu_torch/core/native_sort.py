"""ctypes binding for the native parallel radix sort (csrc/sortkv.c).

The global sort-and-group index union (build.py) is the TPU-native
replacement for the reference's locked union tree
(ref: src/krepp.cpp:248-303); at tens of millions of tuples numpy's
single-threaded comparison sort dominates the build, so the key/payload
sort runs through this OpenMP LSD radix. Inputs under 65,536 elements take
numpy's sort (the same result). The library is built at first use by
csrc/build.cc_library (temporary name renamed into place); a missing
compiler or a failed build raises, there is no quiet fallback.

The port's own copy of krepp_tpu/core/native_sort.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Tuple

import numpy as np

from ..csrc.build import BUILD_DIR, CSRC_DIR, cc_library

SRC = os.path.join(CSRC_DIR, "sortkv.c")
CC_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared")

_LIBS = {}
_LOCK = threading.Lock()


def _self_test(lib) -> None:
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**63, 1000).astype(np.uint64)
    v = np.arange(1000, dtype=np.uint32)
    ks = np.sort(k)
    vs = v[np.argsort(k, kind="stable")]
    rc = lib.krepp_sort_kv(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(1000))
    if rc != 0 or not (np.array_equal(k, ks) and np.array_equal(v, vs)):
        raise RuntimeError("native sort self-test failed")


def get_lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build (at first use), load, bind and self-test the radix sort."""
    with _LOCK:
        lib = _LIBS.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(cc_library(SRC, "sortkv", CC_FLAGS, build_dir))
            lib.krepp_sort_kv.restype = ctypes.c_int64
            lib.krepp_sort_kv.argtypes = [
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
            lib.krepp_sort_k.restype = ctypes.c_int64
            lib.krepp_sort_k.argtypes = [
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
            lib.krepp_pack_keys.restype = None
            lib.krepp_pack_keys.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
            lib.krepp_sort_unique_pairs.restype = ctypes.c_int64
            lib.krepp_sort_unique_pairs.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64]
            lib.krepp_pack_codes.restype = ctypes.c_int64
            lib.krepp_pack_codes.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32)]
            _self_test(lib)
            _LIBS[build_dir] = lib
        return lib


def sort_kv(keys: np.ndarray, vals: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Stable ascending sort of (u64 keys, u32 payload). Returns sorted
    copies (native in-place on copies, or the numpy fallback)."""
    assert keys.dtype == np.uint64 and len(keys) == len(vals)
    if len(keys) < (1 << 16):
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order]
    lib = get_lib()
    k = np.ascontiguousarray(keys, np.uint64).copy()
    v = np.ascontiguousarray(vals, np.uint32).copy()
    rc = lib.krepp_sort_kv(
        k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(k)))
    if rc != 0:
        order = np.argsort(keys, kind="stable")
        return keys[order], vals[order]
    return k, v


def pack_codes(codes: np.ndarray, lengths: np.ndarray):
    """Native 2-bit read packing; returns (packed, vbits | None)."""
    lib = get_lib()
    B, L = codes.shape
    W = (L + 15) // 16
    WV = (L + 31) // 32
    codes_c = np.ascontiguousarray(codes, np.uint8)
    lengths_c = np.ascontiguousarray(lengths, np.int32)
    packed = np.empty((B, W), np.uint32)
    vbits = np.empty((B, WV), np.uint32)
    n_inv = lib.krepp_pack_codes(
        codes_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(B), ctypes.c_int64(L),
        lengths_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vbits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return packed, (vbits if n_inv else None)


def pack_keys(rows: np.ndarray, res: np.ndarray) -> np.ndarray:
    """(row, residual) u32 pairs -> u64 keys row<<32|res."""
    if len(rows) < (1 << 16):
        return rows.astype(np.uint64) << np.uint64(32) | res.astype(np.uint64)
    lib = get_lib()
    rows = np.ascontiguousarray(rows, np.uint32)
    res = np.ascontiguousarray(res, np.uint32)
    out = np.empty(len(rows), np.uint64)
    lib.krepp_pack_keys(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        res.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(len(rows)))
    return out


def sort_unique_pairs(rows: np.ndarray, res: np.ndarray,
                      inplace: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted dedupe of (row, residual) pairs (per-genome dedupe,
    ref: src/table.cpp:157-166). Returns unique pairs in key order.

    inplace=True permutes the caller's arrays (callers owning freshly
    extracted buffers skip one copy per genome)."""
    lib = get_lib()
    r = np.ascontiguousarray(rows, np.uint32)
    s = np.ascontiguousarray(res, np.uint32)
    if not inplace:
        r = r.copy() if r is rows else r
        s = s.copy() if s is res else s
    m = lib.krepp_sort_unique_pairs(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(r)))
    if m < 0:
        key = np.unique(rows.astype(np.uint64) << np.uint64(32)
                        | res.astype(np.uint64))
        return ((key >> np.uint64(32)).astype(np.uint32),
                (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return r[:m], s[:m]


def sort_k(keys: np.ndarray) -> np.ndarray:
    """Ascending sort of u64 keys."""
    assert keys.dtype == np.uint64
    if len(keys) < (1 << 16):
        return np.sort(keys, kind="stable")
    lib = get_lib()
    k = np.ascontiguousarray(keys, np.uint64).copy()
    if lib.krepp_sort_k(
            k.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.c_int64(len(k))) != 0:
        return np.sort(keys, kind="stable")
    return k
