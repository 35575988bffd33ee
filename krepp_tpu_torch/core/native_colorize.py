"""ctypes binding for the native group colorizer (csrc/colorize.c).

One C pass over the sorted (key, leaf) tuples assigns uniform groups their
leaf id and interns every multi-leaf group's leaf-set bitmask through a
hash table (the deterministic replacement for the reference's additive
subset hashing, ref: src/record.cpp:82-107). The library is built at first
use by csrc/build.cc_library (temporary name renamed into place); a missing
compiler or a failed build raises, there is no quiet fallback. A pass the
library itself refuses returns None, and index/build.py then takes its
numpy formulation.

The port's own copy of krepp_tpu/core/native_colorize.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from ..csrc.build import BUILD_DIR, CSRC_DIR, cc_library

SRC = os.path.join(CSRC_DIR, "colorize.c")
CC_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared")

_LIBS = {}
_LOCK = threading.Lock()


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _self_test(lib) -> None:
    starts = np.array([0, 1, 3, 6], np.int64)
    leaf = np.array([5, 2, 2, 1, 3, 1], np.int32)
    se = np.empty(3, np.int32)
    n = lib.krepp_color_groups(_i64p(starts), 3, _i32p(leaf), 1, _i32p(se))
    masks = np.empty((max(n, 1), 1), np.uint64)
    got = lib.krepp_fetch_masks(_u64p(masks))
    ok = (n == 1 and got == 1 and se[0] == 5 and se[1] == 2
          and se[2] == -1 and masks[0, 0] == (1 << 1) | (1 << 3))
    if not ok:
        raise RuntimeError("native colorize self-test failed")


def get_lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build (at first use), load, bind and self-test the colorizer."""
    with _LOCK:
        lib = _LIBS.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(cc_library(SRC, "colorize", CC_FLAGS,
                                          build_dir))
            lib.krepp_color_groups.restype = ctypes.c_int64
            lib.krepp_color_groups.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32)]
            lib.krepp_fetch_masks.restype = ctypes.c_int64
            lib.krepp_fetch_masks.argtypes = [
                ctypes.POINTER(ctypes.c_uint64)]
            _self_test(lib)
            _LIBS[build_dir] = lib
        return lib


def color_groups(starts: np.ndarray, leaf: np.ndarray, W: int
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """starts int64[ng+1], leaf int32[n] -> (se_out int32[ng],
    umask uint64[n_unique, W] in first-encounter order), or None.

    se_out >= 0 is a leaf id (uniform group); negative values -(uid+1)
    index umask rows."""
    lib = get_lib()
    ng = len(starts) - 1
    starts = np.ascontiguousarray(starts, np.int64)
    leaf = np.ascontiguousarray(leaf, np.int32)
    se_out = np.empty(ng, np.int32)
    n = lib.krepp_color_groups(_i64p(starts), ctypes.c_int64(ng),
                               _i32p(leaf), ctypes.c_int32(W),
                               _i32p(se_out))
    if n < 0:
        return None
    umask = np.empty((max(n, 1), W), np.uint64)
    got = lib.krepp_fetch_masks(_u64p(umask))
    if got != n:
        return None
    return se_out, umask[:n]
