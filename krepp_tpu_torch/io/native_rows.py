"""ctypes binding for dist's row emitter (csrc/dist_rows.c).

`dist_rows` writes a batch's TSV rows with one native call: the read
names and the leaf names go to C as '\\n'-joined UTF-8 blocks, the kept
rows as (read, slot, dist) arrays sorted by read, and the rows come back
as one string. The library is built at first use through
csrc/build.cc_library; a missing compiler raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Tuple

import numpy as np

from ..core import trace
from ..csrc.build import BUILD_DIR, CSRC_DIR, cc_library

SRC = os.path.join(CSRC_DIR, "dist_rows.c")
CC_FLAGS = ("-O3", "-fPIC", "-shared")
# bytes a row may take beyond its two names: two tabs, a newline and the
# longest "%.5f" of a double, with room (dist_rows.c's NUM_MAX + 3)
ROW_EXTRA = 333

_LIBS = {}
_LOCK = threading.Lock()
_P8 = ctypes.POINTER(ctypes.c_uint8)
_P64 = ctypes.POINTER(ctypes.c_int64)
_PF64 = ctypes.POINTER(ctypes.c_double)


def get_lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build (at first use), load and bind the row emitter."""
    with _LOCK:
        lib = _LIBS.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(cc_library(SRC, "dist_rows", CC_FLAGS,
                                          build_dir, libs=("-lm",)))
            lib.dist_rows.restype = ctypes.c_int64
            lib.dist_rows.argtypes = [
                _P8, _P64, ctypes.c_int64, _P8, _P64, ctypes.c_int64, _P8,
                _P64, _P64, _PF64, ctypes.c_int64, _P8, ctypes.c_int64, _P64]
            _LIBS[build_dir] = lib
        return lib


def _block(strs: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """strs as one UTF-8 block, each followed by '\\n', and the int64
    offsets [len(strs) + 1] of their starts."""
    raw = np.frombuffer(("\n".join(strs) + "\n").encode(), np.uint8) \
        if strs else np.zeros(1, np.uint8)
    ends = np.flatnonzero(raw == 10)
    if len(ends) != len(strs):
        raise ValueError("a name holds a newline")
    off = np.zeros(len(strs) + 1, np.int64)
    off[1:] = ends + 1
    return raw, off


def dist_rows(names: List[str], leaf_names: List[str], na: np.ndarray,
              b: np.ndarray, s: np.ndarray, d: np.ndarray) -> Tuple[str, int]:
    """(text, rows) of a batch's dist rows: for each read in order,
    "name\\tNA\\tNaN\\n" where na (bool [B]) is set, then
    "name\\tleaf\\tdist\\n" for each of its kept rows (b, s, d: read, leaf
    slot and distance of each, sorted by read), the distance as "%.5f".
    Counts the call as `dist_emit_calls`."""
    trace.count("dist_emit_calls")
    name_raw, name_off = _block(names)
    leaf_raw, leaf_off = _block(leaf_names)
    na = np.ascontiguousarray(na, np.uint8)
    b = np.ascontiguousarray(b, np.int64)
    s = np.ascontiguousarray(s, np.int64)
    d = np.ascontiguousarray(d, np.float64)
    name_len = np.diff(name_off) - 1
    cap = (int(name_len[b].sum()) + int(np.diff(leaf_off)[s].sum())
           + ROW_EXTRA * len(b) + int(name_len[na.view(bool)].sum())
           + 8 * int(na.sum()))
    buf = np.empty(max(cap, 1), np.uint8)
    rows = np.zeros(1, np.int64)
    n = get_lib().dist_rows(
        name_raw.ctypes.data_as(_P8), name_off.ctypes.data_as(_P64),
        len(names), leaf_raw.ctypes.data_as(_P8),
        leaf_off.ctypes.data_as(_P64), len(leaf_names),
        na.ctypes.data_as(_P8), b.ctypes.data_as(_P64),
        s.ctypes.data_as(_P64), d.ctypes.data_as(_PF64), len(b),
        buf.ctypes.data_as(_P8), cap, rows.ctypes.data_as(_P64))
    if n == -1:
        raise ValueError("dist rows out of read order or out of range")
    if n < 0:
        raise MemoryError("dist rows overran their buffer")
    return str(buf[:n].data, "utf-8"), int(rows[0])
