"""The port's loader of the bulk jplace emitter (csrc/report.c).

Builds the port's `csrc/report.c` (a byte-identical copy of the
reference's) with the reference's flags into
`krepp_tpu_torch/csrc/_build/`, under a name keyed on the source hash. The
compiler writes to a temporary name that is renamed into place, so
concurrent loaders (xdist workers, place drivers) never open a
half-written library. `jplace_emit` is a copy of
krepp_tpu/io/native_report.py's wrapper that calls this library.

There is no quiet fallback: a missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..csrc.build import BUILD_DIR, CSRC_DIR, cc_library

SRC = os.path.join(CSRC_DIR, "report.c")
CC_FLAGS = ("-O3", "-fPIC", "-shared")

_LIBS = {}
_LOCK = threading.Lock()


def get_lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build (at first use), load and bind the emitter."""
    with _LOCK:
        lib = _LIBS.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(cc_library(SRC, "report", CC_FLAGS,
                                          build_dir, libs=("-lm",)))
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.jplace_emit.restype = ctypes.c_int64
            lib.jplace_emit.argtypes = [
                ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                u8p, i64p, u8p, i64p, i64p, i64p,
                i64p, f64p, f64p, i64p, f64p, f64p, f64p, f64p,
                ctypes.c_char_p, i64p]
            _LIBS[build_dir] = lib
        return lib


def jplace_emit(names_list, kind, s_of, starts, ends, s_q, s_d, s_v,
                c_q, c_d, c_v, c_w, blen, multi: bool, has_previous: bool):
    """Render one batch's jplace fragment -> (str, emitted_count).

    kind [B] u8: 0 skip, 1 single placement (row s_of[b] of s_*), 2 the
    candidate rows starts[b]:ends[b] of c_*. Every field must fit the C
    rows' 192 bytes (callers check; see place._native_fits)."""
    lib = get_lib()
    B = len(kind)
    nb = "".join(names_list).encode("ascii", "replace")
    name_off = np.zeros(B + 1, np.int64)
    np.cumsum([len(n) for n in names_list], out=name_off[1:])
    names_a = np.frombuffer(nb, np.uint8) if nb else np.zeros(1, np.uint8)

    def i64(x):
        return np.ascontiguousarray(x, np.int64)

    def f64(x):
        return np.ascontiguousarray(x, np.float64)

    kind = np.ascontiguousarray(kind, np.uint8)
    s_of, starts, ends, s_q, c_q = (i64(s_of), i64(starts), i64(ends),
                                    i64(s_q), i64(c_q))
    s_d, s_v, c_d, c_v, c_w, blen = (f64(s_d), f64(s_v), f64(c_d), f64(c_v),
                                     f64(c_w), f64(blen))
    cap = 192 * (B + len(s_q) + len(c_q)) + int(name_off[-1]) + 64
    buf = ctypes.create_string_buffer(cap)
    emitted = ctypes.c_int64(0)

    def p(a):
        return a.ctypes.data_as(ctypes.POINTER(
            {np.int64: ctypes.c_int64, np.float64: ctypes.c_double,
             np.uint8: ctypes.c_uint8}[a.dtype.type]))

    n = lib.jplace_emit(
        B, int(multi), int(has_previous), p(names_a), p(name_off), p(kind),
        p(s_of), p(starts), p(ends), p(s_q), p(s_d), p(s_v), p(c_q), p(c_d),
        p(c_v), p(c_w), p(blen), buf, ctypes.byref(emitted))
    return buf.raw[:n].decode("ascii"), int(emitted.value)
