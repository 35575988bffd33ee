"""ctypes binding for the native FASTA/FASTQ reader (csrc/fastx.c).

Builds the shared library on first use with the system compiler through
csrc/build.cc_library (temporary name renamed into place; the C ABI +
ctypes keeps the binding dependency-free). A missing compiler or a failed
build raises, there is no quiet fallback to the Python reader.

The port's own copy of krepp_tpu/io/native.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, List, Tuple

import numpy as np

from ..csrc.build import BUILD_DIR, CSRC_DIR, cc_library

SRC = os.path.join(CSRC_DIR, "fastx.c")
CC_FLAGS = ("-O3", "-fPIC", "-shared")

_LIBS = {}
_LOCK = threading.Lock()


def get_lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build (at first use), load and bind the reader."""
    with _LOCK:
        lib = _LIBS.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(cc_library(SRC, "fastx", CC_FLAGS, build_dir,
                                          libs=("-lz",)))
            lib.fastx_open.restype = ctypes.c_void_p
            lib.fastx_open.argtypes = [ctypes.c_char_p]
            lib.fastx_close.argtypes = [ctypes.c_void_p]
            lib.fastx_read_chunk.restype = ctypes.c_int64
            lib.fastx_read_chunk.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
            _LIBS[build_dir] = lib
        return lib


class NativeFastxReader:
    """Chunked reader: (names, codes arena, offsets) per chunk."""

    def __init__(self, path: str, max_records: int = 4096,
                 max_bases: int = 8 << 20):
        self.lib = get_lib()
        self.h = self.lib.fastx_open(path.encode())
        if not self.h:
            raise FileNotFoundError(f"Failed to open the file at {path}")
        self.max_records = max_records
        self.max_bases = max_bases
        self._codes = np.empty(max_bases + (1 << 20), np.uint8)
        self._seq_off = np.zeros(max_records + 1, np.int64)
        self._names = ctypes.create_string_buffer(max_records * 256)
        self._name_off = np.zeros(max_records + 1, np.int64)

    def __iter__(self) -> Iterator[Tuple[List[str], np.ndarray, np.ndarray]]:
        lib = self.lib
        try:
            while True:
                self._seq_off[0] = 0
                self._name_off[0] = 0
                n = lib.fastx_read_chunk(
                    self.h, self.max_records, self.max_bases,
                    self._codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    self._seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    self._names,
                    self._name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
                if n < 0:
                    raise ValueError("Unrecognised FASTA/FASTQ format")
                if n == 0:
                    return
                raw = self._names.raw
                names = [
                    raw[self._name_off[i]: self._name_off[i + 1]].decode()
                    for i in range(n)]
                yield (names, self._codes[: self._seq_off[n]].copy(),
                       self._seq_off[: n + 1].copy())
        finally:
            self.close()

    def close(self):
        if self.h:
            self.lib.fastx_close(self.h)
            self.h = None


def read_fastx_native(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (name, codes) records through the native reader."""
    for names, arena, off in NativeFastxReader(path):
        for i, name in enumerate(names):
            yield name, arena[off[i]: off[i + 1]]
