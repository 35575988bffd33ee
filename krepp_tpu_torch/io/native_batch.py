"""ctypes binding for the batch-at-a-time query reader (csrc/fastx_batch.c).

`read_batches(path, bp_limit)` yields one batch of records a native call:
the batch's base codes in one arena with record offsets (`ReadCodes`) and
its names, decoded and split once from the reader's '\\n'-joined block.
`pad_rows` fills a [B, width] matrix from a `ReadCodes` with one C copy a
row. io/fastx.read_genome_codes reads genomes through the same reader, a
fixed number of bases a call. The library is built at first use through
csrc/build.cc_library; a missing compiler raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
from collections.abc import Sequence
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core import trace
from ..csrc.build import BUILD_DIR, CSRC_DIR, cc_library

SRC = os.path.join(CSRC_DIR, "fastx_batch.c")
CC_FLAGS = ("-O3", "-fPIC", "-shared")

_LIBS = {}
_LOCK = threading.Lock()
_P8 = ctypes.POINTER(ctypes.c_uint8)
_P64 = ctypes.POINTER(ctypes.c_int64)


def get_lib(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build (at first use), load and bind the batch reader."""
    with _LOCK:
        lib = _LIBS.get(build_dir)
        if lib is None:
            lib = ctypes.CDLL(cc_library(SRC, "fastx_batch", CC_FLAGS,
                                          build_dir, libs=("-lz",)))
            lib.fxb_open.restype = ctypes.c_void_p
            lib.fxb_open.argtypes = [ctypes.c_char_p]
            lib.fxb_close.argtypes = [ctypes.c_void_p]
            lib.fxb_next.restype = ctypes.c_int64
            lib.fxb_next.argtypes = [ctypes.c_void_p, ctypes.c_int64, _P64]
            lib.fxb_pad.argtypes = [_P8, _P64, ctypes.c_int64,
                                    ctypes.c_int64, _P8]
            _LIBS[build_dir] = lib
        return lib


class ReadCodes(Sequence):
    """The base codes of a batch's reads: one uint8 arena and int64
    offsets [B + 1]. Indexing gives read i's codes as a view of the arena;
    `lengths` (int32 [B]) holds every read's length."""

    def __init__(self, codes: np.ndarray, offsets: np.ndarray):
        self.codes = codes
        self.offsets = offsets
        self.lengths = np.diff(offsets).astype(np.int32)

    def __len__(self) -> int:
        return len(self.lengths)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = range(len(self))[i]
        return self.codes[self.offsets[i]: self.offsets[i + 1]]


def read_batches(path: str, bp_limit: int
                 ) -> Iterator[Tuple[List[str], ReadCodes]]:
    """Yield (names, ReadCodes) of each batch of `path`: a batch closes
    after the read that brings its bases to at least bp_limit, or at the
    end. Counts each native call as `fastx_batch_calls`."""
    return _batches(path, bp_limit, "fastx_batch_calls")


def _batches(path: str, bp_limit: int, counter: Optional[str]
             ) -> Iterator[Tuple[List[str], ReadCodes]]:
    """read_batches' body; each native call counted as `counter` (None:
    not counted)."""
    lib = get_lib()
    h = lib.fxb_open(path.encode())
    if not h:
        raise FileNotFoundError(f"Failed to open the file at {path}")
    info = np.zeros(6, np.int64)
    try:
        while True:
            n = lib.fxb_next(h, bp_limit, info.ctypes.data_as(_P64))
            if counter:
                trace.count(counter)
            if n == -1:
                raise ValueError("Unrecognised FASTA/FASTQ format")
            if n < 0:
                raise MemoryError(f"reading {path}")
            if n == 0:
                return
            nb, nn, at_end, p_codes, p_off, p_names = (int(x) for x in info)
            codes = np.empty(nb, np.uint8)
            if nb:
                ctypes.memmove(codes.ctypes.data, p_codes, nb)
            offsets = np.empty(n + 1, np.int64)
            ctypes.memmove(offsets.ctypes.data, p_off, 8 * (n + 1))
            names = ctypes.string_at(p_names, nn).decode().split("\n")
            names.pop()
            yield names, ReadCodes(codes, offsets)
            if at_end:
                return
    finally:
        lib.fxb_close(h)


def pad_rows(reads: ReadCodes, width: int) -> np.ndarray:
    """[B, width] uint8: row i holds read i's codes, then 4 (= N)."""
    if len(reads) and int(reads.lengths.max()) > width:
        raise ValueError(f"a read of {int(reads.lengths.max())} bases does "
                         f"not fit a row of {width}")
    out = np.empty((len(reads), width), np.uint8)
    get_lib().fxb_pad(reads.codes.ctypes.data_as(_P8),
                      reads.offsets.ctypes.data_as(_P64), len(reads), width,
                      out.ctypes.data_as(_P8))
    return out
