"""FASTA/FASTQ streaming reader and query batcher.

JAX-free copy of the batcher of krepp_tpu/io/fastx.py. kseq semantics
(ref: src/kseq.h); gzip handled transparently; the batcher mirrors
QSeq::read_next_batch (ref: src/rqseq.cpp:180-197). Records come through
the port's native C reader (io/native.py, built at first use; a failed
build raises), so the reference's Python reader is not carried over, nor
is its URL download: inputs are local paths.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from ..params import BATCH_BP_LIMIT
from . import native


def _records(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    yield from native.read_fastx_native(path)


def read_genome_codes(path: str) -> Iterator[np.ndarray]:
    """Yield per-contig base-code arrays."""
    for _name, codes in _records(path):
        yield codes


class QueryBatcher:
    """Batches query reads by cumulative bp (ref: src/rqseq.cpp:180-197).

    Yields (names, per-read base-code arrays)."""

    def __init__(self, path: str, bp_limit: int = BATCH_BP_LIMIT):
        self.path = path
        self.bp_limit = bp_limit

    def __iter__(self) -> Iterator[Tuple[List[str], List[np.ndarray]]]:
        names: List[str] = []
        seqs: List[np.ndarray] = []
        bpc = 0
        for name, codes in _records(self.path):
            names.append(name)
            seqs.append(codes)
            bpc += len(codes)
            if bpc >= self.bp_limit:
                yield names, seqs
                names, seqs, bpc = [], [], 0
        if names:
            yield names, seqs
