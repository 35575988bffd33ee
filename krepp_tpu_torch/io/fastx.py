"""FASTA/FASTQ streaming reader and query batcher.

JAX-free copy of krepp_tpu/io/fastx.py (which imports krepp_tpu.core.codec
and with it JAX). kseq semantics (ref: src/kseq.h); gzip handled
transparently; the batcher mirrors QSeq::read_next_batch
(ref: src/rqseq.cpp:180-197). krepp_tpu's native C reader
(krepp_tpu/io/native.py) is used when it builds. Inputs are local paths:
the reference package's URL download is not carried over.
"""

from __future__ import annotations

import gzip
import io
from typing import Iterator, List, Tuple

import numpy as np

from krepp_tpu.io import native
from krepp_tpu.params import BATCH_BP_LIMIT

from ..core.codec import seq_to_codes


def _open_text(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="ascii",
                                errors="replace")
    return io.TextIOWrapper(f, encoding="ascii", errors="replace")


def _rec_name(header_rest: str) -> str:
    parts = header_rest.split()
    return parts[0] if parts else ""


def read_fastx(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) records from FASTA or FASTQ (optionally .gz)."""
    with _open_text(path) as f:
        line = f.readline()
        while line and not line.strip():
            line = f.readline()
        if not line:
            return
        if line.startswith(">"):
            name = _rec_name(line[1:])
            parts: List[str] = []
            for line in f:
                if line.startswith(">"):
                    yield name, "".join(parts)
                    name = _rec_name(line[1:])
                    parts = []
                else:
                    parts.append(line.strip())
            yield name, "".join(parts)
        elif line.startswith("@"):
            # kseq: the sequence spans every line up to '+'; quality lines
            # accumulate until they cover the sequence length
            while True:
                name = _rec_name(line[1:])
                parts = []
                while True:
                    line = f.readline()
                    if not line or line.startswith("+"):
                        break
                    parts.append(line.strip())
                seq = "".join(parts)
                qlen = 0
                while qlen < len(seq):
                    qline = f.readline()
                    if not qline:
                        break
                    qlen += len(qline.strip())
                yield name, seq
                line = f.readline()
                while line and not line.strip():
                    line = f.readline()
                if not line:
                    return
        else:
            raise ValueError(f"Unrecognised FASTA/FASTQ format in {path}")


def _records(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    if native.native_available():
        yield from native.read_fastx_native(path)
        return
    for name, seq in read_fastx(path):
        yield name, seq_to_codes(seq)


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
