"""FASTA/FASTQ streaming reader and query batcher.

The port's own copy of the batcher and the URL inputs of
krepp_tpu/io/fastx.py. kseq semantics (ref: src/kseq.h); gzip handled
transparently; the batcher mirrors QSeq::read_next_batch
(ref: src/rqseq.cpp:180-197). Records come through the port's native C
reader (io/native.py, built at first use; a failed build raises), so the
reference's Python reader is not carried over. A sequence path may be an
http://, https:// or ftp:// URL (ref: src/rqseq.hpp:13-56 fetches them
with libcurl): it is downloaded to a temporary file, which is read as a
local file and removed once the read ends, finished, failed or closed
early.
"""

from __future__ import annotations

import contextlib
import os
import re
import tempfile
from typing import Iterator, List, Tuple

import numpy as np

from ..params import BATCH_BP_LIMIT
from . import native

_URL_RE = re.compile(r"^(?:https?|ftp)://\S+$")


def is_url(path: str) -> bool:
    return bool(_URL_RE.match(path))


def resolve_input(path: str) -> str:
    """Download a URL input to a temporary file (seq_*, .gz kept) and
    return its path, which the caller removes; local paths pass through."""
    if not is_url(path):
        return path
    import urllib.request

    suffix = ".gz" if path.endswith(".gz") else ""
    tmp = tempfile.NamedTemporaryFile(prefix="seq_", suffix=suffix,
                                      delete=False)
    try:
        with urllib.request.urlopen(path, timeout=60) as r:
            while True:
                chunk = r.read(1 << 20)
                if not chunk:
                    break
                tmp.write(chunk)
        tmp.close()
        return tmp.name
    except Exception as e:  # noqa: BLE001
        tmp.close()
        os.unlink(tmp.name)
        raise RuntimeError(
            f"Failed to download {path}: {e} (offline environment?)") from e


def _records(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """The records of `path`; a URL's download is removed once the read
    ends, finished, failed or closed early."""
    local = resolve_input(path)
    try:
        yield from native.read_fastx_native(local)
    finally:
        if local != path:
            os.unlink(local)


def read_genome_codes(path: str) -> Iterator[np.ndarray]:
    """Yield per-contig base-code arrays."""
    with contextlib.closing(_records(path)) as records:
        for _name, codes in records:
            yield codes


class QueryBatcher:
    """Batches query reads by cumulative bp (ref: src/rqseq.cpp:180-197).

    Yields (names, per-read base-code arrays). A URL is downloaded once
    an iteration."""

    def __init__(self, path: str, bp_limit: int = BATCH_BP_LIMIT):
        self.path = path
        self.bp_limit = bp_limit

    def __iter__(self) -> Iterator[Tuple[List[str], List[np.ndarray]]]:
        names: List[str] = []
        seqs: List[np.ndarray] = []
        bpc = 0
        with contextlib.closing(_records(self.path)) as records:
            for name, codes in records:
                names.append(name)
                seqs.append(codes)
                bpc += len(codes)
                if bpc >= self.bp_limit:
                    yield names, seqs
                    names, seqs, bpc = [], [], 0
        if names:
            yield names, seqs
