"""FASTA/FASTQ streaming reader and query batcher.

The port's own copy of the URL inputs of krepp_tpu/io/fastx.py, and of its
batcher's rule, read a batch at a time. kseq semantics (ref: src/kseq.h);
gzip handled transparently; the batcher mirrors QSeq::read_next_batch
(ref: src/rqseq.cpp:180-197). Queries and genomes come through the port's
native C reader (io/native_batch.py, a batch of records a call; built at
first use, a failed build raises), so the reference's Python reader is
not carried over. A sequence path may be an http://, https:// or ftp://
URL (ref: src/rqseq.hpp:13-56 fetches them with libcurl): it is
downloaded to a temporary file, which is read as a local file and removed
once the read ends, finished, failed or closed early.
"""

from __future__ import annotations

import contextlib
import os
import re
import tempfile
from typing import Iterator, List, Tuple

import numpy as np

from ..params import BATCH_BP_LIMIT
from .native_batch import ReadCodes, _batches, read_batches

# bases a native call reads of a genome: records up to the one that brings
# a call's bases to this many (a longer record is one call's alone)
GENOME_BP_A_CALL = 8 << 20
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


@contextlib.contextmanager
def _local(path: str) -> Iterator[str]:
    """A local path for `path`; a URL's download is removed once the
    block ends, finished, failed or closed early."""
    local = resolve_input(path)
    try:
        yield local
    finally:
        if local != path:
            os.unlink(local)


def read_genome_codes(path: str) -> Iterator[np.ndarray]:
    """Yield per-contig base-code arrays, GENOME_BP_A_CALL bases a native
    call (not counted as `fastx_batch_calls`)."""
    with _local(path) as local, contextlib.closing(
            _batches(local, GENOME_BP_A_CALL, None)) as batches:
        for _names, contigs in batches:
            yield from contigs


class QueryBatcher:
    """Batches query reads by cumulative bp (ref: src/rqseq.cpp:180-197).

    Yields (names, reads) a batch, each from one call of the native batch
    reader (io/native_batch.py): `reads` is a `ReadCodes`, a sequence of
    per-read base-code arrays over one arena that also holds the batch's
    codes, offsets and lengths. A URL is downloaded once an iteration."""

    def __init__(self, path: str, bp_limit: int = BATCH_BP_LIMIT):
        self.path = path
        self.bp_limit = bp_limit

    def __iter__(self) -> Iterator[Tuple[List[str], ReadCodes]]:
        with _local(self.path) as local:
            yield from read_batches(local, self.bp_limit)
