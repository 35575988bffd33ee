"""`seek`: query reads against a single-genome sketch.

Port of krepp_tpu/query/seek.py (ref: src/krepp.cpp:321-345,
src/seek.cpp): the same batching and rows over the torch SeekEngine.
"""

from __future__ import annotations

from typing import Optional, TextIO

from ..reports import fmt5, seek_header

from ..core.codec import pad_codes_batch
from ..index.index import DeviceSketch
from ..io.fastx import QueryBatcher
from .dist import _bucket_len
from .engine import SeekEngine


def run_seek(sketch: DeviceSketch, query_path: str, out: TextIO,
             invocation: str, hdist_th: int = 4, device="cuda",
             stats: Optional[dict] = None) -> int:
    """Run `seek` over query_path, writing `SEQ_ID\\tDIST` rows to `out`;
    returns the number of reads. If `stats` is a dict it receives the
    engine mode ('direct' or 'csr') and the batch count."""
    engine = SeekEngine(sketch, hdist_th, device=device)
    out.write(seek_header(invocation))
    total = batches = 0
    for names, seqs in QueryBatcher(query_path):
        total += len(names)
        batches += 1
        codes, lengths = pad_codes_batch(
            seqs, pad_to=_bucket_len(max(len(s) for s in seqs)))
        has, d = engine.run(codes, lengths)
        out.write("".join(
            f"{name}\t{fmt5(float(d[i]))}\n" if has[i] else f"{name}\tNaN\n"
            for i, name in enumerate(names)))
    if stats is not None:
        stats.update(mode=engine.mode, batches=batches)
    return total
