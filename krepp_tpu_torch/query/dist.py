"""`dist`: per-read ML distances to every matching reference.

Port of krepp_tpu/query/dist.py: the same batching, report semantics
(IBatch::report_distances, ref: src/query.cpp:158-196) and bulk row
emission (one native call a batch, io/native_rows), over the torch
engine. Up to three batches are in flight: a batch's device-to-host
copies are issued when it is dispatched, and it is reported once two more
have been dispatched behind it.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, TextIO

import numpy as np

from ..reports import dist_header, fmt5

from ..core import trace
from ..core.codec import pad_codes_batch
from ..index.index import DeviceIndex
from ..io.fastx import QueryBatcher
from ..io.native_rows import dist_rows
from .engine import QueryEngine, _pad_batch

IN_FLIGHT = 3


def _bucket_len(n: int) -> int:
    """Pad the batch max length to a few shapes: short reads snap to
    64-multiples, long queries to powers of two."""
    if n <= 512:
        return max(64, ((n + 63) // 64) * 64)
    return 1 << (n - 1).bit_length()


@dataclass
class DistConfig:
    hdist_th: int = 4
    chisq_value: float = 2.706
    dist_max: float = math.nan
    multi: bool = True
    no_filter: bool = True
    summarize: bool = False
    # device batch granularity (output-neutral)
    batch_bp: int = 16384 * 150
    # multi-process output slicing: (rank, nranks) restricts row emission
    # to this process's slice of every batch (every process computes the
    # whole batch; only the emission is divided)
    emit_slice: Optional[tuple] = None


def run_dist(dindex: DeviceIndex, query_path: str, out: TextIO,
             invocation: str, cfg: Optional[DistConfig] = None,
             engine_factory=None, device="cuda",
             stats: Optional[dict] = None) -> int:
    """Run `dist` over query_path, writing the TSV to `out`; returns the
    number of reads. engine_factory(dindex, hdist_th) may supply a built
    engine. If `stats` is a dict it receives the engine mode, its bucket-row
    flavor and mask words (hflavor, W) and the overflow re-runs
    ("escalations") of each batch."""
    cfg = cfg or DistConfig()
    with trace.batch(None), trace.span("entry"):
        engine = engine_factory(dindex, cfg.hdist_th) if engine_factory \
            else QueryEngine(dindex, cfg.hdist_th, device=device)
        out.write(dist_header(invocation, cfg.summarize))
        leaf_names = [dindex.ftree.names[se] for se in dindex.leaf_ses]
    total = 0
    wcount = np.zeros(len(leaf_names))
    escalations: List[int] = []
    pending = deque()
    # the chi-square ratio is only consulted by summarize / --filter modes;
    # it is recomputed host-side from the closest-candidate summary
    need_ratio = cfg.summarize or not cfg.no_filter
    out_mode = "dist_ratio" if need_ratio else "dist"

    def flush_one():
        names_b, lengths_b, codes_b, dev, bid = pending.popleft()
        with trace.batch(bid):
            before = engine.escalations
            lr = engine.fetch_leaf_stage(dev, lengths_b, codes=codes_b,
                                         out_mode=out_mode)
            escalations.append(engine.escalations - before)
            if need_ratio:
                lr.lanes.ratio = engine.compute_ratio_host(lr)
            if len(lr.lengths) != len(names_b):   # drop batch padding reads
                lr = lr.select(0, len(names_b))
            if cfg.emit_slice:
                rank, nranks = cfg.emit_slice
                B = len(names_b)
                lo, hi = rank * B // nranks, (rank + 1) * B // nranks
                lr = lr.select(lo, hi)
                names_b = names_b[lo:hi]
            _report_batch(lr, names_b, leaf_names, cfg, out, wcount)

    batch_bp = min(cfg.batch_bp, engine.suggested_batch_reads() * 150)
    mult = getattr(engine, "n_data", 1)
    batches = iter(QueryBatcher(query_path, bp_limit=batch_bp))
    while True:
        with trace.span("prep"):
            batch = next(batches, None)
            if batch is None:
                break
            names, seqs = batch
            total += len(names)
            codes, lengths = pad_codes_batch(
                seqs, pad_to=_bucket_len(int(seqs.lengths.max())))
            note_batch(lengths, dindex.lsh.k)
            codes, lengths = _pad_batch(codes, lengths, mult)
        dev = engine.run_leaf_stage_async(codes, lengths, out_mode=out_mode)
        pending.append((names, lengths, codes, dev, trace.current_batch()))
        if len(pending) >= IN_FLIGHT:
            flush_one()
    while pending:
        flush_one()
    if cfg.summarize:
        with trace.batch(None), trace.span("report"):
            twcount = wcount.sum()
            rows = np.flatnonzero(wcount)
            for slot in rows:
                w = wcount[slot]
                out.write(f"{leaf_names[slot]}\t{fmt5(w)}\t"
                          f"{fmt5(w / twcount)}\n")
            trace.count("rows", len(rows))
    if stats is not None:
        stats.update(mode=engine.mode, hflavor=engine.hflavor, W=engine.W,
                     batches=len(escalations), escalations=escalations)
    return total


def note_batch(lengths: np.ndarray, k: int) -> None:
    """With tracing on: number a new batch of reads of `lengths` (before
    batch padding) and count it, its reads and their k-mer positions."""
    if trace.enabled():
        trace.new_batch()
        trace.count("batches")
        trace.count("reads", len(lengths))
        trace.count("kmer_positions",
                    int(np.maximum(lengths.astype(np.int64) - k + 1,
                                   0).sum()))


def _report_batch(lr, names: List[str], leaf_names: List[str],
                  cfg: DistConfig, out: TextIO, wcount: np.ndarray):
    """Bulk row emission: one native call over the batch's kept rows + one
    write per batch, rows in (read-major, slot-minor) order (ref:
    src/query.cpp:158-196)."""
    with trace.span("report"):
        trace.count("rows", _report_rows(lr, names, leaf_names, cfg, out,
                                         wcount))


def _report_rows(lr, names: List[str], leaf_names: List[str],
                 cfg: DistConfig, out: TextIO, wcount: np.ndarray) -> int:
    """_report_batch's body over the batch's lanes; returns the rows
    written."""
    B = len(names)
    lanes = lr.lanes
    lb, ls, ld = lanes.b, lanes.s, lanes.d
    dist_max = cfg.dist_max
    no_dmax = math.isnan(dist_max)
    if cfg.summarize:
        # (ref: src/query.cpp:160-171): chisq filter always applies
        sel = lanes.ratio < cfg.chisq_value
        if not no_dmax:
            sel &= ld < dist_max
        bs, ss = lb[sel], ls[sel]
        cnt = np.bincount(bs, minlength=B)
        w = np.zeros(B)
        np.divide(1.0, cnt, out=w, where=cnt > 0)
        np.add.at(wcount, ss, w[bs])
        return 0
    na = np.bincount(lb, minlength=B) == 0
    if not no_dmax:
        na |= lr.closest_d > dist_max
    if cfg.multi:
        sel = ~na[lb]
        if not cfg.no_filter:
            sel &= lanes.ratio < cfg.chisq_value
        if not no_dmax:
            sel &= ld < dist_max
        bs, ss, ds = lb[sel], ls[sel], ld[sel]
    else:
        bs = np.flatnonzero(~na)
        ss, ds = lr.closest_slot[bs], lr.closest_d[bs]
    text, rows = dist_rows(names, leaf_names, na, bs, ss, ds)
    out.write(text)
    return rows
