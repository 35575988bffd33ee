"""`dist`: per-read ML distances to every matching reference.

Port of krepp_tpu/query/dist.py: the same batching, report semantics
(IBatch::report_distances, ref: src/query.cpp:158-196) and bulk row
emission, over the torch engine. Up to three batches are in flight: a
batch's device-to-host copies are issued when it is dispatched, and it is
reported once two more have been dispatched behind it.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from dataclasses import dataclass
from typing import List, Optional, TextIO

import numpy as np

from ..reports import dist_header, fmt5, fmt5_array

from ..core.codec import pad_codes_batch
from ..index.index import DeviceIndex
from ..io.fastx import QueryBatcher
from .engine import QueryEngine

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
    engine = engine_factory(dindex, cfg.hdist_th) if engine_factory else \
        QueryEngine(dindex, cfg.hdist_th, device=device)
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
        names_b, lengths_b, codes_b, dev = pending.popleft()
        before = engine.escalations
        lr = engine.fetch_leaf_stage(dev, lengths_b, codes=codes_b,
                                     out_mode=out_mode)
        escalations.append(engine.escalations - before)
        if need_ratio:
            lr.ratio = engine.compute_ratio_host(lr)
        if len(lr.lengths) != len(names_b):   # drop batch padding reads
            lr = _slice_results(lr, 0, len(names_b))
        _report_batch(lr, names_b, leaf_names, cfg, out, wcount)

    batch_bp = min(cfg.batch_bp, engine.suggested_batch_reads() * 150)
    mult = getattr(engine, "n_data", 1)
    for names, seqs in QueryBatcher(query_path, bp_limit=batch_bp):
        total += len(names)
        codes, lengths = pad_codes_batch(
            seqs, pad_to=_bucket_len(max(len(s) for s in seqs)))
        codes, lengths = _pad_batch(codes, lengths, mult)
        dev = engine.run_leaf_stage_async(codes, lengths, out_mode=out_mode)
        pending.append((names, lengths, codes, dev))
        if len(pending) >= IN_FLIGHT:
            flush_one()
    while pending:
        flush_one()
    if cfg.summarize:
        twcount = wcount.sum()
        for slot in np.flatnonzero(wcount):
            w = wcount[slot]
            out.write(f"{leaf_names[slot]}\t{fmt5(w)}\t{fmt5(w / twcount)}\n")
    if stats is not None:
        stats.update(mode=engine.mode, hflavor=engine.hflavor, W=engine.W,
                     batches=len(escalations), escalations=escalations)
    return total


def _pad_batch(codes: np.ndarray, lengths: np.ndarray, mult: int):
    """Pad the batch (with zero-length reads) to a multiple of an engine's
    data-parallel width; callers slice results back to the real count."""
    B = codes.shape[0]
    if mult <= 1 or B % mult == 0:
        return codes, lengths
    padn = mult - B % mult
    codes = np.concatenate(
        [codes, np.full((padn, codes.shape[1]), 4, codes.dtype)])
    lengths = np.concatenate([lengths, np.zeros(padn, lengths.dtype)])
    return codes, lengths


def _slice_results(lr, lo: int, hi: int):
    """Slice every per-read (leading batch axis) field of a LeafResults."""
    B = len(lr.lengths)
    repl = {}
    for f in dataclasses.fields(lr):
        v = getattr(lr, f.name)
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == B:
            repl[f.name] = v[lo:hi]
    return dataclasses.replace(lr, **repl)


def _report_batch(lr, names: List[str], leaf_names: List[str],
                  cfg: DistConfig, out: TextIO, wcount: np.ndarray):
    """Bulk row emission: one numpy pass + one write per batch, rows in
    (read-major, slot-minor) order (ref: src/query.cpp:158-196)."""
    B, S = lr.present.shape
    dist_max = cfg.dist_max
    no_dmax = math.isnan(dist_max)
    names_a = np.asarray(names, dtype=object)
    if cfg.summarize:
        # (ref: src/query.cpp:160-171): chisq filter always applies
        sel = lr.present & (lr.ratio < cfg.chisq_value)
        if not no_dmax:
            sel &= lr.d < dist_max
        cnt = sel.sum(axis=1)
        w = np.zeros(B)
        np.divide(1.0, cnt, out=w, where=cnt > 0)
        bs, ss = np.nonzero(sel)
        np.add.at(wcount, ss, w[bs])
        return
    leaf_a = np.asarray(leaf_names, dtype=object)
    na = ~lr.present.any(axis=1)
    if not no_dmax:
        na |= lr.closest_d > dist_max
    if cfg.multi:
        sel = lr.present & ~na[:, None]
        if not cfg.no_filter:
            sel &= lr.ratio < cfg.chisq_value
        if not no_dmax:
            sel &= lr.d < dist_max
        bs, ss = np.nonzero(sel)
        rows = (names_a[bs] + "\t" + leaf_a[ss] + "\t"
                + fmt5_array(lr.d[bs, ss]) + "\n")
    else:
        bs = np.flatnonzero(~na)
        ss = lr.closest_slot[bs]
        rows = (names_a[bs] + "\t" + leaf_a[ss] + "\t"
                + fmt5_array(lr.closest_d[bs]) + "\n")
    na_b = np.flatnonzero(na)
    if len(na_b):
        na_rows = names_a[na_b] + "\tNA\tNaN\n"
        order = np.argsort(np.concatenate([bs, na_b]), kind="stable")
        rows = np.concatenate([rows, na_rows])[order]
    out.write("".join(rows.tolist()))
