"""`inspect`: index statistics report (ref: src/index.cpp:172-186,
src/table.cpp:262-270, src/record.cpp:257-302).

JAX-free copy of krepp_tpu/inspect.py, which imports krepp_tpu.index.index
and through it JAX; the text is the same for the same index."""

from __future__ import annotations

from collections import Counter
from typing import TextIO

import numpy as np

from .index.index import DeviceIndex


def display_info(di: DeviceIndex, out: TextIO) -> None:
    """Per-partial metadata block + color histograms, as the reference's
    display (ref: src/index.cpp:172-186): the metadata .txt content
    verbatim for reference-format partials, the save_info-format block
    (ref: src/krepp.cpp:187-204) for native ones. Histogram rows
    are emitted in sorted key order (the reference iterates an unordered
    hash map there, so its row order is unspecified)."""
    if di.wbackbone and di.tree is not None:
        out.write(f"Backbone tree: {di.tree.newick()}\n")
    else:
        out.write("Backbone tree: NA\n")
    res_info = getattr(di, "res_info", None) or {}
    for r in np.flatnonzero(di.resident):
        out.write(f"======= Partial index: {r} =======\n")
        info = res_info.get(int(r)) or di.info
        if info:
            out.write(info)
        else:
            p = di.lsh
            out.write(f"k: {p.k}\nh: {p.h}\nm: {p.m}\n")
            out.write(f"nrows: {p.nrows_global}\n")
            out.write(f"total_num_kmers: {di.nkmers}\n")
        _display_colors(di, int(r), out)


def _display_colors(di: DeviceIndex, r: int, out: TextIO) -> None:
    colors = di.colors
    nse = colors.nse
    out.write(f"{r}\tNUM_COLORS\t{nse - 1}\n")
    se_count = np.bincount(di.se_v, minlength=nse)
    count_hist = Counter(int(c) for c in se_count[1:])
    se_pse = getattr(di, "se_pse", None)
    if se_pse is not None and len(se_pse) == nse:
        # reference-format index: out-degree over the binary decomposition
        # graph, exactly as CRecord::display_info counts it
        # (ref: src/record.cpp:259-264)
        outdeg = np.bincount(
            np.concatenate([se_pse[1:, 0], se_pse[1:, 1]]).astype(np.int64),
            minlength=nse)[:nse]
    else:
        # native index: colors decompose flat to leaves, so the out-degree
        # counts each composite color's (ids nnodes+1..nse-1) leaf
        # references
        comp = colors.leaf_list[colors.leaf_off[colors.nnodes + 1]:
                                colors.leaf_off[nse]]
        outdeg = np.bincount(comp, minlength=nse)[:nse]
    outdeg_hist = Counter(int(c) for c in outdeg[1:])
    for key in sorted(count_hist):
        out.write(f"{r}\tMER_COUNT\t{key}\t{count_hist[key]}\n")
    for key in sorted(outdeg_hist):
        out.write(f"{r}\tOUTDEGREE_COUNT\t{key}\t{outdeg_hist[key]}\n")
