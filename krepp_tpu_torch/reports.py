"""Output formatting: dist TSV, jplace v3, tabular/summarize reports.

Byte-compatible with the reference writers (ref: src/krepp.cpp:305-319,
396-432; fixed 5-decimal precision per src/common.hpp:48). The software
name/version strings mirror the reference so downstream jplace consumers and
diff-based parity checks see identical framing.

The port's own copy of krepp_tpu/reports.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

import math

import numpy as np

from . import REFERENCE_VERSION


def fmt5(x: float) -> str:
    """%.5f fixed formatting, as stream precision(5) + std::fixed."""
    if math.isnan(x):
        return "nan"
    return f"{x:.5f}"


def fmt5_array(x: np.ndarray) -> np.ndarray:
    """Vectorized fmt5: f64 array -> object array of '%.5f' strings.

    One C-level sprintf per element instead of a Python f-string — the bulk
    row emitters build whole report batches from these."""
    out = np.char.mod("%.5f", np.asarray(x, np.float64)).astype(object)
    nan = np.isnan(x)
    if nan.any():
        out[nan] = "nan"
    return out


def dist_header(invocation: str, summarize: bool) -> str:
    """(ref: src/krepp.cpp:311-319)."""
    s = f"# software: krepp\tversion: {REFERENCE_VERSION}\tinvocation :" + invocation
    if summarize:
        s += "\nREFERENCE_NAME\tWEIGHTED_COUNT\tSEQUENCE_ABUNDANCE\n"
    else:
        s += "\nSEQ_ID\tREFERENCE_NAME\tDIST\n"
    return s


def seek_header(invocation: str) -> str:
    """(ref: src/krepp.cpp:305-309)."""
    return (f"# software: krepp\tversion: {REFERENCE_VERSION}\tinvocation :"
            + invocation + "\nSEQ_ID\tDIST\n")


def place_header(invocation: str, tree_jplace_nwk: str, summarize: bool,
                 tabular: bool) -> str:
    """(ref: src/krepp.cpp:396-408)."""
    s = f"# software: krepp\tversion: {REFERENCE_VERSION}\tinvocation :" + invocation
    s += "\n# " + tree_jplace_nwk
    if summarize:
        s += "\nDISTAL_NODE\tEDGE_NUM\tWEIGHTED_COUNT\tSEQUENCE_ABUNDANCE\n"
    elif tabular:
        s += "\nSEQ_ID\tDISTAL_NODE\tEDGE_NUM\tLWR\tDIST\n"
    return s


def begin_jplace() -> str:
    """(ref: src/krepp.cpp:426-432)."""
    return (
        '{\n\t"version" : 3,\n\t'
        '"fields" : ["edge_num", "pendant_length", "distal_length", '
        '"likelihood", "like_weight_ratio", "distance"],\n\t"placements" : [\n')


def end_jplace(invocation: str, num_queries: int, tree_jplace_nwk: str) -> str:
    """(ref: src/krepp.cpp:410-424)."""
    return (
        "],\n"
        '\t"metadata" : {\n'
        '\t\t"software" : "krepp",\n'
        f'\t\t"version" : "{REFERENCE_VERSION}",\n'
        '\t\t"repository" : "https://github.com/bo1929/krepp",\n'
        f'\t\t"num_queries" : "{num_queries}",\n'
        '\t\t"invocation" : "' + invocation + '"\n\t},\n'
        '\t"tree" : "' + tree_jplace_nwk + '"\n}')


def jplace_fields(en: int, pendant: float, distal: float, likelihood: float,
                  lwr: float, dist: float) -> str:
    """PP_JPLACE_FIELDS (ref: src/query.hpp:202-204)."""
    return (f"[{en}, {fmt5(pendant)}, {fmt5(distal)}, {fmt5(likelihood)}, "
            f"{fmt5(lwr)}, {fmt5(dist)}]")


def jukes_cantor(d: float) -> float:
    """(ref: src/query.hpp:197)."""
    return -0.75 * math.log(1.0 - (4.0 / 3.0) * d)
