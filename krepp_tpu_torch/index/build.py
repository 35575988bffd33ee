"""Index build: genome winnowing -> sorted merge -> colors -> frozen CSR;
and the single-genome sketch build.

JAX-free copy of krepp_tpu/index/build.py (its module imports the device
winnower and the sdust extractor, which import JAX). Winnowing goes only
through the repo's native C winnower, loaded by the port's
core/native_extract.py; the device winnower and sdust-masked extraction
raise until ROADMAP slice 6 ports them. The merge, dedupe and coloring
are the reference's numpy and C code, so a build here is field-for-field
the JAX package's build.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io.fastx import read_genome_codes
from ..params import IndexParams
from ..tree.flat import FlatTree
from ..tree.newick import Tree
from .colors import ColorBuilder, ColorTable

# above this local-row-space size the dense cumulative-offset array is not
# materialised at build; per-entry rows are kept instead
SPARSE_INC_THRESHOLD = 1 << 24


@dataclass
class BuiltIndex:
    """A frozen single-partial index (the build output); see
    krepp_tpu.index.build.BuiltIndex."""

    params: IndexParams
    tree: Optional[Tree]
    names: List[str]
    enc_v: np.ndarray
    se_v: np.ndarray
    inc: Optional[np.ndarray]
    colors: ColorTable
    ftree: FlatTree
    rows_local: Optional[np.ndarray] = None

    @property
    def nkmers(self) -> int:
        return len(self.enc_v)


@dataclass
class BuiltSketch:
    """Color-less single-target sketch (ref: src/table.hpp:8-21, sketch
    cmd); see krepp_tpu.index.build.BuiltSketch."""

    params: IndexParams
    enc_v: np.ndarray
    inc: np.ndarray
    rho: float

    @property
    def nkmers(self) -> int:
        return len(self.enc_v)


def _extract_genome(contigs, params: IndexParams):
    """Winnow one genome with the native C winnower (built by the port's
    own loader; a failed build raises)."""
    from ..core import native_extract

    if params.sdust_t > 0 and params.sdust_w > 0:
        raise NotImplementedError(
            "sdust-masked extraction is not ported to krepp_tpu_torch yet "
            "(ROADMAP Queue 1, slice 6)")
    if not native_extract.window_fits(params):
        raise NotImplementedError(
            "w - k + 1 exceeds the native C winnower's window and device "
            "winnowing is not ported yet (ROADMAP Queue 1, slice 6)")
    return native_extract.extract_genome_mers_native(contigs, params)


def _dedupe_genome(rows: np.ndarray, res: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-genome (row, residual) dedupe (ref: src/table.cpp:157-166)."""
    key = rows.astype(np.uint64) << np.uint64(32) | res.astype(np.uint64)
    key = np.unique(key)
    return ((key >> np.uint64(32)).astype(np.uint32),
            (key & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def build_index(input_map: Sequence[Tuple[str, str]], params: IndexParams,
                tree: Optional[Tree] = None, progress: bool = True,
                num_threads: int = 1) -> BuiltIndex:
    """Build a single-partial index from {name -> genome path}."""
    names = [n for n, _ in input_map]
    path_of = dict(input_map)
    contig_source = {n: (lambda p=path_of[n]: read_genome_codes(p))
                     for n in names if n in path_of}
    return build_index_from_sources(names, contig_source, params, tree,
                                    progress, num_threads=num_threads)


def _prepare_tree(names: List[str], tree: Optional[Tree]):
    if tree is None:
        print("No tree has given as a guide, the color index could be "
              "suboptimal.", file=sys.stderr)
        tree = Tree.generate(names)
    ftree = FlatTree.from_tree(tree)
    leaf_se = {ftree.names[se]: se for se in range(1, ftree.nnodes + 1)
               if ftree.is_leaf[se]}
    return tree, ftree, leaf_se


def build_index_from_sources(names: List[str], contig_source,
                             params: IndexParams, tree: Optional[Tree] = None,
                             progress: bool = True,
                             num_threads: int = 1) -> BuiltIndex:
    """Core build: contig_source[name]() yields per-contig code arrays.

    num_threads > 1 winnows genomes on a host thread pool (the native
    winnower releases the GIL); results are consumed in input order, so the
    index is independent of the schedule."""
    from ..core.native_sort import sort_unique_pairs

    tree, ftree, leaf_se = _prepare_tree(names, tree)

    def extract_dedup(n):
        rows, res, g_rho = _extract_genome(list(contig_source[n]()), params)
        rows, res = sort_unique_pairs(rows, res, inplace=True)
        return rows, res, g_rho

    fetched = {}
    pool = None
    if num_threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(num_threads)
        fetched = {n: pool.submit(extract_dedup, n)
                   for n in names
                   if n in contig_source and leaf_se.get(n) is not None}

    def extracted():
        count = 0
        for name in names:
            count += 1
            if leaf_se.get(name) is None:
                continue
            if name not in contig_source:
                if progress:
                    print(f"Genome skipped: {name}", file=sys.stderr)
                continue
            if name in fetched:
                rows, res, g_rho = fetched[name].result()
            else:
                rows, res, g_rho = extract_dedup(name)
            if progress:
                print(f"Leaf node: {name}\tsize: {len(rows)}\t"
                      f"progress: {count}/{ftree.nnodes}", file=sys.stderr)
            yield name, rows, res, g_rho

    try:
        return build_index_from_extracted(names, extracted(), params, tree,
                                          ftree, leaf_se, deduped=True)
    finally:
        if pool is not None:
            pool.shutdown()


def build_index_from_extracted(names: List[str], extracted,
                               params: IndexParams, tree: Tree,
                               ftree: Optional[FlatTree] = None,
                               leaf_se=None, deduped: bool = False
                               ) -> BuiltIndex:
    """Merge + color pre-winnowed genomes.

    extracted yields (name, rows, res, rho) per genome; deduped=True
    promises per-genome-unique tuples."""
    from ..core.native_sort import sort_unique_pairs

    if ftree is None:
        tree, ftree, leaf_se = _prepare_tree(names, tree)
    all_rows: List[np.ndarray] = []
    all_res: List[np.ndarray] = []
    all_leaf: List[np.ndarray] = []
    rho = np.zeros(ftree.nnodes + 1)
    for name, rows, res, g_rho in extracted:
        se = leaf_se.get(name)
        if se is None:
            continue
        if not deduped:
            rows, res = sort_unique_pairs(rows, res)
        rho[se] = g_rho
        all_rows.append(rows)
        all_res.append(res)
        all_leaf.append(np.full(len(rows), se, np.int32))

    rows = np.concatenate(all_rows) if all_rows else np.empty(0, np.uint32)
    res = np.concatenate(all_res) if all_res else np.empty(0, np.uint32)
    leaf = np.concatenate(all_leaf) if all_leaf else np.empty(0, np.int32)
    if len(rows) == 0:
        raise ValueError("No k-mers to index!")

    enc_v, se_v, inc, rows_local, colors = _merge_and_color(
        rows, res, leaf, params, ftree, rho)
    return BuiltIndex(params=params, tree=tree, names=names, enc_v=enc_v,
                      se_v=se_v, inc=inc, colors=colors, ftree=ftree,
                      rows_local=rows_local)


def _mask_leafset(mask: np.ndarray, W: int) -> tuple:
    """uint64[W] bitmask -> ascending tuple of set leaf ids."""
    ls = []
    for wd in range(W):
        mw = int(mask[wd])
        while mw:
            b = mw & -mw
            ls.append(wd * 64 + b.bit_length() - 1)
            mw ^= b
    return tuple(ls)


def _merge_and_color(rows: np.ndarray, res: np.ndarray, leaf: np.ndarray,
                     params: IndexParams, ftree: FlatTree, rho: np.ndarray):
    """Global sorted merge (the union tree collapsed to one sort) + colors.

    One stable radix sort by (row, residual) key makes every k-mer's group
    contiguous; groups reduce to leaf-set bitmasks whose color ids are
    assigned in lexicographic mask order."""
    from ..core import native_colorize
    from ..core.native_sort import pack_keys, sort_kv

    key = pack_keys(rows, res)
    key, leaf_u = sort_kv(key, leaf.astype(np.uint32))
    leaf = leaf_u.astype(np.int32)
    new_group = np.empty(len(key), bool)
    new_group[0] = True
    np.not_equal(key[1:], key[:-1], out=new_group[1:])
    starts = np.flatnonzero(new_group)
    uniq = key[starts]
    starts_full = np.empty(len(starts) + 1, np.int64)
    starts_full[:-1] = starts
    starts_full[-1] = len(key)
    sizes = np.diff(starts_full)

    cbuild = ColorBuilder(ftree)
    se_v = np.empty(len(uniq), np.int32)
    W = (ftree.nnodes + 1 + 63) // 64
    native = native_colorize.color_groups(starts_full, leaf, W)
    if native is not None:
        se_out, umask = native
        uniform = se_out >= 0
        se_v[uniform] = se_out[uniform]
        if int((~uniform).sum()):
            order = np.lexsort(umask.T[::-1])
            ucolor = np.empty(len(umask), np.int32)
            for i in order:
                ucolor[i] = cbuild.color_of(_mask_leafset(umask[i], W))
            se_v[~uniform] = ucolor[-se_out[~uniform] - 1]
    else:
        gmin = np.minimum.reduceat(leaf, starts)
        gmax = np.maximum.reduceat(leaf, starts)
        uniform = gmin == gmax
        se_v[uniform] = gmin[uniform]
        multi = np.flatnonzero(~uniform)
        if len(multi):
            sel = np.repeat(~uniform, sizes)
            gid = np.repeat(np.arange(len(multi), dtype=np.int64),
                            sizes[multi])
            lm = leaf[sel].astype(np.int64)
            flat = np.zeros(len(multi) * W, np.uint64)
            np.bitwise_or.at(
                flat, gid * W + (lm >> 6),
                np.uint64(1) << (lm & 63).astype(np.uint64))
            gmask = flat.reshape(len(multi), W)
            umask, inv = np.unique(gmask, axis=0, return_inverse=True)
            ucolor = np.empty(len(umask), np.int32)
            for i, mask in enumerate(umask):
                ucolor[i] = cbuild.color_of(_mask_leafset(mask, W))
            se_v[multi] = ucolor[inv.reshape(-1)]

    g_rows = (uniq >> np.uint64(32)).astype(np.int64)
    enc_v = (uniq & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    nrows = params.nrows_local
    colors = cbuild.finalize(rho)
    if nrows > SPARSE_INC_THRESHOLD:
        return enc_v, se_v, None, g_rows, colors
    counts = np.bincount(g_rows, minlength=nrows)
    inc = np.cumsum(counts).astype(np.int64)
    return enc_v, se_v, inc, None, colors


def build_sketch(path: str, params: IndexParams,
                 progress: bool = True) -> BuiltSketch:
    """Single-genome sketch (ref: src/krepp.cpp:110-119): the genome's
    distinct (row, residual) pairs as a CSR over local rows."""
    from ..core.native_sort import sort_k

    rows, res, rho = _extract_genome(read_genome_codes(path), params)
    key = sort_k(rows.astype(np.uint64) << np.uint64(32)
                 | res.astype(np.uint64))
    if len(key):
        keep = np.empty(len(key), bool)
        keep[0] = True
        np.not_equal(key[1:], key[:-1], out=keep[1:])
        key = key[keep]
    g_rows = (key >> np.uint64(32)).astype(np.int64)
    enc_v = (key & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    counts = np.bincount(g_rows, minlength=params.nrows_local)
    inc = np.cumsum(counts).astype(np.int64)
    if progress:
        print(f"Total number of k-mers included in the sketch: {len(enc_v)}",
              file=sys.stderr)
        print(f"Subsampling rate (rho) is: {rho}", file=sys.stderr)
    return BuiltSketch(params=params, enc_v=enc_v, inc=inc, rho=rho)
