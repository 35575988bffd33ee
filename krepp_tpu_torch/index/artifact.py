"""Index and sketch persistence: save and load.

JAX-free copy of krepp_tpu/index/artifact.py; files written by either
package load in the other. Two formats: the native one (a directory of npz
arrays + JSON metadata, one partial or several suffixed ones that combine
at load) and the reference's binary one (ref: src/krepp.cpp:18-29,206-246,
src/table.cpp:23-41,65-83, src/record.cpp:203-219, src/sketch.cpp:3-23),
single- or multi-partial.
"""

from __future__ import annotations

import json
import os
import struct
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import REFERENCE_VERSION
from ..params import IndexParams, LSHParams
from ..tree.flat import FlatTree
from ..tree.newick import Tree
from .colors import ColorTable, colors_from_pse

from .build import BuiltIndex, BuiltSketch
from .index import (DeviceIndex, DeviceSketch, _local_row_to_global,
                    _local_rows_to_global)

FORMAT_VERSION = 1


def save_native(built: BuiltIndex, index_dir: str, seed: int = 0,
                partial: bool = False) -> None:
    """Write the native artifact. partial=True writes suffixed files
    (meta-m{m}r{r}-{frac}.json + arrays-*.npz) so independently built
    residue partials can share one directory and combine at load — the
    native equivalent of the reference's partial workflow
    (ref: src/krepp.cpp:66-108)."""
    os.makedirs(index_dir, exist_ok=True)
    p = built.params
    sfx = p.suffix if partial else ""
    meta = {
        "format_version": FORMAT_VERSION,
        "software": "krepp-tpu",
        "reference_version": REFERENCE_VERSION,
        "k": p.k, "w": p.w, "h": p.h, "m": p.m, "r": p.r, "frac": p.frac,
        "sdust_t": p.sdust_t, "sdust_w": p.sdust_w,
        "ppos": list(p.lsh.ppos), "npos": list(p.lsh.npos),
        "nrows": p.nrows_local, "nkmers": built.nkmers,
        "nnodes": built.colors.nnodes, "nse": built.colors.nse,
        "seed": seed,
        "names": built.names,
        "wbackbone": built.tree is not None,
    }
    with open(os.path.join(index_dir, f"meta{sfx}.json"), "w") as f:
        json.dump(meta, f, indent=1)
    # uncompressed: the arrays are nearly incompressible hashes; np.load
    # reads both
    row_arrays = ({"inc": built.inc} if built.inc is not None
                  else {"rows_local": built.rows_local})
    np.savez(
        os.path.join(index_dir, f"arrays{sfx}.npz"),
        enc_v=built.enc_v, se_v=built.se_v,
        leaf_off=built.colors.leaf_off, leaf_list=built.colors.leaf_list,
        rho=built.colors.rho, **row_arrays)
    if built.tree is not None:
        with open(os.path.join(index_dir, "tree.nwk"), "w") as f:
            f.write(built.tree.nwk_str or built.tree.newick())
    with open(os.path.join(index_dir, "reflist.txt"), "w") as f:
        f.write("\n".join(built.names) + "\n")


def _load_native_partial(index_dir: str, sfx: str = ""):
    with open(os.path.join(index_dir, f"meta{sfx}.json")) as f:
        meta = json.load(f)
    lsh = LSHParams(k=meta["k"], h=meta["h"], m=meta["m"],
                    ppos=tuple(meta["ppos"]), npos=tuple(meta["npos"]))
    params = IndexParams(lsh=lsh, w=meta["w"], r=meta["r"], frac=meta["frac"],
                         sdust_t=meta["sdust_t"], sdust_w=meta["sdust_w"])
    z = np.load(os.path.join(index_dir, f"arrays{sfx}.npz"))
    colors = ColorTable(nnodes=meta["nnodes"], nse=meta["nse"],
                        leaf_off=z["leaf_off"], leaf_list=z["leaf_list"],
                        rho=z["rho"])
    return meta, params, z, colors


def _native_tree(index_dir: str, meta: dict) -> Optional[Tree]:
    tpath = os.path.join(index_dir, "tree.nwk")
    if meta.get("wbackbone") and os.path.exists(tpath):
        with open(tpath) as f:
            nwk = f.read()
        tree = Tree.parse(nwk)
        tree.nwk_str = nwk
        return tree
    if not meta.get("wbackbone"):
        return Tree.generate(meta["names"])
    return None


def load_native(index_dir: str) -> BuiltIndex:
    """Load a single-partial native artifact as a BuiltIndex."""
    meta, params, z, colors = _load_native_partial(index_dir)
    tree = _native_tree(index_dir, meta)
    return BuiltIndex(params=params, tree=tree, names=meta["names"],
                      enc_v=z["enc_v"], se_v=z["se_v"],
                      inc=z["inc"] if "inc" in z else None,
                      rows_local=(z["rows_local"] if "rows_local" in z
                                  else None),
                      colors=colors, ftree=FlatTree.from_tree(tree))


def _scan_native_partials(index_dir: str) -> List[str]:
    return sorted(fn[len("meta"): -len(".json")]
                  for fn in os.listdir(index_dir)
                  if fn.startswith("meta-") and fn.endswith(".json"))


def load_native_device(index_dir: str) -> DeviceIndex:
    """Load a native index directory: one meta.json partial, or several
    suffixed partials combined exactly like the reference's multi-partial
    workflow (ref: src/krepp.cpp:66-108, src/index.cpp:144-158)."""
    sfxs = _scan_native_partials(index_dir)
    if not sfxs:
        built = load_native(index_dir)
        with open(os.path.join(index_dir, "meta.json")) as f:
            meta = json.load(f)
        di = DeviceIndex.from_built(built)
        di.wbackbone = bool(meta.get("wbackbone"))
        di.res_info = {int(r): _native_info(meta, built.params)
                       for r in _partial_residues(built.params)}
        return di
    partials = []
    names: List[str] = []
    wbackbone = False
    tree: Optional[Tree] = None
    res_info: Dict[int, str] = {}
    for sfx in sfxs:
        meta, params, z, colors = _load_native_partial(index_dir, sfx)
        names = meta["names"]
        wbackbone = wbackbone or bool(meta.get("wbackbone"))
        if tree is None:
            tree = _native_tree(index_dir, meta)
        if "inc" in z:
            g_rows = _local_rows_to_global(z["inc"].astype(np.int64), params)
        else:
            g_rows = _local_row_to_global(z["rows_local"].astype(np.int64),
                                          params)
        partials.append((params, g_rows, z["enc_v"],
                         z["se_v"].astype(np.int64), colors))
        for r in _partial_residues(params):
            res_info[int(r)] = _native_info(meta, params)
    di = _merge_partials(partials, tree, names, wbackbone)
    di.wbackbone = wbackbone
    di.res_info = res_info
    return di


def load_index(index_dir: str) -> DeviceIndex:
    """The CLI's loader: the native format preferred, else the reference's
    binary format."""
    if os.path.exists(os.path.join(index_dir, "meta.json")) \
            or _scan_native_partials(index_dir):
        return load_native_device(index_dir)
    return load_index_reference(index_dir)


def _write_config(f, p: IndexParams) -> None:
    """BaseLSH::save_configuration (ref: src/krepp.cpp:18-29); ppos stored
    descending (ref: src/lshf.cpp:146)."""
    f.write(struct.pack("<BBB", p.k, p.w, p.h))
    f.write(struct.pack("<II?", p.m, p.r, p.frac))
    f.write(struct.pack("<I", p.nrows_local))
    f.write(bytes(sorted(p.lsh.ppos, reverse=True)))
    f.write(bytes(p.lsh.npos))


def _read_config(f) -> Tuple[IndexParams, int]:
    k, w, h = struct.unpack("<BBB", f.read(3))
    m, r, frac = struct.unpack("<II?", f.read(9))
    (nrows,) = struct.unpack("<I", f.read(4))
    ppos = tuple(sorted(f.read(h)))
    npos = tuple(sorted(f.read(k - h)))
    lsh = LSHParams(k=k, h=h, m=m, ppos=ppos, npos=npos)
    return IndexParams(lsh=lsh, w=w, r=r, frac=bool(frac)), nrows


def save_sketch_reference(built: BuiltSketch, path: str) -> None:
    """SFlatHT::save + config + rho (ref: src/krepp.cpp:121-129,
    src/table.cpp:35-41)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", built.nkmers))
        built.enc_v.astype("<u4").tofile(f)
        f.write(struct.pack("<I", len(built.inc)))
        built.inc.astype("<u8").tofile(f)
        _write_config(f, built.params)
        f.write(struct.pack("<d", built.rho))


def load_sketch_reference(path: str) -> DeviceSketch:
    """(ref: src/sketch.cpp:3-23)."""
    with open(path, "rb") as f:
        (nkmers,) = struct.unpack("<Q", f.read(8))
        enc = np.fromfile(f, dtype="<u4", count=nkmers)
        (nrows,) = struct.unpack("<I", f.read(4))
        inc = np.fromfile(f, dtype="<u8", count=nrows).astype(np.int64)
        params, _ = _read_config(f)
        (rho,) = struct.unpack("<d", f.read(8))
    return DeviceSketch.from_built(
        BuiltSketch(params=params, enc_v=enc, inc=inc, rho=rho))


def _decompose_colors(built: BuiltIndex) -> np.ndarray:
    """Binary decomposition table se -> (a, b) for the reference crecord.

    Our colors are flat leaf lists; the reference stores subsets as a binary
    DAG over tree nodes (ref: src/record.cpp:156-176). Any decomposition
    that decodes to the same leaf set is valid for the reference reader; we
    split each composite set at the LCA's child subtrees and fold left.
    Returns pse[next_id, 2] (may allocate ids beyond built.colors.nse).
    """
    ftree = built.ftree
    colors = built.colors
    nnodes = colors.nnodes
    parent = ftree.parent
    children = ftree.children_lists()

    # leafsets as Python int bitmasks (bit = leaf se): set algebra becomes
    # O(nnodes/64) bignum word ops, so the export scales to large indexes
    def to_mask(leaves) -> int:
        m = 0
        for l in leaves:
            m |= 1 << int(l)
        return m

    clades = ftree.clade_leafsets()
    clade_mask: List[int] = [0] * (nnodes + 1)
    for se in range(1, nnodes + 1):
        clade_mask[se] = to_mask(clades[se])
    set_to_id: Dict[int, int] = {clade_mask[se]: se
                                 for se in range(1, nnodes + 1)}
    comp_masks: Dict[int, int] = {}
    for se in range(nnodes + 1, colors.nse):
        m = to_mask(colors.leaves_of(se))
        set_to_id[m] = se
        comp_masks[se] = m

    pse: List[Tuple[int, int]] = [(0, 0)] * colors.nse
    filled = [True] * (nnodes + 1) + [False] * (colors.nse - nnodes - 1)

    def lca_of(mask: int) -> int:
        x = (mask & -mask).bit_length() - 1     # lowest set leaf
        while x:
            if mask & ~clade_mask[x] == 0:
                return x
            x = int(parent[x])
        raise ValueError("leafset not under the tree root")

    def get_id(mask: int) -> int:
        if mask & (mask - 1) == 0:              # singleton -> leaf id
            return mask.bit_length() - 1
        sid = set_to_id.get(mask)
        if sid is None:
            sid = len(pse)
            set_to_id[mask] = sid
            pse.append((0, 0))
            filled.append(True)
            fill(sid, mask)
        elif not filled[sid]:
            filled[sid] = True
            fill(sid, mask)
        return sid

    def fill(sid: int, mask: int) -> None:
        node = lca_of(mask)
        groups = [mask & clade_mask[ch] for ch in children[node]]
        groups = [g for g in groups if g]
        assert len(groups) >= 2, (sid, node)
        acc_id = get_id(groups[0])
        acc_mask = groups[0]
        for g in groups[1:-1]:
            nid = get_id(g)
            acc_mask |= g
            prev = set_to_id.get(acc_mask)
            if prev is None:
                prev = len(pse)
                set_to_id[acc_mask] = prev
                pse.append((acc_id, nid))
                filled.append(True)
            acc_id = prev
        pse[sid] = (acc_id, get_id(groups[-1]))

    for se in range(nnodes + 1, colors.nse):
        if not filled[se]:
            filled[se] = True
            fill(se, comp_masks[se])
    return np.array(pse, dtype=np.uint32)


def save_index_reference(built: BuiltIndex, index_dir: str, seed: int = 0,
                         invocation: str = "") -> None:
    """Write the six reference per-partial files (ref: src/krepp.cpp:206-246)."""
    os.makedirs(index_dir, exist_ok=True)
    p = built.params
    sfx = p.suffix
    with open(os.path.join(index_dir, "cmer" + sfx), "wb") as f:
        f.write(struct.pack("<Q", built.nkmers))
        pairs = np.empty((built.nkmers, 2), dtype="<u4")
        pairs[:, 0] = built.enc_v
        pairs[:, 1] = built.se_v.astype(np.uint32)
        pairs.tofile(f)
    with open(os.path.join(index_dir, "inc" + sfx), "wb") as f:
        inc = built.dense_inc()
        f.write(struct.pack("<I", len(inc)))
        inc.astype("<u8").tofile(f)
    pse = _decompose_colors(built)
    nnodes_f = built.ftree.nnodes + 1
    with open(os.path.join(index_dir, "crecord" + sfx), "wb") as f:
        f.write(struct.pack("<II", nnodes_f, len(pse)))
        pse.astype("<u4").tofile(f)
        built.colors.rho[:nnodes_f].astype("<f8").tofile(f)
    with open(os.path.join(index_dir, "reflist" + sfx), "w") as f:
        f.write("\n".join(built.names) + "\n")
    if built.tree is not None and built.tree.nwk_str:
        with open(os.path.join(index_dir, "tree" + sfx), "w") as f:
            f.write(built.tree.nwk_str)
    with open(os.path.join(index_dir, "metadata" + sfx), "wb") as f:
        _write_config(f, p)
    with open(os.path.join(index_dir, "metadata" + sfx + ".txt"), "w") as f:
        f.write(f"krepp version: {REFERENCE_VERSION}\n")
        f.write("date: ?\n")
        f.write(f"seed: {seed}\n")
        f.write(f"k: {p.k}\nw: {p.w}\nh: {p.h}\nm: {p.m}\n")
        f.write("frac: true\n" if p.frac else "frac: false\n")
        ppos_desc = sorted(p.lsh.ppos, reverse=True)
        f.write("ppos_v: [" + ", ".join(str(x) for x in ppos_desc) + "]\n")
        f.write("npos_v: [" + ", ".join(str(x) for x in p.lsh.npos) + "]\n")
        f.write(f"nrows: {p.nrows_local}\n")
        f.write(f"total_num_kmers: {built.nkmers}\n")
        f.write(f"sdust-t: {p.sdust_t}\nsdust-w: {p.sdust_w}\n")


def _fallback_info(params: IndexParams, nrows: int, nkmers: int) -> str:
    """Byte-identical to the reference's partial-info fallback when no
    metadata .txt file exists (ref: src/index.cpp:121-141)."""
    p = params
    ppos_desc = sorted(p.lsh.ppos, reverse=True)
    return ("krepp version: ?\ndate: ?\nseed: ?\n"
            f"k: {p.k}\nw: {p.w}\nh: {p.h}\nm: {p.m}\n"
            + ("frac: true\n" if p.frac else "frac: false\n")
            + "ppos_v: [" + ", ".join(map(str, ppos_desc)) + "]\n"
            + "npos_v: [" + ", ".join(map(str, p.lsh.npos)) + "]\n"
            + f"nrows: {nrows}\ntotal_num_kmers: {nkmers}\n"
            + "sdust-t: ?\nsdust-w: ?\n")


def _native_info(meta: dict, params: IndexParams) -> str:
    """Reference save_info-format block for native artifacts
    (ref: src/krepp.cpp:187-204), with the fields meta.json records."""
    p = params
    ppos_desc = sorted(p.lsh.ppos, reverse=True)
    return (f"krepp version: {REFERENCE_VERSION}\ndate: ?\n"
            f"seed: {meta.get('seed', '?')}\n"
            f"k: {p.k}\nw: {p.w}\nh: {p.h}\nm: {p.m}\n"
            + ("frac: true\n" if p.frac else "frac: false\n")
            + "ppos_v: [" + ", ".join(map(str, ppos_desc)) + "]\n"
            + "npos_v: [" + ", ".join(map(str, p.lsh.npos)) + "]\n"
            + f"nrows: {meta['nrows']}\n"
            + f"total_num_kmers: {meta['nkmers']}\n"
            + f"sdust-t: {p.sdust_t}\nsdust-w: {p.sdust_w}\n")


def _partial_residues(params: IndexParams):
    """Residues a partial serves: frac partials cover 0..r
    (ref: src/index.cpp:144-156)."""
    return range(params.r + 1) if params.frac else [params.r]


def _scan_reference_dir(index_dir: str) -> Dict[str, set]:
    """Group files by -m{m}r{r}-{frac} suffix (ref: src/krepp.cpp:66-108)."""
    suffix_to_ltype: Dict[str, set] = {}
    lall = {"cmer", "crecord", "inc", "metadata", "tree", "reflist"}
    for fn in os.listdir(index_dir):
        if "." in fn:
            continue
        p1 = fn.find("-")
        if p1 == -1:
            continue
        ltype = fn[:p1]
        if ltype in lall:
            suffix_to_ltype.setdefault(fn[p1:], set()).add(ltype)
    return suffix_to_ltype


def _check_partials_compatible(paramss: List[IndexParams]) -> None:
    """LSHF compatibility across partials (ref: src/lshf.cpp:159-180,
    src/index.cpp:75-86): k, h, m and the position draws must agree."""
    p0 = paramss[0].lsh
    for p in paramss[1:]:
        q = p.lsh
        if not (q.k == p0.k and q.h == p0.h and q.m == p0.m
                and tuple(q.ppos) == tuple(p0.ppos)
                and tuple(q.npos) == tuple(p0.npos)):
            raise ValueError(
                "Partial libraries have incompatible hash functions!")


def _merge_partials(partials, tree: Tree, names: List[str],
                    wbackbone: bool) -> DeviceIndex:
    """Merge loaded partials into one unified DeviceIndex.

    partials: list of (params, g_rows, enc, se, ColorTable). Tree-node
    color ids are shared; composite ids are remapped by leaf set. The
    partial-rho coefficient |residues|/m is applied by from_parts
    (ref: src/index.cpp:144-158,188-201)."""
    _check_partials_compatible([p[0] for p in partials])
    ftree = FlatTree.from_tree(tree)
    nnodes = ftree.nnodes
    all_rows, all_enc, all_se = [], [], []
    residues: set = set()
    merged_sets: Dict[Tuple[int, ...], int] = {}
    merged_list: List[Tuple[int, ...]] = []
    rho_merged: Optional[np.ndarray] = None
    for params, g_rows, enc, se, part_colors in partials:
        if params.frac:
            residues.update(range(params.r + 1))
        else:
            residues.add(params.r)
        rho_p = np.zeros(nnodes + 1)
        rho_p[: min(len(part_colors.rho), nnodes + 1)] = \
            part_colors.rho[: nnodes + 1]
        if rho_merged is None:
            rho_merged = rho_p
        elif not np.allclose(rho_merged, rho_p, rtol=1e-6, atol=1e-12,
                             equal_nan=True):
            # the genome-level winnowing ratio is residue-independent, so
            # same-build partials agree; a mismatch means mixed builds
            print("WARNING: partial indexes carry different subsampling "
                  "rates (rho); using the first partial's values",
                  file=sys.stderr)
        remap = np.arange(part_colors.nse, dtype=np.int64)
        for cse in range(nnodes + 1, part_colors.nse):
            ls = tuple(part_colors.leaves_of(cse).tolist())
            if ls not in merged_sets:
                merged_sets[ls] = nnodes + 1 + len(merged_list)
                merged_list.append(ls)
            remap[cse] = merged_sets[ls]
        all_rows.append(g_rows)
        all_enc.append(enc)
        all_se.append(remap[se.astype(np.int64)])

    nse = nnodes + 1 + len(merged_list)
    off = np.zeros(nse + 1, np.int64)
    sets: List[Tuple[int, ...]] = [()] * nse
    sets[1: nnodes + 1] = ftree.clade_leafsets()[1:]
    for i, s in enumerate(merged_list):
        sets[nnodes + 1 + i] = s
    for se in range(nse):
        off[se + 1] = off[se] + len(sets[se])
    flat = np.empty(off[-1], np.int32)
    for se in range(nse):
        flat[off[se]: off[se + 1]] = sets[se]
    colors = ColorTable(nnodes=nnodes, nse=nse, leaf_off=off, leaf_list=flat,
                        rho=rho_merged)
    lsh = partials[0][0].lsh
    entries = (np.concatenate(all_rows),
               np.concatenate(all_enc).astype(np.uint32),
               np.concatenate(all_se).astype(np.int32))
    return DeviceIndex.from_parts(lsh, sorted(residues), entries, colors,
                                  tree, names, wbackbone)


def load_index_reference(index_dir: str) -> DeviceIndex:
    """Load a (possibly multi-partial) reference-format index directory."""
    groups = _scan_reference_dir(index_dir)
    if not groups:
        raise FileNotFoundError(f"No reference-format partials in {index_dir}")
    need = {"cmer", "crecord", "inc", "metadata"}
    tree: Optional[Tree] = None
    names: List[str] = []
    wbackbone = False
    partials = []
    res_info: Dict[int, str] = {}
    for sfx, ltypes in sorted(groups.items()):
        if not need <= ltypes:
            raise ValueError("There is a partial index with a missing file!")
        with open(os.path.join(index_dir, "metadata" + sfx), "rb") as f:
            params, nrows = _read_config(f)
        rpath = os.path.join(index_dir, "reflist" + sfx)
        if os.path.exists(rpath):
            with open(rpath) as f:
                names = [l.strip() for l in f if l.strip()]
        tpath = os.path.join(index_dir, "tree" + sfx)
        if "tree" in ltypes and os.path.exists(tpath):
            with open(tpath) as f:
                nwk = f.read()
            t = Tree.parse(nwk)
            t.nwk_str = nwk
            wbackbone = True
        else:
            t = Tree.generate(names)
        if tree is None:
            tree = t
        elif not tree.check_compatible(t):
            raise ValueError("Partial libraries are based on different trees!")
        with open(os.path.join(index_dir, "cmer" + sfx), "rb") as f:
            (nkmers,) = struct.unpack("<Q", f.read(8))
            pairs = np.fromfile(f, dtype="<u4", count=2 * nkmers).reshape(-1, 2)
        with open(os.path.join(index_dir, "inc" + sfx), "rb") as f:
            (ninc,) = struct.unpack("<I", f.read(4))
            inc = np.fromfile(f, dtype="<u8", count=ninc).astype(np.int64)
        with open(os.path.join(index_dir, "crecord" + sfx), "rb") as f:
            nnodes_f, nsubsets = struct.unpack("<II", f.read(8))
            pse = np.fromfile(f, dtype="<u4", count=2 * nsubsets).reshape(-1, 2)
            rho = np.fromfile(f, dtype="<f8", count=nnodes_f)
        # partial info block for `inspect`: the metadata .txt verbatim when
        # present, else the reference's "?" fallback (src/index.cpp:120-141)
        txt_path = os.path.join(index_dir, "metadata" + sfx + ".txt")
        if os.path.exists(txt_path):
            with open(txt_path) as f:
                info = f.read()
        else:
            info = _fallback_info(params, nrows, len(pairs))
        for r in _partial_residues(params):
            res_info[int(r)] = info
        partials.append((params, pairs, inc, pse, rho))

    ftree = FlatTree.from_tree(tree)
    merged = []
    for params, pairs, inc, pse, rho in partials:
        part_colors = colors_from_pse(ftree.nnodes, pse, ftree,
                                      rho[: ftree.nnodes + 1])
        g_rows = _local_rows_to_global(inc, params)
        merged.append((params, g_rows, pairs[:, 0],
                       pairs[:, 1].astype(np.int64), part_colors))
    di = _merge_partials(merged, tree, names, wbackbone)
    di.res_info = res_info
    if len(partials) == 1:
        # keep the binary color-decomposition graph for `inspect`'s
        # OUTDEGREE histogram (ref: src/record.cpp:257-276); multi-partial
        # merges remap composite ids, so the per-partial graphs don't apply
        di.se_pse = partials[0][3]
    return di
