"""Native index artifact (one meta.json partial) and the reference's
binary sketch file: save and load.

JAX-free copy of the native-format half and the sketch functions of
krepp_tpu/index/artifact.py; files written by either package load in the
other. Multi-partial directories and the reference binary index format
raise NotImplementedError until their ROADMAP item ports them.
"""

from __future__ import annotations

import json
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from .. import REFERENCE_VERSION
from ..params import IndexParams, LSHParams
from ..tree.flat import FlatTree
from ..tree.newick import Tree
from .colors import ColorTable

from .build import BuiltIndex, BuiltSketch
from .index import DeviceIndex, DeviceSketch

FORMAT_VERSION = 1


def save_native(built: BuiltIndex, index_dir: str, seed: int = 0) -> None:
    """Write the native artifact (meta.json + arrays.npz + tree + reflist)."""
    os.makedirs(index_dir, exist_ok=True)
    p = built.params
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
    with open(os.path.join(index_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    row_arrays = ({"inc": built.inc} if built.inc is not None
                  else {"rows_local": built.rows_local})
    np.savez(
        os.path.join(index_dir, "arrays.npz"),
        enc_v=built.enc_v, se_v=built.se_v,
        leaf_off=built.colors.leaf_off, leaf_list=built.colors.leaf_list,
        rho=built.colors.rho, **row_arrays)
    if built.tree is not None:
        with open(os.path.join(index_dir, "tree.nwk"), "w") as f:
            f.write(built.tree.nwk_str or built.tree.newick())
    with open(os.path.join(index_dir, "reflist.txt"), "w") as f:
        f.write("\n".join(built.names) + "\n")


def _scan_native_partials(index_dir: str) -> List[str]:
    return sorted(fn[len("meta"): -len(".json")]
                  for fn in os.listdir(index_dir)
                  if fn.startswith("meta-") and fn.endswith(".json"))


def _read_meta(index_dir: str) -> dict:
    with open(os.path.join(index_dir, "meta.json")) as f:
        return json.load(f)


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
    meta = _read_meta(index_dir)
    lsh = LSHParams(k=meta["k"], h=meta["h"], m=meta["m"],
                    ppos=tuple(meta["ppos"]), npos=tuple(meta["npos"]))
    params = IndexParams(lsh=lsh, w=meta["w"], r=meta["r"],
                         frac=meta["frac"], sdust_t=meta["sdust_t"],
                         sdust_w=meta["sdust_w"])
    z = np.load(os.path.join(index_dir, "arrays.npz"))
    colors = ColorTable(nnodes=meta["nnodes"], nse=meta["nse"],
                        leaf_off=z["leaf_off"], leaf_list=z["leaf_list"],
                        rho=z["rho"])
    tree = _native_tree(index_dir, meta)
    return BuiltIndex(params=params, tree=tree, names=meta["names"],
                      enc_v=z["enc_v"], se_v=z["se_v"],
                      inc=z["inc"] if "inc" in z else None,
                      rows_local=(z["rows_local"] if "rows_local" in z
                                  else None),
                      colors=colors, ftree=FlatTree.from_tree(tree))


def _native_info(meta: dict, params: IndexParams) -> str:
    """Reference save_info-format block (ref: src/krepp.cpp:187-204)."""
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
    """Residues a partial serves (ref: src/index.cpp:144-156)."""
    return range(params.r + 1) if params.frac else [params.r]


def load_native_device(index_dir: str) -> DeviceIndex:
    """Load a native index directory holding one meta.json partial."""
    if _scan_native_partials(index_dir):
        raise NotImplementedError(
            "multi-partial native indexes are not ported to krepp_tpu_torch "
            "yet (ROADMAP Queue 1, reference-format and multi-partial "
            "loading)")
    built = load_native(index_dir)
    meta = _read_meta(index_dir)
    di = DeviceIndex.from_built(built)
    di.wbackbone = bool(meta.get("wbackbone"))
    di.res_info = {int(r): _native_info(meta, built.params)
                   for r in _partial_residues(built.params)}
    return di


def load_index(index_dir: str) -> DeviceIndex:
    """The CLI's loader: the native single-partial format only."""
    if os.path.exists(os.path.join(index_dir, "meta.json")) \
            or _scan_native_partials(index_dir):
        return load_native_device(index_dir)
    raise NotImplementedError(
        f"{index_dir} holds no native meta.json; reference-format index "
        "loading is not ported to krepp_tpu_torch yet (ROADMAP Queue 1)")


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
