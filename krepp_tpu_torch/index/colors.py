"""Color system: k-mer -> subset-of-genomes mapping as dense leaf-list CSR.

The reference encodes subsets as additive 64-bit hashes compacted to 32-bit
ids with a binary decomposition table, BFS-decoded per probe
(ref: src/record.{hpp,cpp}, src/query.cpp:369-387). On TPU that per-probe
pointer chase is replaced by a precomputed per-color leaf list (CSR) and a
per-color leaf *bitmask* so the probe kernel's color expansion is a gather +
bitwise OR.

Color ids ("se") keep the reference numbering convention: tree nodes occupy
1..nnodes (post-order), composite subsets nnodes+1.. (ref:
src/record.cpp:132-154). A k-mer whose genome set equals a clade gets that
clade's node id.

The port's own copy of krepp_tpu/index/colors.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..tree.flat import FlatTree


@dataclass
class ColorTable:
    """Frozen color table.

    leaf_off/leaf_list: CSR of *leaf se* values per color id.
    nnodes: tree-node id space bound (ids <= nnodes are tree nodes).
    rho: per-tree-node subsampling rate, indexed by se (only leaves
    meaningful; ref CRecord::se_to_rho, src/record.hpp:104).
    """

    nnodes: int
    nse: int
    leaf_off: np.ndarray    # int64 [nse + 1]
    leaf_list: np.ndarray   # int32, values are leaf se
    rho: np.ndarray         # float64 [nnodes + 1]

    def leaves_of(self, se: int) -> np.ndarray:
        return self.leaf_list[self.leaf_off[se]: self.leaf_off[se + 1]]

    def apply_rho_coef(self, coef: float) -> None:
        """(ref: src/record.cpp:304-309)."""
        self.rho = self.rho * coef

    def leaf_masks(self, leaf_slot: Dict[int, int], nslots: int) -> np.ndarray:
        """uint32 bitmask [nse, ceil(nslots/32)] of leaf slots per color."""
        W = (nslots + 31) // 32
        masks = np.zeros((self.nse, W), np.uint32)
        # vectorized: one scatter-OR over the whole CSR
        nse_of = np.repeat(np.arange(self.nse, dtype=np.int64),
                           np.diff(self.leaf_off))
        slot_map = np.full(int(max(leaf_slot, default=0)) + 2, -1, np.int64)
        for leaf, slot in leaf_slot.items():
            slot_map[leaf] = slot
        slots = slot_map[self.leaf_list]
        ok = slots >= 0
        flat = masks.reshape(-1)
        np.bitwise_or.at(
            flat, nse_of[ok] * W + slots[ok] // 32,
            (np.uint32(1) << (slots[ok] % 32).astype(np.uint32)))
        return flat.reshape(self.nse, W)


class ColorBuilder:
    """Assign color ids to genome subsets during index build."""

    def __init__(self, ftree: FlatTree):
        self.ftree = ftree
        self.nnodes = ftree.nnodes
        clades = ftree.clade_leafsets()
        self._clade_to_se: Dict[Tuple[int, ...], int] = {
            clades[se]: se for se in range(1, ftree.nnodes + 1)}
        self._extra: Dict[Tuple[int, ...], int] = {}
        self._extra_sets: List[Tuple[int, ...]] = []

    def color_of(self, leafset: Tuple[int, ...]) -> int:
        se = self._clade_to_se.get(leafset)
        if se is not None:
            return se
        se = self._extra.get(leafset)
        if se is None:
            se = self.nnodes + 1 + len(self._extra_sets)
            self._extra[leafset] = se
            self._extra_sets.append(leafset)
        return se

    def finalize(self, rho: np.ndarray) -> ColorTable:
        nse = self.nnodes + 1 + len(self._extra_sets)
        sets: List[Tuple[int, ...]] = [()] * nse
        sets[1: self.nnodes + 1] = self.ftree.clade_leafsets()[1:]
        for i, s in enumerate(self._extra_sets):
            sets[self.nnodes + 1 + i] = s
        off = np.zeros(nse + 1, np.int64)
        for se in range(nse):
            off[se + 1] = off[se] + len(sets[se])
        flat = np.empty(off[-1], np.int32)
        for se in range(nse):
            flat[off[se]: off[se + 1]] = sets[se]
        return ColorTable(nnodes=self.nnodes, nse=nse, leaf_off=off,
                          leaf_list=flat, rho=rho)


def colors_from_pse(nnodes: int, se_to_pse: np.ndarray, ftree: FlatTree,
                    rho: np.ndarray) -> ColorTable:
    """Decode a reference-format binary-decomposition table into leaf CSR.

    se_to_pse[se] = (a, b) with subset(se) = subset(a) U subset(b); ids
    <= nnodes are tree nodes (ref: src/record.cpp:239-255).
    """
    nse = len(se_to_pse)
    children = ftree.children_lists()
    memo: List[Tuple[int, ...] | None] = [None] * nse

    def leaves(se: int) -> Tuple[int, ...]:
        if se == 0:
            return ()
        if memo[se] is not None:
            return memo[se]
        out: List[int] = []
        stack = [se]
        while stack:
            s = stack.pop()
            if s == 0:
                continue
            if memo[s] is not None:
                out.extend(memo[s])
            elif s <= nnodes:
                if ftree.is_leaf[s]:
                    out.append(s)
                else:
                    stack.extend(children[s])
            else:
                a, b = se_to_pse[s]
                stack.append(int(a))
                stack.append(int(b))
        res = tuple(sorted(set(out)))
        memo[se] = res
        return res

    off = np.zeros(nse + 1, np.int64)
    all_sets = []
    for se in range(nse):
        s = leaves(se) if se else ()
        all_sets.append(s)
        off[se + 1] = off[se] + len(s)
    flat = np.empty(off[-1], np.int32)
    for se in range(nse):
        flat[off[se]: off[se + 1]] = all_sets[se]
    return ColorTable(nnodes=nnodes, nse=nse, leaf_off=off, leaf_list=flat,
                      rho=rho)
