"""Flattened, edge-indexed tree arrays for batched device ops.

The reference walks shared_ptr trees per read (ref: src/query.cpp:248-265);
here the phylogeny is flattened once into dense arrays and the placement
ancestor-accumulation becomes a single (nodes x leaves) matmul with
precomputed damping weights.

The port's own copy of krepp_tpu/tree/flat.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np

from .newick import Tree


@dataclass
class FlatTree:
    """Arrays indexed by post-order id se (1..nnodes; slot 0 unused)."""

    nnodes: int
    parent: np.ndarray        # int32, 0 for root
    blen: np.ndarray          # float64, NaN where absent
    card: np.ndarray          # int32
    nchildren: np.ndarray     # int32
    eff_nchildren: np.ndarray  # int32
    is_leaf: np.ndarray       # bool
    is_taxon: np.ndarray      # bool
    names: List[str]          # raw names ('' where unnamed)

    @staticmethod
    def from_tree(tree: Tree) -> "FlatTree":
        n = tree.nnodes
        parent = np.zeros(n + 1, np.int32)
        blen = np.full(n + 1, math.nan)
        card = np.zeros(n + 1, np.int32)
        nchildren = np.zeros(n + 1, np.int32)
        eff = np.zeros(n + 1, np.int32)
        is_leaf = np.zeros(n + 1, bool)
        is_taxon = np.zeros(n + 1, bool)
        names = [""] * (n + 1)
        for nd in tree.postorder():
            se = nd.se
            parent[se] = nd.parent.se if nd.parent is not None else 0
            blen[se] = nd.blen
            card[se] = nd.card
            nchildren[se] = nd.nchildren
            eff[se] = nd.eff_nchildren
            is_leaf[se] = nd.is_leaf
            is_taxon[se] = nd.is_taxon
            names[se] = nd.name
        return FlatTree(n, parent, blen, card, nchildren, eff, is_leaf,
                        is_taxon, names)

    def leaf_ses(self) -> np.ndarray:
        return np.flatnonzero(self.is_leaf).astype(np.int32)

    def clade_leafset(self, se: int) -> tuple:
        """Sorted tuple of leaf ses beneath node se."""
        out = []
        stack = [se]
        children = self.children_lists()
        while stack:
            s = stack.pop()
            if self.is_leaf[s]:
                out.append(s)
            else:
                stack.extend(children[s])
        return tuple(sorted(out))

    def children_lists(self) -> List[List[int]]:
        ch: List[List[int]] = [[] for _ in range(self.nnodes + 1)]
        for se in range(1, self.nnodes + 1):
            p = self.parent[se]
            if p:
                ch[p].append(se)
        return ch


def placement_weights(qtree_flat: FlatTree, leaf_qse: np.ndarray) -> np.ndarray:
    """W[qse, slot]: contribution weight of leaf slot's Minfo to qtree node.

    Mirrors the pp_map ancestor walk (ref: src/query.cpp:248-265): starting
    at denom = 1, each step to a parent divides by that parent's
    eff_nchildren (or keeps denom = 1 on taxon-to-taxon steps); the leaf's
    own node receives weight 1. leaf_qse[slot] = 0 marks an unmapped slot
    (weight 0 everywhere).
    """
    n = qtree_flat.nnodes
    S = len(leaf_qse)
    W = np.zeros((n + 1, S))
    for s, q in enumerate(leaf_qse):
        q = int(q)
        if q == 0:
            continue
        W[q, s] = 1.0
        denom = 1.0
        leaf_is_taxon = bool(qtree_flat.is_taxon[q])
        node = q
        while True:
            p = int(qtree_flat.parent[node])
            if p == 0:
                break
            if qtree_flat.is_taxon[p] and leaf_is_taxon:
                denom = 1.0
            else:
                denom /= float(qtree_flat.eff_nchildren[p])
            W[p, s] += denom
            node = p
    return W
