"""Flattened, edge-indexed tree arrays for batched device ops.

The reference walks shared_ptr trees per read (ref: src/query.cpp:248-265);
here the phylogeny is flattened once into dense arrays and the placement
ancestor-accumulation becomes a single (nodes x leaves) matmul with
precomputed damping weights.

The port's own copy of krepp_tpu/tree/flat.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

import itertools
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
        return self.clade_leafsets()[se]

    def clade_leafsets(self) -> List[tuple]:
        """clade_leafset of every node (index se; slot 0 empty), from one
        post-order pass over the tree, computed once: every node's set is
        its children's sets merged, so the work is linear in the node count
        times the depth, not quadratic in the node count."""
        sets = self.__dict__.get("_clade_sets")
        if sets is None:
            children = self.children_lists()
            order = []
            stack = [se for se in range(1, self.nnodes + 1)
                     if not self.parent[se]]
            while stack:
                s = stack.pop()
                order.append(s)
                stack.extend(children[s])
            sets = [()] * (self.nnodes + 1)
            for s in reversed(order):         # children before parents
                if self.is_leaf[s]:
                    sets[s] = (s,)
                elif children[s]:
                    sets[s] = tuple(sorted(itertools.chain.from_iterable(
                        sets[c] for c in children[s])))
            self._clade_sets = sets
        return sets

    def children_lists(self) -> List[List[int]]:
        """Child ses of every node (index se), computed once."""
        ch = self.__dict__.get("_children")
        if ch is None:
            ch = [[] for _ in range(self.nnodes + 1)]
            for se in range(1, self.nnodes + 1):
                p = self.parent[se]
                if p:
                    ch[p].append(se)
            self._children = ch
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


def placement_ancestors(qtree_flat: FlatTree, leaf_qse: np.ndarray):
    """The non-zero entries of placement_weights, slot by slot, without
    the dense [qn+1, S] array (19,999 x 10,000 f64 at 10,000 leaves on a
    balanced tree, of which about depth + 1 entries a column are set).

    Returns (anc_q int64 [S, D], anc_w float64 [S, D]): row s holds
    np.flatnonzero(W[:, s] > 0) (ascending node ids: the slot's own node
    first, as post-order ids grow root-ward) and W at those nodes, the
    same floats, zero-padded to the longest chain D (at least 1). The walk
    is placement_weights'."""
    S = len(leaf_qse)
    chains = []
    for q in leaf_qse:
        q = int(q)
        if q == 0:
            chains.append([])
            continue
        chain = [(q, 1.0)]
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
            chain.append((p, denom))
            node = p
        chains.append(sorted(c for c in chain if c[1] > 0))
    D = max(max((len(c) for c in chains), default=0), 1)
    anc_q = np.zeros((S, D), np.int64)
    anc_w = np.zeros((S, D), np.float64)
    for s, chain in enumerate(chains):
        if chain:
            anc_q[s, : len(chain)], anc_w[s, : len(chain)] = zip(*chain)
    return anc_q, anc_w
