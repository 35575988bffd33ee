"""Phylogeny: Newick parse/emit, post-order numbering, taxonomy trees.

Host-side tree handling mirroring the reference's Tree/Node semantics
(ref: src/phytree.{hpp,cpp}) with the pointer structures replaced by a flat
node table; device-facing arrays live in tree/flat.py.

Key semantics reproduced:
  * post-order ids `se` starting at 1, assigned at node completion during
    parsing; root gets the largest id; edge number en = se - 1
    (ref: src/phytree.cpp:150-215, src/phytree.hpp:156);
  * missing branch lengths are NaN and print as bare labels
    (ref: src/phytree.hpp:145-152);
  * random balanced backbone generation when no tree is given, with the
    *second* half of the name list parsed first (ref: src/phytree.cpp:234-243);
  * GTDB/Greengenes lineage files -> taxonomy trees (ref: src/phytree.cpp:320-370);
  * re-rooting the index tree onto a user tree (map_to_qtree) and effective
    child counts (ref: src/phytree.cpp:421-473).

The port's own copy of krepp_tpu/tree/newick.py: the port imports
nothing of the JAX package, so it carries the host code it needs.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Node:
    name: str = ""
    parent: Optional["Node"] = None
    children: List["Node"] = field(default_factory=list)
    blen: float = math.nan
    se: int = 0
    card: int = 0
    ldepth: int = 0
    is_leaf: bool = True
    is_taxon: bool = False
    eff_nchildren: int = 0
    rank: str = ""

    @property
    def nchildren(self) -> int:
        return len(self.children)

    @property
    def en(self) -> int:
        return self.se - 1

    def get_name(self, return_na: bool = False) -> str:
        """(ref: src/phytree.hpp:133-144)."""
        if self.name:
            return self.name
        return "NA" if return_na else str(self.se - 1)

    def midpoint_pendant(self) -> float:
        """(ref: src/phytree.hpp:124-131)."""
        return self.blen / 2.0 if not math.isnan(self.blen) else 0.0

    def add_child(self, child: "Node") -> None:
        child.parent = self
        self.children.append(child)
        self.card += child.card
        self.eff_nchildren += 1
        self.is_leaf = False


class Tree:
    def __init__(self):
        self.root: Optional[Node] = None
        self.nnodes: int = 0
        self.se_to_node: List[Optional[Node]] = [None]
        self.nwk_str: str = ""

    # ------------------------------------------------------------- parsing
    @staticmethod
    def tokenize(nwk: str) -> List[str]:
        """Newick tokenizer: quotes (with '' escape) and [comments]
        (ref: src/phytree.cpp:84-148)."""
        nwk = nwk.rstrip("\n")
        if not nwk:
            raise ValueError("Given Newick tree seems to be empty?!?.")
        if not nwk.endswith(";"):
            raise ValueError("Given Newick tree ends with a character other than ';'.")
        toks: List[str] = []
        buf = ""
        i = 0
        n = len(nwk)
        while i < n:
            c = nwk[i]
            if c in "'\"":
                # quoted label; doubled quote is a literal quote; comments
                # inside quotes are skipped (ref: src/phytree.cpp:103-117)
                q = c
                i += 1
                while i < n:
                    if nwk[i] == q:
                        if i + 1 < n and nwk[i + 1] == q:
                            buf += q
                            i += 2
                            continue
                        i += 1
                        break
                    if nwk[i] == "[":
                        j = nwk.find("]", i)
                        if j == -1:
                            raise ValueError("Unterminated comment in Newick tree.")
                        i = j + 1
                        continue
                    buf += nwk[i]
                    i += 1
                continue
            if c == "[":
                j = nwk.find("]", i)
                if j == -1:
                    raise ValueError("Unterminated comment in Newick tree.")
                i = j + 1
                continue
            if c in "():,":
                if buf:
                    toks.append(buf)
                    buf = ""
                toks.append(c)
                i += 1
                continue
            if c == ";":
                if i != n - 1:
                    raise ValueError(
                        "Given Newick tree contains an unquoted label or "
                        "length with ';'.")
                break
            if c in " \n":
                if buf:
                    raise ValueError(
                        "Given Newick tree contains an unquoted label or "
                        "length with ' ' or newline.")
                i += 1
                continue
            buf += c
            i += 1
        if buf:
            toks.append(buf)
        return toks

    @staticmethod
    def parse(nwk: str) -> "Tree":
        """Recursive-descent parse with post-order numbering
        (ref: src/phytree.cpp:150-215, 394-404)."""
        tree = Tree()
        tree.nwk_str = nwk if nwk.endswith("\n") or nwk.endswith(";") else nwk
        toks = Tree.tokenize(nwk)
        pos = 0

        def parse_node(parent: Optional[Node]) -> Node:
            nonlocal pos
            nd = Node()
            nd.ldepth = parent.ldepth + 1 if parent else 0
            if pos < len(toks) and toks[pos] == "(":
                # internal node
                while True:
                    pos += 1
                    child = parse_node(nd)
                    child.parent = nd
                    nd.children.append(child)
                    nd.card += child.card
                    nd.eff_nchildren += 1
                    nd.is_leaf = False
                    if pos < len(toks) and toks[pos] == ",":
                        continue
                    break
                if nd.nchildren == 1:
                    raise ValueError(
                        "A node has a single child in the backbone tree! "
                        "Please suppress unifurcations.")
                if pos < len(toks) and toks[pos] == ")":
                    pos += 1
                tree.nnodes += 1
                nd.se = tree.nnodes
                tree.se_to_node.append(nd)
                nd.name = ""
                nd.blen = math.nan
                if pos < len(toks) and toks[pos] not in ",)":
                    if toks[pos] != ":":
                        nd.name = toks[pos]
                        pos += 1
                    if pos < len(toks) and toks[pos] == ":":
                        nd.blen = float(toks[pos + 1])
                        pos += 2
            else:
                nd.name = ""
                nd.blen = math.nan
                if pos < len(toks) and toks[pos] not in ",)":
                    if toks[pos] != ":":
                        nd.name = toks[pos]
                        pos += 1
                    if pos < len(toks) and toks[pos] == ":":
                        nd.blen = float(toks[pos + 1])
                        pos += 2
                nd.is_leaf = True
                nd.card = 1
                tree.nnodes += 1
                nd.se = tree.nnodes
                tree.se_to_node.append(nd)
            return nd

        tree.root = parse_node(None)
        _set_ldepth(tree.root, 0)
        return tree

    @staticmethod
    def generate(names: List[str]) -> "Tree":
        """Random-free balanced backbone when no tree is given
        (ref: src/phytree.cpp:38-45, 217-253). Note the reference descends
        into the *second* half of the name list first."""
        tree = Tree()

        def build(lo: int, hi: int, parent: Optional[Node]) -> Node:
            nd = Node()
            nd.ldepth = parent.ldepth + 1 if parent else 0
            if hi - lo == 1:
                nd.name = names[lo]
                nd.blen = 1.0
                nd.is_leaf = True
                nd.card = 1
                tree.nnodes += 1
                nd.se = tree.nnodes
                tree.se_to_node.append(nd)
                return nd
            half = lo + (hi - lo) // 2
            for pix in range(2):
                child = build(half, hi, nd) if pix == 0 else build(lo, half, nd)
                child.parent = nd
                nd.children.append(child)
                nd.card += child.card
                nd.eff_nchildren += 1
                nd.is_leaf = False
            nd.blen = 1.0
            tree.nnodes += 1
            nd.se = tree.nnodes
            tree.se_to_node.append(nd)
            return nd

        tree.root = build(0, len(names), None)
        return tree

    @staticmethod
    def parse_lineages(text: str) -> "Tree":
        """GTDB/Greengenes lineage file -> taxonomy tree
        (ref: src/phytree.cpp:320-370)."""
        tree = Tree()
        root = Node(name="root")
        root.rank = "root"
        root.is_taxon = True
        root.is_leaf = True
        tree.root = root
        taxon_to_node: Dict[str, Node] = {}
        order: List[str] = []
        for line in text.splitlines():
            if not line.strip():
                continue
            line = line.replace("; ", ";")
            parts = line.split("\t")
            if len(parts) < 2:
                raise ValueError("Failed to read reference to lineage mapping!")
            name, lineage = parts[0], parts[1]
            parent: Optional[Node] = None
            for taxon in lineage.split(";"):
                rank = re.sub(r"__.*", "", taxon)
                taxon = re.sub(r".__", "", taxon, count=1)
                if not taxon:
                    continue
                if taxon not in taxon_to_node:
                    nd = Node(name=taxon)
                    nd.rank = rank
                    nd.is_taxon = True
                    nd.card = 0
                    nd.is_leaf = True
                    taxon_to_node[taxon] = nd
                    order.append(taxon)
                    if parent is not None:
                        nd.card = 0
                        parent.add_child(nd)
                        nd.ldepth = parent.ldepth + 1
                parent = taxon_to_node[taxon]
            if name in taxon_to_node:
                raise ValueError(
                    "The same reference appears more than once in the lineage file.")
            leaf = Node(name=name)
            leaf.is_leaf = True
            leaf.card = 1
            taxon_to_node[name] = leaf
            order.append(name)
            if parent is not None:
                parent.add_child(leaf)
                leaf.ldepth = parent.ldepth + 1
        for taxon in order:
            nd = taxon_to_node[taxon]
            if nd.parent is None:
                root.add_child(nd)
        # propagate cards
        def fix_card(nd: Node) -> int:
            if nd.is_leaf:
                nd.card = 1 if not nd.children else 0
            if nd.children:
                nd.card = sum(fix_card(c) for c in nd.children)
            return nd.card

        fix_card(root)
        _set_ldepth(root, 0)
        # post-order numbering (ref: src/phytree.cpp:363-369)
        tree.nnodes = 0
        tree.se_to_node = [None]
        for nd in tree.postorder():
            tree.nnodes += 1
            nd.se = tree.nnodes
            tree.se_to_node.append(nd)
        return tree

    # ---------------------------------------------------------- traversal
    def postorder(self):
        def rec(nd: Node):
            for c in nd.children:
                yield from rec(c)
            yield nd

        if self.root is not None:
            yield from rec(self.root)

    def leaves(self) -> List[Node]:
        return [nd for nd in self.postorder() if nd.is_leaf]

    def get_node(self, se: int) -> Optional[Node]:
        if 0 <= se < len(self.se_to_node):
            return self.se_to_node[se]
        return None

    def check_node(self, se: int) -> bool:
        """(ref: src/phytree.hpp:34)."""
        return se <= self.nnodes

    # ----------------------------------------------------------- emission
    @staticmethod
    def _entry(nd: Node, fixed5: bool) -> str:
        if math.isnan(nd.blen):
            return nd.name
        if fixed5:
            return f"{nd.name}:{nd.blen:.5f}"
        return f"{nd.name}:{nd.blen:g}"

    def newick(self, jplace: bool = False, fixed5: bool = False) -> str:
        """Emit Newick; jplace adds {edge_num} labels
        (ref: src/phytree.cpp:47-82). fixed5 mirrors the reference's
        stream precision(5) + std::fixed on the jplace path."""

        def rec(nd: Node) -> str:
            s = ""
            if not nd.is_leaf:
                s += "(" + ",".join(rec(c) for c in nd.children) + ")"
            s += self._entry(nd, fixed5)
            if jplace:
                s += "{" + str(nd.en) + "}"
            return s

        return rec(self.root) + ";"

    # ------------------------------------------------------ relationships
    @staticmethod
    def lca(a: Node, b: Node) -> Node:
        """(ref: src/phytree.cpp:307-318) by depth walk."""
        if a is None or b is None:
            return a if a is not None else b
        while a is not b:
            if a.ldepth < b.ldepth:
                b = b.parent
            else:
                a = a.parent
        return a

    @staticmethod
    def distance(a: Node, b: Node) -> float:
        """Patristic distance (ref: src/phytree.cpp:372-386)."""
        if a is None or b is None:
            return math.inf
        d = 0.0
        while a is not b:
            if a.ldepth < b.ldepth:
                d += b.blen
                b = b.parent
            else:
                d += a.blen
                a = a.parent
        return d

    def check_compatible(self, other: Optional["Tree"]) -> bool:
        """Same shape and names in post-order (ref: src/phytree.cpp:10-36)."""
        if other is None:
            return True
        mine = list(self.postorder())
        theirs = list(other.postorder())
        if len(mine) != len(theirs):
            return False
        return all(a.name == b.name for a, b in zip(mine, theirs))


def _set_ldepth(root: Node, depth: int) -> None:
    stack = [(root, depth)]
    while stack:
        nd, d = stack.pop()
        nd.ldepth = d
        for c in nd.children:
            stack.append((c, d + 1))


def map_to_qtree(index_tree: Tree, qtree: Tree) -> List[Optional[Node]]:
    """Map index-tree leaf slots onto a query/placement tree.

    Returns se_to_node: for se in 1..index_tree.nnodes, the qtree node the
    index se now resolves to (qtree leaf for mapped leaves, None for index
    leaves absent from qtree, the original index node for internals).
    Also recomputes qtree eff_nchildren (number of children covered by
    indexed leaves). (ref: src/phytree.cpp:421-473.)
    """
    se_to_node: List[Optional[Node]] = list(index_tree.se_to_node)
    name_to_se: Dict[str, int] = {}
    for nd in index_tree.postorder():
        if nd.is_leaf:
            name_to_se[nd.name] = nd.se
            se_to_node[nd.se] = None
    for nd in qtree.postorder():
        if nd.is_leaf and nd.name and nd.name in name_to_se:
            se_to_node[name_to_se[nd.name]] = nd
    compute_eff_nchildren(qtree, se_to_node, index_tree.nnodes)
    return se_to_node


def compute_eff_nchildren(qtree: Tree, se_to_node: List[Optional[Node]],
                          nnodes: int) -> None:
    """(ref: src/phytree.cpp:452-473)."""
    covered = set()
    for se in range(1, nnodes + 1):
        nd = se_to_node[se]
        if nd is None or not nd.is_leaf:
            continue
        anc = nd
        while anc is not None and id(anc) not in covered:
            covered.add(id(anc))
            anc = anc.parent
    for nd in qtree.postorder():
        nd.eff_nchildren = 0
    by_id = {}
    for nd in qtree.postorder():
        by_id[id(nd)] = nd
    for nid in covered:
        nd = by_id.get(nid)
        if nd is not None and nd.parent is not None:
            nd.parent.eff_nchildren += 1
