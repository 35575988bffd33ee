"""The placement tree of the plain reference: a Newick tree of names and
branch lengths, its nodes numbered in post-order from 1 (the edge number
of node se is se - 1, src/phytree.cpp:150-215, src/phytree.hpp:156)."""

from __future__ import annotations

import math
from typing import List


class Tree:
    """Nodes 1..n in post-order: parent (0 at the root), children, branch
    length (NaN where none is given), name (leaves)."""

    def __init__(self, nwk: str):
        s = nwk.strip()
        if not s.endswith(";"):
            raise ValueError("a Newick tree ends with ';'")
        self.parent: List[int] = [0]
        self.children: List[List[int]] = [[]]
        self.blen: List[float] = [math.nan]
        self.name: List[str] = [""]
        self._s = s[:-1]
        self._i = 0
        self._node()
        if self._i != len(self._s):
            raise ValueError("trailing text after the Newick tree")
        del self._s, self._i
        self.n = len(self.parent) - 1

    def _label(self) -> str:
        j = self._i
        while self._i < len(self._s) and self._s[self._i] not in "(),:":
            self._i += 1
        return self._s[j: self._i]

    def _node(self) -> int:
        kids = []
        if self._s[self._i] == "(":
            while True:
                self._i += 1
                kids.append(self._node())
                if self._s[self._i] != ",":
                    break
            if self._s[self._i] != ")":
                raise ValueError("unbalanced Newick tree")
            self._i += 1
        name = self._label()
        blen = math.nan
        if self._i < len(self._s) and self._s[self._i] == ":":
            self._i += 1
            blen = float(self._label())
        se = len(self.parent)
        self.parent.append(0)
        self.children.append(kids)
        self.blen.append(blen)
        self.name.append(name if not kids else "")
        for c in kids:
            self.parent[c] = se
        return se

    def is_leaf(self, se: int) -> bool:
        return not self.children[se]

    def leaves(self) -> List[int]:
        return [se for se in range(1, self.n + 1) if self.is_leaf(se)]
