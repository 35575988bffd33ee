"""The plain reference that decides `correct`.

Plain torch and numpy, written from krepp's published semantics; it
imports nothing of the program under test and takes nothing the program
made: it works the index, the subsampling rates, the matches, the
distances and the placements out again from the generated genomes, tree
and reads (see query.py).
"""

from __future__ import annotations

import numpy as np
import torch

from . import query
from .tree import Tree


def report(command: str, genomes: torch.Tensor, genome_names, nwk: str,
           reads: np.ndarray, read_names, p: dict, dtype=torch.float64):
    """What `command` (dist or place) reports for the reads, by default
    settings: dist, read name -> {genome name: distance} (empty for its
    NA row); place, read name -> {edge number: the five numbers of its jplace
    row} for each read placed.

    genomes [G, L] uint8 base codes (on the device the reference runs on),
    named genome_names, on the Newick tree nwk; reads [n, Lr] uint8 codes;
    p holds k, w, h, m, r, frac, ppos, npos and th."""
    tree = Tree(nwk)
    se_of = {tree.name[se]: se for se in tree.leaves()}
    genome_se = np.array([se_of[g] for g in genome_names])
    (lanes, closest), rho = query.leaf_lanes(genomes, genome_se, reads, p,
                                             dtype)
    if command == "dist":
        return query.dist_rows(lanes, read_names, genome_names)
    if command == "place":
        P = reads.shape[1] - p["k"] + 1
        return query.place_rows(lanes, closest, rho, read_names,
                                genome_names, tree, P, p, dtype,
                                genomes.device)
    raise ValueError(f"unknown command {command!r}")
