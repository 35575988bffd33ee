"""dist and place of the plain reference, for a sample of reads.

What the port derives, worked out again from the generated genomes, tree
and reads alone:

1. the index: each genome's minimizers (its k-mers that are the least by
   the xur64 hash in some window of w bases), their LSH rows and 32-bit
   residuals, and the set of genomes ("color") that holds each
   (row, residual); only the rows the sampled reads probe are kept;
2. each genome's subsampling rate rho (HyperLogLog of its minimizer
   hashes over that of all its k-mer hashes, src/rqseq.hpp:79, times
   (r + 1) / m for a fractional partial);
3. per read and strand: every k-mer's probe of its row, the Hamming
   distance of each stored residual, and per genome the histogram of the
   least distance at each position (IBatch::search_mers /
   add_matching_mer, src/query.cpp:40-94, 352-390);
4. the strand filter, Brent's ML distance of each genome, the closest
   genome and the choice between strands (summarize_matches,
   src/query.cpp:96-139); dist's rows (report_distances, :158-196);
5. place: each match carried up the tree with the weight 1 / children at
   each step, the internal nodes' ML distances, the chi-square test
   against the closest genome and the like-weight ratios
   (report_placement, src/query.cpp:218-333), as jplace rows.

Integer work runs in torch integer ops on `device`; every float
operation runs in `dtype`.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import kmers, llh
from .tree import Tree

CHISQ = 2.706           # krepp's default chi-square threshold
TAU = 2                 # place's default tau
BLOCK_POSITIONS = 1 << 23
NO_MATCH = 1 << 20      # a least distance above any class


def build_table(genomes: torch.Tensor, need: torch.Tensor, p: dict):
    """The index rows in `need` (sorted local rows) and every genome's rho.

    genomes [G, L] uint8 codes on the reference's device. Returns (row,
    residual, genome) numpy arrays of the distinct entries, sorted, and
    rho [G] f64."""
    G, L = genomes.shape
    per = max(1, BLOCK_POSITIONS // L)
    rows, ress, gs, n1, n2 = [], [], [], [], []
    for lo in range(0, G, per):
        g, local, res, c1, c2 = kmers.winnow(
            genomes[lo: lo + per], p["k"], p["w"], p["ppos"], p["npos"],
            p["m"], p["r"], p["frac"])
        keep = torch.isin(local, need)
        rows.append(local[keep].cpu().numpy())
        ress.append(res[keep].cpu().numpy())
        gs.append(g[keep].cpu().numpy() + lo)
        n1.append(kmers.hll_estimate(c1).cpu().numpy())
        n2.append(kmers.hll_estimate(c2).cpu().numpy())
    n1 = np.concatenate(n1)
    n2 = np.concatenate(n2)
    coef = ((p["r"] + 1) if p["frac"] else 1) / p["m"]
    rho = np.where(n1 > 0, n2 / np.where(n1 > 0, n1, 1.0), 0.0) * coef
    t = np.unique(np.stack([np.concatenate(rows), np.concatenate(ress),
                            np.concatenate(gs)], axis=1), axis=0)
    return t[:, 0], t[:, 1], t[:, 2], rho


def leaf_lanes(genomes: torch.Tensor, genome_se: np.ndarray,
               reads: np.ndarray, p: dict, dtype):
    """Steps 1-4 for [n, Lr] reads: per read, the chosen lane of each
    genome it matches and the closest genome.

    genome_se: each genome's leaf number in the tree, the order in which
    krepp visits matched genomes. Returns ((lanes, closest), rho) where
    lanes is a dict of numpy arrays
    (read, genome, hist [., th+1], match, d, v), one entry per (read,
    genome) kept, in (read, genome) order, and closest[read] is the lane
    index of the read's closest genome or -1."""
    dev = genomes.device
    k, th = p["k"], p["th"]
    X = th + 1
    codes = torch.from_numpy(np.ascontiguousarray(reads)).to(dev)
    pos, rix, res = kmers.read_probes(codes, k, p["ppos"], p["npos"])
    resident, local = kmers.resident_local(rix, p["m"], p["r"], p["frac"])
    need = torch.unique(local[resident])
    t_row, t_res, t_g, rho = build_table(genomes, need, p)
    # CSR of the distinct (row, residual) entries and their genomes
    ent_key, ent_first = np.unique(np.stack([t_row, t_res], 1), axis=0,
                                   return_index=True)
    ent_row, ent_res = ent_key[:, 0], ent_key[:, 1]
    ent_gstart = np.append(ent_first, len(t_g))
    urow, row_first = np.unique(ent_row, return_index=True)
    row_end = np.append(row_first[1:], len(ent_row))

    n, P = reads.shape[0], pos.shape[-1]
    s_i, r_i, t_i = np.nonzero(resident.cpu().numpy())
    prow = local.cpu().numpy()[s_i, r_i, t_i]
    pres = res.cpu().numpy()[s_i, r_i, t_i]
    at = np.searchsorted(urow, prow)
    found = (at < len(urow)) & (urow[np.minimum(at, len(urow) - 1)] == prow)
    s_i, r_i, t_i, pres, at = (a[found] for a in (s_i, r_i, t_i, pres, at))
    cnt = row_end[at] - row_first[at]
    # one item per (probe, entry of its row)
    rep = np.repeat(np.arange(len(at)), cnt)
    ent = (np.repeat(row_first[at] - np.cumsum(cnt) + cnt, cnt)
           + np.arange(cnt.sum()))
    hd = kmers.hdist(torch.from_numpy(ent_res[ent]),
                     torch.from_numpy(pres[rep])).numpy()
    ok = hd <= th
    rep, ent, hd = rep[ok], ent[ok], hd[ok]
    strand, read, tpos = s_i[rep], r_i[rep], t_i[rep]
    # the strand filter: least distance of any match of the strand
    filt = np.full((2, n), NO_MATCH)
    np.minimum.at(filt, (strand, read), hd)
    filt = 2 * filt + 1
    # one item per (probe match, genome of its entry)
    gcnt = ent_gstart[ent + 1] - ent_gstart[ent]
    rep2 = np.repeat(np.arange(len(ent)), gcnt)
    gi = (np.repeat(ent_gstart[ent] - np.cumsum(gcnt) + gcnt, gcnt)
          + np.arange(gcnt.sum()))
    genome = t_g[gi]
    strand, read, tpos, hd = strand[rep2], read[rep2], tpos[rep2], hd[rep2]
    # the least distance at each (strand, read, genome, position)
    order = np.lexsort((hd, tpos, genome, read, strand))
    strand, read, genome, tpos, hd = (a[order] for a in
                                      (strand, read, genome, tpos, hd))
    first = np.ones(len(hd), bool)
    first[1:] = ((strand[1:] != strand[:-1]) | (read[1:] != read[:-1])
                 | (genome[1:] != genome[:-1]) | (tpos[1:] != tpos[:-1]))
    strand, read, genome, hd = strand[first], read[first], genome[first], \
        hd[first]
    # per (strand, read, genome): histogram, matches, least distance
    lane_key = np.stack([strand, read, genome], 1)
    ukey, lane = np.unique(lane_key, axis=0, return_inverse=True)
    lane = lane.reshape(-1)
    nl = len(ukey)
    hist = np.zeros((nl, X))
    np.add.at(hist, (lane, hd), 1.0)
    match = hist.sum(1)
    hmin = np.full(nl, NO_MATCH)
    np.minimum.at(hmin, lane, hd)
    ls, lr, lg = ukey[:, 0], ukey[:, 1], ukey[:, 2]
    keep = hmin <= filt[ls, lr]
    ls, lr, lg, hist, match = ls[keep], lr[keep], lg[keep], hist[keep], \
        match[keep]
    uc = P - match                      # every position holds a k-mer
    d, v = solve(hist, uc, rho[lg], p, dtype, dev)
    return choose(ls, lr, lg, genome_se[lg], hist, match, uc, d, v, n), rho


def solve(hist, uc, rho, p: dict, dtype, dev):
    """Brent's ML distance and likelihood of each lane, in dtype."""
    if len(uc) == 0:
        return np.zeros(0), np.zeros(0)
    H, U, R = (_tensor(a, dtype, dev) for a in (hist, uc, rho))
    x, fx = llh.brent(lambda d: llh.llh(d, H, U, R, p["k"], p["h"], p["th"]),
                      len(uc), dtype, dev)
    return (x.to(torch.float64).cpu().numpy(),
            fx.to(torch.float64).cpu().numpy())


def choose(ls, lr, lg, lse, hist, match, uc, d, v, n: int):
    """summarize_matches: per read, the forward lanes in leaf order then
    the reverse ones; the last lane of least d is the closest; a genome
    matched on both strands keeps its reverse lane unless that is farther,
    or as far with fewer matches; the closest lane stands for its genome.
    Returns (lanes, closest) as leaf_lanes documents."""
    order = np.lexsort((lse, ls, lr))
    chosen = {}
    closest = np.full(n, -1)
    best = np.full(n, np.inf)
    for j in order:
        b, g = int(lr[j]), int(lg[j])
        if d[j] <= best[b]:
            best[b] = d[j]
            closest[b] = j
        o = chosen.get((b, g))
        if o is not None and ls[j] == 1 and (
                d[j] > d[o] or (d[j] == d[o] and match[j] < match[o])):
            continue
        chosen[(b, g)] = j
    for b in range(n):
        if closest[b] >= 0:
            chosen[(b, int(lg[closest[b]]))] = closest[b]
    keys = sorted(chosen)
    idx = np.array([chosen[kk] for kk in keys], np.int64)
    lanes = dict(read=lr[idx], genome=lg[idx], hist=hist[idx],
                 match=match[idx], uc=uc[idx], d=d[idx], v=v[idx])
    pos_of = {j: i for i, j in enumerate(idx.tolist())}
    return lanes, np.array([pos_of.get(int(c), -1) for c in closest])


def dist_rows(lanes, names, genome_names) -> Dict[str, dict]:
    """report_distances with krepp's defaults (every match, no filter):
    read name -> {genome name: d}, empty for the read's NA row."""
    out = {nm: {} for nm in names}
    for j in range(len(lanes["read"])):
        out[names[lanes["read"][j]]][genome_names[lanes["genome"][j]]] = \
            float(lanes["d"][j])
    return out


def place_rows(lanes, closest, rho, names, genome_names, tree: Tree, P: int,
               p: dict, dtype, dev) -> Dict[str, dict]:
    """report_placement with krepp's defaults (multi, chi-square filter,
    tau 2) on the index's own tree: read name -> {edge number: (pendant,
    distal, likelihood, lwr, distance)} for every read placed."""
    k, h, th = p["k"], p["h"], p["th"]
    se_of = {tree.name[se]: se for se in tree.leaves()}
    leaf_se = np.array([se_of[g] for g in genome_names])
    X = th + 1
    # ancestors of each leaf with the weight of its matches there
    chains = {}
    for se in tree.leaves():
        chain, w, a = [], 1.0, tree.parent[se]
        while a:
            w /= len(tree.children[a])
            chain.append((a, w))
            a = tree.parent[a]
        chains[se] = chain
    reads = lanes["read"]
    starts = np.searchsorted(reads, np.arange(len(names) + 1))
    todo = []                       # aggregated nodes to solve
    plan = []
    for b in range(len(names)):
        lo, hi = starts[b], starts[b + 1]
        c = closest[b]
        if hi == lo or c < 0:
            continue
        if lanes["hist"][c, : TAU + 1].sum() <= 1.0:
            continue
        if hi - lo == 1:
            plan.append((b, None))
            continue
        agg = {}
        nodes = []
        for j in range(lo, hi):
            se = int(leaf_se[lanes["genome"][j]])
            nodes.append((se, j, None))
            for a, w in chains[se]:
                e = agg.get(a)
                if e is None:
                    e = agg[a] = [np.zeros(X), 0.0, 0.0]
                e[0] += lanes["hist"][j] * w
                e[1] += lanes["match"][j] * w
                e[2] = max(e[2], rho[lanes["genome"][j]])
        for a, (hs, mt, rh) in agg.items():
            if hs[: TAU + 1].sum() > 1.0:
                nodes.append((a, None, len(todo)))
                todo.append((hs, P - mt, rh))
        plan.append((b, nodes))
    if todo:
        td, tv = solve(np.array([t[0] for t in todo]),
                       np.array([t[1] for t in todo]),
                       np.array([t[2] for t in todo]), p, dtype, dev)
    out = {}
    for b, nodes in plan:
        c = closest[b]
        rows = {}
        if nodes is None:               # one genome matched
            rows[int(leaf_se[lanes["genome"][c]])] = (
                1.0, lanes["d"][c], lanes["v"][c])
        else:
            cands = []
            for se, j, t in nodes:
                if j is not None:
                    if lanes["hist"][j, : TAU + 1].sum() <= 1.0:
                        continue
                    d, v = lanes["d"][j], lanes["v"][j]
                else:
                    d, v = td[t], tv[t]
                if tree.parent[se] == 0:
                    continue
                cands.append((se, d, v))
            if cands:
                chisq = _chisq(np.array([x[1] for x in cands]),
                               lanes["hist"][c], lanes["uc"][c],
                               rho[lanes["genome"][c]], lanes["v"][c], k, h,
                               th, dtype, dev)
                lw = {i: math.exp(-chisq[i] / 2)
                      for i in range(len(cands)) if chisq[i] < CHISQ}
                tot = sum(lw.values())
                for i, x in lw.items():
                    se, d, v = cands[i]
                    rows[se] = (x / tot, d, v)
        if rows:
            out[names[b]] = {se - 1: _fields(tree, se, *x)
                             for se, x in rows.items()}
    return out


def _chisq(d, hist_c, uc_c, rho_c, v_c, k, h, th, dtype, dev):
    """2 (llh(d | the closest genome's counts) - its own optimum)."""
    n = len(d)
    f = llh.llh(_tensor(d, dtype, dev),
                _tensor(np.tile(hist_c, (n, 1)), dtype, dev),
                _tensor(np.full(n, uc_c), dtype, dev),
                _tensor(np.full(n, rho_c), dtype, dev), k, h, th)
    v = _tensor(np.full(n, v_c), dtype, dev)
    return (2.0 * (f - v)).to(torch.float64).cpu().numpy()


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float64)).to(device=dev,
                                                          dtype=dtype)


def _fields(tree: Tree, se: int, lwr: float, d: float, v: float):
    """The five numbers of a jplace row (src/query.hpp:197-204)."""
    blen = tree.blen[se]
    pend = 0.0 if math.isnan(blen) else blen / 2.0
    jc = -0.75 * math.log(1.0 - (4.0 / 3.0) * d) if d < 0.75 else math.nan
    return (jc - pend, pend, -v, lwr, d)
