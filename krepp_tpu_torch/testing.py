"""Synthetic worlds for the port's tests and chip_smoke.py (numpy only).

JAX-free copy of the code-world half of krepp_tpu/testing.py: the same
generators with the same draws, so a seed gives the same genomes, reads
and index in both packages.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from .index.build import build_index_from_sources
from .params import IndexParams, LSHParams
from .tree.newick import Tree


def mutate_codes(rng, codes: np.ndarray, rate: float) -> np.ndarray:
    mask = rng.random(codes.shape) < rate
    shift = rng.integers(1, 4, size=codes.shape)
    return np.where(mask & (codes < 4), (codes + shift) % 4,
                    codes).astype(np.uint8)


def _world_split(names, seq, depth, rng, rate):
    if len(names) == 1:
        return f"{names[0]}:{0.05 + 0.01 * depth:.4f}", {names[0]: [seq]}
    half = len(names) // 2
    lnwk, lgen = _world_split(names[:half], mutate_codes(rng, seq, rate),
                              depth + 1, rng, rate)
    rnwk, rgen = _world_split(names[half:], mutate_codes(rng, seq, rate),
                              depth + 1, rng, rate)
    lgen.update(rgen)
    return f"({lnwk},{rnwk}):{0.02 + 0.005 * depth:.4f}", lgen


def make_world_codes(rng, nleaves=12, glen=500_000, rate=0.04):
    """Base-code genomes on a balanced tree: (newick, {name: [codes]})."""
    root = rng.integers(0, 4, size=glen).astype(np.uint8)
    names = [f"G{i:03d}" for i in range(nleaves)]
    nwk, genomes = _world_split(names, root, 0, rng, rate)
    return nwk.rsplit(":", 1)[0] + ";", genomes


def sample_read_codes(rng, genomes_codes: Dict[str, List[np.ndarray]], n: int,
                      rlen: int = 150, mut: float = 0.05) -> np.ndarray:
    """[n, rlen] uint8 reads drawn from code genomes, then mutated."""
    gl = [genomes_codes[g][0] for g in sorted(genomes_codes)]
    out = np.empty((n, rlen), np.uint8)
    for i in range(n):
        g = gl[rng.integers(len(gl))]
        start = rng.integers(0, len(g) - rlen)
        out[i] = g[start: start + rlen]
    mask = rng.random(out.shape) < mut
    out = np.where(mask, (out + rng.integers(1, 4, size=out.shape)) % 4,
                   out).astype(np.uint8)
    return out


def build_world_index(seed=0, nleaves=6, glen=2000, rate=0.05,
                      k=27, h=11, w=35, m=4, r=1, frac=True, num_threads=1):
    """Generate a code world and build its index in memory.

    Returns (BuiltIndex, genomes as code arrays, tree)."""
    rng = np.random.default_rng(seed)
    nwk, genomes = make_world_codes(rng, nleaves=nleaves, glen=glen, rate=rate)
    tree = Tree.parse(nwk)
    params = IndexParams(lsh=LSHParams.generate(k, h, m, seed=seed),
                         w=w, r=r, frac=frac)
    names = sorted(genomes)
    sources = {n: (lambda n=n: iter(genomes[n])) for n in names}
    built = build_index_from_sources(names, sources, params, tree,
                                     progress=False, num_threads=num_threads)
    return built, genomes, tree


def write_world_files(root: str, nwk: str,
                      genomes_codes: Dict[str, List[np.ndarray]]
                      ) -> Tuple[str, str]:
    """A code world as the `index` command reads it: one FASTA file per
    genome, the name -> path TSV and the Newick tree, all under root.
    Returns (TSV path, tree path)."""
    os.makedirs(root, exist_ok=True)
    acgt = np.frombuffer(b"ACGTN", np.uint8)
    map_path = os.path.join(root, "map.tsv")
    with open(map_path, "w") as m:
        for name in sorted(genomes_codes):
            path = os.path.join(root, f"{name}.fna")
            with open(path, "wb") as f:
                for i, contig in enumerate(genomes_codes[name]):
                    f.write(f">{name}_c{i}\n".encode()
                            + acgt[contig].tobytes() + b"\n")
            m.write(f"{name}\t{path}\n")
    tree_path = os.path.join(root, "tree.nwk")
    with open(tree_path, "w") as f:
        f.write(nwk + "\n")
    return map_path, tree_path


def write_fastq(path: str, codes: np.ndarray, prefix: str = "r") -> None:
    """[n, L] uint8 code reads -> FASTQ with names {prefix}{i}."""
    seqs = np.frombuffer(b"ACGTN", np.uint8)[codes]
    qual = "I" * codes.shape[1]
    with open(path, "w") as f:
        for i, row in enumerate(seqs):
            f.write(f"@{prefix}{i}\n{row.tobytes().decode()}\n+\n{qual}\n")


def _leaf_words(rng, shape, W, S, leafsets, thin):
    """[*shape, W] u32 leaf-set mask words with no bit at or above S:
    "random" (about half the leaves, with `thin` a quarter in half of the
    words; a tenth of the sets empty), "dense" (every leaf of every word) or
    "last" (leaf S - 1 alone)."""
    top = S - 32 * (W - 1)
    top_bits = np.uint32((1 << top) - 1 if top < 32 else 0xFFFFFFFF)
    if leafsets == "dense":
        m = np.full(shape + (W,), 0xFFFFFFFF, np.uint32)
        m[..., W - 1] = top_bits
        return m
    if leafsets == "last":
        m = np.zeros(shape + (W,), np.uint32)
        m[..., W - 1] = np.uint32(1) << np.uint32(top - 1)
        return m
    if leafsets != "random":
        raise ValueError(f"leafsets {leafsets!r}")
    m = rng.integers(0, 2 ** 32, shape + (W,), dtype=np.uint32)
    if thin:                            # sparse leaf sets as well as dense
        m &= np.where(rng.random(shape + (W,)) < 0.5,
                      rng.integers(0, 2 ** 32, shape + (W,), dtype=np.uint32),
                      np.uint32(0xFFFFFFFF))
    m[..., W - 1] &= top_bits
    m[rng.random(shape) < 0.1] = 0
    return m


def epilogue_inputs(rng, N, P, C0, S, th, dark=False, leafsets="random"):
    """Random probe-epilogue rows with planted near matches, for comparing
    probe_hist_packed with its plain version: (res [N, P] u32, light [N, P]
    bool, d [N, P, 1 + 2*C0] u32 gathered bucket rows with enc_c at column
    1 + 2c and mask_c (S leaf bits) at 2 + 2c). dark=True clears light;
    leafsets as in _leaf_words."""
    res = rng.integers(0, 2 ** 32, (N, P), dtype=np.uint32)
    light = (rng.random((N, P)) < 0.7) & (not dark)
    d = rng.integers(0, 2 ** 32, (N, P, 1 + 2 * C0), dtype=np.uint32)
    for c in range(C0):
        # candidates 0..th+1 bit flips away from the probe residual
        flips = rng.integers(0, th + 2, (N, P))
        enc = res.copy()
        for b in range(th + 1):
            bit = rng.integers(0, 16, (N, P)).astype(np.uint32)
            enc ^= np.where(flips > b, np.uint32(1) << bit, np.uint32(0))
        use = rng.random((N, P)) < 0.6
        d[..., 1 + 2 * c] = np.where(use, enc, d[..., 1 + 2 * c])
        d[..., 2 + 2 * c] = _leaf_words(rng, (N, P), 1, S, leafsets,
                                        False)[..., 0]
    return res, light, d


def tiles_inputs(rng, N, P, C0, W, S, th, flavor="embed", dark=False,
                 nse=97, leafsets="random"):
    """Random inputs of probe_hist_tiles with planted near matches:
    (res [N, P] u32, light [N, P] bool, d [N, P, width] u32 gathered bucket
    rows, mask_tab [nse, W] u32 or None). flavor "embed" puts each
    candidate's W mask words after its enc (width 1 + C0(1+W)); "se" stores
    enc_c at 1 + c and a color id at 1 + C0 + c into mask_tab (width
    1 + 2 C0). Candidates are 0..th+1 bit flips from the residual; about a
    tenth of the masks are all zero (no match); mask bits sit below S.
    dark=True clears light; leafsets as in _leaf_words."""
    res = rng.integers(0, 2 ** 32, (N, P), dtype=np.uint32)
    light = (rng.random((N, P)) < 0.7) & (not dark)

    def masks(shape):
        return _leaf_words(rng, shape, W, S, leafsets, True)

    encs = []
    for _ in range(C0):
        flips = rng.integers(0, th + 2, (N, P))
        enc = res.copy()
        for b in range(th + 1):
            bit = rng.integers(0, 16, (N, P)).astype(np.uint32)
            enc ^= np.where(flips > b, np.uint32(1) << bit, np.uint32(0))
        encs.append(np.where(rng.random((N, P)) < 0.6, enc,
                             rng.integers(0, 2 ** 32, (N, P),
                                          dtype=np.uint32)))
    if flavor == "embed":
        d = rng.integers(0, 2 ** 32, (N, P, 1 + C0 * (1 + W)), dtype=np.uint32)
        for c in range(C0):
            col = 1 + c * (1 + W)
            d[..., col] = encs[c]
            d[..., col + 1: col + 1 + W] = masks((N, P))
        return res, light, d, None
    mask_tab = masks((nse,))
    mask_tab[0] = 0                     # the empty color, as in an index
    d = rng.integers(0, 2 ** 32, (N, P, 1 + 2 * C0), dtype=np.uint32)
    for c in range(C0):
        d[..., 1 + c] = encs[c]
        d[..., 1 + C0 + c] = rng.integers(0, nse, (N, P)).astype(np.uint32)
    return res, light, d, mask_tab


def brent_inputs(rng, shape, th, P=122, keep=0.3):
    """Lanes of brent_llh shaped like stage 2's, for comparing the kernel
    with its plain version: (A, Bx, uc, rho f64 and a bool mask, each of
    `shape`). A lane's read has P positions; a random number of them match
    in classes 0..th (fewer in the higher classes), the rest are unmatched
    (uc). Runs of lanes have no match (A = 0), no unmatched position
    (uc = 0), rho = 1, and A = uc = 0; a `keep` share is selected."""
    n = int(np.prod(shape))
    pvals = 0.5 ** np.arange(th + 1)
    hist = rng.multinomial(rng.integers(0, P + 1, n), pvals / pvals.sum())
    hist = hist.astype(np.float64)
    uc = P - hist.sum(-1)
    rho = rng.uniform(0.05, 1.0, n)
    q = n // 8
    hist[:q] = 0.0
    uc[:q] = P
    uc[q: 2 * q] = 0.0
    rho[2 * q: 3 * q] = 1.0
    hist[3 * q: 3 * q + 4] = 0.0
    uc[3 * q: 3 * q + 4] = 0.0
    A = hist.sum(-1)
    Bx = (hist * np.arange(th + 1)).sum(-1)
    mask = rng.random(n) < keep
    return tuple(a.reshape(shape) for a in (A, Bx, uc, rho, mask))
