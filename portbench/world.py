"""The benchmark's inputs, made from the seed: genomes on a balanced tree
and reads drawn from them, as base codes 0..3, on the device.

The model is that of the repository's synthetic worlds (the root genome
uniform at random; each child mutates its parent at `rate` per base, a
mutated base moving to one of the three others with equal chance; names
G000, G001, ... split in halves down the tree); here a whole level of the
tree mutates in one call of a torch.Generator, so a world of 1,000
genomes takes well under a second on the card.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

CHUNK = 1 << 27                 # bases a random draw covers at most
ACGT = np.frombuffer(b"ACGT", np.uint8)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def mutate(codes: torch.Tensor, rate: float, gen: torch.Generator):
    """Each base moves to one of the other three at `rate`, in place; one
    uniform draw a base decides both whether and where."""
    flat = codes.view(-1)
    for lo in range(0, flat.numel(), CHUNK):
        c = flat[lo: lo + CHUNK]
        u = torch.rand(c.shape, generator=gen, device=c.device)
        hit = u < rate
        shift = (u / rate * 3).clamp(max=2).to(torch.uint8) + 1
        c.copy_(torch.where(hit, (c + shift) % 4, c))
    return codes


def _newick(lo: int, hi: int, depth: int) -> str:
    if hi - lo == 1:
        return f"G{lo:03d}:{0.05 + 0.01 * depth:.4f}"
    mid = lo + (hi - lo) // 2
    return (f"({_newick(lo, mid, depth + 1)},{_newick(mid, hi, depth + 1)})"
            f":{0.02 + 0.005 * depth:.4f}")


def make_genomes(n: int, glen: int, rate: float, gen: torch.Generator,
                 device) -> Tuple[str, List[str], torch.Tensor]:
    """n genomes of glen bases on a balanced tree: (Newick, names, [n, glen]
    uint8 codes on device, row i named G{i:03d})."""
    out = torch.empty((n, glen), dtype=torch.uint8, device=device)
    seqs = torch.randint(0, 4, (1, glen), generator=gen, device=device,
                         dtype=torch.uint8)
    nodes = [(0, n)]
    while nodes:
        kids = []
        for lo, hi in nodes:
            mid = lo + (hi - lo) // 2
            kids += [(lo, mid), (mid, hi)]
        seqs = mutate(seqs.repeat_interleave(2, dim=0), rate, gen)
        keep = []
        for i, (lo, hi) in enumerate(kids):
            if hi - lo == 1:
                out[lo] = seqs[i]
            else:
                keep.append(i)
        nodes = [kids[i] for i in keep]
        seqs = seqs[keep]
    nwk = _newick(0, n, 0).rsplit(":", 1)[0] + ";"
    return nwk, [f"G{i:03d}" for i in range(n)], out


def draw_reads(source: torch.Tensor, n: int, rlen: int, mut: float,
               gen: torch.Generator) -> torch.Tensor:
    """n reads of rlen bases, each from a uniform genome of source [G, L]
    at a uniform start, then mutated at `mut` per base."""
    G, L = source.shape
    g = torch.randint(0, G, (n,), generator=gen, device=source.device)
    start = torch.randint(0, L - rlen, (n,), generator=gen,
                          device=source.device)
    at = (g * L + start)[:, None] + torch.arange(rlen, device=source.device)
    return mutate(source.view(-1)[at], mut, gen)


def sample(genomes: torch.Tensor, traffic: dict, gen: torch.Generator):
    """The traffic's sample: [reads, read_len] uint8 codes on the host.
    A share `offtarget_share` of the reads (a fixed count) comes from one
    random genome of `offtarget_bp` bases outside the index, at
    `offtarget_error` per base; the rest from the indexed genomes at
    `mutation`; the two kinds are shuffled together."""
    n, rlen = traffic["reads"], traffic["read_len"]
    n_off = round(n * traffic.get("offtarget_share", 0.0))
    parts = [draw_reads(genomes, n - n_off, rlen, traffic["mutation"], gen)]
    if n_off:
        host = torch.randint(0, 4, (1, traffic["offtarget_bp"]),
                             generator=gen, device=genomes.device,
                             dtype=torch.uint8)
        parts.append(draw_reads(host, n_off, rlen,
                                traffic["offtarget_error"], gen))
    reads = torch.cat(parts)
    perm = torch.randperm(n, generator=gen, device=genomes.device)
    return reads[perm].cpu().numpy()


def write_fastq(path: str, reads: np.ndarray) -> List[str]:
    """Write [n, L] codes as FASTQ, reads named r0, r1, ...; returns the
    names."""
    names = [f"r{i}" for i in range(len(reads))]
    qual = b"I" * reads.shape[1]
    seqs = ACGT[reads]
    with open(path, "wb") as f:
        f.write(b"".join(b"@%s\n%s\n+\n%s\n" % (nm.encode(), s.tobytes(), qual)
                         for nm, s in zip(names, seqs)))
    return names
