"""Data-parallel index build: genome winnowing spread over several devices.

Port of krepp_tpu/parallel/build.py. As there, the build

  * cuts every contig into halo-overlapped tiles (the single-device
    chunked winnower's own `winnow_device.contig_tiles`, where the original
    repeats that code as `_contig_tiles`: each emit position is computed
    by exactly one tile with its full minimizer window in view),
  * winnows batches of tiles data-parallel across the devices,
  * merges per-contig HLL registers and per-genome entries on the host and
    feeds the shared sort-and-group union (index/build.py).

Tiles are independent, so no collective and no process group is needed:
`devices` is a list of torch devices, a batch of D * TILE_GROUP tiles is cut
into D pieces, and each piece is one `winnow_device` call on its device (a
CUDA call returns before its kernels end, so the D pieces overlap).

Results are bit-identical to the sequential build: identical tile
semantics, identical HLL register maxima, identical (row, residual) sets.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import resolve_device
from ..core import winnow_device as wd
from ..core.hll import genome_rho
from ..index.build import (BuiltIndex, _prepare_tree,
                           build_index_from_extracted)
from ..params import IndexParams
from ..tree.newick import Tree


def mesh_devices(n: int, device="cuda", what: Optional[str] = None) -> List:
    """The first n devices of kind `device` ("cuda": cuda:0 .. cuda:n-1,
    and fewer than n cards raises naming the count; "cpu": the host n
    times, which exercises the sharding without a card). `what` names the
    request in the errors (default "--mesh n")."""
    import torch

    what = what or f"--mesh {n}"
    dev = resolve_device(device)
    if n < 1:
        raise ValueError(f"{what}: the device count must be positive")
    if dev.type == "cpu":
        return [dev] * n
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"{what} asks for {n} CUDA devices but this "
                           f"machine has {have}")
    return [torch.device("cuda", i) for i in range(n)]


def winnow_genomes_sharded(names: List[str], contig_source,
                           params: IndexParams, devices,
                           progress: bool = True):
    """Winnow many genomes across `devices` (a list of torch devices).

    Yields (name, rows, res, rho) in input order: the same contract as the
    sequential extraction loop, bit-identical output."""
    devices = [resolve_device(d) for d in devices]
    D = len(devices)
    w = max(params.w, params.lsh.k)

    # ---- work list: tiles (contig, start, slen, t_lo, final) keyed by
    # (genome, contig), and the contigs that need the host fallback
    tiles = []
    keys: List[Tuple[int, int]] = []
    fallback: Dict[Tuple[int, int], np.ndarray] = {}
    ncontigs: Dict[int, int] = {}
    present = []
    for gi, name in enumerate(names):
        if name not in contig_source:
            continue
        present.append(gi)
        ci = 0
        for codes in contig_source[name]():
            codes = np.asarray(codes, np.uint8)
            if len(codes) < w:
                continue
            specs = wd.contig_tiles(codes, params)
            if specs is None:
                fallback[(gi, ci)] = codes
            else:
                tiles += [(codes,) + s for s in specs]
                keys += [(gi, ci)] * len(specs)
            ci += 1
        ncontigs[gi] = ci

    # per contig: its tiles' (rows, res) pieces in tile order, and the
    # running register maxima
    pieces: Dict[Tuple[int, int], list] = {}
    regs: Dict[Tuple[int, int], tuple] = {}
    group = D * wd.TILE_GROUP
    # one host thread per device: a winnow call waits for its device (the
    # compaction of the unique entries synchronizes), and torch releases
    # the interpreter lock while it does
    with ThreadPoolExecutor(D) as pool:
        for g0 in range(0, len(tiles), group):
            batch = tiles[g0: g0 + group]
            per = -(-len(batch) // D)
            parts = [(batch[d * per: (d + 1) * per], dev)
                     for d, dev in enumerate(devices)
                     if batch[d * per: (d + 1) * per]]
            outs = pool.map(
                lambda a: wd.winnow_tiles_host(a[0], params, a[1]), parts)
            for key, (rows, res, c1, c2) in zip(
                    keys[g0: g0 + group], (o for part in outs for o in part)):
                pieces.setdefault(key, []).append((rows, res))
                if key in regs:
                    c1 = np.maximum(regs[key][0], c1)
                    c2 = np.maximum(regs[key][1], c2)
                regs[key] = (c1, c2)

    for key, codes in fallback.items():
        rows, res, c1, c2 = wd.host_fallback(codes, params, devices[0])
        pieces[key] = [(rows, res)]
        regs[key] = (c1, c2)

    def contig_result(key):
        parts = pieces.pop(key)
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts])) + regs.pop(key)

    for done, gi in enumerate(present, 1):
        name = names[gi]
        rows, res, rho = genome_rho(
            (contig_result((gi, ci)) for ci in range(ncontigs[gi])),
            from_registers=True)
        if progress:
            print(f"Leaf node: {name}\tsize: {len(rows)}\t"
                  f"progress: {done}/{len(present)} (mesh x{D})",
                  file=sys.stderr)
        yield name, rows, res, rho


def build_index_sharded(input_map, params: IndexParams,
                        tree: Optional[Tree], devices,
                        progress: bool = True) -> BuiltIndex:
    """Multi-device build front end; bit-identical to build_index.
    `devices`: a list of torch devices (see mesh_devices)."""
    from ..io.fastx import read_genome_codes

    names = [n for n, _ in input_map]
    path_of = dict(input_map)
    sources = {n: (lambda p=path_of[n]: read_genome_codes(p))
               for n in names if n in path_of}
    tree, ftree, leaf_se = _prepare_tree(names, tree)
    extracted = winnow_genomes_sharded(names, sources, params, devices,
                                       progress=progress)
    return build_index_from_extracted(names, extracted, params, tree,
                                      ftree, leaf_se)
