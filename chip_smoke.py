#!/usr/bin/env python3
"""Smoke test of krepp_tpu_torch (the PyTorch/CUDA port) on one CUDA card.

    python3 chip_smoke.py        # needs one card

Drives the port's paths, `index`, `sketch`, `dist`, `place` and `seek`
through its CLI on generated worlds and the probe microbenchmark, and
checks them:

  1. device: CUDA must be available; prints the card and its power limit;
     `krepp_tpu` and `jax` are blocked from import for the whole run, and
     the run fails at its end if either got into sys.modules;
  2. build: compiles the CUDA kernels from the checkout, one nvcc per
     source, all started together (the five C host libraries build at
     first use in the phases that need them);
  3. kernels vs plain: probe_hist_packed, probe_hist_tiles, hdist_chunk
     and dma_gather against their plain torch versions on the card,
     bit-equal, at the main path's shapes and edge shapes (row spans that
     are not 16-byte aligned, N = 1, every leaf set, leaf S - 1 alone),
     with median times from CUDA events beside the bound: the least bytes
     the function must move over the card's 3.35 TB/s; for dma_gather
     `tab[idx]` is the one PyTorch call for the same function, and the
     kernel is also timed on a [32M x 5] table, which the card's L2 cannot
     hold, beside the sector-granular figure (rows fetched in whole
     32-byte sectors), and at the main shape also through its bare
     launcher into an output allocated once (no wrapper's host time
     between launches); the tiles kernel is also timed at its main shape
     with every position dark, where it only moves those bytes;
  3b. (runs after 5 and after 11) each epilogue kernel again on a batch
     of the main path: the arguments of the first probe_hist_packed launch
     of the base world's dist run and of the first probe_hist_tiles launch
     of the wide world's, kept by the wrappers' `keep_next` hook; bit-equal
     to the plain version, kernel time, bound and share;
  4. base world: bench.py's "base" configuration (24 genomes x 500 kbp,
     k=27 h=11 w=35 m=4); writes the genomes as FASTA files, the name ->
     path TSV and the Newick tree, builds the index from them with the
     port's `index` command (host; k-mers/s with the --num-threads used,
     bench.py's "build" cell, the C libraries compiled before the clock
     starts; the k-mer count is checked), writes 65,536
     reads of 150 bp as FASTQ; phases 5, 6, 8, 9, 13, 15, 19 and 20 run on
     the directory the command wrote;
  5. dist through the CLI on cuda: framing, one answer per read, kernel
     launches counted from zero (probe_hist_packed, not the tiles kernel),
     engine mode, overflow re-runs per batch;
  6. the same reads' first 2,048 through the port on the host (--device
     cpu): identical (read, reference) rows, distances within 1e-5;
  7. 5 and 6 again on a sparse-row world (24 x 200 kbp, k=29 h=13 m=4,
     8,192 reads);
  8. dist reads/s on the base world: warm-up, then 3 timed passes;
  9. long reads: 4,096 reads of 400 bp (374 positions) on the base index,
     through probe_hist_tiles; the first 1,024 against the host;
 10. mid world: 48 genomes x 250 kbp at the base parameters (two mask
     words, embed rows), 8,192 reads, through probe_hist_tiles; host check
     on the first 1,024;
 11. wide world: bench.py's "1k" configuration (k=29 h=13 w=35 m=4, 250 kbp
     genomes) with 256 genomes, the most a bitmask index holds (8 mask
     words, 'se' bucket rows), 65,536 reads: dist through the CLI on cuda
     through probe_hist_tiles only, the first 1,024 reads against the host,
     reads/s (warm-up + 3 timed passes), and one profiled pass (device
     busy share, device time by kernel);
 12. the probe microbenchmark (krepp_tpu_torch.tools.probe_microbench) at
     the reference tool's sizes on cuda, its row gather through dma_gather;
 13. place on the base index through the CLI on cuda: the jplace parses,
     each read at most once, the dense stage-3 formulation, through
     probe_hist_packed (not the tiles kernel); its first 2,048 reads
     against --device cpu (the same edges per read; distance, LWR and
     likelihood within one unit of the 5-decimal grid);
 14. the same on the wide index: the lane formulation, through
     probe_hist_tiles; host check on the first 1,024 reads;
 15. place reads/s on base and wide (warm-up + 3 timed passes) and one
     profiled place pass on wide;
 16. many world: bench.py's "1k" configuration at full size (seed 13,
     1,000 genomes x 250 kbp, k=29 h=13 w=35 m=4): no bitmask table, so
     the event probe; 65,536 reads; dist through the CLI on cuda (mode
     event, neither epilogue kernel launched), the first 1,024 reads
     against the host, reads/s (warm-up + 3 timed passes, with tier
     re-runs per pass and peak device memory) and one profiled pass;
 17. place on the many index the same way: the lane formulation, host
     check on the first 1,024 reads, reads/s and one profiled pass;
 18. seek: `sketch` of one generated 5 Mbp genome at the sketch defaults
     (k=26 h=10 w=32 m=4) through the CLI, `seek` of 65,536 reads at 5%
     mutation through the CLI on cuda, the first 2,048 reads against the
     host, reads/s (warm-up + 3 timed passes);
 19. inspect of the base index through the CLI: its framing, and the
     k-mer count its color histogram sums to;
 20. index round trips: base's two --no-frac partials (-r 0, -r 1,
     --partial) built into one directory and base again with
     --export-reference-format (its native files then removed), each
     loaded and queried by dist through the CLI on cuda with the first
     8,192 base reads: the rows of phase 5's base run for those reads
     (same reads, same references, distances within 1e-5); inspect of the
     reference-format directory prints the binary color graph's
     OUTDEGREE histogram;
 21. (last) none of jax, jaxlib, krepp_tpu in sys.modules;
 22. the int64 pieces of the build path on the card against the host's on
     2^20 random inputs, equal element for element: `xur64` (a multiply
     that must wrap mod 2^64), `bp64` at k = 27 and k = 32 (the sign bit)
     and the HyperLogLog ranks;
 23. base through the device winnower: `index` through the CLI with
     KREPP_DEVICE_WINNOW=1 --device cuda on phase 4's FASTA files: the
     directory of phase 4 (the C winnower), file for file; twice, between
     two more C-winnower builds, k-mers/s of each, peak device memory; one
     genome winnowed under the profiler (launches and device time a tile);
 24. the chunked path: `sketch` of phase 18's 5 Mbp genome (five tiles of
     2^20 bases) through the device winnower: phase 18's file, byte for
     byte; seconds and peak device memory;
 25. `index --mesh 1 --device cuda` on base (and `--mesh N` where the
     machine has N > 1 cards): phase 4's directory again; one card too many
     raises naming the count;
 26. sdust: 4 genomes x 50 kbp with planted homopolymers and tandem
     repeats, `index --sdust-t 20 --sdust-w 64` with --device cuda and with
     --device cpu: the same directory; k-mers masked against the unmasked
     build;
 27. a window wider than the C winnower's (w = 4200, ldiff 4174) on two
     1 Mbp genomes (one tile each, 13 doubling passes, some hundreds of
     k-mers), --device cuda against --device cpu: the same directory.
 28. the sharded query engine in process, on the first 16,384 reads of
     base, wide and many (the worlds at full size, the reads cut): base
     dist (probe_hist_packed on the shard), wide dist and place
     (probe_hist_tiles), many dist and place (event lanes across shards)
     and many dist with KREPP_SHARD_DENSE=1 (the dense event probe), each
     through the CLI with `--mesh 1x1` and byte for byte the one-device
     report of the same reads, run just before it; the first launch of
     each epilogue kernel on the shard bit-equal to its plain version
     (phase 3b's hook); warm reads/s of 1x1 beside one device on wide and
     many dist, passes in turn, and each run's peak device memory;
 29. two processes on the one card over gloo (KREPP_NUM_PROCESSES=2,
     KREPP_DIST_BACKEND=gloo), each under the same import block: wide and
     many dist and wide place --tabular with `--mesh 1x2 -o PATH`, so the
     shard merge crosses processes; PATH.rank0 and PATH.rank1
     concatenated (the header once) are the one-device report byte for
     byte; seconds, peak device memory and launches of each rank;
 30. on a machine with N >= 2 cards: wide and many dist with `--mesh 1xN`
     and `2x(N/2)` in process (byte for byte, warm reads/s of 1xN beside
     1x1) and wide dist in two NCCL processes, a card each; on one card
     a line says it was skipped.

Any failure raises (non-zero exit). Each phase prints its seconds. The line
before the last is the kernels JSON (launches: counted over the CLI runs on
cuda of phases 5, 7, 9, 10, 11, 13, 14, 16, 17, 18, 20 and 28-30, the ranks
of other processes included, and for dma_gather over the microbenchmark of
phase 12; the build path of phases 22-27 runs torch ops and no hand-written
kernel, which phases 23-27 check; ms, plain_ms, bound_ms and library_ms at
the main shape of phase 3, batch_ms and batch_bound_ms from phase 3b,
shard_batch_ms and shard_batch_bound_ms from phase 28, dma_gather's cold_ms
and cold_bound_ms on the [32M x 5] table and its launcher_ms through the
bare launcher);
the last line is {"ok": true, "device": {...}}. Without a card it exits 1
and prints no result.
"""

from __future__ import annotations

import contextlib
import importlib.abc
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

BASE = dict(seed=7, nleaves=24, glen=500_000, rate=0.05, k=27, h=11, w=35,
            m=4)                              # bench.py CONFIGS["base"]
BASE_READS = 65536
BASE_KMERS = 1165849                          # PERF.md section 4
ROUND_TRIP_READS = 8192
SPARSE = dict(seed=11, nleaves=24, glen=200_000, rate=0.05, k=29, h=13,
              w=35, m=4)                      # reference-default k, h
SPARSE_READS = 8192
WIDE = dict(seed=13, nleaves=256, glen=250_000, rate=0.05, k=29, h=13, w=35,
            m=4)                              # bench.py "1k", 256 genomes
WIDE_READS = 65536
MID = dict(seed=17, nleaves=48, glen=250_000, rate=0.05, k=27, h=11, w=35,
           m=4)
MID_READS = 8192
MANY = dict(seed=13, nleaves=1000, glen=250_000, rate=0.05, k=29, h=13, w=35,
            m=4)                              # bench.py "1k", not cut
MANY_READS = 65536
SEEK_SEED = 19
SEEK_GLEN = 5_000_000
SEEK_READS = 65536
SEEK_KMERS = 624980                           # PERF.md section 4
SDUST = dict(seed=23, nleaves=4, glen=50_000, rate=0.05, k=27, h=11, w=35,
             m=4)
SDUST_FLAGS = ["--sdust-t", "20", "--sdust-w", "64"]   # NCBI dustmasker's
WINDOW = dict(seed=29, nleaves=2, glen=1_000_000, rate=0.05, k=27, h=11,
              w=4200, m=4)            # w - k + 1 = 4174 > the C winnower's 4096
WINDOW_KMERS = 498
LONG_READS = 4096
LONG_LEN = 400
CPU_READS = 2048
WIDE_CPU_READS = 1024
DIST_TOL = 1e-5                               # one unit of the output grid
ROW_RE = re.compile(r"[^\t]+\t[^\t]+\t(\d+\.\d{5}|NaN)")
SEEK_ROW_RE = re.compile(r"[^\t]+\t(\d+\.\d{5}|NaN)")
KERNELS = ("probe_hist_packed", "probe_hist_tiles", "hdist_chunk",
           "dma_gather")
EPILOGUES = {"probe_hist_packed", "probe_hist_tiles"}
COPY_ONLY = "main shape, every position dark (copy only)"
COLD_GATHER = "[32M x 5] n=4M"                # a table the L2 cannot hold
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
BLOCKED = ("jax", "jaxlib", "krepp_tpu")
REPLACES = {  # the Pallas TPU kernel bodies each CUDA kernel replaces
    "probe_hist_packed": "krepp_tpu/query/pallas_kernels.py:210",
    "probe_hist_tiles": "krepp_tpu/query/pallas_kernels.py:93",
    "hdist_chunk": "krepp_tpu/query/pallas_kernels.py:28",
    "dma_gather": "tools/probe_microbench.py:157",
}
MESH_READS = 16384            # reads a world in the sharded phases 28-30
# (world, command, flags, epilogue kernel, engine mode, environment) of the
# in-process `--mesh 1x1` runs of phase 28, each against one device
MESH_RUNS = (
    ("base", "dist", [], "probe_hist_packed", "hybrid", None),
    ("wide", "dist", [], "probe_hist_tiles", "hybrid", None),
    ("wide", "place", [], "probe_hist_tiles", "hybrid", None),
    ("many", "dist", [], None, "event", None),
    ("many", "dist", [], None, "event", {"KREPP_SHARD_DENSE": "1"}),
    ("many", "place", [], None, "event", None),
)
# the runs of several processes (phases 29, 30), one batch each, so that
# the rank files concatenated are the one-device report
RANK_RUNS = (
    ("wide", "dist", [], "probe_hist_tiles", "hybrid"),
    ("many", "dist", [], None, "event"),
    ("wide", "place", ["--tabular"], "probe_hist_tiles", "hybrid"),
)
CHILD_TIMEOUT_S = 300         # each process of a multi-process run
# a rank of a multi-process run: the CLI under the same import block, then
# one JSON line (exit code, seconds, peak device memory, kernel launches)
CHILD = """\
import json, sys, time
import chip_smoke
sys.meta_path.insert(0, chip_smoke.BlockReference())
import torch
from krepp_tpu_torch import cli
from krepp_tpu_torch.query import kernels
t0 = time.time()
rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc, "seconds": time.time() - t0,
                  "peak": torch.cuda.max_memory_allocated(),
                  "launches": {k: getattr(kernels, k).launches
                               for k in chip_smoke.KERNELS},
                  "imported": chip_smoke.reference_modules()}))
sys.exit(rc)
"""


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class BlockReference(importlib.abc.MetaPathFinder):
    """Refuses to import JAX or the JAX package: the port stands alone."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked: the port imports nothing "
                              "of it")
        return None


def reference_modules():
    return sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)


def phase(n, msg: str) -> None:
    print(f"[{n}] {msg}", flush=True)


@contextlib.contextmanager
def timed(n, name: str):
    t0 = time.time()
    yield
    phase(n, f"{name}: {time.time() - t0:.1f} s")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_median_ms(fn, reps: int = 10, warmup: int = 3,
                   launches: int = 10) -> float:
    """Median over reps of the time of one call, each taken as a run of
    `launches` calls between two CUDA events over their count: the card
    stays busy while the host prepares the next call, so a wrapper's host
    time is not counted as the kernel's."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _compare(label: str, got, want, main: bool, kernel, ref, args,
             dark: bool = False, library=None, moved=None, tag=3):
    """Bit-equality of a kernel's outputs with its plain version's. At the
    main shape also: the kernel's and the plain version's time, the bound
    (`moved` bytes, by default every tensor argument read once and every
    output written once, over the device memory rate) and, where `library`
    is given, the time of that one PyTorch call for the same function."""
    import torch

    torch.cuda.synchronize()
    err = max((int((g.long() - w.long()).abs().max()) if g.numel() else 0)
              for g, w in zip(got, want))
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{kernel.__name__} != plain at {label} (max abs err {err})")
    check(dark or bool((want[-1] < 255).any()),
          f"no matches planted at {label}")
    line = f"{kernel.__name__} {label}: bit-equal"
    if not main:
        phase(tag, line)
        return None
    if moved is None:
        moved = nbytes(*(a for a in args if isinstance(a, torch.Tensor)),
                       *want)
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    ms = cuda_median_ms(lambda: kernel(*args))
    plain_ms = cuda_median_ms(lambda: ref(*args), reps=3, warmup=1,
                              launches=1)
    library_ms = None if library is None else cuda_median_ms(library)
    phase(tag, line + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median); bound {bound_ms:.4f} ms ({moved} bytes at 3.35 TB/s), "
          f"{100 * bound_ms / ms:.1f}% of it reached"
          + ("" if library is None else
             f"; one PyTorch call {library_ms:.4f} ms"))
    return dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms)


def sector_granular_ms(width: int, n: int) -> float:
    """The byte bound of an n-row gather with each table row counted in
    the whole 32-byte sectors it touches (the mean over all offsets of a
    4 * width byte row at that stride), in ms."""
    row = 4 * width
    fetched = statistics.mean(32 * ((i * row % 32 + row + 31) // 32)
                              for i in range(32))
    return n * (4 + fetched + row) / HBM_BYTES_PER_S * 1e3


def gather_launcher_ms(tab, idx, rows: int) -> float:
    """dma_gather's time without its wrapper: the library's entry point
    called into an output allocated once (checked equal to tab[idx])."""
    import torch

    from krepp_tpu_torch.query import kernels

    fn = kernels._gather_launcher()
    out = torch.empty((idx.shape[0], tab.shape[1]), dtype=torch.int32,
                      device=tab.device)
    args = (tab.data_ptr(), tab.shape[0], tab.shape[1], idx.data_ptr(),
            idx.shape[0], rows, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(fn(*args) == 0, "bare dma_gather did not launch")
    check(torch.equal(out, tab[idx.long()]), "bare dma_gather != tab[idx]")
    ms = cuda_median_ms(lambda: fn(*args))
    return ms


def kernels_vs_plain():
    """Phase 3: bit-equality at the main and edge shapes; times at main."""
    import numpy as np
    import torch

    from krepp_tpu_torch.query import kernels
    from krepp_tpu_torch.testing import epilogue_inputs, tiles_inputs

    def dev(arrays):
        return tuple(None if a is None else torch.from_numpy(
            a.view(np.int32) if a.dtype == np.uint32 else a).cuda()
            for a in arrays)

    rng = np.random.default_rng(3)
    result = {}
    packed = [  # (label, N, P, C0, S, th, dark)
        ("main N=32768 P=166 C0=2 S=24 X=5", 32768, 166, 2, 24, 4, False),
        ("odd N=777", 777, 166, 2, 24, 4, False),
        ("P=255", 1000, 255, 2, 24, 4, False),
        ("S=32", 1000, 166, 2, 32, 4, False),
        ("C0=1", 1000, 166, 1, 24, 4, False),
        ("X=6", 1000, 166, 2, 24, 5, False),
        ("dark", 1000, 166, 2, 24, 4, True),
        # row spans that start off a 16-byte line, one row, few rows
        ("P=1", 1000, 1, 2, 24, 4, False),
        ("P=122", 1000, 122, 2, 24, 4, False),
        ("N=1", 1, 166, 2, 24, 4, False),
        ("N=3169 S=1 X=1", 3169, 33, 2, 1, 0, False),
        ("every leaf", 1000, 166, 2, 32, 4, False, "dense"),
        ("leaf S-1 alone", 1000, 166, 2, 24, 4, False, "last"),
    ]
    for i, (label, N, P, C0, S, th, dark, *sets) in enumerate(packed):
        args = dev(epilogue_inputs(rng, N, P, C0, S, th, dark, *sets)) + (
            th, C0, S)
        r = _compare(label, kernels.probe_hist_packed(*args),
                     kernels.probe_hist_packed_ref(*args), i == 0,
                     kernels.probe_hist_packed,
                     kernels.probe_hist_packed_ref, args, dark)
        result.setdefault("probe_hist_packed", r)
    # the main path pads 150-bp reads to 192 bases (P = 192 - k + 1) and
    # 400-bp reads to 448
    tiles = [  # (label, N, P, C0, W, S, th, flavor, dark)
        ("main N=32768 P=164 C0=2 W=8 S=256 X=5 se", 32768, 164, 2, 8, 256,
         4, "se", False),
        ("P=122", 32768, 122, 2, 8, 256, 4, "se", False),
        ("odd N=777", 777, 164, 2, 8, 256, 4, "se", False),
        ("W=2 S=48 embed", 2000, 166, 2, 2, 48, 4, "embed", False),
        ("W=1 P=374 embed", 2000, 374, 2, 1, 24, 4, "embed", False),
        ("W=1 P=422 embed", 2000, 422, 2, 1, 24, 4, "embed", False),
        ("X=7", 2000, 164, 2, 8, 256, 6, "se", False),
        ("S=33", 2000, 164, 2, 2, 33, 4, "se", False),
        ("C0=1", 2000, 164, 1, 3, 70, 4, "se", False),
        ("dark", 2000, 164, 2, 8, 256, 4, "se", True),
        # every position dark at the main shape: nothing to count, so the
        # time is that of moving the bytes of the bound
        (COPY_ONLY, 32768, 164, 2, 8, 256, 4, "se", True),
        # row spans that start off a 16-byte line, one row, few rows
        ("P=1 S=255", 2000, 1, 2, 8, 255, 4, "se", False),
        ("P=166", 2000, 166, 2, 8, 256, 4, "se", False),
        ("P=255 embed", 500, 255, 2, 8, 256, 4, "embed", False),
        ("N=1", 1, 164, 2, 8, 256, 4, "se", False),
        ("N=3169 P=1000", 3169, 1000, 1, 1, 24, 4, "se", False),
        ("X=21 (th 20)", 500, 164, 2, 2, 40, 20, "embed", False),
        ("every leaf", 2000, 164, 2, 8, 256, 4, "se", False, "dense"),
        ("every leaf embed S=255", 500, 166, 2, 8, 255, 4, "embed", False,
         "dense"),
        ("leaf S-1 alone", 2000, 164, 2, 8, 256, 4, "se", False, "last"),
        ("leaf S-1 alone S=33", 2000, 122, 2, 2, 33, 4, "embed", False,
         "last"),
    ]
    for i, (label, N, P, C0, W, S, th, flavor, dark,
            *sets) in enumerate(tiles):
        args = dev(tiles_inputs(rng, N, P, C0, W, S, th, flavor, dark, 97,
                                *sets)) + (th, C0, W, S)
        r = _compare(label, kernels.probe_hist_tiles(*args),
                     kernels.probe_hist_tiles_ref(*args),
                     i == 0 or label == COPY_ONLY,
                     kernels.probe_hist_tiles, kernels.probe_hist_tiles_ref,
                     args, dark)
        if label == COPY_ONLY:
            result["probe_hist_tiles"]["copy_only_ms"] = r["ms"]
        else:
            result.setdefault("probe_hist_tiles", r)
    hdist = [("main N=1000003 C=16", 1000003, 16, 4), ("N=1537 C=4", 1537, 4, 4),
             ("C=1 th=6", 4099, 1, 6)]
    for i, (label, N, C, th) in enumerate(hdist):
        res = rng.integers(0, 2 ** 32, N, dtype=np.uint32)
        enc = rng.integers(0, 2 ** 32, (N, C), dtype=np.uint32)
        near = rng.random(N) < 0.3          # planted near matches
        enc[near, 0] = res[near] ^ np.uint32(1 << 3)
        cnt = rng.integers(0, C + 1, N, dtype=np.int32)
        args = dev((res, enc, cnt)) + (th,)
        r = _compare(label, kernels.hdist_chunk(*args),
                     kernels.hdist_chunk_ref(*args), i == 0,
                     kernels.hdist_chunk, kernels.hdist_chunk_ref, args)
        result.setdefault("hdist_chunk", r)
    gather = [  # (label, nrows, width, n, rows per block)
        ("main [2M x 5] n=1M tile 256", 2 << 20, 5, 1 << 20, 256),
        ("tile 512", 2 << 20, 5, 1 << 20, 512),
        ("odd n=1000003", 2 << 20, 5, 1000003, 256),
        ("width 1", 2 << 20, 1, 1 << 20, 256),
        ("width 9", 1 << 20, 9, 1000003, 512),
        (COLD_GATHER, 32 << 20, 5, 4 << 20, 256),
        ("n=0", 1000, 5, 0, 256),
        # the tiling's edges: one row and an odd count of rows a tile (runs
        # that start off a 16-byte line), the most rows, n below one tile,
        # a row of more words than a block has threads
        ("tile 1", 1 << 20, 5, 100003, 1),
        ("tile 3", 1 << 20, 5, 1000003, 3),
        ("tile 1024", 2 << 20, 5, 1000003, 1024),
        ("width 9 tile 1024", 1 << 20, 9, 1000003, 1024),
        ("width 4", 2 << 20, 4, 1000003, 256),
        ("n=100", 2 << 20, 5, 100, 256),
        ("width 9000 n=37", 4096, 9000, 37, 256),
    ]
    for i, (label, nrows, width, n, rows) in enumerate(gather):
        tab = torch.randint(-2 ** 31, 2 ** 31, (nrows, width),
                            dtype=torch.int32, device="cuda")
        idx = torch.randint(0, nrows, (n,), dtype=torch.int32,
                            device="cuda")
        r = _compare(label, (kernels.dma_gather(tab, idx, rows),),
                     (kernels.dma_gather_ref(tab, idx, rows),),
                     i == 0 or label == COLD_GATHER,
                     kernels.dma_gather, kernels.dma_gather_ref,
                     (tab, idx, rows), dark=True,     # no match counts
                     library=lambda: tab[idx],
                     # the rows the indices name, not the whole table
                     moved=n * 4 + 2 * n * width * 4)
        if r is not None:
            sector_ms = sector_granular_ms(width, n)
            phase(3, f"dma_gather {label}: sector-granular figure "
                     f"{sector_ms:.4f} ms (rows fetched in whole 32-byte "
                     f"sectors), {100 * sector_ms / r['ms']:.1f}% of it "
                     f"reached")
        if i == 0:
            r["launcher_ms"] = gather_launcher_ms(tab, idx, rows)
            phase(3, f"dma_gather {label}: {r['launcher_ms']:.4f} ms through "
                     f"the bare launcher (another method than `kernel` "
                     f"above: output allocated once, no wrapper)")
        if label == COLD_GATHER:
            result["dma_gather"].update(cold_ms=r["ms"],
                                        cold_bound_ms=r["bound_ms"],
                                        cold_library_ms=r["library_ms"])
        else:
            result.setdefault("dma_gather", r)
        del tab, idx
    return result


def kept_batch(name: str, world: str, kstats: dict, key: str = "batch",
               tag="3b"):
    """Phase 3b: the epilogue kernel `name` on the arguments its wrapper
    kept from the first launch of the `world` world's dist run: bit-equal
    to the plain version; time, bound and share as in phase 3, kept in
    kstats[name] under `key`_ms etc."""
    import torch

    from krepp_tpu_torch.query import kernels

    kernel = getattr(kernels, name)
    ref = getattr(kernels, name + "_ref")
    args = kernel.kept
    check(args is not None and not kernel.keep_next,
          f"{name} kept no launch of the {world} world")
    kernel.kept = None
    want = ref(*args)
    N, P, width = args[2].shape
    hits = float(want[0].sum()) / (N * P)
    r = _compare(f"batch of the {world} world N={N} P={P} width={width} "
                 f"S={want[0].shape[1]} X={want[0].shape[2]}, "
                 f"{float(args[1].float().mean()):.3f} of positions light, "
                 f"{hits:.3f} leaf hits per position", kernel(*args), want,
                 True, kernel, ref, args, tag=tag)
    kstats[name].update({f"{key}_ms": r["ms"], f"{key}_plain_ms": r["plain_ms"],
                         f"{key}_bound_ms": r["bound_ms"],
                         f"{key}_max_abs_err": r["max_abs_err"]})
    del args, want
    torch.cuda.empty_cache()


def make_world(cfg: dict, root: str, tag: str):
    """Index of a generated world, saved under root; returns (index path,
    genomes, k-mers, seconds)."""
    from krepp_tpu_torch.index.artifact import save_native
    from krepp_tpu_torch.testing import build_world_index

    t0 = time.time()
    built, genomes, _ = build_world_index(**cfg,
                                          num_threads=os.cpu_count() or 1)
    idx = os.path.join(root, f"idx_{tag}")
    save_native(built, idx)
    return idx, genomes, built.nkmers, time.time() - t0


def index_cli(argv, seed: int, threads: int):
    """`index` through cli.main in this process (on the host with the C
    winnower unless argv or KREPP_DEVICE_WINNOW ask for a device path);
    returns (k-mers indexed, seconds)."""
    from krepp_tpu_torch import cli

    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--seed", str(seed), "--num-threads", str(threads),
                       "index"] + argv)
    dt = time.time() - t0
    check(rc == 0, f"index returned {rc}")
    said = re.search(r"Total number of k-mers indexed: (\d+)", err.getvalue())
    check(said is not None, "index did not print its k-mer count")
    return int(said.group(1)), dt


@contextlib.contextmanager
def device_winnower():
    """KREPP_DEVICE_WINNOW=1 (the variable krepp_tpu reads) for the block:
    `index` and `sketch` winnow on --device instead of in C."""
    os.environ["KREPP_DEVICE_WINNOW"] = "1"
    try:
        yield
    finally:
        del os.environ["KREPP_DEVICE_WINNOW"]


@contextlib.contextmanager
def no_kernel_launched(n, what: str):
    """The build path runs torch ops only: no hand-written kernel may be
    launched inside the block, and it must have allocated on the card (the
    C winnower would not). Prints the peak device memory of the block."""
    import torch

    from krepp_tpu_torch.query import kernels

    for name in KERNELS:
        getattr(kernels, name).launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    yield
    torch.cuda.synchronize()
    counts = {name: getattr(kernels, name).launches for name in KERNELS}
    check(not any(counts.values()), f"{what} launched {counts}")
    peak = torch.cuda.max_memory_allocated()
    check(peak > 0, f"{what} allocated nothing on the card")
    phase(n, f"{what}: peak device memory {peak / 2 ** 30:.3f} GiB, no "
             f"hand-written kernel launched")


def same_directory(n, label: str, want_dir: str, got_dir: str):
    """Two index directories hold the same files: each byte for byte,
    except that an .npz (a zip, whose bytes could differ in its headers)
    that differs in bytes must hold the same arrays with the same dtypes."""
    import filecmp

    import numpy as np

    names = sorted(os.listdir(want_dir))
    check(names == sorted(os.listdir(got_dir)),
          f"{label}: {sorted(os.listdir(got_dir))} != {names}")
    by_bytes = 0
    for name in names:
        a, b = os.path.join(want_dir, name), os.path.join(got_dir, name)
        if filecmp.cmp(a, b, shallow=False):
            by_bytes += 1
            continue
        check(name.endswith(".npz"), f"{label}: {name} differs")
        za, zb = np.load(a), np.load(b)
        check(sorted(za.files) == sorted(zb.files),
              f"{label}: {name} holds other arrays")
        for key in za.files:
            check(za[key].dtype == zb[key].dtype
                  and np.array_equal(za[key], zb[key]),
                  f"{label}: {name}[{key}] differs")
    phase(n, f"{label}: {len(names)} files identical ({by_bytes} byte for "
             f"byte, {len(names) - by_bytes} array for array)")


def lsh_flags(cfg: dict):
    return ["-k", str(cfg["k"]), "-h", str(cfg["h"]), "-w", str(cfg["w"]),
            "-m", str(cfg["m"])]


def build_base(n: int, root: str, card: str):
    """The base world as files (FASTA per genome, name -> path TSV, Newick
    tree) and its index built from them by the port's `index` command.
    Returns (index path, genomes, k-mers, (TSV path, tree path))."""
    import numpy as np

    from krepp_tpu_torch.core import (native_colorize, native_extract,
                                      native_sort)
    from krepp_tpu_torch.io import native as native_fastx
    from krepp_tpu_torch.testing import make_world_codes, write_world_files

    # the C libraries `index` uses compile at first use: before the clock
    t0 = time.time()
    for mod in (native_fastx, native_extract, native_sort, native_colorize):
        mod.get_lib()
    phase(n, f"C libraries of the build (reader, winnower, sort, colorizer)"
             f" compiled or found in {time.time() - t0:.2f} s")
    nwk, genomes = make_world_codes(
        np.random.default_rng(BASE["seed"]), nleaves=BASE["nleaves"],
        glen=BASE["glen"], rate=BASE["rate"])
    files = write_world_files(os.path.join(root, "base_refs"), nwk, genomes)
    idx = os.path.join(root, "idx_base")
    threads = os.cpu_count() or 1
    nk, dt = index_cli(["-i", files[0], "-o", idx, "-t", files[1]]
                       + lsh_flags(BASE), BASE["seed"], threads)
    check(nk == BASE_KMERS, f"index built {nk} k-mers, want {BASE_KMERS}")
    check(sorted(os.listdir(idx)) == ["arrays.npz", "meta.json",
                                      "reflist.txt", "tree.nwk"],
          f"index wrote {sorted(os.listdir(idx))}")
    nbases = sum(len(c) for contigs in genomes.values() for c in contigs)
    phase(n, f"`index` through the CLI (host, --num-threads {threads}): "
             f"{nk} k-mers from {nbases} bases in {dt:.2f} s, "
             f"{nk / dt:.1f} k-mers/s, {nbases / dt:.1f} bases/s on the "
             f"host of {card}")
    return idx, genomes, nk, files


def write_reads(genomes, seed: int, n: int, rlen: int, ncpu: int, root: str,
                tag: str):
    """n reads of rlen bp at 5% mutation as FASTQ, and the first ncpu of
    them as a second file; returns both paths."""
    import numpy as np

    from krepp_tpu_torch.testing import sample_read_codes, write_fastq

    reads = sample_read_codes(np.random.default_rng(seed), genomes, n,
                              rlen=rlen, mut=0.05)
    fq = os.path.join(root, f"{tag}.fq")
    write_fastq(fq, reads)
    fq_cpu = os.path.join(root, f"{tag}_cpu.fq")
    write_fastq(fq_cpu, reads[:ncpu])
    return fq, fq_cpu


def run_cli(argv):
    """cli.main in this process; returns (rc, stats dict from --verbose)."""
    from krepp_tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--verbose"] + argv)
    text = err.getvalue()
    sys.stderr.write(text)
    stats = json.loads(text.split(f"{argv[0]} stats: ", 1)[1]
                       .splitlines()[0])
    return rc, stats


def counted_run(argv, launched, total: dict):
    """run_cli with every kernel count set to 0 just before and read just
    after: `launched` must have run and the other epilogue kernel not; with
    launched None (the event probe and seek, which run no kernel) neither
    epilogue kernel may run. Adds the counts to `total`; returns (stats,
    counts, seconds)."""
    from krepp_tpu_torch.query import kernels

    for name in KERNELS:
        getattr(kernels, name).launches = 0
    t0 = time.time()
    rc, stats = run_cli(argv)
    dt = time.time() - t0
    counts = {name: getattr(kernels, name).launches for name in KERNELS}
    check(rc == 0, f"cli returned {rc}")
    if launched is None:
        check(not any(counts[e] for e in EPILOGUES),
              f"an epilogue kernel was launched on this path: {counts}")
    else:
        other = (EPILOGUES - {launched}).pop()
        check(counts[launched] > 0,
              f"{launched} was not launched on this path")
        check(counts[other] == 0, f"{other} was launched on this path")
    for name, c in counts.items():
        total[name] += c
    return stats, counts, dt


def read_rows(path: str):
    with open(path) as f:
        lines = f.read().splitlines()
    check(lines[0].startswith("# software: krepp\tversion: v0.8.3"
                              "\tinvocation :"), f"bad header in {path}")
    check(lines[1] == "SEQ_ID\tREFERENCE_NAME\tDIST",
          f"bad column line in {path}")
    for row in lines[2:]:
        check(ROW_RE.fullmatch(row) is not None, f"bad row {row!r}")
    return lines[2:]


def dist_on_card(n: int, idx: str, fq: str, out: str, nreads: int,
                 launched, layout: tuple, total: dict, mode: str = "hybrid"):
    """dist through the CLI on cuda with every kernel count set to 0 just
    before and read just after: `launched` must run (None: no epilogue
    kernel), the other epilogue kernel must not, the engine mode must be
    `mode` and (hflavor, W) `layout`. Adds the counts to `total`."""
    stats, counts, dt = counted_run(["dist", "-q", fq, "-i", idx, "-o", out,
                                     "--device", "cuda"], launched, total)
    rows = read_rows(out)
    nids = len({r.split("\t", 1)[0] for r in rows})
    check(nids == nreads, f"{nids} reads answered of {nreads}")
    check(stats["mode"] == mode, f"engine mode {stats['mode']}")
    check((stats["hflavor"], stats["W"]) == layout,
          f"bucket rows {stats['hflavor']}, W={stats['W']}; want {layout}")
    phase(n, f"dist on cuda: {nreads} reads, {len(rows)} rows, "
             f"{dt:.2f} s with index load; mode={stats['mode']}, "
             f"hflavor={stats['hflavor']}, W={stats['W']}, launches={counts}, "
             f"overflow re-runs per batch={stats['escalations']}")


def gpu_vs_cpu(n: int, idx: str, fq_cpu: str, out_gpu: str, out_cpu: str,
               ncpu: int):
    """The first ncpu reads through --device cpu: the same rows."""
    rc, _ = run_cli(["dist", "-q", fq_cpu, "-i", idx, "-o", out_cpu,
                     "--device", "cpu"])
    check(rc == 0, f"cpu cli returned {rc}")
    same_rows(n, f"cuda vs cpu on {ncpu} reads",
              first_reads(read_rows(out_gpu), ncpu), read_rows(out_cpu))


def first_reads(rows, nreads: int):
    """The rows of reads r0 .. r{nreads - 1}."""
    keep = {f"r{i}" for i in range(nreads)}
    return [r for r in rows if r.split("\t", 1)[0] in keep]


def same_rows(n, label: str, got_rows, want_rows):
    """Two dist reports hold the same (read, reference) pairs, with
    distances within DIST_TOL."""
    def keyed(rows):
        out = {}
        for r in rows:
            sid, ref, d = r.split("\t")
            out[(sid, ref)] = float(d)
        return out

    g, c = keyed(got_rows), keyed(want_rows)
    check(g.keys() == c.keys(), f"row sets differ: {len(g.keys() ^ c.keys())}"
                                " (read, reference) pairs")
    worst = max((abs(g[k] - c[k]) for k in g
                 if not (math.isnan(g[k]) and math.isnan(c[k]))), default=0.0)
    check(worst <= DIST_TOL, f"distance differs by {worst}")
    ndiff = sum(a != b for a, b in zip(got_rows, want_rows))
    phase(n, f"{label}: {len(c)} rows identical as sets, max |dist diff| "
             f"{worst:g}, rows differing in bytes {ndiff}")


def throughput(n: int, name: str, idx: str, fq: str, card: str,
               cmd: str = "dist"):
    """dist or place reads/s (index loaded once): a warm-up, then 3 timed
    passes, with the tier re-runs of each pass and the peak device memory
    (tables included). Returns a function running one more pass."""
    import torch

    from krepp_tpu_torch.index.artifact import load_index
    from krepp_tpu_torch.query.dist import DistConfig, run_dist
    from krepp_tpu_torch.query.engine import QueryEngine
    from krepp_tpu_torch.query.place import PlaceConfig, run_place

    eng = QueryEngine(load_index(idx), 4, device="cuda")

    def one_pass(stats=None):
        with open(os.devnull, "w") as sink:
            if cmd == "place":
                return run_place(eng.di, fq, sink, "smoke", PlaceConfig(),
                                 engine_factory=lambda di, th: eng,
                                 stats=stats)
            return run_dist(eng.di, fq, sink, "smoke", DistConfig(),
                            engine_factory=lambda di, th: eng, stats=stats)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    reruns = []
    for rep in range(4):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nr = one_pass(stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rep:
            rates.append(nr / dt)
            reruns.append(sum(stats["escalations"]))
            phase(n, f"pass {rep}: {nr / dt:.1f} reads/s ({dt:.3f} s) "
                     f"on {card}")
    med = statistics.median(rates)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    phase(n, f"{cmd} {name}: median {med:.1f} reads/s, spread "
             f"{max(rates) / min(rates):.3f}x (max/min of 3), tier re-runs "
             f"per pass {reruns} over {len(stats['escalations'])} batches, "
             f"peak device memory {peak:.3f} GiB, mode {stats['mode']} on "
             f"{card}")
    return one_pass


def profile_pass(n: int, one_pass):
    """One pass under torch.profiler: wall time, device busy time and the
    device time of the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    phase(n, f"profiled pass: {wall * 1e3:.1f} ms wall (profiler on), "
             f"{busy:.3f} ms device time ({100 * busy / (wall * 1e3):.1f}% "
             f"busy), {launches} cudaLaunchKernel")
    ours = [e for e in events if any(k in e.key for k in KERNELS)
            and e not in top]
    for e in top + ours:
        phase(n, f"  {e.self_device_time_total / 1e3:9.3f} ms "
                 f"x{e.count:<6d} {e.key[:90]}")


def microbench(n: int, total: dict):
    """The ported probe microbenchmark at the reference tool's sizes; its
    row-gather section must launch dma_gather."""
    from krepp_tpu_torch.query import kernels
    from krepp_tpu_torch.tools import probe_microbench

    for name in KERNELS:
        getattr(kernels, name).launches = 0
    buf = io.StringIO()
    probe_microbench.run("cuda", out=buf)
    launches = kernels.dma_gather.launches
    for line in buf.getvalue().splitlines():
        phase(n, line)
    check(launches > 0, "the microbenchmark did not launch dma_gather")
    total["dma_gather"] += launches
    phase(n, f"dma_gather launches: {launches}")


def read_jplace(path: str, nreads: int):
    """Parse a jplace; checks the query count (nreads) and that no read
    appears twice. Returns {read: [row, ...]}."""
    with open(path) as f:
        doc = json.load(f)
    check(doc["version"] == 3 and len(doc["fields"]) == 6,
          f"bad jplace framing in {path}")
    check(doc["metadata"]["num_queries"] == str(nreads),
          f"num_queries {doc['metadata']['num_queries']} != {nreads}")
    by_read = {}
    for e in doc["placements"]:
        (name,) = e["n"]
        check(name not in by_read, f"read {name} placed twice")
        check(len(e["p"]) > 0 and all(len(r) == 6 for r in e["p"]),
              f"bad placement rows for {name}")
        by_read[name] = e["p"]
    return by_read


def place_on_card(n: int, idx: str, fq: str, out: str, nreads: int,
                  launched, formulation: str, total: dict,
                  mode: str = "hybrid"):
    """place through the CLI on cuda: a parsable jplace, each read at most
    once, the expected engine mode, stage-3 formulation and epilogue kernel
    (None: none)."""
    stats, counts, dt = counted_run(["place", "-q", fq, "-i", idx, "-o", out,
                                     "--device", "cuda"], launched, total)
    check(stats["mode"] == mode, f"engine mode {stats['mode']}")
    check(stats["formulation"] == formulation,
          f"stage-3 formulation {stats['formulation']}, want {formulation}")
    placed = read_jplace(out, nreads)
    check(len(placed) > nreads // 2, f"only {len(placed)} of {nreads} reads "
                                     "placed")
    nrows = sum(len(p) for p in placed.values())
    phase(n, f"place on cuda: {nreads} reads, {len(placed)} placed, {nrows} "
             f"rows, {dt:.2f} s with index load; mode={stats['mode']}, "
             f"formulation={stats['formulation']}, "
             f"hflavor={stats['hflavor']}, W={stats['W']}, "
             f"launches={counts}, tier re-runs per batch="
             f"{stats['escalations']}")


def place_vs_host(n: int, idx: str, fq_cpu: str, out_gpu: str, nreads: int,
                  out_cpu: str, ncpu: int):
    """The first ncpu reads through --device cpu: the same reads placed on
    the same edges; distance, LWR and likelihood within one unit of the
    5-decimal grid."""
    rc, _ = run_cli(["place", "-q", fq_cpu, "-i", idx, "-o", out_cpu,
                     "--device", "cpu"])
    check(rc == 0, f"cpu cli returned {rc}")
    cpu = read_jplace(out_cpu, ncpu)
    keep = {f"r{i}" for i in range(ncpu)}
    gpu = {r: p for r, p in read_jplace(out_gpu, nreads).items() if r in keep}
    check(gpu.keys() == cpu.keys(),
          f"placed read sets differ: {len(gpu.keys() ^ cpu.keys())} reads")
    worst = 0
    ndiff = nrows = 0
    for r, crows in cpu.items():
        g = {row[0]: row for row in gpu[r]}
        c = {row[0]: row for row in crows}
        check(g.keys() == c.keys(), f"read {r}: edges {sorted(g)} on cuda, "
                                    f"{sorted(c)} on the host")
        for e, crow in c.items():
            nrows += 1
            ndiff += g[e] != crow
            for j in (3, 4, 5):              # likelihood, LWR, distance
                if not (math.isnan(g[e][j]) and math.isnan(crow[j])):
                    units = abs(round(g[e][j] * 1e5) - round(crow[j] * 1e5))
                    worst = max(worst, units)
    check(worst <= 1, f"a field differs by {worst} units of 1e-5")
    phase(n, f"cuda vs cpu on {ncpu} reads: {len(cpu)} placed, {nrows} rows "
             f"on the same edges, max diff {worst} x 1e-5, rows differing in "
             f"bytes {ndiff}")


def read_seek_rows(path: str, nreads: int):
    """The seek report's framing and rows: one row per read, in order."""
    with open(path) as f:
        lines = f.read().splitlines()
    check(lines[0].startswith("# software: krepp\tversion: v0.8.3"
                              "\tinvocation :"), f"bad header in {path}")
    check(lines[1] == "SEQ_ID\tDIST", f"bad column line in {path}")
    rows = lines[2:]
    check(len(rows) == nreads, f"{len(rows)} seek rows for {nreads} reads")
    for row in rows:
        check(SEEK_ROW_RE.fullmatch(row) is not None, f"bad row {row!r}")
    return rows


def seek_on_card(n: int, sk: str, fq: str, out: str, total: dict):
    """seek through the CLI on cuda (no kernel on its path; the direct
    bucket-row table for a shallow sketch)."""
    stats, counts, dt = counted_run(["seek", "-q", fq, "-i", sk, "-o", out,
                                     "--device", "cuda"], None, total)
    check(stats["mode"] == "direct", f"seek mode {stats['mode']}")
    rows = read_seek_rows(out, SEEK_READS)
    found = sum(not r.endswith("\tNaN") for r in rows)
    check(found > SEEK_READS // 2, f"only {found} reads found in the sketch")
    phase(n, f"seek on cuda: {SEEK_READS} reads, {found} found, {dt:.2f} s "
             f"with sketch load; mode={stats['mode']}, "
             f"batches={stats['batches']}, launches={counts}")


def seek_vs_host(n: int, sk: str, fq_cpu: str, out_gpu: str, out_cpu: str,
                 ncpu: int):
    """The first ncpu reads through --device cpu: the same rows, distances
    within 1e-5."""
    rc, _ = run_cli(["seek", "-q", fq_cpu, "-i", sk, "-o", out_cpu,
                     "--device", "cpu"])
    check(rc == 0, f"cpu cli returned {rc}")
    cpu = read_seek_rows(out_cpu, ncpu)
    gpu = read_seek_rows(out_gpu, SEEK_READS)[:ncpu]
    worst = 0.0
    for g, c in zip(gpu, cpu):
        (gn, gd), (cn, cd) = g.split("\t"), c.split("\t")
        check(gn == cn and (gd == "NaN") == (cd == "NaN"),
              f"seek rows differ: {g!r} on cuda, {c!r} on the host")
        if gd != "NaN":
            worst = max(worst, abs(float(gd) - float(cd)))
    check(worst <= DIST_TOL, f"seek distance differs by {worst}")
    phase(n, f"cuda vs cpu on {ncpu} reads: same rows, max |dist diff| "
             f"{worst:g}, rows differing in bytes "
             f"{sum(g != c for g, c in zip(gpu, cpu))}")


def seek_throughput(n: int, sk: str, fq: str, card: str):
    """seek reads/s (sketch loaded once): a warm-up, then 3 timed passes."""
    import torch

    from krepp_tpu_torch.index.artifact import load_sketch_reference
    from krepp_tpu_torch.query.seek import run_seek

    sketch = load_sketch_reference(sk)
    rates = []
    for rep in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with open(os.devnull, "w") as sink:
            nr = run_seek(sketch, fq, sink, "smoke", device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rep:
            rates.append(nr / dt)
            phase(n, f"pass {rep}: {nr / dt:.1f} reads/s ({dt:.3f} s) "
                     f"on {card}")
    phase(n, f"seek: median {statistics.median(rates):.1f} reads/s, spread "
             f"{max(rates) / min(rates):.3f}x (max/min of 3) on {card}")


def sketch_world(n: int, root: str):
    """One generated SEEK_GLEN-bp genome as FASTA, sketched through the CLI
    at the sketch defaults; its reads as FASTQ. Returns (sketch, reads,
    first CPU_READS reads)."""
    import numpy as np

    from krepp_tpu_torch import cli

    genome = np.random.default_rng(SEEK_SEED).integers(
        0, 4, SEEK_GLEN).astype(np.uint8)
    fa = os.path.join(root, "target.fna")
    with open(fa, "wb") as f:
        f.write(b">target\n" + np.frombuffer(b"ACGT", np.uint8)[genome]
                .tobytes() + b"\n")
    sk = os.path.join(root, "target.sk")
    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["sketch", "-i", fa, "-o", sk])
    check(rc == 0, f"sketch returned {rc}")
    kmers = re.search(r"included in the sketch: (\d+)", err.getvalue())
    check(kmers is not None and int(kmers.group(1)) > 0,
          "the sketch holds no k-mers")
    phase(n, f"sketch of a {SEEK_GLEN}-bp genome (k=26 h=10 w=32 m=4): "
             f"{kmers.group(1)} k-mers, {os.path.getsize(sk)} bytes, "
             f"{time.time() - t0:.1f} s")
    fq, fq_cpu = write_reads({"target": [genome]}, SEEK_SEED + 1, SEEK_READS,
                             150, CPU_READS, root, "seek")
    return sk, fq, fq_cpu


def inspect_base(n: int, idx: str, nkmers: int):
    """inspect through the CLI: the backbone tree, one block per resident
    residue, and a k-mer-per-color histogram summing to the index size."""
    from krepp_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["inspect", "-i", idx])
    check(rc == 0, f"inspect returned {rc}")
    lines = out.getvalue().splitlines()
    check(lines[0].startswith("Backbone tree: (") and lines[0].endswith(";"),
          f"bad first line {lines[0][:60]!r}")
    blocks = [ln for ln in lines if ln.startswith("======= Partial index:")]
    check(blocks == ["======= Partial index: 0 =======",
                     "======= Partial index: 1 ======="],
          f"partial blocks {blocks}")
    check("k: 27" in lines and "h: 11" in lines and "m: 4" in lines,
          "the parameters are missing from the block")
    mers = sum(int(key) * int(cnt) for r, kind, key, cnt in
               (ln.split("\t") for ln in lines if "\tMER_COUNT\t" in ln)
               if r == "0")
    check(mers == nkmers, f"MER_COUNT sums to {mers}, index holds {nkmers}")
    phase(n, f"inspect: {len(lines)} lines, {len(blocks)} partial blocks, "
             f"MER_COUNT sums to the {nkmers} k-mers")
    return lines


def head_fastq(src: str, dst: str, nreads: int) -> str:
    """The first nreads records of a FASTQ file as a file of their own."""
    with open(src) as f, open(dst, "w") as g:
        for _ in range(4 * nreads):
            g.write(f.readline())
    return dst


def round_trips(n: int, root: str, files, fq: str, base_out: str, nk: int,
                total: dict):
    """Phase 20: what `index --partial` and `index
    --export-reference-format` write, read back and queried on the card:
    the rows of the plain base index for the first ROUND_TRIP_READS reads."""
    head = head_fastq(fq, os.path.join(root, "base_head.fq"),
                      ROUND_TRIP_READS)
    want = first_reads(read_rows(base_out), ROUND_TRIP_READS)
    threads = os.cpu_count() or 1
    common = ["-i", files[0], "-t", files[1]] + lsh_flags(BASE)

    parts = os.path.join(root, "idx_base_parts")
    counts = [index_cli(common + ["-o", parts, "--no-frac", "-r", str(r),
                                  "--partial"], BASE["seed"], threads)
              for r in (0, 1)]
    check(sum(c for c, _ in counts) == nk,
          f"the partials hold {[c for c, _ in counts]} k-mers, not {nk}")
    metas = sorted(x for x in os.listdir(parts) if x.startswith("meta"))
    check(len(metas) == 2 and "meta.json" not in metas,
          f"--partial wrote {metas}")
    phase(n, f"two --no-frac partials: {[c for c, _ in counts]} k-mers in "
             f"{[round(dt, 2) for _, dt in counts]} s, {metas}")

    refd = os.path.join(root, "idx_base_ref")
    rk, rdt = index_cli(common + ["-o", refd, "--export-reference-format"],
                        BASE["seed"], threads)
    check(rk == nk, f"the reference-format build holds {rk} k-mers")
    for name in ("meta.json", "arrays.npz", "reflist.txt", "tree.nwk"):
        os.remove(os.path.join(refd, name))
    kept = sorted(os.listdir(refd))
    check({x.split("-")[0] for x in kept} >= {"cmer", "crecord", "inc",
                                              "metadata", "reflist", "tree"},
          f"--export-reference-format wrote {kept}")
    phase(n, f"reference format: {rk} k-mers in {rdt:.2f} s (with the "
             f"native files, removed now), {kept}")

    for tag, d in (("partials", parts), ("reference format", refd)):
        out = os.path.join(root, f"rt_{tag.split()[0]}.tsv")
        dist_on_card(n, d, head, out, ROUND_TRIP_READS, "probe_hist_packed",
                     ("embed", 1), total)
        same_rows(n, f"{tag} vs the base index on {ROUND_TRIP_READS} reads",
                  read_rows(out), want)
    lines = inspect_base(n, refd, nk)
    check(any("\tOUTDEGREE_COUNT\t" in ln for ln in lines),
          "inspect of the reference-format index has no OUTDEGREE rows")


def int64_pieces(n: int):
    """Phase 22: xur64, bp64 and the HLL ranks on the card against the
    host's, 2^20 random inputs each, equal element for element."""
    import numpy as np
    import torch

    from krepp_tpu_torch.core import codec, minimizer, winnow_device

    rng = np.random.default_rng(22)
    N = 1 << 20
    h = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, N))
    h[:4] = torch.tensor([0, -1, 2 ** 63 - 1, -2 ** 63])
    want = minimizer.xur64(h)
    got = minimizer.xur64(h.cuda()).cpu()
    check(torch.equal(want, got), "xur64 on the card != the host's")
    check(int(want[0]) == 0 and len(torch.unique(want)) == len(
        torch.unique(h)), "xur64 is not the bijection it should be")
    key = minimizer.ordered_u64(got)
    check(torch.equal(minimizer.less_u64(h.cuda(), got.cuda()).cpu(),
                      minimizer.ordered_u64(h) < key),
          "the unsigned compare on the card != the host's")
    for k in (27, 32):
        codes = torch.from_numpy(rng.choice(
            5, size=N + k - 1, p=[0.2475] * 4 + [0.01]).astype(np.uint8))
        codes[:k] = 3                                   # every bit set
        want = codec.bp64(codes, k)
        got = codec.bp64(codes.cuda(), k).cpu()
        check(torch.equal(want, got) and want.shape == (N,),
              f"bp64 k={k} on the card != the host's")
        check(int(got[0]) == (4 ** k - 1 if k < 32 else -1),
              f"bp64 k={k} of the all-T k-mer is {int(got[0])}")
    zlo = torch.from_numpy(rng.integers(0, 2 ** 32, N))
    zlo[:4] = torch.tensor([0, 1, 0xFFFFF, 0x100000])
    want = winnow_device._hll_ranks(zlo)
    got = winnow_device._hll_ranks(zlo.cuda())
    check(all(torch.equal(a, b.cpu()) for a, b in zip(want, got)),
          "HLL ranks on the card != the host's")
    check(want[1][:4].tolist() == [21, 20, 1, 21]
          and int(want[1].min()) == 1 and int(want[1].max()) == 21,
          f"HLL ranks {want[1][:4].tolist()}")
    mask = torch.from_numpy(rng.random(N) < 0.5)
    check(torch.equal(
        winnow_device._hll_registers(zlo[None], mask[None]),
        winnow_device._hll_registers(zlo[None].cuda(),
                                     mask[None].cuda()).cpu()),
        "HLL registers (scatter amax) on the card != the host's")
    phase(n, f"xur64, the unsigned compare, bp64 (k = 27, 32), HLL ranks and "
             f"registers: card == host on {N} inputs each")


def profile_one_genome(n: int, genome, card: str):
    """One base genome through the device winnower under torch.profiler:
    launches and device time of its one batch of tiles."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from krepp_tpu_torch.core import winnow_device
    from krepp_tpu_torch.params import IndexParams, LSHParams

    params = IndexParams(lsh=LSHParams.generate(BASE["k"], BASE["h"],
                                                BASE["m"], seed=BASE["seed"]),
                         w=BASE["w"], r=1, frac=True)
    winnow_device.extract_sequence_mers_device(genome, params, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rows, _, _, _ = winnow_device.extract_sequence_mers_device(
            genome, params, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    t0 = time.perf_counter()
    winnow_device.extract_sequence_mers_device(genome, params, "cuda")
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    phase(n, f"one {len(genome)}-base genome, one tile: {len(rows)} unique "
             f"pairs, {launches} cudaLaunchKernel, {busy:.3f} ms device "
             f"time, {wall * 1e3:.1f} ms wall under the profiler, "
             f"{bare * 1e3:.1f} ms without it, on {card}")
    top = sorted((e for e in events if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:5]
    for e in top:
        phase(n, f"  {e.self_device_time_total / 1e3:9.3f} ms "
                 f"x{e.count:<6d} {e.key[:90]}")


def device_winnowed_base(n: int, root: str, files, idx: str, genome,
                         card: str):
    """Phase 23: base through `index` with the device winnower, between two
    more builds with the C winnower (C, device, device, C): phase 4's
    directory each time, k-mers/s of each."""
    threads = os.cpu_count() or 1
    argv = ["-i", files[0], "-t", files[1]] + lsh_flags(BASE)
    rates = {}
    for tag in ("c1", "device1", "device2", "c2"):
        out = os.path.join(root, f"idx_base_{tag}")
        if tag.startswith("device"):
            with device_winnower(), no_kernel_launched(
                    n, f"`index`, device winnower ({tag[-1]})"):
                nk, dt = index_cli(argv + ["-o", out, "--device", "cuda"],
                                   BASE["seed"], threads)
        else:
            nk, dt = index_cli(argv + ["-o", out], BASE["seed"], threads)
        check(nk == BASE_KMERS, f"{tag} built {nk} k-mers, want {BASE_KMERS}")
        same_directory(n, f"{tag} vs phase 4's directory", idx, out)
        rates[tag] = nk / dt
        phase(n, f"{tag}: {nk} k-mers in {dt:.3f} s, {nk / dt:.1f} k-mers/s "
                 f"(--num-threads {threads}) on {card}")
    phase(n, f"device winnower / C winnower k-mers/s in this call: "
             f"{rates['device2'] / rates['c2']:.3f} (second builds), "
             f"{rates['device1'] / rates['c1']:.3f} (first builds)")
    profile_one_genome(n, genome, card)


def device_winnowed_sketch(n: int, root: str, sk: str, card: str):
    """Phase 24: phase 18's genome sketched through the device winnower
    (five tiles of 2^20 bases, one batch): phase 18's file."""
    import filecmp

    from krepp_tpu_torch import cli

    fa = os.path.join(root, "target.fna")
    out = os.path.join(root, "target_device.sk")
    err = io.StringIO()
    with device_winnower(), no_kernel_launched(
            n, "`sketch`, device winnower"), contextlib.redirect_stderr(err):
        t0 = time.time()
        rc = cli.main(["sketch", "-i", fa, "-o", out, "--device", "cuda"])
        dt = time.time() - t0
    check(rc == 0, f"sketch returned {rc}")
    kmers = re.search(r"included in the sketch: (\d+)", err.getvalue())
    check(kmers is not None and int(kmers.group(1)) == SEEK_KMERS,
          f"the device-winnowed sketch holds {kmers and kmers.group(1)} "
          f"k-mers, want {SEEK_KMERS}")
    check(filecmp.cmp(sk, out, shallow=False),
          "the device-winnowed sketch differs from the C winnower's")
    phase(n, f"`sketch` of the {SEEK_GLEN}-bp genome through the device "
             f"winnower: {SEEK_KMERS} k-mers, the C winnower's file byte for "
             f"byte, {dt:.2f} s on {card}")


def mesh_base(n: int, root: str, files, idx: str, card: str):
    """Phase 25: `index --mesh 1 --device cuda` on base and, on a machine
    with more cards, `--mesh <all of them>`: phase 4's directory; one card
    more than the machine has must raise naming the count."""
    import torch

    have = torch.cuda.device_count()
    argv = ["-i", files[0], "-t", files[1], "--device", "cuda"] \
        + lsh_flags(BASE)
    for ndev in sorted({1, have}):
        out = os.path.join(root, f"idx_base_mesh{ndev}")
        with no_kernel_launched(n, f"`index --mesh {ndev}`"):
            nk, dt = index_cli(argv + ["-o", out, "--mesh", str(ndev)],
                               BASE["seed"], 1)
        check(nk == BASE_KMERS,
              f"--mesh {ndev} built {nk} k-mers, want {BASE_KMERS}")
        same_directory(n, f"--mesh {ndev} vs phase 4's directory", idx, out)
        phase(n, f"`index --mesh {ndev}`: {nk} k-mers in {dt:.3f} s, "
                 f"{nk / dt:.1f} k-mers/s on {card}")
    try:
        index_cli(argv + ["-o", os.path.join(root, "idx_base_mesh_over"),
                          "--mesh", str(have + 1)], BASE["seed"], 1)
    except RuntimeError as e:
        check(f"this machine has {have}" in str(e), f"--mesh {have + 1}: {e}")
        phase(n, f"`index --mesh {have + 1}` raises: {e}")
    else:
        raise SmokeFailure(f"--mesh {have + 1} ran on {have} card(s)")


def card_vs_host_build(n: int, root: str, tag: str, cfg: dict, flags,
                       plant: bool):
    """A generated world through `index` with `flags`, --device cuda
    against --device cpu: the same directory. Returns (k-mers, files)."""
    import numpy as np

    from krepp_tpu_torch.testing import make_world_codes, write_world_files

    rng = np.random.default_rng(cfg["seed"])
    nwk, genomes = make_world_codes(rng, nleaves=cfg["nleaves"],
                                    glen=cfg["glen"], rate=cfg["rate"])
    if plant:   # homopolymers and tandem repeats of 60-200 bases
        for (contig,) in genomes.values():
            for at in range(2000, len(contig) - 300, 6000):
                unit = rng.integers(0, 4, int(rng.integers(1, 5)))
                run = int(rng.integers(60, 200))
                contig[at: at + run] = np.resize(unit, run)
    files = write_world_files(os.path.join(root, f"{tag}_refs"), nwk, genomes)
    argv = ["-i", files[0], "-t", files[1]] + lsh_flags(cfg) + flags
    built = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(root, f"idx_{tag}_{dev}")
        if dev == "cuda":
            said = " ".join(lsh_flags(cfg)[4:6] + flags)
            with no_kernel_launched(n, f"`index {said}` on cuda"):
                built[dev] = index_cli(argv + ["-o", out, "--device", dev],
                                       cfg["seed"], 1)
        else:
            built[dev] = index_cli(argv + ["-o", out, "--device", dev],
                                   cfg["seed"], 1)
    check(built["cuda"][0] == built["cpu"][0] > 0,
          f"{tag}: {built['cuda'][0]} k-mers on cuda, {built['cpu'][0]} on "
          f"the host")
    same_directory(n, f"{tag}: --device cuda vs --device cpu",
                   os.path.join(root, f"idx_{tag}_cpu"),
                   os.path.join(root, f"idx_{tag}_cuda"))
    phase(n, f"{tag}: {cfg['nleaves']} genomes x {cfg['glen']} bases, "
             f"{built['cuda'][0]} k-mers, {built['cuda'][1]:.2f} s on cuda, "
             f"{built['cpu'][1]:.2f} s on the host")
    return built["cuda"][0], files


def build_path_phases(root: str, card: str, idx: str, base_files,
                      base_genome, sk: str):
    """Phases 22-27: the device forms of the build path, against phase 4's
    base directory `idx` and phase 18's sketch `sk`."""
    with timed(22, "int64 pieces, card vs host"):
        int64_pieces(22)

    with timed(23, "base through the device winnower"):
        device_winnowed_base(23, root, base_files, idx, base_genome, card)

    with timed(24, "5 Mbp sketch through the device winnower"):
        device_winnowed_sketch(24, root, sk, card)

    with timed(25, "index --mesh"):
        mesh_base(25, root, base_files, idx, card)

    with timed(26, "sdust"):
        masked, sfiles = card_vs_host_build(26, root, "sdust", SDUST,
                                            SDUST_FLAGS, plant=True)
        plain, _ = index_cli(
            ["-i", sfiles[0], "-t", sfiles[1], "-o",
             os.path.join(root, "idx_sdust_plain")] + lsh_flags(SDUST),
            SDUST["seed"], 1)
        check(0 < masked < plain, f"sdust kept {masked} of {plain} k-mers")
        phase(26, f"sdust masked {plain - masked} of the {plain} k-mers of "
                  f"the unmasked build")

    with timed(27, "a window wider than the C winnower's"):
        nk, _ = card_vs_host_build(27, root, "window", WINDOW, [],
                                   plant=False)
        check(nk == WINDOW_KMERS, f"window built {nk} k-mers, want "
                                  f"{WINDOW_KMERS}")


def paired_rates(n: int, world: str, idx: str, fq: str, card: str, meshes):
    """Warm dist reads/s of one engine per entry of `meshes` (None: one
    device, else DATAxSHARD over the first cards) on the same reads: a
    warm-up pass each, then 3 rounds of one pass each in turn, so that the
    host's drift falls on all alike. Prints the medians and the ratio of
    the second to the first."""
    import torch

    from krepp_tpu_torch.index.artifact import load_index
    from krepp_tpu_torch.parallel.mesh import (ShardedQueryEngine,
                                               make_query_mesh, parse_mesh)
    from krepp_tpu_torch.query.dist import DistConfig, run_dist
    from krepp_tpu_torch.query.engine import QueryEngine

    di = load_index(idx)
    engines = {m: QueryEngine(di, 4, device="cuda") if m is None else
               ShardedQueryEngine(di, make_query_mesh(*parse_mesh(m),
                                                      device="cuda"), 4)
               for m in meshes}
    rates = {m: [] for m in meshes}
    for rep in range(4):
        for m, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with open(os.devnull, "w") as sink:
                nr = run_dist(di, fq, sink, "smoke", DistConfig(),
                              engine_factory=lambda d, th, e=eng: e)
            torch.cuda.synchronize()
            if rep:
                rates[m].append(nr / (time.perf_counter() - t0))
    med = {m: statistics.median(r) for m, r in rates.items()}
    said = {m: "one device" if m is None else f"--mesh {m}" for m in meshes}
    a, b = meshes
    phase(n, f"{world} dist, {MESH_READS} reads, warm, passes in turn: "
          + ", ".join(f"{said[m]} {med[m]:.1f} reads/s (spread "
                      f"{max(r) / min(r):.3f}x)" for m, r in rates.items())
          + f"; {said[b]} / {said[a]} {med[b] / med[a]:.3f}x on {card}")


def card_run(n, label: str, argv, launched, total: dict, mode: str,
             env=None) -> float:
    """counted_run of `argv` on cuda with `env` set for the run only; the
    engine mode must be `mode`. Prints the seconds (index load included),
    the peak device memory and the launches; returns the seconds."""
    import torch

    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        stats, counts, dt = counted_run(argv + ["--device", "cuda"],
                                        launched, total)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(stats["mode"] == mode, f"{label}: engine mode {stats['mode']}")
    phase(n, f"{label}: {dt:.2f} s with index load, peak device memory "
             f"{peak:.3f} GiB, mode={stats['mode']}, launches={counts}, "
             f"tier re-runs per batch={stats['escalations']}")
    return dt


def same_file(n, label: str, got: str, want: str):
    import filecmp

    check(filecmp.cmp(got, want, shallow=False),
          f"{label}: the report differs from one device's")
    with open(got) as f:
        nlines = sum(1 for _ in f)
    phase(n, f"{label}: the one-device report byte for byte ({nlines} "
             f"lines)")


def mesh_in_process(n: int, root: str, worlds: dict, card: str, total: dict,
                    kstats: dict):
    """Phase 28: MESH_RUNS through the CLI with `--mesh 1x1` in process,
    each report byte for byte the one-device report of the same reads; the
    first launch of each epilogue kernel on a shard held against its plain
    version; warm reads/s of 1x1 beside one device on wide and many dist,
    passes in turn. Returns {(world, cmd, *flags): (one-device report,
    seconds)}."""
    from krepp_tpu_torch.query import kernels

    singles = {}

    def single(world, cmd, flags, launched, mode):
        key = (world, cmd, *flags)
        if key not in singles:
            idx, fq = worlds[world]
            out = os.path.join(root, "_".join(("one",) + key))
            singles[key] = (out, card_run(
                n, f"{' '.join(key)} on one device",
                [cmd, "-q", fq, "-i", idx, "-o", out, *flags], launched,
                total, mode))
        return singles[key]

    keep = {"base": "probe_hist_packed", "wide": "probe_hist_tiles"}
    for world, cmd, flags, launched, mode, env in MESH_RUNS:
        want, _ = single(world, cmd, flags, launched, mode)
        idx, fq = worlds[world]
        out = want + ("_mesh_dense" if env else "_mesh")
        label = f"{world} {cmd} --mesh 1x1" + "".join(
            f" {k}={v}" for k, v in (env or {}).items())
        name = keep.pop(world, None) if cmd == "dist" else None
        if name:
            getattr(kernels, name).keep_next = True
        card_run(n, label, [cmd, "-q", fq, "-i", idx, "-o", out, "--mesh",
                            "1x1", *flags], launched, total, mode, env)
        same_file(n, label, out, want)
        if name:
            kept_batch(name, f"{world} (--mesh 1x1, shard 0)", kstats,
                       key="shard_batch", tag=n)
    for world, cmd, flags, launched, mode in RANK_RUNS:
        single(world, cmd, flags, launched, mode)

    for world in ("wide", "many"):
        paired_rates(n, world, *worlds[world], card, (None, "1x1"))
    return singles


def run_ranks(argv, root: str, tag: str, backend: str):
    """argv through the CLI in two processes of one torch.distributed
    group (KREPP_* variables, `backend`), each a CHILD under the import
    block. A process that fails, or a run that outlives CHILD_TIMEOUT_S,
    fails the phase; every process is stopped before this returns.
    Returns (each rank's JSON line with its `stats`, seconds)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    t0 = time.time()
    try:
        for r in range(2):
            env = dict(os.environ, KREPP_COORDINATOR=f"localhost:{port}",
                       KREPP_NUM_PROCESSES="2",
                       KREPP_PROCESS_ID=str(r), KREPP_DIST_BACKEND=backend)
            logs.append(tuple(os.path.join(root, f"{tag}.rank{r}.{s}")
                              for s in ("out", "err")))
            with open(logs[r][0], "w") as out, open(logs[r][1], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", CHILD] + argv, cwd=here, env=env,
                    stdout=out, stderr=err))

        def tail(r):
            with open(logs[r][1]) as f:
                return f.read()[-3000:]

        while any(p.poll() is None for p in procs):
            for r, p in enumerate(procs):
                check(p.poll() in (None, 0),
                      f"{tag}: rank {r} exited {p.poll()}:\n{tail(r)}")
            check(time.time() - t0 < CHILD_TIMEOUT_S,
                  f"{tag}: the processes outlived {CHILD_TIMEOUT_S} s:\n"
                  f"{tail(0)}")
            time.sleep(0.2)
        dt = time.time() - t0
        results = []
        for r, p in enumerate(procs):
            check(p.returncode == 0,
                  f"{tag}: rank {r} exited {p.returncode}:\n{tail(r)}")
            with open(logs[r][0]) as f:
                res = json.loads(f.read().strip().splitlines()[-1])
            with open(logs[r][1]) as f:
                res["stats"] = json.loads(f.read().split(
                    f"{argv[1]} stats: ", 1)[1].splitlines()[0])
            results.append(res)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results, dt


def ranks_on_card(n: int, root: str, worlds: dict, singles: dict,
                  total: dict, backend: str, runs=RANK_RUNS):
    """Phases 29-30: each of `runs` through the CLI in two processes of one
    group over `backend` with --mesh 1x2 and -o: the rank files
    concatenated (their header once) are the one-device report byte for
    byte, the invocation aside; each rank launched the epilogue kernel
    of the path and imported nothing of the reference. Adds the ranks'
    launches to `total`."""
    for world, cmd, flags, launched, mode in runs:
        want, one_dt = singles[(world, cmd, *flags)]
        idx, fq = worlds[world]
        out = os.path.join(root, f"{world}_{cmd}_{backend}")
        label = (f"{world} {' '.join([cmd, *flags])} --mesh 1x2, two "
                 f"processes over {backend}")
        results, wall = run_ranks(
            ["--verbose", cmd, "-q", fq, "-i", idx, "-o", out, "--device",
             "cuda", "--mesh", "1x2", *flags], root, os.path.basename(out),
            backend)
        for r, res in enumerate(results):
            check(not res["imported"], f"{label}: rank {r} imported "
                                       f"{res['imported']}")
            stats, counts = res["stats"], res["launches"]
            check(stats["mode"] == mode and len(stats["escalations"]) == 1,
                  f"{label}: rank {r} ran mode {stats['mode']} in "
                  f"{len(stats['escalations'])} batches")
            if launched is None:
                check(not any(counts[e] for e in EPILOGUES),
                      f"{label}: rank {r} launched {counts}")
            else:
                check(counts[launched] > 0
                      and not counts[(EPILOGUES - {launched}).pop()],
                      f"{label}: rank {r} launched {counts}")
            for name, c in counts.items():
                total[name] += c
        nhead = 3 if cmd == "place" else 2
        got = []
        for r in range(2):
            with open(f"{out}.rank{r}") as f:
                lines = f.read().splitlines(keepends=True)
            check(len(lines) > nhead, f"{label}: rank {r} wrote no rows")
            got += lines if r == 0 else lines[nhead:]
        with open(want) as f:
            ref = f.read().splitlines(keepends=True)
        check(got[0].split("invocation :")[0]
              == ref[0].split("invocation :")[0] and got[1:] == ref[1:],
              f"{label}: the rank files differ from one device's report")
        phase(n, f"{label}: the rank files are the one-device report byte "
                 f"for byte ({len(ref)} lines, the invocation aside); both "
                 f"processes {wall:.2f} s (start, index load, run): "
                 f"{MESH_READS / wall:.1f} reads/s beside one device's "
                 f"{MESH_READS / one_dt:.1f} in process with index load "
                 f"({one_dt:.2f} s); per rank: CLI "
                 f"{[round(r['seconds'], 2) for r in results]} s, peak device"
                 f" memory {[round(r['peak'] / 2 ** 30, 3) for r in results]}"
                 f" GiB, launches {[r['launches'] for r in results]}, tier "
                 f"re-runs {[r['stats']['escalations'] for r in results]}")


def multi_card(n: int, root: str, worlds: dict, singles: dict, card: str,
               total: dict):
    """Phase 30, on a machine with N >= 2 cards: wide and many dist with
    --mesh 1xN and 2x(N/2) in process, byte for byte the one-device
    report, warm reads/s of 1xN beside 1x1 (passes in turn); wide dist in
    two NCCL processes, a card each."""
    import torch

    have = torch.cuda.device_count()
    if have < 2:
        phase(n, f"skipped: this machine has {have} card; meshes over "
                 f"several cards in one process, and NCCL ranks (a card "
                 f"each), need two or more")
        return
    for world, cmd, flags, launched, mode in RANK_RUNS[:2]:
        want, _ = singles[(world, cmd, *flags)]
        idx, fq = worlds[world]
        for mesh in (f"1x{have}", f"2x{have // 2}"):
            out = f"{want}_mesh{mesh}"
            label = f"{world} {cmd} --mesh {mesh}"
            card_run(n, label, [cmd, "-q", fq, "-i", idx, "-o", out,
                                "--mesh", mesh], launched, total, mode)
            same_file(n, label, out, want)
        paired_rates(n, world, idx, fq, card, ("1x1", f"1x{have}"))
    ranks_on_card(n, root, worlds, singles, total, "nccl", RANK_RUNS[:1])


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    sys.meta_path.insert(0, BlockReference())
    try:
        import krepp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the root "
              "of a checkout", file=sys.stderr)
        return 1

    t_start = time.time()
    card = card_line()
    print(card)
    phase(1, f"device: {torch.cuda.get_device_name(0)} x "
             f"{torch.cuda.device_count()}; torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}; imports of {', '.join(BLOCKED)} "
             "blocked")
    check(not reference_modules(),
          f"loaded before the port: {reference_modules()}")
    from krepp_tpu_torch import resolve_device
    from krepp_tpu_torch.csrc.build import build

    resolve_device("cuda")
    t0 = time.time()
    for name, lib in zip(KERNELS, build(KERNELS)):
        with open(lib + ".log") as f:
            ptxas = [ln.strip() for ln in f
                     if "registers" in ln or "spill" in ln]
        phase(2, f"{name}.cu: " + "; ".join(ptxas))
    phase(2, f"nvcc build of {len(KERNELS)} sources in parallel: "
             f"{time.time() - t0:.2f} s")

    with timed(3, "kernels vs plain"):
        kstats = kernels_vs_plain()
    launches = {name: 0 for name in KERNELS}

    with tempfile.TemporaryDirectory(prefix="krepp_smoke_") as root:
        with timed(4, "base world"):
            idx, bgen, nk, base_files = build_base(4, root, card)
            fq, fq_cpu = write_reads(bgen, BASE["seed"] + 1, BASE_READS, 150,
                                     CPU_READS, root, "base")
            phase(4, f"base world: {BASE_READS} reads written")
        with timed(5, "base dist on cuda"):
            from krepp_tpu_torch.query import kernels

            out_gpu = os.path.join(root, "base_gpu.tsv")
            kernels.probe_hist_packed.keep_next = True
            dist_on_card(5, idx, fq, out_gpu, BASE_READS,
                         "probe_hist_packed", ("embed", 1), launches)
        with timed("3b", "probe_hist_packed on a base batch"):
            kept_batch("probe_hist_packed", "base", kstats)
        with timed(6, "base host check"):
            gpu_vs_cpu(6, idx, fq_cpu, out_gpu,
                       os.path.join(root, "base_cpu.tsv"), CPU_READS)

        with timed(7, "sparse world"):
            sidx, sgen, snk, sdt = make_world(SPARSE, root, "sparse")
            sfq, sfq_cpu = write_reads(sgen, SPARSE["seed"] + 1, SPARSE_READS,
                                       150, CPU_READS, root, "sparse")
            del sgen
            from krepp_tpu_torch.index.artifact import load_index

            check(load_index(sidx).row_ids is not None,
                  "the sparse world did not get a sparse row table")
            phase(7, f"sparse world: {snk} k-mers, row_ids set, "
                     f"{SPARSE_READS} reads, built in {sdt:.1f} s")
            sout = os.path.join(root, "sparse_gpu.tsv")
            dist_on_card(7, sidx, sfq, sout, SPARSE_READS,
                         "probe_hist_packed", ("embed", 1), launches)
            gpu_vs_cpu(7, sidx, sfq_cpu, sout,
                       os.path.join(root, "sparse_cpu.tsv"), CPU_READS)

        with timed(8, "base reads/s"):
            throughput(8, "base", idx, fq, card)

        with timed(9, "long reads"):
            lfq, lfq_cpu = write_reads(bgen, BASE["seed"] + 2, LONG_READS,
                                       LONG_LEN, WIDE_CPU_READS, root, "long")
            base_genome = bgen["G000"][0]
            del bgen
            lout = os.path.join(root, "long_gpu.tsv")
            dist_on_card(9, idx, lfq, lout, LONG_READS, "probe_hist_tiles",
                         ("embed", 1), launches)
            gpu_vs_cpu(9, idx, lfq_cpu, lout,
                       os.path.join(root, "long_cpu.tsv"), WIDE_CPU_READS)

        with timed(10, "mid world"):
            midx, mgen, mnk, mdt = make_world(MID, root, "mid")
            mfq, mfq_cpu = write_reads(mgen, MID["seed"] + 1, MID_READS, 150,
                                       WIDE_CPU_READS, root, "mid")
            del mgen
            phase(10, f"mid world: {mnk} k-mers, built in {mdt:.1f} s")
            mout = os.path.join(root, "mid_gpu.tsv")
            dist_on_card(10, midx, mfq, mout, MID_READS, "probe_hist_tiles",
                         ("embed", 2), launches)
            gpu_vs_cpu(10, midx, mfq_cpu, mout,
                       os.path.join(root, "mid_cpu.tsv"), WIDE_CPU_READS)

        with timed(11, "wide world"):
            widx, wgen, wnk, wdt = make_world(WIDE, root, "wide")
            wfq, wfq_cpu = write_reads(wgen, WIDE["seed"] + 1, WIDE_READS,
                                       150, WIDE_CPU_READS, root, "wide")
            del wgen
            phase(11, f"wide world: {wnk} k-mers, 256 leaves, built in "
                      f"{wdt:.1f} s")
            wout = os.path.join(root, "wide_gpu.tsv")
            kernels.probe_hist_tiles.keep_next = True
            dist_on_card(11, widx, wfq, wout, WIDE_READS, "probe_hist_tiles",
                         ("se", 8), launches)
            kept_batch("probe_hist_tiles", "wide", kstats)
            gpu_vs_cpu(11, widx, wfq_cpu, wout,
                       os.path.join(root, "wide_cpu.tsv"), WIDE_CPU_READS)
            profile_pass(11, throughput(11, "wide", widx, wfq, card))

        with timed(12, "probe microbenchmark"):
            microbench(12, launches)

        with timed(13, "base place"):
            pout = os.path.join(root, "base_gpu.jplace")
            place_on_card(13, idx, fq, pout, BASE_READS, "probe_hist_packed",
                          "dense", launches)
            place_vs_host(13, idx, fq_cpu, pout, BASE_READS,
                          os.path.join(root, "base_cpu.jplace"), CPU_READS)

        with timed(14, "wide place"):
            wpout = os.path.join(root, "wide_gpu.jplace")
            place_on_card(14, widx, wfq, wpout, WIDE_READS,
                          "probe_hist_tiles", "lanes", launches)
            place_vs_host(14, widx, wfq_cpu, wpout, WIDE_READS,
                          os.path.join(root, "wide_cpu.jplace"),
                          WIDE_CPU_READS)

        with timed(15, "place reads/s"):
            throughput(15, "base", idx, fq, card, cmd="place")
            profile_pass(15, throughput(15, "wide", widx, wfq, card,
                                        cmd="place"))

        with timed(16, "many world dist"):
            nidx, ngen, nnk, ndt = make_world(MANY, root, "many")
            nfq, nfq_cpu = write_reads(ngen, MANY["seed"] + 1, MANY_READS,
                                       150, WIDE_CPU_READS, root, "many")
            del ngen
            phase(16, f"many world: {nnk} k-mers, 1000 leaves, built in "
                      f"{ndt:.1f} s")
            nout = os.path.join(root, "many_gpu.tsv")
            dist_on_card(16, nidx, nfq, nout, MANY_READS, None, ("se", 32),
                         launches, mode="event")
            gpu_vs_cpu(16, nidx, nfq_cpu, nout,
                       os.path.join(root, "many_cpu.tsv"), WIDE_CPU_READS)
            profile_pass(16, throughput(16, "many", nidx, nfq, card))

        with timed(17, "many place"):
            npout = os.path.join(root, "many_gpu.jplace")
            place_on_card(17, nidx, nfq, npout, MANY_READS, None, "lanes",
                          launches, mode="event")
            place_vs_host(17, nidx, nfq_cpu, npout, MANY_READS,
                          os.path.join(root, "many_cpu.jplace"),
                          WIDE_CPU_READS)
            profile_pass(17, throughput(17, "many", nidx, nfq, card,
                                        cmd="place"))

        with timed(18, "seek"):
            sk, sfq, sfq_cpu = sketch_world(18, root)
            sout = os.path.join(root, "seek_gpu.tsv")
            seek_on_card(18, sk, sfq, sout, launches)
            seek_vs_host(18, sk, sfq_cpu, sout,
                         os.path.join(root, "seek_cpu.tsv"), CPU_READS)
            seek_throughput(18, sk, sfq, card)

        with timed(19, "inspect"):
            inspect_base(19, idx, nk)

        with timed(20, "index round trips"):
            round_trips(20, root, base_files, fq, out_gpu, nk, launches)

        build_path_phases(root, card, idx, base_files, base_genome, sk)

        worlds = {w: (i, head_fastq(f, os.path.join(root, f"{w}_mesh.fq"),
                                    MESH_READS))
                  for w, i, f in (("base", idx, fq), ("wide", widx, wfq),
                                  ("many", nidx, nfq))}
        with timed(28, "--mesh 1x1 in process"):
            singles = mesh_in_process(28, root, worlds, card, launches,
                                      kstats)
        with timed(29, "two processes on one card over gloo"):
            ranks_on_card(29, root, worlds, singles, launches, "gloo")
        with timed(30, "meshes over several cards"):
            multi_card(30, root, worlds, singles, card, launches)

    check(not reference_modules(),
          f"the run imported {reference_modules()}")
    phase(21, f"none of {', '.join(BLOCKED)} in sys.modules; total "
              f"{time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"krepp_tpu_torch/csrc/{name}.cu",
        "replaces": REPLACES[name], "launches": launches[name],
        **kstats[name]} for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
