#!/usr/bin/env python3
"""Smoke test of krepp_tpu_torch (the PyTorch/CUDA port) on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths, `dist` and `place` through its CLI on generated
worlds and the probe microbenchmark, and checks them:

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
     `tab[idx]` is the one PyTorch call for the same function; the tiles
     kernel is also timed at its main shape with every position dark,
     where it only moves those bytes;
  3b. (runs after 5 and after 11) each epilogue kernel again on a batch
     of the main path: the arguments of the first probe_hist_packed launch
     of the base world's dist run and of the first probe_hist_tiles launch
     of the wide world's, kept by the wrappers' `keep_next` hook; bit-equal
     to the plain version, kernel time, bound and share;
  4. base world: bench.py's "base" configuration (24 genomes x 500 kbp,
     k=27 h=11 w=35 m=4); builds the index, saves it, writes 65,536 reads
     of 150 bp as FASTQ;
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
     k-mer count its color histogram sums to.

Any failure raises (non-zero exit). Each phase prints its seconds. The line
before the last is the kernels JSON (launches: counted over the CLI runs on
cuda of phases 5, 7, 9, 10, 11, 13, 14, 16, 17 and 18, and for dma_gather
over the microbenchmark of phase 12; ms, plain_ms, bound_ms and library_ms
at the main shape of phase 3, batch_ms and batch_bound_ms from phase 3b);
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
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
BLOCKED = ("jax", "jaxlib", "krepp_tpu")
REPLACES = {  # the Pallas TPU kernel bodies each CUDA kernel replaces
    "probe_hist_packed": "krepp_tpu/query/pallas_kernels.py:210",
    "probe_hist_tiles": "krepp_tpu/query/pallas_kernels.py:93",
    "hdist_chunk": "krepp_tpu/query/pallas_kernels.py:28",
    "dma_gather": "tools/probe_microbench.py:157",
}


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
        ("[32M x 5] n=4M", 32 << 20, 5, 4 << 20, 256),
        ("n=0", 1000, 5, 0, 256),
    ]
    for i, (label, nrows, width, n, rows) in enumerate(gather):
        tab = torch.randint(-2 ** 31, 2 ** 31, (nrows, width),
                            dtype=torch.int32, device="cuda")
        idx = torch.randint(0, nrows, (n,), dtype=torch.int32,
                            device="cuda")
        r = _compare(label, (kernels.dma_gather(tab, idx, rows),),
                     (kernels.dma_gather_ref(tab, idx, rows),), i == 0,
                     kernels.dma_gather, kernels.dma_gather_ref,
                     (tab, idx, rows), dark=True,     # no match counts
                     library=lambda: tab[idx],
                     # the rows the indices name, not the whole table
                     moved=n * 4 + 2 * n * width * 4)
        result.setdefault("dma_gather", r)
        del tab, idx
    return result


def kept_batch(name: str, world: str, kstats: dict):
    """Phase 3b: the epilogue kernel `name` on the arguments its wrapper
    kept from the first launch of the `world` world's dist run: bit-equal
    to the plain version; time, bound and share as in phase 3."""
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
                 True, kernel, ref, args, tag="3b")
    kstats[name].update(batch_ms=r["ms"], batch_plain_ms=r["plain_ms"],
                        batch_bound_ms=r["bound_ms"],
                        batch_max_abs_err=r["max_abs_err"])
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
    cpu_rows = read_rows(out_cpu)
    keep = {f"r{i}" for i in range(ncpu)}
    gpu_rows = [r for r in read_rows(out_gpu) if r.split("\t", 1)[0] in keep]

    def keyed(rows):
        out = {}
        for r in rows:
            sid, ref, d = r.split("\t")
            out[(sid, ref)] = float(d)
        return out

    g, c = keyed(gpu_rows), keyed(cpu_rows)
    check(g.keys() == c.keys(), f"row sets differ: {len(g.keys() ^ c.keys())}"
                                " (read, reference) pairs")
    worst = max((abs(g[k] - c[k]) for k in g
                 if not (math.isnan(g[k]) and math.isnan(c[k]))), default=0.0)
    check(worst <= DIST_TOL, f"distance differs by {worst}")
    ndiff = sum(a != b for a, b in zip(gpu_rows, cpu_rows))
    phase(n, f"cuda vs cpu on {ncpu} reads: {len(c)} rows identical "
             f"as sets, max |dist diff| {worst:g}, rows differing in bytes "
             f"{ndiff}")


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
            idx, bgen, nk, dt = make_world(BASE, root, "base")
            fq, fq_cpu = write_reads(bgen, BASE["seed"] + 1, BASE_READS, 150,
                                     CPU_READS, root, "base")
            phase(4, f"base world: {nk} k-mers indexed in {dt:.1f} s, "
                     f"{BASE_READS} reads written")
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

    check(not reference_modules(),
          f"the run imported {reference_modules()}")
    phase(20, f"none of {', '.join(BLOCKED)} in sys.modules; total "
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
