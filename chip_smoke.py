#!/usr/bin/env python3
"""Smoke test of krepp_tpu_torch (the PyTorch/CUDA port) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, `dist` on a hybrid-mode index, through its
CLI at the size of bench.py's "base" world (24 genomes x 500 kbp, k=27
h=11 w=35 m=4, 65,536 reads of 150 bp), and checks it:

  1. device: CUDA must be available; prints the card and its power limit;
  2. build: compiles the CUDA kernels from the checkout with nvcc;
  3. kernel vs plain: probe_hist_packed against its plain torch version on
     the card, bit-equal, at the main path's shape and edge shapes, with
     median times from CUDA events;
  4. base world: builds the index, saves it, writes the reads as FASTQ;
  5. dist through the CLI on cuda: framing, one answer per read, kernel
     launches counted from zero, engine mode, overflow re-runs per batch;
  6. the same reads' first 2,048 through the port on the host (--device
     cpu): identical (read, reference) rows, distances within 1e-5;
  7. 5 and 6 again on a sparse-row world (24 x 200 kbp, k=29 h=13 m=4,
     8,192 reads);
  8. dist reads/s on the base world: warm-up, then 3 timed passes.

Any failure raises (non-zero exit). The line before the last is the
kernels JSON; the last line is {"ok": true, "device": {...}}. Without a
card it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
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
CPU_READS = 2048
DIST_TOL = 1e-5                               # one unit of the output grid
ROW_RE = re.compile(r"[^\t]+\t[^\t]+\t(\d+\.\d{5}|NaN)")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(n: int, msg: str) -> None:
    print(f"[{n}] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_vs_plain():
    """Phase 3: bit-equality at the main and edge shapes; times at main."""
    import numpy as np
    import torch

    from krepp_tpu_torch.query import kernels
    from krepp_tpu_torch.testing import epilogue_inputs

    rng = np.random.default_rng(3)
    shapes = [  # (label, N, P, C0, S, th, dark)
        ("main", 32768, 166, 2, 24, 4, False),   # 16,384 reads x 2 strands
        ("odd N", 777, 166, 2, 24, 4, False),
        ("P=255", 1000, 255, 2, 24, 4, False),
        ("S=32", 1000, 166, 2, 32, 4, False),
        ("C0=1", 1000, 166, 1, 24, 4, False),
        ("X=6", 1000, 166, 2, 24, 5, False),
        ("dark", 1000, 166, 2, 24, 4, True),
    ]
    result = {}
    for label, N, P, C0, S, th, dark in shapes:
        res, light, d = epilogue_inputs(rng, N, P, C0, S, th, dark)
        args = (torch.from_numpy(res.view(np.int32)).cuda(),
                torch.from_numpy(light).cuda(),
                torch.from_numpy(d.view(np.int32)).cuda())
        got = kernels.probe_hist_packed(*args, th, C0, S)
        want = kernels.probe_hist_packed_ref(*args, th, C0, S)
        torch.cuda.synchronize()
        err = max(int((got[0] - want[0]).abs().max()),
                  int((got[1] - want[1]).abs().max()))
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"kernel != plain at {label} (max abs err {err})")
        check(dark or int(want[0].sum()) > 0, f"no matches planted at {label}")
        line = f"{label}: N={N} P={P} C0={C0} S={S} X={th + 1} bit-equal"
        if label == "main":
            ms = cuda_median_ms(lambda: kernels.probe_hist_packed(
                *args, th, C0, S))
            plain_ms = cuda_median_ms(lambda: kernels.probe_hist_packed_ref(
                *args, th, C0, S), reps=5)
            result = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms)
            line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median)"
        phase(3, line)
    return result


def make_world(cfg: dict, nreads: int, root: str, tag: str):
    """Phase 4/7: index + FASTQ of a generated world; returns the paths."""
    import numpy as np

    from krepp_tpu_torch.index.artifact import save_native
    from krepp_tpu_torch.testing import (build_world_index,
                                         sample_read_codes, write_fastq)

    t0 = time.time()
    built, genomes, _ = build_world_index(**cfg,
                                          num_threads=os.cpu_count() or 1)
    idx = os.path.join(root, f"idx_{tag}")
    save_native(built, idx)
    reads = sample_read_codes(np.random.default_rng(cfg["seed"] + 1),
                              genomes, nreads, rlen=150, mut=0.05)
    fq = os.path.join(root, f"{tag}.fq")
    write_fastq(fq, reads)
    fq_cpu = os.path.join(root, f"{tag}_cpu.fq")
    write_fastq(fq_cpu, reads[:CPU_READS])
    return idx, fq, fq_cpu, built.nkmers, time.time() - t0


def run_cli(argv):
    """cli.main in this process; returns (rc, stats dict from --verbose)."""
    from krepp_tpu_torch import cli

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--verbose"] + argv)
    text = err.getvalue()
    sys.stderr.write(text)
    stats = json.loads(text.split("dist stats: ", 1)[1].splitlines()[0])
    return rc, stats


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


def dist_on_card(n: int, idx: str, fq: str, out: str, nreads: int) -> int:
    """Phase 5: dist through the CLI on cuda; returns the kernel launches."""
    from krepp_tpu_torch.query import kernels

    kernels.probe_hist_packed.launches = 0
    t0 = time.time()
    rc, stats = run_cli(["dist", "-q", fq, "-i", idx, "-o", out,
                         "--device", "cuda"])
    dt = time.time() - t0
    launches = kernels.probe_hist_packed.launches
    check(rc == 0, f"cli returned {rc}")
    rows = read_rows(out)
    nids = len({r.split("\t", 1)[0] for r in rows})
    check(nids == nreads, f"{nids} reads answered of {nreads}")
    check(launches > 0, "probe_hist_packed was not launched on the main path")
    check(stats["mode"] == "hybrid", f"engine mode {stats['mode']}")
    phase(n, f"dist on cuda: {nreads} reads, {len(rows)} rows, "
             f"{dt:.2f} s with index load; mode={stats['mode']}, "
             f"probe_hist_packed launches={launches}, overflow re-runs per "
             f"batch={stats['escalations']}")
    return launches


def gpu_vs_cpu(n: int, idx: str, fq_cpu: str, out_gpu: str, out_cpu: str):
    """Phase 6: the first CPU_READS reads through --device cpu."""
    rc, _ = run_cli(["dist", "-q", fq_cpu, "-i", idx, "-o", out_cpu,
                     "--device", "cpu"])
    check(rc == 0, f"cpu cli returned {rc}")
    cpu_rows = read_rows(out_cpu)
    keep = {f"r{i}" for i in range(CPU_READS)}
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
    phase(n, f"cuda vs cpu on {CPU_READS} reads: {len(c)} rows identical "
             f"as sets, max |dist diff| {worst:g}, rows differing in bytes "
             f"{ndiff}")


def throughput(idx: str, fq: str, card: str):
    """Phase 8: dist reads/s on the base world (index loaded once)."""
    import torch

    from krepp_tpu_torch.index.artifact import load_index
    from krepp_tpu_torch.query.dist import DistConfig, run_dist
    from krepp_tpu_torch.query.engine import QueryEngine

    eng = QueryEngine(load_index(idx), 4, device="cuda")
    rates = []
    for rep in range(4):
        with open(os.devnull, "w") as sink:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = run_dist(eng.di, fq, sink, "smoke", DistConfig(),
                         engine_factory=lambda di, th: eng)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if rep:
            rates.append(n / dt)
            phase(8, f"pass {rep}: {n / dt:.1f} reads/s ({dt:.3f} s) "
                     f"on {card}")
    med = statistics.median(rates)
    phase(8, f"dist base: median {med:.1f} reads/s, spread "
             f"{max(rates) / min(rates):.3f}x (max/min of 3) on {card}")
    return med


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
    try:
        import krepp_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the root "
              "of a checkout", file=sys.stderr)
        return 1

    card = card_line()
    print(card)
    phase(1, f"device: {torch.cuda.get_device_name(0)} x "
             f"{torch.cuda.device_count()}; torch {torch.__version__}, "
             f"CUDA {torch.version.cuda}")
    from krepp_tpu_torch import resolve_device
    from krepp_tpu_torch.csrc.build import library_path

    resolve_device("cuda")
    t0 = time.time()
    lib = library_path("probe_hist_packed")
    with open(lib + ".log") as f:
        ptxas = [l.strip() for l in f if "registers" in l or "spill" in l]
    phase(2, f"nvcc build of probe_hist_packed.cu: {time.time() - t0:.2f} s; "
             + "; ".join(ptxas))

    kstats = kernel_vs_plain()

    with tempfile.TemporaryDirectory(prefix="krepp_smoke_") as root:
        idx, fq, fq_cpu, nk, dt = make_world(BASE, BASE_READS, root, "base")
        phase(4, f"base world: {nk} k-mers indexed, {BASE_READS} reads "
                 f"written in {dt:.1f} s")
        out_gpu = os.path.join(root, "base_gpu.tsv")
        launches = dist_on_card(5, idx, fq, out_gpu, BASE_READS)
        gpu_vs_cpu(6, idx, fq_cpu, out_gpu, os.path.join(root, "base_cpu.tsv"))

        sidx, sfq, sfq_cpu, snk, sdt = make_world(SPARSE, SPARSE_READS, root,
                                                  "sparse")
        from krepp_tpu_torch.index.artifact import load_index

        check(load_index(sidx).row_ids is not None,
              "the sparse world did not get a sparse row table")
        phase(7, f"sparse world: {snk} k-mers, row_ids set, {SPARSE_READS} "
                 f"reads, built in {sdt:.1f} s")
        sout = os.path.join(root, "sparse_gpu.tsv")
        dist_on_card(7, sidx, sfq, sout, SPARSE_READS)
        gpu_vs_cpu(7, sidx, sfq_cpu, sout, os.path.join(root, "sparse_cpu.tsv"))

        throughput(idx, fq, card)

    print(json.dumps({"kernels": [{
        "name": "probe_hist_packed", "route": "cuda",
        "source": "krepp_tpu_torch/csrc/probe_hist_packed.cu",
        "replaces": "krepp_tpu/query/pallas_kernels.py:210",
        "launches": launches, **kstats}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
