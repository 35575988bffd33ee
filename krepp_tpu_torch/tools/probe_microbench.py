"""Microbenchmarks of the stage-1 probe's building blocks on one device.

Port of tools/probe_microbench.py, with its sections and labels: a null
op; the row gather of a [2M, 5] and a [32M, 5] u32 table by 4M indices;
sorts of 4M keys with and without one payload and at 1M / 500k / 250k; a
2-key sort of 250k; a [4M, 6] scatter; a sorted segment sum 4M -> 32k; a
one-hot join 4M x 512 rows x 20 planes in bf16; and the [2M, 5] row
gather by 1M indices through the `dma_gather` kernel at 256 and 512 rows
per block (the TPU kernel's two tile sizes), beside the plain gather at
the same shape. Every dma_gather result is checked equal to tab[idx].

Per-op time is the median of `reps` timed runs after a warm-up: CUDA
events on the card; on the host (--device cpu, for tests at tiny sizes)
the host clock, which says nothing about a device. The data is drawn on
the device from a seeded generator.

    python -m krepp_tpu_torch.tools.probe_microbench [--device cuda]
        [--n-idx 4000000] [--n-dma 1048576] [--reps 10]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from .. import resolve_device
from ..query.kernels import dma_gather

WIDTH = 5                      # bucket-row words (count + 2 x (enc, mask))
ONEHOT_T, ONEHOT_ROWS, ONEHOT_PLANES = 1024, 512, 20


def _count(n: int) -> str:
    """4000000 -> '4M', 2 << 20 -> '2M', 32768 -> '32k' (label counts)."""
    if n >= 1 << 20 and n % (1 << 20) == 0:
        return f"{n >> 20}M"
    if n >= 1_000_000:
        return f"{n / 1e6:g}M"
    if n >= 1000:
        return f"{n // 1000}k"
    return str(n)


def _thousands(n: int) -> str:
    """1000000 -> '1000k' (the reference's sort labels), 500 -> '500'."""
    return f"{n // 1000}k" if n >= 1000 else str(n)


class _Bench:
    """Times ops on one device and prints one line per op."""

    def __init__(self, dev: torch.device, reps: int, out):
        self.dev = dev
        self.reps = reps
        self.out = out
        self.results: Dict[str, float] = {}

    def _once(self, fn: Callable[[], object]) -> float:
        if self.dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def __call__(self, fn, label: str, work: Optional[int] = None) -> float:
        """Median seconds per call of fn (one warm-up call first)."""
        self._once(fn)
        per = statistics.median(self._once(fn) for _ in range(self.reps))
        extra = f"  {work / per / 1e6:8.1f} Mrows/s" if work else ""
        print(f"{label:46s} {per * 1e3:9.3f} ms{extra}", file=self.out,
              flush=True)
        self.results[label] = per
        return per


def run(device="cuda", n_idx: int = 4_000_000, n_dma: int = 1 << 20,
        tab_rows: Sequence[int] = (2 << 20, 32 << 20),
        n_segments: int = 32768, reps: int = 10,
        out=sys.stdout) -> Dict[str, float]:
    """Run every section; returns {label: median seconds}. tab_rows[0] is
    also the dma_gather table's row count."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", file=out)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bench = _Bench(dev, reps, out)

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    def words(shape):
        return ints(-2 ** 31, 2 ** 31, shape)

    # null op: launch and timing overhead
    x0 = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    bench(lambda: x0 + 1.0, "null op")

    # ---- gather rate vs table size
    for nrows in tab_rows:
        tab = words((nrows, WIDTH))
        idx = ints(0, nrows, (n_idx,), torch.int64)
        bench(lambda: tab[idx],
              f"gather [{_count(nrows)} rows x {WIDTH} u32] "
              f"{_count(n_idx)} idx", work=n_idx)
        del tab, idx

    # ---- sort costs
    keys = ints(0, 2 ** 31, (n_idx,))
    pay = ints(0, 2 ** 31, (n_idx,))

    def sort_payload(k, p):
        ks, perm = torch.sort(k)
        return ks, p[perm]

    bench(lambda: torch.sort(keys), f"sort {_count(n_idx)} u32 key")
    bench(lambda: sort_payload(keys, pay),
          f"sort {_count(n_idx)} u32 key + 1 payload")
    for sz in (n_idx // 4, n_idx // 8, n_idx // 16):
        bench(lambda: sort_payload(keys[:sz], pay[:sz]),
              f"sort {_thousands(sz)} key + 1 payload")
    # 2-key sort (the event probe's shape): both keys < 2^31 pack into one
    # int64 key
    sz = n_idx // 16
    packed = (keys[:sz].to(torch.int64) << 32) | pay[:sz].to(torch.int64)
    bench(lambda: torch.sort(packed), f"2-key sort {_thousands(sz)}")
    del keys, pay, packed

    # ---- scatter
    vals6 = words((n_idx, 6))
    perm = torch.randperm(n_idx, generator=g, device=dev)
    bench(lambda: torch.zeros((n_idx, 6), dtype=torch.int32,
                              device=dev).index_copy_(0, perm, vals6),
          f"scatter [{_count(n_idx)} x 6 u32]", work=n_idx)
    del vals6, perm

    # ---- segment sum, sorted ids
    seg = torch.sort(ints(0, n_segments, (n_idx,), torch.int64)).values
    ones = torch.ones((n_idx,), dtype=torch.int32, device=dev)
    bench(lambda: torch.zeros((n_segments,), dtype=torch.int32,
                              device=dev).index_add_(0, seg, ones),
          f"segment_sum {_count(n_idx)}->{_count(n_segments)} sorted")
    del seg, ones

    # ---- one-hot matmul join
    nt = max(1, n_idx // ONEHOT_T)
    lrow = ints(0, ONEHOT_ROWS, (nt, ONEHOT_T))
    chunk = ints(0, 255, (nt, ONEHOT_ROWS, ONEHOT_PLANES)).to(torch.bfloat16)
    iota = torch.arange(ONEHOT_ROWS, dtype=torch.int32, device=dev)

    def onehot_join():
        oh = (lrow[..., None] == iota).to(torch.bfloat16)
        return torch.bmm(oh, chunk)

    bench(onehot_join, f"onehot join {_count(n_idx)} x {ONEHOT_ROWS} rows x "
                       f"{ONEHOT_PLANES} u8planes", work=n_idx)
    del lrow, chunk

    # ---- row gather through the hand-written kernel
    nrows = tab_rows[0]
    tab = words((nrows, WIDTH))
    idx = ints(0, nrows, (n_dma,))
    want = tab[idx.to(torch.int64)]
    label = f"[{_count(n_dma)} x {WIDTH} u32]"
    bench(lambda: tab[idx.to(torch.int64)], f"plain gather {label}",
          work=n_dma)
    for rows in (256, 512):
        got = dma_gather(tab, idx, rows)
        if not torch.equal(got, want):
            raise RuntimeError(f"dma_gather != tab[idx] at {rows} rows "
                               "per block")
        bench(lambda: dma_gather(tab, idx, rows),
              f"DMA gather {label} tile {rows}", work=n_dma)
    return bench.results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-idx", type=int, default=4_000_000,
                   help="indices of the gathers, keys of the sorts, rows of "
                        "the scatter, segment sum and one-hot join")
    p.add_argument("--n-dma", type=int, default=1 << 20,
                   help="indices of the dma_gather rows")
    p.add_argument("--tab-rows", type=int, nargs=2,
                   default=(2 << 20, 32 << 20),
                   help="rows of the two gather tables (the first is "
                        "dma_gather's)")
    p.add_argument("--n-segments", type=int, default=32768)
    p.add_argument("--reps", type=int, default=10)
    a = p.parse_args(argv)
    run(a.device, a.n_idx, a.n_dma, a.tab_rows, a.n_segments, a.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
