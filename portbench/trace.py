"""One pass under torch.profiler, read from its exported trace: the
device's busy time (the union of its kernel, copy and set intervals, so
work on two streams at once counts once), kernel launches, device time by
operation, and the idle gaps labelled by the host span that covers most of
each."""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PASS = "portbench.pass"
TOP = 10


@dataclass
class Trace:
    reads: int
    wall_s: float
    busy_s: float
    launches: int
    device_ops: Dict[str, float]            # seconds by operation name
    device_calls: Dict[str, int]            # runs by operation name
    gaps: List[Tuple[str, float]]           # longest idle gaps, longest first
    batches: List[np.ndarray] = field(default_factory=list)   # read lengths

    def kernel_s(self, part: str) -> float:
        return sum(s for n, s in self.device_ops.items() if part in n)

    def kernel_calls(self, part: str) -> int:
        return sum(c for n, c in self.device_calls.items() if part in n)


def profile(one_pass, path: str, spans) -> Tuple[int, dict, float]:
    """Run one_pass() under the profiler with `spans` annotating; returns
    (its reads, the trace's events, host wall seconds of the pass)."""
    from torch.profiler import ProfilerActivity, profile as prof_

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    with prof_(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        spans.active = True
        with torch.profiler.record_function(PASS):
            reads = one_pass()
            sync()
        spans.active = False
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    return reads, events, wall


def read(events, reads: int, wall: float, batches) -> Trace:
    dev = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
           if e.get("cat") in DEVICE_CATS]
    notes = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
             if e.get("cat") == "user_annotation"]
    launches = sum(1 for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "LaunchKernel" in e.get("name", ""))
    ops = defaultdict(float)
    calls = defaultdict(int)
    for a, b, name in dev:
        ops[name[:120]] += (b - a) * 1e-6
        calls[name[:120]] += 1
    merged = []
    for a, b, _ in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    whole = [(a, b) for a, b, n in notes if n == PASS]
    spans = []
    if whole and merged:
        lo, hi = whole[0]
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        spans = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2])
                        if b > a), key=lambda ab: ab[0] - ab[1])[:TOP]
    gaps = [(_label(a, b, notes), (b - a) * 1e-6) for a, b in spans]
    return Trace(reads=reads, wall_s=wall, busy_s=busy, launches=launches,
                 device_ops=dict(ops), device_calls=dict(calls), gaps=gaps,
                 batches=list(batches))


def _label(a: float, b: float, notes) -> str:
    """The host span covering most of [a, b] ("host" where none does)."""
    best, cover = "host", 0.0
    for x, y, name in notes:
        if name == PASS:
            continue
        c = min(b, y) - max(a, x)
        if c > cover:
            best, cover = name, c
    return best


def breakdown(tr: Trace) -> dict:
    ops = sorted(tr.device_ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in tr.gaps]}
