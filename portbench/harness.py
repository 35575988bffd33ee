"""One run of one cell: set-up, the measured window, the traced pass and
the comparison with the plain reference.

Everything a cell is made of is found by name: its configuration in
configs/<name>.json, its traffic mix in traffic/<name>.json, each
per-layer metric in metrics/<name>.py (see metrics/__init__.py). The
command of a traffic mix (dist or place) is driven through the program's
own entry, `query.dist.run_dist` or `query.place.run_place`, on one
engine built once: a resident pipeline working through a queue of
samples, a closed loop with one caller.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, reference, world
from . import trace as trace_mod
from .spans import Spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_THREADS = 8


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell_spec(bench: dict, name: str):
    """(workload entry, configuration, traffic) of the named cell."""
    for w in bench["workloads"]:
        if w["name"] == name:
            cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
            return (w, load_json(ROOT, cfg["file"]),
                    load_json(HERE, "traffic", w["traffic"] + ".json"))
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metric_module(name: str):
    return importlib.import_module(f"{__package__}.metrics.{name}")


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics the cell reports:
    every end-to-end metric, and the per-layer metrics that list it."""
    if kind == "end_to_end":
        return list(bench[kind])
    return [m for m in bench[kind] if cell in m["workloads"]]


@dataclass
class World:
    """The generated inputs: genomes (host codes), tree, reads and the
    index parameters handed to both the program and the reference."""
    nwk: str
    names: List[str]
    genomes: np.ndarray
    reads: np.ndarray
    params: dict


def make_world(cfg: dict, traffic: dict, seed: int, device) -> World:
    gen = world.generator(seed, device)
    nwk, names, genomes = world.make_genomes(
        cfg["genomes"], cfg["genome_bp"], cfg["branch_mutation"], gen, device)
    reads = world.sample(genomes, traffic, gen)
    host = genomes.cpu().numpy()
    del genomes
    # the LSH positions, drawn from the seed as krepp draws them from its
    # own: h distinct positions of k
    k, h = cfg["k"], cfg["h"]
    rng = np.random.default_rng(seed)
    ppos = tuple(sorted(int(x) for x in rng.choice(k, h, replace=False)))
    params = dict(k=k, h=h, w=cfg["w"], m=cfg["m"], r=cfg["r"],
                  frac=cfg["frac"], ppos=ppos,
                  npos=tuple(i for i in range(k) if i not in ppos),
                  th=cfg["hdist_th"])
    return World(nwk, names, host, reads, params)


class Sink:
    """The report's destination: counts bytes and lines; keeps the text
    while `keep` is set."""

    def __init__(self):
        self.bytes = 0
        self.lines = 0
        self.keep = False
        self.kept: List[str] = []

    def write(self, s: str) -> int:
        self.bytes += len(s)
        self.lines += s.count("\n")
        if self.keep:
            self.kept.append(s)
        return len(s)


@dataclass
class Program:
    """The program under test, loaded as a user's query run loads it."""
    engine: object
    entry: Callable          # entry(fastq, out, stats) -> reads
    facts: dict


def load_program(w: World, traffic: dict, seed: int, device,
                 workdir: str) -> Program:
    """Build the index with the program's own build, save it, load it back,
    build one engine."""
    from krepp_tpu_torch.index import artifact
    from krepp_tpu_torch.index.build import build_index_from_sources
    from krepp_tpu_torch.params import IndexParams, LSHParams
    from krepp_tpu_torch.query.dist import DistConfig, run_dist
    from krepp_tpu_torch.query.engine import QueryEngine
    from krepp_tpu_torch.query.place import PlaceConfig, run_place
    from krepp_tpu_torch.tree.newick import Tree

    p = w.params
    lsh = LSHParams(k=p["k"], h=p["h"], m=p["m"], ppos=p["ppos"],
                    npos=p["npos"])
    iparams = IndexParams(lsh=lsh, w=p["w"], r=p["r"], frac=p["frac"])
    sources = {n: (lambda i=i: iter([w.genomes[i]]))
               for i, n in enumerate(w.names)}
    built = build_index_from_sources(w.names, sources, iparams,
                                     Tree.parse(w.nwk), progress=False,
                                     num_threads=BUILD_THREADS)
    idx = os.path.join(workdir, "index")
    artifact.save_native(built, idx, seed=seed)
    del built
    di = artifact.load_index(idx)
    eng = QueryEngine(di, p["th"], device=device)
    command = traffic["command"]
    invocation = f"krepp {command} -i index -q sample.fq"

    def entry(fastq, out, stats):
        if command == "dist":
            return run_dist(di, fastq, out, invocation,
                            DistConfig(hdist_th=p["th"]),
                            engine_factory=lambda d, th: eng, stats=stats)
        return run_place(di, fastq, out, invocation,
                         PlaceConfig(hdist_th=p["th"]),
                         engine_factory=lambda d, th: eng, stats=stats)

    facts = dict(mode=eng.mode, hflavor=eng.hflavor, C0=eng.C0, W=eng.W,
                 S=eng.S, th=p["th"], k=p["k"], nkmers=di.nkmers,
                 nse=0 if di.se_mask is None else int(di.se_mask.shape[0]))
    return Program(eng, entry, facts)


@dataclass
class Run:
    """What one run measured, for the per-layer metrics' readers."""
    reads: int = 0
    seconds: float = 0.0
    batches: int = 0
    escalations: int = 0
    pass_s: List[float] = field(default_factory=list)
    spans: Dict[str, float] = field(default_factory=dict)
    trace: Optional[trace_mod.Trace] = None
    facts: dict = field(default_factory=dict)

    def per_kread(self, span: str) -> Optional[float]:
        """The span's self time over the window, ms per 1,000 reads."""
        if span not in self.spans or not self.reads:
            return None
        return self.spans[span] * 1e3 / (self.reads / 1e3)


def window(prog: Program, fastq: str, seconds: float, sink: Sink) -> Run:
    """Whole passes over the sample until `seconds` have passed; the
    first pass's report is kept in the sink."""
    run = Run(facts=prog.facts)
    sink.keep = True
    t0 = time.perf_counter()
    while True:
        stats: dict = {}
        t1 = time.perf_counter()
        run.reads += prog.entry(fastq, sink, stats)
        run.pass_s.append(time.perf_counter() - t1)
        sink.keep = False
        run.batches += stats["batches"]
        run.escalations += sum(stats["escalations"])
        if time.perf_counter() - t0 >= seconds:
            break
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    run.seconds = time.perf_counter() - t0
    return run


def span_specs(metrics: List[dict]):
    specs = []
    for m in metrics:
        specs += list(getattr(metric_module(m["name"]), "SPANS", ()))
    return specs


def profiled_pass(prog: Program, fastq: str, specs, workdir: str):
    """One whole pass over `fastq` under the profiler, its spans annotating
    it, batches in flight as in the window; the read lengths of each batch
    it dispatched are recorded for the rooflines."""
    spans = Spans(annotate=True)
    spans.install(specs)
    batches = []
    upload = prog.engine.upload

    def recording(codes, lengths, leaf_ok=None):
        batches.append(np.array(lengths, copy=True))
        return upload(codes, lengths, leaf_ok)

    prog.engine.upload = recording
    try:
        reads, events, wall = trace_mod.profile(
            lambda: prog.entry(fastq, Sink(), {}),
            os.path.join(workdir, "trace.json"), spans)
    finally:
        del prog.engine.upload
        spans.uninstall()
    return trace_mod.read(events, reads, wall, batches)


def reference_gap(w: World, traffic: dict, text: str, seed: int,
                  device) -> float:
    """The widest gap between `text` (a report of the whole sample) and the
    reference over the sample drawn from the seed."""
    names, idx = check_sample(w, traffic, seed)
    genomes = torch.from_numpy(w.genomes).to(device)
    ref = reference.report(traffic["command"], genomes, w.names, w.nwk,
                           w.reads[idx], names, w.params)
    return check.compare(traffic["command"], text, ref, names)


def check_sample(w: World, traffic: dict, seed: int):
    """(names, indexes) of the reads compared, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    idx = np.sort(rng.choice(len(w.reads), traffic["check_reads"],
                             replace=False))
    return [f"r{i}" for i in idx], idx


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, scale: Optional[dict] = None) -> dict:
    """One run of the cell on `device`; returns the result line's fields.
    `scale` overrides sizes of the configuration and traffic (tests)."""
    _, cfg, traffic = cell_spec(bench, cell)
    if scale:
        cfg = {**cfg, **scale.get("config", {})}
        traffic = {**traffic, **scale.get("traffic", {})}
    on_card = torch.device(device).type == "cuda"
    marks = [("start", t_start)]
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        w = make_world(cfg, traffic, seed, device)
        marks.append(("inputs", time.perf_counter()))
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        prog = load_program(w, traffic, seed, device, workdir)
        marks.append(("index and engine", time.perf_counter()))
        fastq = os.path.join(workdir, "sample.fq")
        world.write_fastq(fastq, w.reads)
        prog.entry(fastq, Sink(), {})                       # warm-up
        if on_card:
            torch.cuda.synchronize()
        marks.append(("fastq and warm-up", time.perf_counter()))
        setup_s = marks[-1][1] - t_start
        print("set-up, s: " + ", ".join(
            f"{a} {t1 - t0:.2f}" for (_, t0), (a, t1) in zip(marks, marks[1:])),
            file=sys.stderr)

        per_layer = cell_metrics(bench, cell, "per_layer") if trace else []
        spans = Spans()
        specs = span_specs(per_layer)
        if trace:
            spans.install(specs)
            spans.active = True
        sink = Sink()
        try:
            run = window(prog, fastq, seconds, sink)
        finally:
            spans.active = False
            spans.uninstall()
        run.spans = dict(spans.totals)
        print("window passes, s: " + " ".join(f"{t:.3f}" for t in run.pass_s)
              + f"; reports {sink.bytes} bytes, {sink.lines} lines",
              file=sys.stderr)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if trace:
            run.trace = profiled_pass(prog, fastq, specs, workdir)
        text = "".join(sink.kept)
        del prog, sink
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gap = reference_gap(w, traffic, text, seed, device)
        print(f"reference and comparison: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)

    limit = traffic["check_limit"]
    result = {"correct": bool(gap <= limit), "attempted": run.reads,
              "failed": 0}
    if trace:
        metrics = {}
        for m in per_layer:
            v = metric_module(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"reads_per_s": run.reads / run.seconds,
                  "peak_device_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, cell, "end_to_end")}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if on_card else "cpu",
                        "kind": (torch.cuda.get_device_name(0) if on_card
                                 else "cpu"),
                        "count": 1, "memory_peak_bytes": peak}
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.wall_s
        result["breakdown"] = trace_mod.breakdown(run.trace)
    result["checks"] = {f"{traffic['command']}_gap": {"value": gap,
                                                      "limit": limit}}
    return result
