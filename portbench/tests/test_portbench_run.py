"""The run command, its readers and its imports."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, peaks, run, trace
from portbench.spans import Spans

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "flax", "krepp_tpu"}


def _imports(path):
    """(top-level name, relative level) of every import in a source."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources(PKG):
        for name, level in _imports(path):
            assert level or name not in FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(PKG, "reference")):
        for name, level in _imports(path):
            assert level <= 1, (path, name)     # nothing outside reference/
            assert level or name in {"__future__", "math", "typing",
                                     "numpy", "torch"}, (path, name)


BLOCKED_RUN = """
import importlib.abc, sys, time, json
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "krepp_tpu"}:
            raise ImportError(name + " is blocked")
sys.meta_path.insert(0, Block())
from portbench import harness, run
from portbench.tests.conftest import TINY
r = harness.run_cell(harness.benchmark(), sys.argv[1], 7, 0.2, True, "cpu",
                     time.perf_counter(), TINY)
print(json.dumps({"correct": r["correct"], "found": run.forbidden_modules()}))
"""


@pytest.mark.parametrize("cell",
                         ["cami_medium.dist.skim", "refs1k.dist.skim"])
def test_a_run_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN, cell],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True).stdout
    got = json.loads(out.strip().splitlines()[-1])
    assert got == {"correct": True, "found": []}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "krepp_tpu_torch_like", sys)
    assert "krepp_tpu_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in run.forbidden_modules()


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "cami_medium.dist.skim", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


def test_trace_busy_is_the_union_of_device_intervals():
    ev = [
        {"cat": "user_annotation", "name": trace.PASS, "ts": 0, "dur": 100},
        {"cat": "user_annotation", "name": "report", "ts": 60, "dur": 35},
        {"cat": "kernel", "name": "a", "ts": 10, "dur": 20},
        {"cat": "kernel", "name": "b", "ts": 20, "dur": 20},    # other stream
        {"cat": "gpu_memcpy", "name": "c", "ts": 50, "dur": 5},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 9,
         "dur": 1},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 19,
         "dur": 1},
    ]
    tr = trace.read(ev, 1000, 1e-4, [])
    assert tr.busy_s == pytest.approx(35e-6)
    assert tr.launches == 2
    assert tr.device_calls == {"a": 1, "b": 1, "c": 1}
    assert tr.gaps[0] == ("report", pytest.approx(45e-6))
    assert [g[1] for g in tr.gaps] == pytest.approx([45e-6, 10e-6, 10e-6])


def test_tiles_bytes_of_the_main_shape():
    # chip_smoke.py's main shape of probe_hist_tiles: N = 32,768 strands,
    # P = 164, C0 = 2, W = 8, S = 256, X = 5, 'se' rows, 97 mask rows; its
    # reads fill the padded length (192 bases), so every position is work
    facts = dict(k=29, C0=2, W=8, S=256, th=4, hflavor="se", nse=97)
    assert peaks.tiles_bytes([192] * 16384, facts) == 302255136


def test_tiles_bytes_count_real_positions_only():
    # 150 bp reads padded to 192: 122 positions a strand are work, not 164
    facts = dict(k=29, C0=2, W=5, S=132, th=4, hflavor="se", nse=0)
    per_pos = 4 * 5 + 4 + 1
    out = 2 * 2 * (132 * 5 * 4 + 4)
    assert peaks.tiles_bytes([150, 150], facts) == 2 * 2 * 122 * per_pos + out
    assert peaks.tiles_bytes([150, 10], facts) == 2 * 122 * per_pos + out


def test_spans_count_self_time():
    s = Spans()
    s.active = True
    with s.span("outer"):
        time.sleep(0.02)
        with s.span("inner"):
            time.sleep(0.03)
    assert s.totals["inner"] == pytest.approx(0.03, abs=0.02)
    assert s.totals["outer"] == pytest.approx(0.02, abs=0.015)


def test_benchmark_file_names_what_exists():
    bench = harness.benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        harness.cell_spec(bench, w["name"])
    for m in bench["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read)


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cami_medium.dist.skim", "--seed", "2147483653", "--seconds", "3",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200, check=True).stdout
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert 0 < r["metrics"]["tiles_roofline_pct"]["value"] <= 100
