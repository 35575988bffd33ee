"""The port stands alone: no module of krepp_tpu_torch (nor chip_smoke.py)
imports `krepp_tpu` or `jax`, a process in which both are blocked imports
every port module and runs a small world end to end on the CPU, and the C
sources the port compiles are byte-identical to the reference's."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "krepp_tpu_torch")
BLOCKED = ("jax", "jaxlib", "krepp_tpu")
C_SOURCES = ("extract.c", "report.c", "sortkv.c", "colorize.c", "fastx.c")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_no_source_imports_the_reference_or_jax():
    sources = _port_sources()
    assert len(sources) > 30
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in BLOCKED, \
                    f"{os.path.relpath(path, REPO)}:{node.lineno}: {name}"


@pytest.mark.parametrize("name", C_SOURCES)
def test_c_source_is_a_byte_identical_copy(name):
    with open(os.path.join(REPO, "csrc", name), "rb") as f:
        want = f.read()
    with open(os.path.join(PORT, "csrc", name), "rb") as f:
        assert f.read() == want and len(want) > 1000


_RUN_BLOCKED = r"""
import contextlib, importlib, io, json, os, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "krepp_tpu")

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(name + " is blocked")

sys.meta_path.insert(0, _Block())
import numpy as np
import krepp_tpu_torch
mods = ["krepp_tpu_torch"]
for m in pkgutil.walk_packages(krepp_tpu_torch.__path__, "krepp_tpu_torch."):
    if m.name.endswith("__main__"):
        continue
    importlib.import_module(m.name)
    mods.append(m.name)

from krepp_tpu_torch import cli, testing
from krepp_tpu_torch.index.artifact import save_native

built, genomes, tree = testing.build_world_index(seed=3, nleaves=5, glen=1500,
                                                 k=27, h=11, m=2)
save_native(built, "idx")
reads = testing.sample_read_codes(np.random.default_rng(4), genomes, 12)
testing.write_fastq("q.fq", reads)
with open("g0.fna", "wb") as f:
    f.write(b">g0\n" + np.frombuffer(b"ACGT", np.uint8)[genomes["G000"][0]]
            .tobytes() + b"\n")

def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    assert rc in (0, None), (argv, rc)
    return out.getvalue()

dist = run(["dist", "-q", "q.fq", "-i", "idx", "--device", "cpu"])
place = run(["place", "-q", "q.fq", "-i", "idx", "--device", "cpu"])
run(["sketch", "-i", "g0.fna", "-o", "g0.sk", "-k", "26"])
seek = run(["seek", "-q", "q.fq", "-i", "g0.sk", "--device", "cpu"])
inspect = run(["inspect", "-i", "idx"])
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
print(json.dumps(dict(
    modules=len(mods), loaded=loaded,
    dist_rows=len(dist.splitlines()) - 2, dist_head=dist.splitlines()[1],
    placements=len(json.loads(place)["placements"]),
    seek_rows=len(seek.splitlines()) - 2,
    seek_found=sum(not r.endswith("NaN") for r in seek.splitlines()[2:]),
    inspect_head=inspect.splitlines()[0][:15])))
"""


def test_port_runs_end_to_end_with_the_reference_and_jax_blocked(tmp_path):
    import json

    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _RUN_BLOCKED], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == [] and got["modules"] >= 30
    assert got["dist_head"] == "SEQ_ID\tREFERENCE_NAME\tDIST"
    assert got["dist_rows"] >= 12 and got["placements"] >= 6
    assert got["seek_rows"] == 12 and got["seek_found"] >= 1
    assert got["inspect_head"] == "Backbone tree: "
