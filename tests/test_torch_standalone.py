"""The port stands alone: no module of krepp_tpu_torch (nor chip_smoke.py)
imports `krepp_tpu` or `jax`, a process in which both are blocked imports
every port module, builds a small world through the port's `index`
command (also with sdust masking, the device winnower and --mesh) and runs
it end to end on the CPU, the C sources the port compiles
are byte-identical to the reference's, and the distribution declares the
port's own command."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "krepp_tpu_torch")
BLOCKED = ("jax", "jaxlib", "krepp_tpu")
C_SOURCES = ("extract.c", "report.c", "sortkv.c", "colorize.c")


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

acgt = np.frombuffer(b"ACGT", np.uint8)
nwk, genomes = testing.make_world_codes(np.random.default_rng(3), nleaves=5,
                                        glen=1500, rate=0.05)
testing.write_world_files(".", nwk, genomes)
reads = testing.sample_read_codes(np.random.default_rng(4), genomes, 12)
testing.write_fastq("q.fq", reads)
with open("g0.fna", "wb") as f:
    f.write(b">g0\n" + acgt[genomes["G000"][0]].tobytes() + b"\n")

def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    assert rc in (0, None), (argv, rc)
    return out.getvalue()

run(["index", "-i", "map.tsv", "-o", "idx", "-t", "tree.nwk", "-k", "27",
     "-h", "11", "-m", "2", "--export-reference-format"])
run(["index", "-i", "map.tsv", "-o", "parts", "-t", "tree.nwk", "-k", "27",
     "-h", "11", "-m", "2", "--no-frac", "-r", "0", "--partial"])
run(["index", "-i", "map.tsv", "-o", "parts", "-t", "tree.nwk", "-k", "27",
     "-h", "11", "-m", "2", "--no-frac", "-r", "1", "--partial"])
os.mkdir("ref")
for name in os.listdir("idx"):
    if "-m2r1-frac" in name:
        os.link(os.path.join("idx", name), os.path.join("ref", name))
dist = run(["dist", "-q", "q.fq", "-i", "idx", "--device", "cpu"])
same = [run(["dist", "-q", "q.fq", "-i", d, "--device", "cpu"])
        .splitlines()[1:] == dist.splitlines()[1:] for d in ("parts", "ref")]
place = run(["place", "-q", "q.fq", "-i", "idx", "--device", "cpu"])
# the sharded query engine on the host repeated (parallel/mesh.py)
mesh_query = [run([cmd, "-q", "q.fq", "-i", "idx", "--mesh", "2x2", "--device",
                   "cpu"]) == want for cmd, want in (("dist", dist),
                                                     ("place", place))]
run(["sketch", "-i", "g0.fna", "-o", "g0.sk", "-k", "26"])
# the device paths of `index` and `sketch`: sdust masking, the device
# winnower (the same files as the C winnower's), the multi-device build
run(["index", "-i", "map.tsv", "-o", "idx_sdust", "-t", "tree.nwk", "-k",
     "27", "-h", "11", "-m", "2", "--sdust-t", "20", "--sdust-w", "64",
     "--device", "cpu"])
run(["sketch", "-i", "g0.fna", "-o", "g0_sdust.sk", "-k", "26", "--sdust-t",
     "20", "--sdust-w", "64", "--device", "cpu"])
os.environ["KREPP_DEVICE_WINNOW"] = "1"
run(["index", "-i", "map.tsv", "-o", "idx_dev", "-t", "tree.nwk", "-k", "27",
     "-h", "11", "-m", "2", "--device", "cpu"])
run(["sketch", "-i", "g0.fna", "-o", "g0_dev.sk", "-k", "26", "--device",
     "cpu"])
del os.environ["KREPP_DEVICE_WINNOW"]
run(["index", "-i", "map.tsv", "-o", "idx_mesh", "-t", "tree.nwk", "-k", "27",
     "-h", "11", "-m", "2", "--mesh", "2", "--device", "cpu"])

def same_file(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()

def same_arrays(a, b):
    za, zb = np.load(a), np.load(b)
    return sorted(za.files) == sorted(zb.files) and all(
        np.array_equal(za[k], zb[k]) for k in za.files)

device_paths = dict(
    sketch=same_file("g0.sk", "g0_dev.sk"),
    index=same_arrays("idx/arrays.npz", "idx_dev/arrays.npz"),
    mesh=same_arrays("idx/arrays.npz", "idx_mesh/arrays.npz"),
    sdust_kmers=int(len(np.load("idx_sdust/arrays.npz")["enc_v"])),
    sdust_sketch=os.path.getsize("g0_sdust.sk"))
seek = run(["seek", "-q", "q.fq", "-i", "g0.sk", "--device", "cpu"])
inspect = run(["inspect", "-i", "idx"])
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
print(json.dumps(dict(
    modules=len(mods), loaded=loaded, same=same, device_paths=device_paths,
    mesh_query=mesh_query,
    parallel=sorted(m for m in mods if m.startswith("krepp_tpu_torch.parallel.")),
    files=sorted(os.listdir("idx")),
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
    assert got["same"] == [True, True]
    paths = got["device_paths"]
    assert paths["sketch"] and paths["index"] and paths["mesh"]
    assert paths["sdust_kmers"] > 500 and paths["sdust_sketch"] > 1000
    assert got["modules"] >= 36          # parallel/ and the new core modules
    assert got["mesh_query"] == [True, True]
    assert got["parallel"] == ["krepp_tpu_torch.parallel." + m for m in
                               ("boot", "build", "mesh", "multihost")]
    assert {"meta.json", "arrays.npz", "tree.nwk", "reflist.txt",
            "cmer-m2r1-frac", "crecord-m2r1-frac"} <= set(got["files"])


def test_the_distribution_declares_the_port_command():
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)["project"]
    assert project["scripts"]["krepp-tpu-torch"] == "krepp_tpu_torch.cli:main"
    assert project["scripts"]["krepp-tpu"] == "krepp_tpu.cli:main"
    assert any(d.split(">")[0].split("=")[0].strip() == "torch"
               for d in project["optional-dependencies"]["torch"])
