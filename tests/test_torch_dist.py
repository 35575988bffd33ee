"""Port `run_dist` and CLI vs krepp_tpu's: byte-identical TSV on the
world of tests/test_e2e_dist.py in every report mode and on 48- and
80-leaf worlds with short and long reads, and the CLI framing of
tests/test_readme_golden.py."""

import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from krepp_tpu.index.build import build_index as jbuild_index
from krepp_tpu.index.index import DeviceIndex as JDeviceIndex
from krepp_tpu.params import IndexParams, LSHParams
from krepp_tpu.query.dist import DistConfig as JDistConfig
from krepp_tpu.query.dist import run_dist as jrun_dist
from krepp_tpu.tree.newick import Tree
from krepp_tpu_torch.index import artifact
from krepp_tpu_torch.index.build import build_index
from krepp_tpu_torch.index.index import DeviceIndex
from krepp_tpu_torch.query.dist import DistConfig, run_dist

import worldgen
from refcsrc import private_reference_csrc  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_e2e_dist.py's world, built by each package from FASTA."""
    rng = np.random.default_rng(42)
    d = tmp_path_factory.mktemp("torch_dist_world")
    nwk, genomes = worldgen.make_world(rng, nleaves=6, glen=1600, rate=0.05)
    input_map = []
    for name in sorted(genomes):
        p = d / f"{name}.fna"
        with open(p, "w") as f:
            for i, contig in enumerate(genomes[name]):
                f.write(f">{name}_c{i}\n{contig}\n")
        input_map.append((name, str(p)))
    params = IndexParams(lsh=LSHParams.generate(27, 11, 2, seed=3),
                         w=35, r=1, frac=True)
    tree = Tree.parse(nwk)
    jdi = JDeviceIndex.from_built(
        jbuild_index(input_map, params, tree, progress=False))
    built = build_index(input_map, params, tree, progress=False)
    reads = worldgen.sample_reads(rng, genomes, n=14, mut=0.06)
    qpath = d / "q.fq"
    with open(qpath, "w") as f:
        for rid, seq in reads:
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    artifact.save_native(built, str(d / "idx"))
    return jdi, DeviceIndex.from_built(built), str(qpath), d


MODES = {
    "default": {},
    "no_multi": dict(multi=False),
    "filter": dict(no_filter=False),
    "dist_max": dict(dist_max=0.05),
    "summarize": dict(summarize=True),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_dist_tsv_is_byte_identical(world, mode):
    jdi, tdi, qpath, _ = world
    want = io.StringIO()
    jrun_dist(jdi, qpath, want, "inv", JDistConfig(**MODES[mode]))
    got = io.StringIO()
    stats = {}
    n = run_dist(tdi, qpath, got, "inv", DistConfig(**MODES[mode]),
                 device="cpu", stats=stats)
    assert n == 16
    assert got.getvalue() == want.getvalue()
    assert len(got.getvalue().splitlines()) > 3
    assert stats["mode"] == "hybrid" and stats["escalations"] == [0]


@pytest.fixture(scope="module", params=[48, 80])
def wide_world(request, tmp_path_factory):
    """A 48-leaf (embed rows, W = 2) or 80-leaf ('se' rows, W = 3) world
    built by each package from FASTA, with 150-bp and 400-bp reads."""
    nleaves = request.param
    rng = np.random.default_rng(nleaves)
    d = tmp_path_factory.mktemp(f"torch_dist_wide{nleaves}")
    nwk, genomes = worldgen.make_world(rng, nleaves=nleaves, glen=1600,
                                       rate=0.05)
    input_map = []
    for name in sorted(genomes):
        p = d / f"{name}.fna"
        with open(p, "w") as f:
            for i, contig in enumerate(genomes[name]):
                f.write(f">{name}_c{i}\n{contig}\n")
        input_map.append((name, str(p)))
    params = IndexParams(lsh=LSHParams.generate(27, 11, 2, seed=5),
                         w=35, r=1, frac=True)
    tree = Tree.parse(nwk)
    jdi = JDeviceIndex.from_built(
        jbuild_index(input_map, params, tree, progress=False))
    tdi = DeviceIndex.from_built(build_index(input_map, params, tree,
                                             progress=False))
    queries = {}
    for tag, rlen in (("short", 150), ("long", 400)):
        queries[tag] = str(d / f"{tag}.fq")
        with open(queries[tag], "w") as f:
            for rid, seq in worldgen.sample_reads(rng, genomes, n=12,
                                                  rlen=rlen, mut=0.04):
                f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    return nleaves, jdi, tdi, queries


@pytest.mark.parametrize("reads", ["short", "long"])
@pytest.mark.parametrize("mode", ["default", "filter"])
def test_wide_run_dist_tsv_is_byte_identical(wide_world, reads, mode):
    nleaves, jdi, tdi, queries = wide_world
    want = io.StringIO()
    jrun_dist(jdi, queries[reads], want, "inv", JDistConfig(**MODES[mode]))
    got = io.StringIO()
    stats = {}
    n = run_dist(tdi, queries[reads], got, "inv", DistConfig(**MODES[mode]),
                 device="cpu", stats=stats)
    assert n == 14
    assert got.getvalue() == want.getvalue()
    assert len(got.getvalue().splitlines()) > 10
    assert stats["mode"] == "hybrid"
    assert (stats["hflavor"], stats["W"]) == (
        ("embed", 2) if nleaves == 48 else ("se", 3))


def _cli(d, *args):
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO}/tests")
    return subprocess.run([sys.executable, "-m", "krepp_tpu_torch", *args],
                          cwd=d, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_dist_on_cpu_prints_the_reference_framing(world):
    _, _, qpath, d = world
    out = _cli(d, "--verbose", "dist", "-q", qpath, "-i", "idx",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("# software: krepp\tversion: v0.8.3"
                               "\tinvocation :")
    assert lines[1] == "SEQ_ID\tREFERENCE_NAME\tDIST"
    assert len(lines) > 2
    for row in lines[2:]:
        _sid, _ref, dist = row.split("\t")
        assert re.fullmatch(r"\d+\.\d{5}|NaN", dist), dist
    assert 'dist stats: {"mode": "hybrid"' in out.stderr


def test_cli_unported_subcommand_exits_with_a_message(world):
    """Every subcommand of krepp_tpu is ported: `index` builds (it used to
    exit 2), and only a command that neither package has exits 2."""
    _, _, qpath, d = world
    with open(os.path.join(d, "map.tsv"), "w") as f:
        for name in sorted(os.listdir(d)):
            if name.endswith(".fna"):
                f.write(f"{name[:-4]}\t{name}\n")
    out = _cli(d, "index", "-i", "map.tsv", "-o", "idx2", "-k", "27", "-h",
               "11", "-m", "2")
    assert out.returncode == 0, out.stderr
    assert "Total number of k-mers indexed: " in out.stderr
    assert "krepp_tpu " not in out.stderr
    assert os.path.exists(os.path.join(d, "idx2", "meta.json"))
    out = _cli(d, "dist", "-q", qpath, "-i", "idx2", "--device", "cpu")
    assert out.returncode == 0 and len(out.stdout.splitlines()) > 2
    out = _cli(d, "reindex", "-i", "map.tsv", "-o", "idx3")
    assert out.returncode == 2 and "invalid choice" in out.stderr
