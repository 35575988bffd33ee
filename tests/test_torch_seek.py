"""Port `sketch` / `seek` vs krepp_tpu's: the sketch build and its binary
file (byte-identical), DeviceSketch, SeekEngine in direct and CSR mode
(has equal, distances within 5e-9), `run_seek` text, and both CLIs."""

import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from krepp_tpu.index import artifact as jartifact
from krepp_tpu.index.build import build_sketch as jbuild_sketch
from krepp_tpu.params import IndexParams, LSHParams
from krepp_tpu.query import engine as jengine
from krepp_tpu.query.seek import run_seek as jrun_seek
from krepp_tpu_torch import cli
from krepp_tpu_torch.core.codec import pad_codes_batch, seq_to_codes
from krepp_tpu_torch.index import artifact
from krepp_tpu_torch.index.build import build_sketch
from krepp_tpu_torch.index.index import DeviceSketch
from krepp_tpu_torch.query import engine
from krepp_tpu_torch.query.seek import run_seek

import worldgen

from test_torch_engine import _assert_tuple_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def sketch_world(tmp_path_factory):
    """tests/test_seek_artifact.py's sketch world on a 20 kbp target, its
    reads at 5% mutation (N bases and garbage reads included), both
    packages' sketches of it and the reference's file."""
    rng = np.random.default_rng(5)
    d = tmp_path_factory.mktemp("torch_seek")
    genome = "".join(rng.choice(list("ACGT"), size=20000))
    (d / "target.fna").write_text(f">target\n{genome}\n")
    reads = worldgen.sample_reads(rng, {"target": [genome]}, n=40, mut=0.05)
    with open(d / "q.fq", "w") as f:
        for rid, seq in reads:
            f.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")
    params = IndexParams(lsh=LSHParams.generate(26, 10, 2, seed=4), w=32,
                         r=1, frac=True)
    jb = jbuild_sketch(str(d / "target.fna"), params, progress=False)
    tb = build_sketch(str(d / "target.fna"), params, progress=False)
    jartifact.save_sketch_reference(jb, str(d / "ref.sk"))
    return jb, tb, reads, d


def test_sketch_build_and_file_match_reference(sketch_world):
    jb, tb, _, d = sketch_world
    for f in ("enc_v", "inc"):
        assert np.array_equal(getattr(jb, f), getattr(tb, f)), f
    assert jb.rho == tb.rho and jb.params == tb.params and tb.nkmers > 1000
    artifact.save_sketch_reference(tb, str(d / "port.sk"))
    assert (d / "port.sk").read_bytes() == (d / "ref.sk").read_bytes()


def test_device_sketch_matches_reference(sketch_world):
    _, _, _, d = sketch_world
    want = jartifact.load_sketch_reference(str(d / "ref.sk"))
    for got in (artifact.load_sketch_reference(str(d / "ref.sk")),
                DeviceSketch.from_reference(want)):
        for f in ("resident", "res_rank", "row_start", "enc_v", "row_ids"):
            a, b = getattr(want, f), getattr(got, f)
            assert (a is None and b is None) or np.array_equal(a, b), f
        for f in ("lsh", "w", "r", "frac", "R", "nrows_u", "max_bucket",
                  "rho"):
            a, b = getattr(want, f), getattr(got, f)
            if dataclasses.is_dataclass(a):      # the port's own class
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f


@pytest.mark.parametrize("mode", ["direct", "csr"])
def test_seek_engine_matches_reference(sketch_world, mode, monkeypatch):
    """The direct table; and the CSR scan, with the direct table's depth
    cap patched to 0 in both engines."""
    _, _, reads, d = sketch_world
    if mode == "csr":
        monkeypatch.setattr(jengine, "SEEK_DIRECT_CAP", 0)
        monkeypatch.setattr(engine, "SEEK_DIRECT_CAP", 0)
    sk = jartifact.load_sketch_reference(str(d / "ref.sk"))
    je = jengine.SeekEngine(sk, 4)
    te = engine.SeekEngine(DeviceSketch.from_reference(sk), 4, device="cpu")
    assert je.mode == te.mode == mode and sk.max_bucket > 1
    codes, lengths = pad_codes_batch([seq_to_codes(s) for _, s in reads],
                                     pad_to=192)
    want = je.run(codes, lengths)
    got = te.run(codes, lengths)
    _assert_tuple_equal(want, got)
    assert got[0].sum() >= len(reads) - 4      # all but the garbage reads

    jout, tout = io.StringIO(), io.StringIO()
    stats = {}
    assert jrun_seek(sk, str(d / "q.fq"), jout, "inv") == len(reads)
    assert run_seek(DeviceSketch.from_reference(sk), str(d / "q.fq"), tout,
                    "inv", device="cpu", stats=stats) == len(reads)
    assert tout.getvalue() == jout.getvalue()
    assert stats == {"mode": mode, "batches": 1}


def test_cli_sketch_and_seek_match_the_reference_cli(sketch_world, capsys):
    """`sketch` at its defaults (k=26, h=k-16, w=k+6, m=4) writes the same
    bytes; `seek` prints the same rows but for the invocation (the port's
    CLI in this process)."""
    _, _, reads, d = sketch_world
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    want = subprocess.run(
        [sys.executable, "-c", "import sys; from krepp_tpu.cli import main; "
         "main(['sketch', '-i', 'target.fna', '-o', 'j.sk']); "
         "main(['seek', '-q', 'q.fq', '-i', 'j.sk'])"],
        cwd=d, env=env, capture_output=True, text=True, timeout=300)
    assert want.returncode == 0, want.stderr
    assert cli.main(["sketch", "-i", str(d / "target.fna"), "-o",
                     str(d / "t.sk")]) == 0
    assert (d / "t.sk").read_bytes() == (d / "j.sk").read_bytes()
    assert cli.main(["--verbose", "seek", "-q", str(d / "q.fq"), "-i",
                     str(d / "t.sk"), "-o", str(d / "t.out"), "--device",
                     "cpu"]) == 0
    assert 'seek stats: {"mode": "direct"' in capsys.readouterr().err
    got = (d / "t.out").read_text().splitlines()
    assert got[1:] == want.stdout.splitlines()[1:]
    assert got[1] == "SEQ_ID\tDIST" and len(got) == 2 + len(reads)
