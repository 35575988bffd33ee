"""Two processes over gloo on the host (torch.distributed), as
tests/test_multihost.py and tests/test_multihost_cli.py run krepp_tpu: the
port's MultiHostQueryEngine at 2x2 (two local CPU devices a process: the
data rows stay inside a process, and each process's two cells wait on a
barrier their steps must reach at once), 1x2 (one each: the shard merge
crosses processes) and 2x2 over four processes (both) against the
single-process engine, and `dist` /
`place --mesh 2x2 -o` through the CLI, whose rank files, concatenated with
the header once, are krepp_tpu's single-device output byte for byte. Each
child has a timeout and is killed with its peer when either fails; the
children import neither jax nor krepp_tpu."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120

_BLOCK = r"""
import importlib.abc, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "krepp_tpu"):
            raise ImportError(name + " is blocked")

sys.meta_path.insert(0, _Block())
import torch
torch.set_num_threads(1)
"""

_ENGINE_CHILD = _BLOCK + r"""
import numpy as np
from krepp_tpu_torch.parallel.boot import (init_distributed,
                                           shutdown_distributed)
pid, port, nproc, nd, ns, outp = (int(sys.argv[1]), sys.argv[2],
                                  int(sys.argv[3]), int(sys.argv[4]),
                                  int(sys.argv[5]), sys.argv[6])
init_distributed(f"localhost:{port}", nproc, pid, device="cpu", timeout_s=100)
try:
    from krepp_tpu_torch import testing
    from krepp_tpu_torch.index.index import DeviceIndex
    from krepp_tpu_torch.parallel.multihost import (MultiHostQueryEngine,
                                                    make_global_mesh)
    built, genomes, _ = testing.build_world_index(seed=21, nleaves=6,
                                                  glen=1200, m=2)
    codes = testing.sample_read_codes(np.random.default_rng(22), genomes, 9,
                                      rlen=150, mut=0.05)
    lengths = np.full(9, 150, np.int32)
    mesh = make_global_mesh(nd, ns, "cpu")
    assert len(mesh.own()) == nd * ns // nproc
    # every cell of this process must be in its step at once
    import threading
    barrier = threading.Barrier(len(mesh.own()), timeout=60)
    step = MultiHostQueryEngine._shard_probe
    MultiHostQueryEngine._shard_probe = lambda self, *a: (
        barrier.wait(), step(self, *a))[1]
    eng = MultiHostQueryEngine(DeviceIndex.from_built(built), mesh, 4)
    assert eng.concurrent
    lr = eng.fetch_leaf_stage(eng.run_leaf_stage_async(codes, lengths),
                              lengths, codes=codes)
    np.savez(outp, present=lr.present, hist=lr.hist, d=lr.d,
             slot=lr.closest_slot, onmers=lr.onmers, match=lr.match)
finally:
    shutdown_distributed()
"""

_CLI_CHILD = _BLOCK + r"""
import os
pid, port = sys.argv[1], sys.argv[2]
os.environ.update(KREPP_COORDINATOR=f"localhost:{port}",
                  KREPP_NUM_PROCESSES="2", KREPP_PROCESS_ID=pid)
from krepp_tpu_torch.cli import main
sys.exit(main(sys.argv[3:]))
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_ranks(child, args_of, nproc=2):
    """Run `child` as ranks 0 .. nproc - 1 (args_of(rank) after rank and
    port); a child that fails or outlives CHILD_TIMEOUT_S fails the test
    and all are killed."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", child, str(r), port]
                              + args_of(r), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(nproc)]
    try:
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=CHILD_TIMEOUT_S)
            assert proc.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.mark.parametrize("nproc,nd,ns", [(2, 2, 2), (2, 1, 2), (4, 2, 2)],
                         ids=["2x2-two", "1x2-two", "2x2-four"])
def test_two_process_engine_equals_single_process(nproc, nd, ns, tmp_path):
    """2x2 over two processes keeps the data rows inside a process, 1x2
    sends the shard merge across them, and 2x2 over four (a cell each)
    does both: a shard merge within each data row's pair of processes and
    the gather of the rows across the pairs."""
    from krepp_tpu_torch import testing
    from krepp_tpu_torch.index.index import DeviceIndex
    from krepp_tpu_torch.query.engine import QueryEngine

    outs = [str(tmp_path / f"rank{r}.npz") for r in range(nproc)]
    _run_ranks(_ENGINE_CHILD, lambda r: [str(nproc), str(nd), str(ns),
                                         outs[r]], nproc)
    built, genomes, _ = testing.build_world_index(seed=21, nleaves=6,
                                                  glen=1200, m=2)
    codes = testing.sample_read_codes(np.random.default_rng(22), genomes, 9,
                                      rlen=150, mut=0.05)
    lengths = np.full(9, 150, np.int32)
    eng = QueryEngine(DeviceIndex.from_built(built), 4, device="cpu")
    lr = eng.fetch_leaf_stage(eng.run_leaf_stage_async(codes, lengths),
                              lengths, codes=codes)
    assert lr.present.sum() > 9
    for r in range(nproc):
        z = np.load(outs[r])
        for key, want in (("present", lr.present), ("hist", lr.hist),
                          ("slot", lr.closest_slot), ("onmers", lr.onmers),
                          ("match", lr.match)):
            assert np.array_equal(z[key], want), (r, key)
        assert np.allclose(z["d"], lr.d, rtol=5e-9, atol=5e-9), r


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    from krepp_tpu_torch import testing
    from krepp_tpu_torch.index.artifact import save_native

    d = tmp_path_factory.mktemp("torch_multihost_cli")
    built, genomes, _ = testing.build_world_index(seed=31, nleaves=6,
                                                  glen=1500, m=2)
    save_native(built, str(d / "idx"))
    testing.write_fastq(str(d / "q.fq"), testing.sample_read_codes(
        np.random.default_rng(32), genomes, 9, rlen=150, mut=0.05))
    return d


@pytest.mark.parametrize("cmd", [["dist"], ["place", "--tabular"]],
                         ids=["dist", "place"])
def test_two_process_cli_rank_files_are_the_reference_output(cli_world,
                                                             cmd):
    from krepp_tpu.cli import main as jmain

    q, idx = str(cli_world / "q.fq"), str(cli_world / "idx")
    want_path = str(cli_world / f"{cmd[0]}_want.tsv")
    assert jmain(cmd + ["-q", q, "-i", idx, "-o", want_path]) == 0
    got_path = str(cli_world / f"{cmd[0]}_mesh.tsv")
    _run_ranks(_CLI_CHILD, lambda r: cmd + [
        "--mesh", "2x2", "-q", q, "-i", idx, "-o", got_path, "--device",
        "cpu"])
    nhead = 2 if cmd[0] == "dist" else 3
    parts = []
    for r in range(2):
        with open(f"{got_path}.rank{r}") as f:
            lines = f.read().splitlines(keepends=True)
        parts.append(lines if r == 0 else lines[nhead:])
        assert len(lines) > nhead
    with open(want_path) as f:
        want = f.read().splitlines(keepends=True)
    got = parts[0] + parts[1]
    # the first line names each run's own invocation
    assert got[0].split("invocation :")[0] == want[0].split("invocation :")[0]
    assert "".join(got[1:]) == "".join(want[1:]) and len(want) > 9 + nhead
