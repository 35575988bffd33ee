"""The port's loader of the native winnower: concurrent first builds into
one empty directory all succeed, and its extraction equals krepp_tpu's."""

import os
import subprocess
import sys

import numpy as np
import pytest

from krepp_tpu.index import build as jbuild
from krepp_tpu.params import IndexParams, LSHParams
from krepp_tpu_torch.core import native_extract
from refcsrc import private_reference_csrc  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LOAD = r"""
import sys
from krepp_tpu_torch.core import native_extract
native_extract.get_lib(sys.argv[1])
print("loaded")
"""


def test_concurrent_first_builds_all_load(tmp_path):
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(build_dir)],
                              cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "loaded"
    built = os.listdir(build_dir)
    assert len(built) == 1 and built[0].startswith("libextract-") \
        and built[0].endswith(".so"), built


_LOAD_ANY = r"""
import importlib, sys
importlib.import_module(sys.argv[1]).get_lib(sys.argv[2])
print("loaded")
"""


@pytest.mark.parametrize("module,stem", [
    ("krepp_tpu_torch.core.native_sort", "sortkv"),
    ("krepp_tpu_torch.core.native_colorize", "colorize"),
    ("krepp_tpu_torch.io.native_batch", "fastx_batch"),
    ("krepp_tpu_torch.io.native_report", "report"),
    ("krepp_tpu_torch.io.native_rows", "dist_rows"),
])
def test_concurrent_first_builds_of_the_other_loaders(tmp_path, module, stem):
    """The loaders that share csrc/build.cc_library: six processes build
    into one empty directory at once and every one loads a whole library."""
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_ANY, module,
                               str(build_dir)], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "loaded"
    built = os.listdir(build_dir)
    assert len(built) == 1 and built[0].startswith(f"lib{stem}-") \
        and built[0].endswith(".so"), built


def test_extraction_matches_reference():
    """Against krepp_tpu's own winnower dispatch (its native library, or
    the device winnower if that library's build lost a race): the same
    per-genome (row, residual) set and the same rho."""
    rng = np.random.default_rng(21)
    params = IndexParams(lsh=LSHParams.generate(27, 11, 4, seed=3), w=35,
                         r=1, frac=True)
    contigs = [rng.integers(0, 4, 20000).astype(np.uint8),
               rng.integers(0, 5, 3000).astype(np.uint8),   # N bases
               rng.integers(0, 4, 20).astype(np.uint8)]     # shorter than w
    want = jbuild._extract_genome(contigs, params)
    got = native_extract.extract_genome_mers_native(contigs, params)
    for a, b in zip(jbuild._dedupe_genome(*want[:2]),
                    jbuild._dedupe_genome(*got[:2])):
        assert np.array_equal(a, b) and len(a) > 100
    assert want[2] == got[2]
