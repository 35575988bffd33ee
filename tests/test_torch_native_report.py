"""The port's loader of the jplace emitter: concurrent first builds into one
empty directory all succeed, and the emitted bytes equal krepp_tpu's."""

import os
import subprocess
import sys

import numpy as np

from krepp_tpu.io import native_report as jnative_report
from krepp_tpu_torch.io import native_report
from refcsrc import private_reference_csrc  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LOAD = r"""
import sys
from krepp_tpu_torch.io import native_report
native_report.get_lib(sys.argv[1])
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
    assert len(built) == 1 and built[0].startswith("libreport-") \
        and built[0].endswith(".so"), built


def test_emitted_bytes_match_reference():
    """One batch: a skipped read, a single placement, a multi-row read and
    a read without candidates, in multi and no-multi form. In no-multi
    form the caller (place._report_batch) skips a read without candidates:
    the emitter reads row starts[b] of such a read unguarded."""
    rng = np.random.default_rng(8)
    names = ["r0", "||61435-r1", "r2", "r3"]
    kinds = {True: np.array([0, 1, 2, 2], np.uint8),
             False: np.array([0, 1, 2, 0], np.uint8)}
    s_of = np.array([-1, 0, -1, -1])
    starts = np.array([0, 0, 0, 3])
    ends = np.array([0, 0, 3, 3])
    s_q, c_q = np.array([4]), np.array([2, 5, 6])
    blen = np.concatenate([[np.nan], rng.random(8)])
    s_d, s_v = rng.random(1) / 10, -rng.random(1) * 50
    c_d, c_v, c_w = rng.random(3) / 10, -rng.random(3) * 50, rng.random(3)
    for multi in (True, False):
        for has_previous in (False, True):
            args = (names, kinds[multi], s_of, starts, ends, s_q, s_d, s_v, c_q, c_d,
                    c_v, c_w, blen, multi, has_previous)
            want = jnative_report.jplace_emit(*args)
            got = native_report.jplace_emit(*args)
            assert got == want and got[1] == 2 + multi and len(got[0]) > 100
