"""Helpers of the benchmark's CPU tests: every cell at a tiny size."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness

torch.set_num_threads(1)        # as the run command's OMP_NUM_THREADS=1

# small enough for the host: the shapes (k, w, h, m, r, read length,
# threshold, traffic mix) are the cells' own, the scale is cut
TINY = {"config": {"genomes": 24, "genome_bp": 20000},
        "traffic": {"reads": 3000, "check_reads": 96, "offtarget_bp": 60000}}


def bench() -> dict:
    return harness.benchmark()


def cells():
    return [w["name"] for w in bench()["workloads"]]


def tiny_run(cell: str, trace: bool = False, seed: int = 2 ** 31 + 5):
    return harness.run_cell(bench(), cell, seed, 0.5, trace, "cpu",
                            time.perf_counter(), TINY)


@pytest.fixture(params=cells())
def cell(request):
    return request.param
