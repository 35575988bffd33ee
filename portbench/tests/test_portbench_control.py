"""The control: the plain reference in float32 put in the program's place
fails the comparison that the float64 reference passes, for every traffic
mix of a cell (at a small size on the host)."""

from __future__ import annotations

import torch

from portbench import check, control, harness, reference

from .conftest import TINY, bench


def _world(cell, seed):
    _, cfg, traffic = harness.cell_spec(bench(), cell)
    cfg = {**cfg, **TINY["config"], "genomes": 32}
    traffic = {**traffic, **TINY["traffic"]}
    return harness.make_world(cfg, traffic, seed, "cpu"), traffic


def test_float32_control_fails(cell):
    for seed in (11, 12, 2 ** 33 + 7):
        w, traffic = _world(cell, seed)
        gap = control.control_gap(w, traffic, seed, "cpu")
        assert gap > traffic["check_limit"], (seed, gap)


def test_reference_agrees_with_itself(cell):
    w, traffic = _world(cell, 3)
    names, idx = harness.check_sample(w, traffic, 3)
    args = (traffic["command"], torch.from_numpy(w.genomes), w.names,
            w.nwk, w.reads[idx], names, w.params)
    a = reference.report(*args)
    assert check.widest_gap(a, reference.report(*args), names) == 0.0
    assert any(a.values())              # something matched
