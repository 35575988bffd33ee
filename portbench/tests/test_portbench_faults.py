"""A run whose timed path is broken underneath comes out not correct:
half of each batch left out, and the answers altered where the engine
produces them. (One card, no training: no state to leave unchanged and
no exchange between chips to leave out.)"""

from __future__ import annotations

import numpy as np
import pytest

from krepp_tpu_torch.query import engine

from .conftest import tiny_run


def half_left_out(monkeypatch):
    upload = engine.QueryEngine.upload

    def broken(self, codes, lengths, leaf_ok=None):
        lengths = np.array(lengths, copy=True)
        lengths[len(lengths) // 2:] = 0
        return upload(self, codes, lengths, leaf_ok)

    monkeypatch.setattr(engine.QueryEngine, "upload", broken)


def answers_altered(monkeypatch):
    get = engine._Pending.get

    def broken(self):
        return tuple(a + 1e-3 if a.dtype == np.float64 else a
                     for a in get(self))

    monkeypatch.setattr(engine._Pending, "get", broken)


@pytest.mark.parametrize("fault", [half_left_out, answers_altered])
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = tiny_run(cell)
    assert not r["correct"], r["checks"]
