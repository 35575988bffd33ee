"""The program's own spans and counters (krepp_tpu_torch/core/trace.py),
read by the per-layer metrics of a traced run.

The registry is turned on, empty, just before a traced run's window:
`HOOK` is the `SPANS` of each metric that reads it, and the harness goes
through every traced metric's `SPANS` once, before the window, for the
calls to wrap (harness.span_specs); going through `HOOK` resets and
enables the registry and names no call, so nothing of the program is
wrapped. The registry stays on through the traced pass, whose profile its
spans annotate. The first `reading` of the run takes the registry's
snapshot and turns it off. A program without the registry gives no
reading, and its readers return None.

The window's spans are the records that ended before the traced pass's
first span (`entry`, one a pass) began, the traced pass being the one
after the window's `len(run.pass_s)` passes; their self times come from
the records alone. Counters cover the window and the traced pass, which
repeat the same sample, so a ratio of two counters is the window's.
"""

from __future__ import annotations

import importlib
from collections import defaultdict
from typing import Dict, Iterable, Optional

MODULE = "krepp_tpu_torch.core.trace"
_readings: Dict[int, Optional["Reading"]] = {}


def _registry():
    try:
        return importlib.import_module(MODULE)
    except ImportError:
        return None


class _Hook:
    """Iterated once before a traced window: the registry on and empty."""

    def __iter__(self):
        reg = _registry()
        if reg is not None:
            _readings.clear()
            reg.reset()
            reg.enable()
        return iter(())


HOOK = _Hook()


class Reading:
    """The window's span self times (seconds by name; None where records
    were dropped) and the run's counters."""

    def __init__(self, snap: dict, passes: int):
        self.counts: Dict[str, int] = snap["counts"]
        self.spans: Optional[Dict[str, float]] = None
        if snap["dropped"]:
            return
        recs = snap["records"]
        entries = sorted(r[1] for r in recs if r[0] == "entry")
        cut = entries[passes] if len(entries) > passes else float("inf")
        win = [r for r in recs if r[2] <= cut]
        child = defaultdict(int)
        for _, t0, t1, _, parent, _, _ in win:
            if parent is not None:
                child[parent] += t1 - t0
        spans = defaultdict(float)
        for name, t0, t1, rid, _, _, _ in win:
            spans[name] += (t1 - t0 - child[rid]) * 1e-9
        self.spans = dict(spans)


def reading(run) -> Optional[Reading]:
    """The registry's reading of `run` (taken once), or None."""
    key = id(run)
    if key not in _readings:
        reg = _registry()
        snap = None
        if reg is not None and reg.enabled():
            snap = reg.snapshot()
            reg.disable()
            reg.reset()
        _readings[key] = (Reading(snap, len(run.pass_s))
                          if snap and snap["records"] else None)
    return _readings[key]


def per_kread(run, names: Iterable[str]) -> Optional[float]:
    """The window's self time of the named spans, ms per 1,000 reads."""
    r = reading(run)
    if r is None or r.spans is None or not run.reads:
        return None
    return sum(r.spans.get(n, 0.0) for n in names) * 1e3 / (run.reads / 1e3)


def ratio(run, num: str, den: str) -> Optional[float]:
    """Counter `num` over counter `den` (a counter not set is 0)."""
    r = reading(run)
    if r is None or not r.counts.get(den):
        return None
    return r.counts.get(num, 0) / r.counts[den]
